"""The port's synthetic data (``repro_torch.data``) against the reference's
(``repro.data``): both draw from numpy generators, so every batch, the
mixture's parameters and its moments must be equal exactly."""

import itertools

import numpy as np
import pytest

from repro import data as J
from repro_torch import data as T


@pytest.mark.parametrize("vocab,seq,batch,seed", [
    (512, 16, 4, 0), (151_936, 32, 8, 3), (7, 5, 3, 11)])
def test_token_stream_equals_reference(vocab, seq, batch, seed):
    cfg = dict(vocab_size=vocab, seq_len=seq, batch_size=batch, seed=seed)
    got = T.TokenStream(T.DataConfig(**cfg))
    ref = J.TokenStream(J.DataConfig(**cfg))
    np.testing.assert_array_equal(got.unigram, ref.unigram)
    np.testing.assert_array_equal(got.succ, ref.succ)
    for a, b in itertools.islice(zip(got.batches(), ref.batches()), 4):
        assert a.keys() == b.keys() == {"tokens"}
        assert a["tokens"].dtype == b["tokens"].dtype == np.int32
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


@pytest.mark.parametrize("d,modes,seed", [(128, 8, 0), (1536, 8, 5), (16, 2, 3)])
def test_gaussian_mixture_equals_reference(d, modes, seed):
    cfg = dict(vocab_size=1, seq_len=12, batch_size=4, kind="diffusion",
               d_model=d, num_modes=modes, seed=seed)
    got = T.GaussianMixtureLatents(T.DataConfig(**cfg))
    ref = J.GaussianMixtureLatents(J.DataConfig(**cfg))
    np.testing.assert_array_equal(got.means, ref.means)
    np.testing.assert_array_equal(got.scales, ref.scales)
    for a, b in zip(got.moments(), ref.moments()):
        np.testing.assert_array_equal(a, b)
    for a, b in itertools.islice(zip(got.batches(), ref.batches()), 4):
        assert a["latents"].dtype == b["latents"].dtype == np.float32
        assert a["latents"].shape == (4, 12, d)
        np.testing.assert_array_equal(a["latents"], b["latents"])


def test_make_loader_picks_the_kind():
    lm = T.DataConfig(vocab_size=32, seq_len=4, batch_size=2)
    assert isinstance(T.make_loader(lm), T.TokenStream)
    diff = T.DataConfig(vocab_size=1, seq_len=4, batch_size=2,
                        kind="diffusion", d_model=8)
    assert isinstance(T.make_loader(diff), T.GaussianMixtureLatents)
    with pytest.raises(ValueError, match="unknown data kind"):
        T.make_loader(T.DataConfig(vocab_size=1, seq_len=4, batch_size=2,
                                   kind="images"))
    with pytest.raises(ValueError, match="d_model"):
        T.GaussianMixtureLatents(lm)


def test_frontend_features_equal_reference():
    a = T.frontend_features(np.random.default_rng(4), 2, 16, 32)
    b = J.frontend_features(np.random.default_rng(4), 2, 16, 32)
    np.testing.assert_array_equal(a, b)
