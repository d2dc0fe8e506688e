"""The port's audio family (whisper-base: the ``enc`` and ``xdec`` blocks,
the encoder over stub frames with sinusoidal positions, cross-attention and
its ``xk`` / ``xv`` cache, learned decoder positions ``pos_embed``, the
layernorms and the plain GELU MLP) against the JAX reference on the CPU.

The reference initializes the weights (``BLOCKS[kind].specs`` /
``build_model(cfg).init`` / ``DiffusionLM.init``); they move to the port by
their dotted keys (``repro_torch.interop``).  The smoke config runs in
float32: d_model 128, 4 heads over 2 KV heads of 32, one ``xdec`` layer,
two encoder layers, 16 stub frames, 512 learned positions.  The frames
are the reference's stub features (``frontend_features``, the port's copy),
drawn from one numpy generator for both packages.

Tolerances: block and cross-attention outputs within ``1e-5 * max|ref| +
1e-6`` (float32 summation order); the encoder's output atol 5e-4, the
denoiser's bound (``test_torch_models``): with the reference's init its
residual stream reaches ~5e2 in two layers, where float32 rounding is
~1e-5 relative, and the final layernorm carries that to the unit-scale
output (6e-5 seen); the ``xk`` / ``xv`` caches, that output projected by
weights of std 0.71 (the reference's stacked fan-in init divides by the
layer count, 2) over 128 inputs, atol 5e-4 * 0.71 * sqrt(128) = 4e-3
(4.3e-4 seen on values up to ~42); slot positions equal; token-model logits
atol 1e-3 (``LOGIT_TOL``): whisper's LM head is untied and fan-in
initialized, so its logits reach ~4 (the dense family's, tied to 0.02-scale
embedding rows, stay under ~1.5 and are held to 1e-4), and the reference
itself lands 5.2e-4 from a float64 run of the port on the same weights
through the ring-wrap case (the port 8.2e-4); ERA x0 atol 2e-3 with ERS
selections equal, as for the dense family (``test_torch_era``); the prefix
and causality walls inside the port bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import linear_schedule as jlinear_schedule
from repro.core.era import ERAConfig as JERAConfig
from repro.data import frontend_features as jfrontend_features
from repro.models import attention as JA
from repro.models import build_model as jbuild_model
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.blocks import BLOCKS as JBLOCKS
from repro.models.blocks import BlockCtx
from repro.serving import BatchedSampler as JBatchedSampler
from repro.serving import Engine as JEngine
from repro.serving import SampleRequest as JSampleRequest
from repro.serving import ServeConfig as JServeConfig
from repro_torch.configs import get_config
from repro_torch.core import linear_schedule
from repro_torch.data import frontend_features
from repro_torch.interop import _leaves
from repro_torch.models import build_model
from repro_torch.models.attention import Attention
from repro_torch.models.blocks import BLOCKS
from repro_torch.serving import BatchedSampler, Engine, SampleRequest, ServeConfig
from repro_torch.serving import result_keys as K
from test_torch_engine import _tokens
from test_torch_engine import build_pair as build_model_pair
from test_torch_models import build_pair
from test_torch_serving import reference_noise
from test_torch_ssm import _close, _t, _x, fused_equals_solo, no_host_data

ARCH = "whisper-base"
FRAMES = 16   # the smoke config's stub frames
LOGIT_TOL = 1e-3


def frames(batch: int, seed: int = 0) -> np.ndarray:
    """Stub frames from a seeded generator (the reference's draw)."""
    d = get_config(ARCH, smoke=True).d_model
    return frontend_features(np.random.default_rng(seed), batch, FRAMES, d)


def block_pair(kind: str, seed: int = 0):
    jcfg = jget_config(ARCH, smoke=True).with_(attention_impl="naive")
    p = JL.init_params(JBLOCKS[kind].specs(jcfg), jax.random.PRNGKey(seed))
    m = BLOCKS[kind](get_config(ARCH, smoke=True),
                     generator=torch.Generator().manual_seed(0),
                     device="cpu", dtype=torch.float32)
    m.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in _leaves(p)})
    return jcfg, p, m


def test_smoke_config_and_frontend_features():
    """The reference's smoke rules: one xdec layer, at most 2 encoder
    layers, 16 frames of width d_model, 512 positions; the port's
    ``frontend_features`` draws the reference's numbers from one seed."""
    cfg = get_config(ARCH, smoke=True)
    assert cfg.blocks == (("xdec", 1),) and cfg.num_encoder_layers == 2
    assert (cfg.frontend.kind, cfg.frontend.num_positions,
            cfg.frontend.feature_dim) == ("audio", FRAMES, 128)
    assert cfg.max_position == 512 and not cfg.use_rope
    want = jfrontend_features(np.random.default_rng(5), 3, 40, 24)
    got = frontend_features(np.random.default_rng(5), 3, 40, 24)
    assert got.dtype == np.float32 and np.array_equal(got, want)


# ---- blocks, encoder, cross-attention ---------------------------------------


@pytest.mark.parametrize("lengths", [None, (12, 7, 3)], ids=["full", "lengths"])
def test_enc_block_matches_reference(lengths):
    """The encoder block attends bidirectionally whatever the context asks,
    with per-row key lengths when given."""
    jcfg, p, m = block_pair("enc")
    x = _x((3, 12, jcfg.d_model), 3)
    ln = None if lengths is None else np.asarray(lengths, np.int32)
    ctx = BlockCtx(mode="train", causal=True,
                   lengths=None if ln is None else jnp.asarray(ln))
    want, _, _ = JBLOCKS["enc"].apply(p, jnp.asarray(x), None, ctx, jcfg)
    got = m(_t(x), causal=True, lengths=None if ln is None else _t(ln))
    _close(got, want)


@pytest.mark.parametrize("case", ["decoder-only", "decoder-only-lengths", "cross"])
def test_xdec_block_matches_reference(case):
    """The decoder block in train mode: decoder-only (the denoiser: no
    encoder states; per-row lengths), and with encoder states, which adds
    the cross-attention over them.  ``causal=False`` is passed: the
    self-attention stays causal, as the reference's does."""
    jcfg, p, m = block_pair("xdec")
    x = _x((3, 12, jcfg.d_model), 4)
    enc = _x((3, FRAMES, jcfg.d_model), 5) if case == "cross" else None
    ln = np.asarray([12, 7, 3], np.int32) if case.endswith("lengths") else None
    ctx = BlockCtx(mode="train", causal=False,
                   enc_out=None if enc is None else jnp.asarray(enc),
                   lengths=None if ln is None else jnp.asarray(ln))
    want, _, _ = JBLOCKS["xdec"].apply(p, jnp.asarray(x), None, ctx, jcfg)
    kw = {} if enc is None else {"enc_out": _t(enc)}
    got = m(_t(x), causal=False, lengths=None if ln is None else _t(ln), **kw)
    _close(got, want)
    if enc is not None:  # the cross-attention moved the output
        assert not np.allclose(got.numpy(), np.asarray(
            JBLOCKS["xdec"].apply(p, jnp.asarray(x), None,
                                  BlockCtx(mode="train"), jcfg)[0]))


def test_encoder_matches_reference():
    """The encoder (``enc`` blocks over frames + sinusoidal positions of
    p / 1000, then a layernorm) against the reference's ``_encode``."""
    jmodel, params, tmodel = build_model_pair(ARCH)
    f = frames(2)
    want = JM._encode(params, jnp.asarray(f), jmodel.config)
    got = tmodel.encoder(_t(f))
    assert got.shape == (2, FRAMES, tmodel.config.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4)


@pytest.mark.parametrize("mode,s,pos", [("train", 9, None), ("prefill", 9, None),
                                        ("decode", 1, 37)])
def test_cross_attention_matches_reference(mode, s, pos):
    """``Attention(..., cross_kv=(ek, ev, arange(F)))`` against the
    reference's ``cross_kv=(ek, ev)``, its queries at 0.. (train, prefill)
    or at ``pos`` (decode), over all 16 encoder keys, not causal, no cache:
    the decode mode takes the decode kernel's non-causal plain version,
    where a causal mask would drop keys past ``pos`` (here 37 > 15, so
    none; at pos 5 it would drop 10 of 16).  The port's queries carry no
    position: it must match the reference at both."""
    jcfg = jget_config(ARCH, smoke=True).with_(attention_impl="naive")
    p = JL.init_params(JA.attention_specs(jcfg), jax.random.PRNGKey(2))
    m = Attention(get_config(ARCH, smoke=True),
                  generator=torch.Generator().manual_seed(0), device="cpu",
                  dtype=torch.float32)
    m.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in _leaves(p)})
    kvh, hd = jcfg.num_kv_heads, jcfg.resolved_head_dim
    x = _x((2, s, jcfg.d_model), 6)
    ek, ev = (_x((2, FRAMES, kvh, hd), seed) for seed in (7, 8))
    for at in ((pos, 5) if mode == "decode" else (None,)):
        want, _ = JA.attention(
            p, jnp.asarray(x), jcfg, mode=mode,
            pos=None if at is None else jnp.int32(at),
            cross_kv=(jnp.asarray(ek), jnp.asarray(ev)))
        xpos = torch.arange(FRAMES, dtype=torch.int32)
        got = m(_t(x), mode=mode, cross_kv=(_t(ek), _t(ev), xpos))
        _close(got, want)


# ---- the token model ----------------------------------------------------------


def test_prefill_fills_the_cross_cache_and_self_ring():
    """After a prefill, every layer's ``xk`` / ``xv`` hold the encoder
    states' K / V (the reference's cache, within the block bound), and the
    self-attention ring holds the prompt's positions."""
    jmodel, params, tmodel = build_model_pair(ARCH)
    f, toks = frames(2), _tokens(tmodel.config.vocab_size, (2, 10), 1)
    jl, jc = jmodel.prefill(params, {"tokens": jnp.asarray(toks),
                                     "frames": jnp.asarray(f)}, 32)
    tl, tc = tmodel.prefill(_t(toks), 32, frames=_t(f))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL)
    assert set(tc) == set(jc) == {"0_xdec"}
    seg, jseg = tc["0_xdec"], jc["0_xdec"]
    assert seg["xk"].shape == (1, 2, FRAMES, 2, 32)
    assert seg["xpos"].tolist() == list(range(FRAMES))
    for key in ("xk", "xv"):
        assert bool(seg[key].abs().max() > 0)
        np.testing.assert_allclose(seg[key].numpy(), np.asarray(jseg[key]),
                                   atol=4e-3)
    assert np.array_equal(seg["self"]["pos"].numpy(), np.asarray(jseg["self"]["pos"][0]))
    assert seg["self"]["pos"][:10].tolist() == list(range(10))
    assert tmodel.rings(tc) == [seg["self"]]


@pytest.mark.parametrize("max_len,prompt_len,steps", [(64, 12, 6), (16, 10, 20)],
                         ids=["short", "ring-wrap"])
def test_whisper_prefill_and_decode_match_reference(max_len, prompt_len, steps):
    """Prefill logits (the encoder, ``pos_embed[:S]``) and teacher-forced
    decode logits (``pos_embed[pos]``, cross-attention over the cached
    ``xk`` / ``xv``) step by step against the reference engine, also
    through a self-attention ring that wraps."""
    jmodel, params, tmodel = build_model_pair(ARCH)
    cfg = tmodel.config
    je, te = (E(m, S(max_len=max_len)) for E, m, S in
              ((JEngine, jmodel, JServeConfig), (Engine, tmodel, ServeConfig)))
    f = frames(2, 3)
    prompts = _tokens(cfg.vocab_size, (2, prompt_len), 1)
    stream = _tokens(cfg.vocab_size, (2, steps), 101)
    jl, jc = je.prefill_step(params, {"tokens": jnp.asarray(prompts),
                                      "frames": jnp.asarray(f)})
    tl, tc = te.prefill_step(_t(prompts), extras={"frames": _t(f)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL)
    for i in range(steps):
        pos = prompt_len + i
        jl, jc = je.decode_step(params, jc, {"tokens": jnp.asarray(stream[:, i : i + 1]),
                                             "pos": jnp.int32(pos)})
        tl, tc = te.decode_step(tc, _t(stream[:, i : i + 1]), pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                                   err_msg=f"pos {pos}")
    assert np.array_equal(tc["0_xdec"]["self"]["pos"].numpy(),
                          np.asarray(jc["0_xdec"]["self"]["pos"][0]))


def test_forward_logits_match_reference_and_decode():
    """Teacher-forcing logits (encoder, learned positions) against the
    reference's ``forward``; a prefill of 8 tokens and 4 decode steps
    reproduce them, and ``pos_embed`` moves them (a decode at another
    position gives other logits)."""
    jmodel, params, tmodel = build_model_pair(ARCH)
    f, toks = frames(2, 4), _tokens(tmodel.config.vocab_size, (2, 12), 2)
    want, _ = jmodel.forward(params, {"tokens": jnp.asarray(toks),
                                      "frames": jnp.asarray(f)})
    full = tmodel(_t(toks), frames=_t(f))
    assert full.shape == (2, 12, tmodel.config.padded_vocab)
    np.testing.assert_allclose(full.numpy(), np.asarray(want), atol=LOGIT_TOL)
    lg, cache = tmodel.prefill(_t(toks[:, :8]), 32, frames=_t(f))
    np.testing.assert_allclose(lg[:, 0].numpy(), full[:, 7].numpy(), atol=2e-5)
    for t in range(8, 12):
        lg, cache = tmodel.decode(cache, _t(toks[:, t : t + 1]), t)
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, t].numpy(), atol=2e-5)
    _, c2 = tmodel.prefill(_t(toks[:, :8]), 32, frames=_t(f))
    other = tmodel.decode(c2, _t(toks[:, 8:9]), 9)[0]
    assert not torch.allclose(other[:, 0], full[:, 8])
    with pytest.raises(ValueError, match="frames"):
        tmodel.prefill(_t(toks), 32)


@pytest.mark.parametrize("seed", [0, 1])
def test_whisper_greedy_generate_matches_reference_tokens(seed):
    """``Engine.generate`` with the frames in ``extras``: the first decode
    position is the prompt's length (no prefix), as in the reference."""
    jmodel, params, tmodel = build_model_pair(ARCH)
    prompts = _tokens(tmodel.config.vocab_size, (2, 12), seed)
    f = frames(2, seed)
    want = JEngine(jmodel, JServeConfig(max_len=64)).generate(
        params, jnp.asarray(prompts), 12, extras={"frames": jnp.asarray(f)})
    got = Engine(tmodel, ServeConfig(max_len=64)).generate(
        _t(prompts), 12, extras={"frames": _t(f)})
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_param_count_matches_reference():
    """The full whisper-base token model on the meta device has the
    reference's ``param_count()``: the 524,288 x 512 position table, the
    6 encoder and 6 decoder layers, an untied LM head; layernorms carry a
    float32 bias."""
    model = build_model(get_config(ARCH), device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == jbuild_model(jget_config(ARCH)).param_count()
    assert model.pos_embed.shape == (524288, 512)
    assert len(model.encoder.layers) == 6 and len(model.backbone.layers) == 6
    assert 0.3e9 < n < 0.4e9
    ln = model.backbone.final_norm
    assert ln.bias.dtype == ln.scale.dtype == torch.float32
    assert model.backbone.layers[0].mlp.wg is None


# ---- the whisper denoiser -------------------------------------------------------


REQS = [dict(batch=1, seq_len=8, nfe=6, seed=3),
        dict(batch=3, seq_len=8, nfe=6, seed=4),
        dict(batch=2, seq_len=6, nfe=7, seed=5)]


def era_drain_matches_reference(arch: str) -> None:
    """Three requests drained through ``BatchedSampler`` on the smoke
    denoiser of ``arch`` against the reference's sampler on the same noise
    (ERA per-sample, the reference with ``use_fused_update=False``): x0
    within 2e-3, ERS selections equal."""
    jdlm, params, tdlm = build_pair(arch, "naive", "auto", seed=3, head_scale=0.05)
    jeng = JBatchedSampler(jdlm, jlinear_schedule(), solver_config=JERAConfig(
        per_sample=True, use_fused_update=False))
    teng = BatchedSampler(tdlm, linear_schedule(),
                          noise_fn=reference_noise(tdlm.config.d_model))
    jf = [jeng.submit_with_future(JSampleRequest(**r))[1] for r in REQS]
    tf = [teng.submit_with_future(SampleRequest(**r))[1] for r in REQS]
    jeng.drain(params)
    teng.drain()
    for r, j, t in zip(REQS, jf, tf):
        j, t = j.result(), t.result()
        assert t.x0.shape == (r["batch"], r["seq_len"], 128)
        np.testing.assert_allclose(t.x0.numpy(), np.asarray(j.x0), atol=2e-3)
        np.testing.assert_array_equal(t.aux[K.ERS_SELECTION_HISTORY].numpy(),
                                      np.asarray(j.aux[K.ERS_SELECTION_HISTORY]))


def test_era_drain_matches_reference():
    """On the whisper denoiser: decoder-only, causal self-attention."""
    era_drain_matches_reference(ARCH)


def test_whisper_denoiser_is_causal_in_both_packages():
    """``xdec``'s self-attention is causal even on the diffusion path (the
    reference passes it no causality): a later token moves no earlier eps,
    in either package, though the denoiser asks for bidirectional
    attention; the port's denoiser holds no encoder or position table."""
    jdlm, params, tdlm = build_pair(ARCH, "naive", "auto", seed=2)
    assert tdlm.causal is False
    assert not any(k.startswith(("encoder", "pos_embed")) for k in tdlm.state_dict())
    x = _x((1, 10, tdlm.config.d_model), 3)
    x2 = x.copy()
    x2[:, -1] += 1.0
    t = np.float32(0.5)
    for eps in (lambda a: np.asarray(jdlm.eps(params, jnp.asarray(a), t)),
                lambda a: tdlm.eps(torch.from_numpy(a), t).numpy()):
        a, b = eps(x), eps(x2)
        assert np.array_equal(a[:, :-1], b[:, :-1])
        assert not np.array_equal(a[:, -1], b[:, -1])


def test_whisper_eps_prefix_bitwise():
    """Inside the port (the reference's ``test_prefix_safety`` wall): a
    right-padded, masked batch gives the exact-shape eps on the prefix
    bitwise and exact zeros on the pad tail."""
    _, _, tdlm = build_pair(ARCH, "naive", "auto", seed=0)
    d = tdlm.config.d_model
    x = _x((2, 5, d), 1)
    xp = np.concatenate([x, np.zeros((2, 4, d), np.float32)], 1)
    lengths = torch.full((2,), 5, dtype=torch.int32)
    exact = tdlm.eps(_t(x), 0.7)
    assert torch.equal(tdlm.eps(_t(x), 0.7, lengths=lengths), exact)
    padded = tdlm.eps(_t(xp), 0.7, lengths=lengths)
    assert torch.equal(padded[:, :5], exact)
    assert bool((padded[:, 5:] == 0).all())


def test_whisper_fused_requests_equal_their_solo_drains():
    _, _, tdlm = build_pair(ARCH, "naive", "auto", seed=4, head_scale=0.05)
    fused_equals_solo(tdlm)


def test_whisper_bucket_program_makes_no_tensor_from_host_data():
    _, _, tdlm = build_pair(ARCH, "naive", "auto", seed=5, head_scale=0.05)
    no_host_data(tdlm)
