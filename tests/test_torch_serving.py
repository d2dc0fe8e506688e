"""The port's BatchedSampler against the reference BatchedSampler.

Both engines serve the same requests on the same smoke denoiser weights
(moved over with ``params_from_jax``); the port draws each request's noise
through ``noise_fn`` from the reference's own ``jax.random`` stream, so the
two runs start from identical latents.  The reference ERA runs with
``use_fused_update=False`` (its fused path needs a JAX API the installed
JAX no longer has).  Tolerances as in test_torch_era: ``x0`` atol 2e-3,
error norms rtol 1e-4 / atol 5e-5, ERS selections equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ERAConfig as JERAConfig
from repro.serving import BatchedSampler as JBatchedSampler
from repro.serving import SampleRequest as JSampleRequest
from repro.serving import result_keys as JK
from repro_torch.core import ERAConfig, linear_schedule
from repro_torch.models import DiffusionLM
from repro_torch.configs import get_config
from repro_torch.serving import (
    SEED_MAX,
    BatchedSampler,
    SampleRequest,
    SamplerService,
)
from repro_torch.serving import result_keys as K
from test_torch_models import build_pair
from repro.core import linear_schedule as jlinear_schedule

REQS = [
    dict(batch=1, seq_len=8, nfe=6, seed=3),
    dict(batch=3, seq_len=8, nfe=6, seed=4),
    dict(batch=2, seq_len=6, nfe=7, seed=5),
]


def reference_noise(d):
    def fn(req):
        return np.asarray(jax.random.normal(
            jax.random.PRNGKey(req.seed), (req.batch, req.seq_len, d),
            jnp.float32,
        ))
    return fn


@pytest.fixture(scope="module")
def served():
    jdlm, params, tdlm = build_pair("qwen2-1.5b", "naive", "auto", seed=3,
                                    head_scale=0.05)
    d = tdlm.config.d_model
    jeng = JBatchedSampler(
        jdlm, jlinear_schedule(),
        solver_config=JERAConfig(per_sample=True, use_fused_update=False),
    )
    teng = BatchedSampler(tdlm, linear_schedule(), noise_fn=reference_noise(d))
    jf = [jeng.submit_with_future(JSampleRequest(**r))[1] for r in REQS]
    tf = [teng.submit_with_future(SampleRequest(**r))[1] for r in REQS]
    jeng.drain(params)
    teng.drain()
    return [f.result() for f in jf], [f.result() for f in tf], teng


def test_batched_sampler_matches_reference(served):
    jres, tres, _ = served
    for r, j, t in zip(REQS, jres, tres):
        assert t.x0.shape == (r["batch"], r["seq_len"], 128)
        np.testing.assert_allclose(t.x0.numpy(), np.asarray(j.x0), atol=2e-3)
        np.testing.assert_array_equal(
            t.aux[K.ERS_SELECTION_HISTORY].numpy(),
            np.asarray(j.aux[JK.ERS_SELECTION_HISTORY]),
        )
        for key in (K.DELTA_EPS_HISTORY, K.DELTA_EPS_HISTORY_PER_SAMPLE):
            np.testing.assert_allclose(
                t.aux[key].numpy(), np.asarray(j.aux[key]), rtol=1e-4, atol=5e-5
            )
        assert (t.padded_batch, t.padded_seq_len, t.padded_nfe) == (
            j.padded_batch, j.padded_seq_len, j.padded_nfe
        )
        assert sorted(t.info) == sorted(j.info)


def test_result_keys_copy_matches_reference():
    names = [n for n in dir(JK) if n.isupper()]
    assert names == [n for n in dir(K) if n.isupper()]
    for n in names:
        assert getattr(K, n) == getattr(JK, n)


def test_metrics_count_fused_batches(served):
    _, _, teng = served
    text = teng.metrics.render()
    assert "sampler_batches_total 2" in text
    assert "sampler_batch_rows_total 6" in text


def _engine(**kw):
    cfg = get_config("llama3.2-1b", smoke=True).with_(num_layers=1)
    return BatchedSampler(DiffusionLM(cfg, device="cpu"), linear_schedule(), **kw)


@pytest.mark.parametrize("req,match", [
    (dict(batch=0, seq_len=4), "batch"),
    (dict(batch=5000, seq_len=4), "max_batch"),
    (dict(batch=1, seq_len=0), "seq_len"),
    (dict(batch=1, seq_len=9000), "max_seq_len"),
    (dict(batch=1, seq_len=4, nfe=3), "nfe >= k"),
    (dict(batch=1, seq_len=4, nfe=2000), "max_nfe"),
    (dict(batch=1, seq_len=4, seed=SEED_MAX + 1), "64-bit"),
    (dict(batch=1, seq_len=4, seed=True), "seed"),
    (dict(batch=1, seq_len=4, solver="nope"), "solver"),
])
def test_validate_rejects_at_submit(req, match):
    eng = _engine()
    with pytest.raises(ValueError, match=match):
        eng.submit_with_future(SampleRequest(**req))
    assert eng.pending == 0


def test_noise_is_seed_deterministic_across_batches():
    """A request's rows do not depend on its batch-mates or pad rows."""
    eng = _engine()
    solo = eng.submit_with_future(SampleRequest(batch=2, seq_len=5, seed=7))[1]
    eng.drain()
    _, mate = eng.submit_with_future(SampleRequest(batch=3, seq_len=5, seed=8))
    again = eng.submit_with_future(SampleRequest(batch=2, seq_len=5, seed=7))[1]
    eng.drain()
    assert mate.result().padded_batch == 8
    torch.testing.assert_close(again.result().x0, solo.result().x0,
                               atol=1e-5, rtol=0)


def test_submit_ticket_keys_the_drain_result():
    eng = _engine()
    t0 = eng.submit(SampleRequest(batch=1, seq_len=4, seed=1))
    t1 = eng.submit(SampleRequest(batch=2, seq_len=4, seed=2))
    results = eng.drain()
    assert sorted(results) == [t0, t1] and t0 != t1
    assert results[t1].x0.shape == (2, 4, eng.dlm.config.d_model)


def test_pack_chunks_to_the_largest_bucket():
    eng = _engine(batch_buckets=(1, 4))
    futs = [eng.submit_with_future(SampleRequest(batch=3, seq_len=4, seed=s))[1]
            for s in range(3)]
    eng.drain()
    assert [f.result().padded_batch for f in futs] == [4, 4, 4]


def test_sampler_service_runs_paper_config_exact_size():
    cfg = get_config("llama3.2-1b", smoke=True).with_(num_layers=1)
    svc = SamplerService(DiffusionLM(cfg, device="cpu"), linear_schedule())
    res = svc.sample(SampleRequest(batch=3, seq_len=4, nfe=5, seed=1))
    assert res.padded_batch == 3 and res.x0.shape == (3, 4, cfg.d_model)
    assert res.aux[K.DELTA_EPS_HISTORY].shape == (5,)  # shared delta_eps
    assert K.ERS_SELECTION_HISTORY not in res.aux
    assert not ERAConfig().per_sample


def test_failed_chunk_resolves_its_futures():
    eng = _engine()

    def boom(x, t):
        raise RuntimeError("denoiser failed")

    eng.dlm.eps_fn = lambda lengths=None: boom
    _, fut = eng.submit_with_future(SampleRequest(batch=1, seq_len=4))
    with pytest.raises(RuntimeError, match="denoiser failed"):
        eng.drain()
    with pytest.raises(RuntimeError, match="denoiser failed"):
        fut.result(timeout=1)
