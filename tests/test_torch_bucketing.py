"""Seq and NFE bucketing in the port, against the reference and inside it.

Against the reference (``repro``, on the CPU; its ERA with
``use_fused_update=False``):

* ``ers_select`` gives the reference's integer selections over a sweep of
  steps, orders and powers;
* ``StepMask`` / ``step_active`` / ``step_row_times`` give the reference's
  values on the same seeded inputs;
* ``era.sample_scan(steps=...)`` matches the reference's step-masked loop
  (tolerances of ``test_torch_era``: x0 atol 1e-5 on the analytic oracle,
  2e-3 on the smoke denoiser; error norms rtol 1e-4 / atol 5e-5; ERS
  selections equal);
* a CPU drain under both ladders matches the reference executor's drain of
  the same requests, with ``noise_fn`` feeding the reference's noise.

Inside the port, bitwise: a request padded to a coarser NFE bucket at one
batch bucket equals its exact-NFE drain; a request padded to a seq bucket
equals its exact-shape solo run under a positionwise denoiser; the smoke
qwen2 denoiser holds the reference's real-denoiser bar (atol 1e-6, ERS
selections equal).  The serving walls of ``tests/test_seq_bucketing.py``
and ``tests/test_nfe_bucketing.py`` (no mesh) are ported below them.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from conftest import AnalyticGaussian
from repro.core import ERAConfig as JERAConfig
from repro.core import era as jera
from repro.core import lagrange as jlagrange
from repro.core import linear_schedule as jlinear_schedule
from repro.core import program as jprogram
from repro.core.schedules import timesteps as jtimesteps
from repro.serving import BatchedSampler as JBatchedSampler
from repro.serving import SampleRequest as JSampleRequest
from repro_torch.core import ERAConfig, lagrange, linear_schedule
from repro_torch.core import era as tera
from repro_torch.core import program as tprogram
from repro_torch.kernels import era_update as ku
from repro_torch.serving import (
    BatchedSampler,
    SampleRequest,
    SamplerService,
    result_keys as K,
)
from test_torch_era import TorchAnalyticGaussian, assert_runs_agree
from test_torch_models import build_pair
from test_torch_serving import reference_noise


class OracleDenoiser:
    """The analytic Gaussian oracle in the shape of a ``DiffusionLM`` on the
    CPU: positionwise, so length masking holds trivially."""

    D_MODEL = 8
    supports_length_masking = True
    device = torch.device("cpu")

    def __init__(self):
        self.analytic = TorchAnalyticGaussian()
        self.config = types.SimpleNamespace(d_model=self.D_MODEL)

    def eps_fn(self, lengths=None):
        return self.analytic.eps


SCHEDULE = linear_schedule()


def _engine(dlm=None, **kw):
    kw.setdefault("batch_buckets", (2, 4, 8))
    return BatchedSampler(dlm or OracleDenoiser(), SCHEDULE, **kw)


def _drain_one(engine, req, mates=()):
    ticket = engine.submit(req)
    for m in mates:
        engine.submit(m)
    return engine.drain()[ticket]


def _batches(engine) -> float:
    return engine.metrics.get("sampler_batches_total").value()


# ---- against the reference ---------------------------------------------


@pytest.mark.parametrize("k", [2, 3, 4, 5])
def test_ers_select_matches_reference(k):
    """Integer selections equal over every step i of a 40-step run and
    powers from 0 to 5 (the ERS power delta_eps / lambda), with no
    per-step device tensor built from host floats."""
    rng = np.random.default_rng(k)
    power = np.concatenate([
        rng.uniform(0.0, 5.0, 48), rng.uniform(0.0, 0.05, 8),
        [0.0, 0.5, 1.0, 2.0],
    ]).astype(np.float32)
    for i in range(k - 1, 40):
        want = np.stack([
            np.asarray(jlagrange.ers_select(jnp.int32(i), k, jnp.float32(p)))
            for p in power
        ])
        got = lagrange.ers_select(i, k, torch.from_numpy(power))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"i={i}")


def _step_mask_case(seed, batch=5, n=9):
    rng = np.random.default_rng(seed)
    acts = rng.integers(1, n + 1, batch).astype(np.int32)
    ts = np.sort(rng.uniform(0, 1, (batch, n + 1)), axis=1)[:, ::-1]
    return acts, np.ascontiguousarray(ts, dtype=np.float32)


@pytest.mark.parametrize("x_ndim", [1, 2, 3])
@pytest.mark.parametrize("i", [0, 3, 8])
def test_step_mask_helpers_match_reference(i, x_ndim):
    acts, ts = _step_mask_case(seed=10 * i + x_ndim)
    jsteps = jprogram.StepMask(jnp.asarray(acts), jnp.asarray(ts))
    tsteps = tprogram.StepMask(torch.from_numpy(acts), torch.from_numpy(ts))
    assert tsteps._fields == jsteps._fields
    want = jprogram.step_active(jsteps, jnp.int32(i), x_ndim)
    got = tprogram.step_active(tsteps, i, x_ndim)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for g, w in zip(tprogram.step_row_times(tsteps, i, x_ndim),
                    jprogram.step_row_times(jsteps, jnp.int32(i), x_ndim)):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _row_grids(acts, n, scheme="uniform"):
    """Each row's exact grid from the reference, terminal-padded to n+1."""
    sched = AnalyticGaussian().schedule
    rows = []
    for a in acts:
        t = np.asarray(jtimesteps(sched, int(a), scheme), np.float32)
        rows.append(np.concatenate([t, np.full(n - a, t[-1], np.float32)]))
    return np.stack(rows)


STEP_CASES = {
    "nfe10 k4 mixed": dict(acts=[10, 7, 5, 10], nfe=10, k=4),
    "nfe8 k3 mixed": dict(acts=[3, 8, 6], nfe=8, k=3),
    "nfe9 k2 logsnr": dict(acts=[9, 2, 5], nfe=9, k=2, scheme="logsnr"),
    "nfe6 k4 all active": dict(acts=[6, 6], nfe=6, k=4),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
@pytest.mark.parametrize("masked", [False, True], ids=["full", "lengths"])
def test_step_masked_sample_scan_matches_reference_on_oracle(case, masked):
    c = dict(STEP_CASES[case])
    acts = np.asarray(c.pop("acts"), np.int32)
    scheme = c.get("scheme", "uniform")
    b = len(acts)
    ts = _row_grids(acts, c["nfe"], scheme)
    x = np.random.default_rng(b).standard_normal((b, 6, 4)).astype(np.float32)
    lengths = (np.asarray([6, 4, 1, 3][:b], np.int32) if masked else None)
    ja, ta = AnalyticGaussian(), TorchAnalyticGaussian()
    jcfg = jera.ERAConfig(per_sample=True, use_fused_update=False, **c)
    tcfg = tera.ERAConfig(per_sample=True, **c)
    jx = jnp.asarray(x)
    want = jera.sample_scan(
        ja.eps, jx, *jera.alloc_buffers(jx, jcfg), ja.schedule, jcfg,
        lengths=None if lengths is None else jnp.asarray(lengths),
        steps=jprogram.StepMask(jnp.asarray(acts), jnp.asarray(ts)),
    )
    tx = torch.from_numpy(x)
    got = tera.sample_scan(
        ta.eps, tx, *tera.alloc_buffers(tx, tcfg), ta.schedule, tcfg,
        lengths=None if lengths is None else torch.from_numpy(lengths),
        steps=tprogram.StepMask(torch.from_numpy(acts), torch.from_numpy(ts)),
    )
    assert_runs_agree(want, got, 1e-5, per_sample=True)


def test_step_masked_sample_scan_matches_reference_on_denoiser():
    jdlm, params, tdlm = build_pair("qwen2-1.5b", "naive", "auto", seed=1,
                                    head_scale=0.05)
    d = tdlm.config.d_model
    acts = np.asarray([7, 5, 4], np.int32)
    ts = _row_grids(acts, 7)
    lengths = np.asarray([8, 5, 8], np.int32)
    x = np.random.default_rng(9).standard_normal((3, 8, d)).astype(np.float32)
    jcfg = jera.ERAConfig(nfe=7, k=3, per_sample=True, use_fused_update=False)
    tcfg = tera.ERAConfig(nfe=7, k=3, per_sample=True)
    jx, jl = jnp.asarray(x), jnp.asarray(lengths)
    want = jera.sample_scan(
        jdlm.eps_fn(params, lengths=jl), jx, *jera.alloc_buffers(jx, jcfg),
        AnalyticGaussian().schedule, jcfg, lengths=jl,
        steps=jprogram.StepMask(jnp.asarray(acts), jnp.asarray(ts)),
    )
    tx, tl = torch.from_numpy(x), torch.from_numpy(lengths)
    got = tera.sample_scan(
        tdlm.eps_fn(lengths=tl), tx, *tera.alloc_buffers(tx, tcfg), SCHEDULE,
        tcfg, lengths=tl,
        steps=tprogram.StepMask(torch.from_numpy(acts), torch.from_numpy(ts)),
    )
    assert_runs_agree(want, got, 2e-3, per_sample=True)


def test_step_masking_needs_per_sample_ers():
    ta = TorchAnalyticGaussian()
    x = torch.randn(2, 3, 4)
    cfg = tera.ERAConfig(nfe=5, k=3)
    steps = tprogram.StepMask(torch.tensor([5, 4], dtype=torch.int32),
                              torch.from_numpy(_row_grids([5, 4], 5)))
    with pytest.raises(ValueError, match="per-sample"):
        tera.sample_scan(ta.eps, x, *tera.alloc_buffers(x, cfg), ta.schedule,
                         cfg, steps=steps)
    program = tera.ERAProgram()
    for per_sample in (False, True):
        c = tera.ERAConfig(per_sample=per_sample)
        assert program.supports_steps(c) is per_sample
        assert program.supports_lengths(c) is per_sample


def test_sample_scan_takes_the_grid_from_the_caller():
    """A grid passed in is the one the loop steps through."""
    ta = TorchAnalyticGaussian()
    x = torch.randn(2, 3, 4)
    cfg = tera.ERAConfig(nfe=6, k=3, per_sample=True)
    own = tera.sample_scan(ta.eps, x, *tera.alloc_buffers(x, cfg), ta.schedule, cfg)
    grid = tera.ERAProgram().step_times(ta.schedule, 6, cfg)
    given = tera.sample_scan(ta.eps, x, *tera.alloc_buffers(x, cfg),
                             ta.schedule, cfg, ts=grid)
    assert torch.equal(own.x0, given.x0)
    with pytest.raises(ValueError, match="time grid"):
        tera.sample_scan(ta.eps, x, *tera.alloc_buffers(x, cfg), ta.schedule,
                         cfg, ts=grid[:-1])


LADDER_REQS = [
    dict(batch=1, seq_len=8, nfe=8, seed=3),
    dict(batch=3, seq_len=5, nfe=6, seed=4),
    dict(batch=2, seq_len=6, nfe=5, seed=5),
    dict(batch=2, seq_len=3, nfe=8, seed=6),
]


def test_bucketed_drain_matches_reference_executor():
    """Both ladders: the port's drain equals the reference executor's drain
    of the same requests on the same weights and noise."""
    jdlm, params, tdlm = build_pair("qwen2-1.5b", "naive", "auto", seed=3,
                                    head_scale=0.05)
    ladders = dict(batch_buckets=(8,), seq_buckets=(4, 8), nfe_buckets=(8,))
    jeng = JBatchedSampler(
        jdlm, jlinear_schedule(),
        solver_config=JERAConfig(per_sample=True, use_fused_update=False),
        **ladders,
    )
    teng = BatchedSampler(tdlm, SCHEDULE,
                          noise_fn=reference_noise(tdlm.config.d_model),
                          **ladders)
    jf = [jeng.submit_with_future(JSampleRequest(**r))[1] for r in LADDER_REQS]
    tf = [teng.submit_with_future(SampleRequest(**r))[1] for r in LADDER_REQS]
    jeng.drain(params)
    teng.drain()
    assert _batches(teng) == 2
    for r, j, t in zip(LADDER_REQS, (f.result() for f in jf),
                       (f.result() for f in tf)):
        assert t.x0.shape == (r["batch"], r["seq_len"], 128) == j.x0.shape
        assert (t.padded_batch, t.padded_seq_len, t.padded_nfe) == (
            j.padded_batch, j.padded_seq_len, j.padded_nfe)
        np.testing.assert_allclose(t.x0.numpy(), np.asarray(j.x0), atol=2e-3)
        np.testing.assert_array_equal(
            t.aux[K.ERS_SELECTION_HISTORY].numpy(),
            np.asarray(j.aux[K.ERS_SELECTION_HISTORY]),
        )
        for key in (K.DELTA_EPS_HISTORY, K.DELTA_EPS_HISTORY_PER_SAMPLE):
            assert t.aux[key].shape == j.aux[key].shape
            np.testing.assert_allclose(
                t.aux[key].numpy(), np.asarray(j.aux[key]), rtol=1e-4, atol=5e-5
            )


# ---- inside the port: bitwise padding invariance -----------------------


@pytest.mark.parametrize("nfe,seq,seed", [(8, 3, 0), (11, 8, 17), (16, 5, 901)])
def test_nfe_padding_invariance_bitwise(nfe, seq, seed):
    """A request drained at its exact NFE (a bucket equal to its nfe) and
    the same request padded to a coarser bucket beside a mate of another
    nfe, at one batch bucket, give the same x0, ERS selections and
    per-sample errors, bit for bit."""
    req = SampleRequest(batch=1, seq_len=seq, nfe=nfe, seed=seed)
    ref = _drain_one(_engine(batch_buckets=(2, 4), seq_buckets=(4, 8),
                             nfe_buckets=(nfe, nfe + 40)), req)
    assert ref.padded_nfe == nfe
    mate = SampleRequest(batch=1, seq_len=seq, nfe=nfe + 3, seed=seed + 1)
    got = _drain_one(_engine(batch_buckets=(2, 4), seq_buckets=(4, 8),
                             nfe_buckets=(nfe + 7, nfe + 40)), req, (mate,))
    assert got.padded_nfe == got.info[K.PADDED_NFE] == nfe + 7
    assert torch.equal(got.x0, ref.x0)
    for key in (K.ERS_SELECTION_HISTORY, K.DELTA_EPS_HISTORY_PER_SAMPLE):
        assert torch.equal(got.aux[key], ref.aux[key]), key


@pytest.mark.parametrize("lens,nfe,seed0", [
    ((3, 6, 1), 5, 0), ((8, 4, 2, 7), 6, 40), ((1, 5), 8, 77),
])
def test_seq_padding_invariance_bitwise(lens, nfe, seed0):
    """A request right-padded to its seq bucket inside a fused mixed-length
    batch equals its exact-shape solo run bit for bit under a positionwise
    denoiser: x0, ERS selections and per-sample errors."""
    reqs = [SampleRequest(batch=1 + i % 2, seq_len=n, nfe=nfe, seed=seed0 + i)
            for i, n in enumerate(lens)]
    engine = _engine(seq_buckets=(4, 8))
    tickets = [engine.submit(r) for r in reqs]
    fused = engine.drain()
    for ticket, req in zip(tickets, reqs):
        got = fused[ticket]
        ref = _drain_one(_engine(batch_buckets=None), req)
        assert got.x0.shape == (req.batch, req.seq_len, OracleDenoiser.D_MODEL)
        assert got.padded_seq_len == (4 if req.seq_len <= 4 else 8)
        assert torch.equal(got.x0, ref.x0), req
        for key in (K.ERS_SELECTION_HISTORY, K.DELTA_EPS_HISTORY_PER_SAMPLE):
            assert torch.equal(got.aux[key], ref.aux[key]), (req, key)


def test_smoke_denoiser_bucketed_drain_equals_solo_drains():
    """On the smoke qwen2 denoiser, every request of a drain fused under
    both ladders equals its solo drain through the same engine (atol 1e-6,
    the reference's real-denoiser bar; ERS selections equal)."""
    _, _, tdlm = build_pair("qwen2-1.5b", "naive", "auto", seed=4,
                            head_scale=0.05)
    engine = _engine(tdlm, batch_buckets=(8,), seq_buckets=(4, 8),
                     nfe_buckets=(8,))
    reqs = [SampleRequest(**r) for r in LADDER_REQS]
    tickets = [engine.submit(r) for r in reqs]
    fused = engine.drain()
    assert _batches(engine) == 2
    for ticket, req in zip(tickets, reqs):
        solo = _drain_one(engine, req)
        torch.testing.assert_close(fused[ticket].x0, solo.x0, atol=1e-6, rtol=0)
        assert torch.equal(fused[ticket].aux[K.ERS_SELECTION_HISTORY],
                           solo.aux[K.ERS_SELECTION_HISTORY])


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "llama3.2-1b"])
def test_per_row_times_and_lengths_give_each_row_its_solo_eps(arch):
    """``DiffusionLM.eps`` with per-row times (as a step-masked batch
    passes them, shaped (B, 1, 1)) and per-row lengths gives each row what
    its solo call at its exact length and scalar time gives, and exact
    zeros at pad positions.  Tolerance atol 5e-6 (observed up to 1.3e-6):
    the CPU's BLAS blocks a 24-row and an 8-row product differently, and
    the smoke stream's ~1e3 scale carries that float32 rounding into eps
    (random head scaled to 0.05, as in the solver tests)."""
    _, _, tdlm = build_pair(arch, "naive", "auto", seed=6, head_scale=0.05)
    d = tdlm.config.d_model
    x = torch.from_numpy(
        np.random.default_rng(8).standard_normal((3, 8, d)).astype(np.float32))
    t = torch.tensor([0.9, 0.5, 0.2]).reshape(3, 1, 1)
    lengths = torch.tensor([8, 5, 3], dtype=torch.int32)
    fused = tdlm.eps(x, t, lengths=lengths)
    for r, n in enumerate(lengths.tolist()):
        solo = tdlm.eps(x[r : r + 1, :n], t[r].reshape(()))
        torch.testing.assert_close(fused[r : r + 1, :n], solo, atol=5e-6, rtol=0)
        assert bool((fused[r, n:] == 0).all())


@pytest.mark.parametrize("fn", ["plain", "wrapper"])
def test_era_update_active_freezes_spent_rows(fn):
    """A spent row's x comes back bitwise and its eps_bar zero; live rows
    equal the unmasked step."""
    rng = np.random.default_rng(3)
    rows, n, cap, k = 4, 37, 8, 4
    x = torch.from_numpy(rng.standard_normal((rows, n)).astype(np.float32))
    x[1, 0] = float("nan")  # a frozen row carries even a NaN through
    buf = torch.from_numpy(rng.standard_normal((cap, rows, n)).astype(np.float32))
    tau = torch.tensor([[0, 2, 4, 6]] * rows, dtype=torch.int32)
    lag_w = torch.from_numpy(rng.standard_normal((rows, k)).astype(np.float32))
    cx, ce = torch.full((rows,), 0.9), torch.full((rows,), -0.1)
    active = torch.tensor([1, 0, 1, 0], dtype=torch.int32)
    step = ku.era_update_plain if fn == "plain" else ku.era_update
    args = (x, buf, tau, (6, 5, 4), lag_w, tera.AM4, cx, ce)
    got_x, got_e = step(*args, active=active)
    want_x, want_e = step(*args)
    spent, live = active == 0, active != 0
    assert torch.equal(got_x[spent].view(torch.int32), x[spent].view(torch.int32))
    assert torch.equal(got_e[spent], torch.zeros_like(got_e[spent]))
    assert torch.equal(got_x[live], want_x[live])
    assert torch.equal(got_e[live], want_e[live])


# ---- the serving walls, ported ------------------------------------------


def test_mixed_lengths_and_nfes_fuse_into_one_chunk_per_bucket():
    engine = _engine(seq_buckets=(4, 8), nfe_buckets=(8, 12))
    reqs = [SampleRequest(batch=1, seq_len=n, nfe=f, seed=10 + i)
            for i, (n, f) in enumerate([(1, 5), (3, 7), (4, 8), (2, 6)])]
    tickets = [engine.submit(r) for r in reqs]
    results = engine.drain()
    assert _batches(engine) == 1
    for t in tickets:
        assert (results[t].padded_batch, results[t].padded_seq_len,
                results[t].padded_nfe) == (4, 4, 8)
    more = [SampleRequest(batch=1, seq_len=n, nfe=f, seed=50 + i)
            for i, (n, f) in enumerate([(2, 9), (6, 12), (8, 5), (5, 6)])]
    tickets = [engine.submit(r) for r in more]
    results = engine.drain()
    assert {(results[t].padded_seq_len, results[t].padded_nfe)
            for t in tickets} == {(4, 12), (8, 12), (8, 8)}
    # on the CPU the chunks run eagerly: no bucket graph is captured
    assert engine.compile_cache() == {}
    assert engine.compile_stats() == {"fresh": 0, "memory": 0}


@pytest.mark.parametrize("req,match", [
    (dict(batch=1, seq_len=9, nfe=6), "largest seq bucket"),
    (dict(batch=1, seq_len=4, nfe=13), "largest nfe bucket"),
])
def test_over_ladder_rejected_at_submit(req, match):
    engine = _engine(seq_buckets=(4, 8), nfe_buckets=(8, 12))
    with pytest.raises(ValueError, match=match):
        engine.submit(SampleRequest(**req))
    assert engine.pending == 0
    _engine().submit(SampleRequest(**req))  # no ladder: accepted


def test_padded_buckets_surface_in_results_and_info():
    engine = _engine(seq_buckets=(4, 8), nfe_buckets=(8,))
    res = _drain_one(engine, SampleRequest(batch=1, seq_len=3, nfe=6, seed=1))
    assert (res.padded_batch, res.padded_seq_len, res.padded_nfe) == (2, 4, 8)
    assert (res.info[K.PADDED_SEQ_LEN], res.info[K.PADDED_NFE]) == (4, 8)
    assert res.x0.shape == (1, 3, OracleDenoiser.D_MODEL)
    svc = SamplerService(engine=_engine(batch_buckets=None))
    res = svc.sample(SampleRequest(batch=2, seq_len=6, nfe=6))
    assert (res.info[K.PADDED_BATCH], res.info[K.PADDED_SEQ_LEN],
            res.info[K.PADDED_NFE]) == (2, 6, 6)
    assert svc.solver_config == svc._engine.solver_config


@pytest.mark.parametrize("impl", ["seq-bucketing", "nfe-bucketing"])
def test_shared_ers_falls_back_to_exact_grouping(impl):
    """Shared-delta ERA couples rows: no padding in positions or steps; the
    verdict is counted once, as non-fusable-config."""
    engine = _engine(solver_config=ERAConfig(per_sample=False),
                     seq_buckets=(4, 8), nfe_buckets=(8, 16))
    verdict = (engine.executor.seq_masked if impl == "seq-bucketing"
               else engine.executor.nfe_masked)
    assert verdict("era") is False
    assert verdict("era") is False
    counter = engine.metrics.get("sampler_masked_fallback_total")
    assert counter.value(impl=impl, reason="non-fusable-config") == 1
    assert engine.executor.group_key(
        SampleRequest(batch=2, seq_len=5, nfe=6)) == ("era", 5, 6)


def test_unmaskable_denoiser_falls_back_to_exact_shape():
    dlm = OracleDenoiser()
    dlm.supports_length_masking = False
    engine = _engine(dlm, seq_buckets=(4, 8))
    assert engine.executor.seq_masked("era") is False
    counter = engine.metrics.get("sampler_masked_fallback_total")
    assert counter.value(impl="seq-bucketing", reason="denoiser-unmaskable") == 1
    res = _drain_one(engine, SampleRequest(batch=1, seq_len=3, nfe=6))
    assert res.padded_seq_len == 3


def test_nfe_padding_rows_counter_counts_wasted_step_rows():
    engine = _engine(nfe_buckets=(8,))
    engine.submit(SampleRequest(batch=1, seq_len=4, nfe=5, seed=1))
    engine.submit(SampleRequest(batch=2, seq_len=4, nfe=8, seed=2))
    engine.drain()
    counter = engine.metrics.get("sampler_nfe_padding_rows_total")
    assert counter.value(solver="era") == 1
    engine.submit(SampleRequest(batch=2, seq_len=4, nfe=8, seed=3))
    engine.drain()
    assert counter.value(solver="era") == 1


def test_aux_scoped_to_request_seq_len_and_nfe():
    engine = _engine(solver_config=ERAConfig(per_sample=True,
                                             return_trajectory=True),
                     batch_buckets=(4,), seq_buckets=(4, 8), nfe_buckets=(8,))
    ta = engine.submit(SampleRequest(batch=1, seq_len=3, nfe=5, seed=0))
    tb = engine.submit(SampleRequest(batch=2, seq_len=7, nfe=8, seed=1))
    results = engine.drain()
    d = OracleDenoiser.D_MODEL
    assert results[ta].aux[K.TRAJECTORY].shape == (6, 1, 3, d)
    assert results[tb].aux[K.TRAJECTORY].shape == (9, 2, 7, d)
    assert results[ta].aux[K.ERS_SELECTION_HISTORY].shape == (5, 1, 4)
    assert results[ta].aux[K.DELTA_EPS_HISTORY_PER_SAMPLE].shape == (5, 1)
    assert results[ta].aux[K.DELTA_EPS_HISTORY].shape == (5,)
    assert results[tb].aux[K.ERS_SELECTION_HISTORY].shape == (8, 2, 4)
    assert torch.equal(results[ta].aux[K.TRAJECTORY][-1], results[ta].x0)


def test_cpu_warmup_validates_the_grid_and_captures_nothing():
    engine = _engine(batch_buckets=(2, 8), seq_buckets=(4, 8),
                     nfe_buckets=(8, 12))
    seen = []
    report = engine.warmup(nfes=(5, 9), progress=lambda d, t: seen.append((d, t)))
    assert report["programs"] == 8  # 2 batches x 2 seqs x 2 nfe buckets
    assert {(g["batch"], g["seq_len"], g["nfe"]) for g in report["grid"]} == {
        (b, s, n) for b in (2, 8) for s in (4, 8) for n in (8, 12)}
    assert (report["fresh"], report["memory"]) == (0, 0)
    assert seen[-1] == (8, 8)
    assert engine.warmup_status()["state"] == "done"
    assert engine.compile_cache() == {}
    with pytest.raises(ValueError, match="nfe >= k"):
        _engine(seq_buckets=(4,)).warmup(nfes=(3,))
    with pytest.raises(ValueError, match="seq_lens"):
        _engine().warmup()


class _HostTensors(TorchDispatchMode):
    """Records every op that makes a tensor from host data (``lift_fresh``:
    ``torch.tensor``, an item assignment of a Python number); on the card
    each would be a host-to-device copy, which a CUDA graph cannot
    capture."""

    def __init__(self):
        super().__init__()
        self.lifted = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.lift_fresh.default:
            self.lifted += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("masked,stepped", [(False, False), (True, True)],
                         ids=["exact", "seq+nfe buckets"])
def test_bucket_program_makes_no_tensor_from_host_data(masked, stepped):
    """The program a bucket graph captures (the smoke qwen2 denoiser and
    the ERA loop on the bucket's grid) builds no tensor from host data."""
    _, _, tdlm = build_pair("qwen2-1.5b", "naive", "auto", seed=5,
                            head_scale=0.05)
    engine = _engine(tdlm, batch_buckets=(4,), seq_buckets=(8,),
                     nfe_buckets=(8,) if stepped else None)
    ex = engine.executor
    reqs = [(0, SampleRequest(batch=1, seq_len=5, nfe=6), 0.0),
            (1, SampleRequest(batch=2, seq_len=8, nfe=8), 0.0)]
    cfg = dataclasses.replace(ex.config_for("era"), nfe=8)
    x_init = torch.randn(4, 8, tdlm.config.d_model)
    lengths = torch.tensor([5, 8, 8, 8], dtype=torch.int32) if masked else None
    steps = ex._step_mask("era", cfg, reqs, 1) if stepped else None
    key = ("era", cfg, 4, 8, masked, stepped)
    ex._run_program(key, x_init, lengths, steps)  # the grid reaches the device
    rec = _HostTensors()
    with rec:
        out = ex._run_program(key, x_init, lengths, steps)
    assert out.x0.shape == x_init.shape
    assert rec.lifted == 0
