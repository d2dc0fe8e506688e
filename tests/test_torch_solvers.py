"""The port's baseline solver programs against the JAX reference, and their
serving walls inside the port.

Every program (DDIM, AB4 and PECE Adams, DPM-Solver 2 / fast / ++2M,
adaptive DPM) runs on the same seeded inputs in both packages, unmasked
and, for the five programs that support steps, under a step mask whose
rows take different step counts.  Tolerances on ``x0``:

* the analytic Gaussian oracle: atol 1e-5 for DDIM and the Adams family
  (float32 elementwise math; worst measured 2.2e-6), 1e-4 for the DPM
  family, whose ``expm1`` / ``lam`` / ``inv_lam`` round differently in the
  two frameworks and whose exponential coefficients amplify it (worst
  measured 1.3e-5, DPM-Solver-fast at nfe=7; the cosine schedule from
  t_begin 0.95, 2.3e-5).  The cosine schedule is tested from t_begin 0.95:
  at t = 1 its alpha is clipped to ~1e-6 and the first step divides by
  it, so a last-place difference in the oracle there grows to ~2e-2
  between the packages (measured on DDIM, nfe=10);
* the smoke qwen2 and llama denoisers (``eps_head`` scaled to 0.05, as in
  ``test_torch_era``): atol 2e-3; the network itself differs by up to
  ~5e-4 an evaluation (worst measured on ``x0``: 3.1e-4, DPM-Solver-2
  on llama).

``dpm_adaptive``'s accept/reject decisions are thresholds, so its
``realized_nfe`` must be equal per row; the cases include budgets large
enough that rows converge early, at different counts.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import AnalyticGaussian
from repro.core import ERAConfig as JERAConfig
from repro.core import cosine_schedule as jcosine
from repro.core import default_config as jdefault_config
from repro.core import get_program as jget_program
from repro.core import get_solver as jget_solver
from repro.core import linear_schedule as jlinear
from repro.core import dpm_solver as jdpm
from repro.core import solver_names as jsolver_names
from repro.core.program import StepMask as JStepMask
from repro.core.schedules import timesteps as jtimesteps
from repro_torch.core import (
    AdaptiveDPMConfig,
    ERAConfig,
    cosine_schedule,
    default_config,
    get_program,
    get_solver,
    linear_schedule,
    solver_names,
)
from repro_torch.core import adams, ddim, dpm_adaptive, dpm_solver
from repro_torch.core.program import StepMask
from repro_torch.serving import BatchedSampler, SampleRequest, result_keys as K
from test_torch_bucketing import OracleDenoiser, _HostTensors
from test_torch_era import TorchAnalyticGaussian
from test_torch_models import build_pair
from test_torch_serving import reference_noise

BASELINES = ["ddim", "explicit_adams", "implicit_adams_pece", "dpm_solver_2",
             "dpm_solver_fast", "dpm_solver_pp2m", "dpm_adaptive"]
STEPPED = ["ddim", "explicit_adams", "implicit_adams_pece", "dpm_solver_pp2m",
           "dpm_adaptive"]
DPM = [s for s in BASELINES if s.startswith("dpm")]
DENOISER_TOL = 2e-3


def oracle_tol(name: str) -> float:
    return 1e-4 if name in DPM else 1e-5


def reported_nfe(name: str, nfe: int) -> int:
    """The evaluations the port reports: the budget, but PECE's 2 per step
    and the adaptive loop's 2 per iteration (every row evaluates)."""
    if name in ("implicit_adams_pece", "dpm_adaptive"):
        return 2 * max(nfe // 2, 1)
    return nfe


@pytest.fixture(scope="module")
def oracles():
    return AnalyticGaussian(), TorchAnalyticGaussian()


@pytest.fixture(scope="module")
def denoisers():
    return {arch: build_pair(arch, "naive", "auto", seed=1, head_scale=0.05)
            for arch in ("qwen2-1.5b", "llama3.2-1b")}


def _x(shape, seed=5):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def run_both(name, j_eps, t_eps, x, jsched, tsched, lengths=None,
             nfes=None, **cfg):
    """One run of program ``name`` in each package on the same ``x``.
    With ``nfes`` (one budget a row) the batch runs the largest budget
    under a step mask built from each package's own ``step_times``."""
    jp, tp = jget_program(name), get_program(name)
    jcfg, tcfg = jdefault_config(name, **cfg), default_config(name, **cfg)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jsteps = tsteps = None
    if nfes is not None:
        cap = tp.steps_for_nfe(tcfg.nfe, tcfg)
        acts, jrows, trows = [], [], []
        for n in nfes:
            k = tp.steps_for_nfe(n, tcfg)
            assert k == jp.steps_for_nfe(n, jcfg)
            jts = np.asarray(jp.step_times(jsched, n, jcfg))
            tts = tp.step_times(tsched, n, tcfg).numpy()
            acts.append(k)
            jrows.append(np.concatenate([jts, np.repeat(jts[-1:], cap - k)]))
            trows.append(np.concatenate([tts, np.repeat(tts[-1:], cap - k)]))
        jsteps = JStepMask(jnp.asarray(acts, jnp.int32),
                           jnp.asarray(np.stack(jrows)))
        tsteps = StepMask(torch.tensor(acts, dtype=torch.int32),
                          torch.from_numpy(np.stack(trows)))
    jl = None if lengths is None else jnp.asarray(lengths)
    tl = None if lengths is None else torch.from_numpy(lengths)
    want = jp.sample_scan(j_eps, jx, jp.alloc_buffers(jx, jcfg), jsched, jcfg,
                          lengths=jl, steps=jsteps)
    got = tp.sample_scan(t_eps, tx, tp.alloc_buffers(tx, tcfg), tsched, tcfg,
                         lengths=tl, steps=tsteps)
    return want, got


def assert_agree(name, want, got, tol):
    np.testing.assert_allclose(got.x0.numpy(), np.asarray(want.x0), atol=tol,
                               err_msg=name)
    assert sorted(got.aux) == sorted(want.aux), name
    if name == "dpm_adaptive":
        np.testing.assert_array_equal(got.aux["realized_nfe"].numpy(),
                                      np.asarray(want.aux["realized_nfe"]))


def test_registry_matches_reference():
    assert solver_names() == jsolver_names()
    for name in solver_names():
        assert type(default_config(name)).__name__ == type(
            jdefault_config(name)).__name__
        jp, tp = jget_program(name), get_program(name)
        for hook in ("supports_steps", "supports_lengths", "fusable"):
            assert getattr(tp, hook)(tp.engine_config()) == getattr(jp, hook)(
                jp.engine_config()), (name, hook)
        assert dict(tp.aux_row_axes) == dict(jp.aux_row_axes), name
    with pytest.raises(ValueError, match="unknown solver"):
        get_program("nope")


def reference_grid(name, sched, nfe, jcfg):
    """The reference's step count and grid for budget ``nfe``.  Its
    singlestep DPM-Solver builds a lambda-uniform grid of ``len(plan)``
    intervals inside its loop; the port's program returns that grid from
    ``step_times`` (the executor hands it to the loop on the device)."""
    jp = jget_program(name)
    if isinstance(jp, jdpm.DPMSolverProgram):
        k = len(jdpm._order_plan(nfe, get_program(name).order))
        return k, jtimesteps(sched, k, "logsnr")
    return jp.steps_for_nfe(nfe, jcfg), jp.step_times(sched, nfe, jcfg)


@pytest.mark.parametrize("name", BASELINES)
def test_step_times_match_reference(name):
    """The grids the executor hands each program, and their step counts:
    the reference's floats to 2e-7, two float32 ulps at t = 1
    (``linspace`` and the lambda maps round in the last place)."""
    tp = get_program(name)
    jcfg, tcfg = jdefault_config(name), default_config(name)
    for jsched, tsched in ((jlinear(), linear_schedule()),
                           (jcosine(), cosine_schedule())):
        for nfe in (2, 5, 6, 10, 13):
            k, want = reference_grid(name, jsched, nfe, jcfg)
            assert tp.steps_for_nfe(nfe, tcfg) == k, (name, nfe)
            got = tp.step_times(tsched, nfe, tcfg).numpy()
            assert got.shape == (k + 1,) == want.shape
            np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=2e-7)


@pytest.mark.parametrize("nfe", [2, 7, 10])
@pytest.mark.parametrize("name", BASELINES)
def test_oracle_matches_reference(oracles, name, nfe):
    ja, ta = oracles
    want, got = run_both(name, ja.eps, ta.eps, _x((3, 6, 4)), ja.schedule,
                         ta.schedule, nfe=nfe)
    assert_agree(name, want, got, oracle_tol(name))
    assert got.nfe == reported_nfe(name, nfe)


@pytest.mark.parametrize("name", STEPPED)
def test_oracle_step_masked_matches_reference(oracles, name):
    """Rows of budget 10, 7 and 4 in one bucket of 10."""
    ja, ta = oracles
    want, got = run_both(name, ja.eps, ta.eps, _x((3, 6, 4)), ja.schedule,
                         ta.schedule, nfe=10, nfes=(10, 7, 4))
    assert_agree(name, want, got, oracle_tol(name))


@pytest.mark.parametrize("name", DPM + ["ddim"])
def test_cosine_schedule_matches_reference(name):
    """The cosine schedule, whose ``inv_lam`` bisects, from t_begin 0.95."""
    js = dataclasses.replace(jcosine(), t_begin=0.95)
    ts = dataclasses.replace(cosine_schedule(), t_begin=0.95)
    ja = AnalyticGaussian(schedule=js)
    ta = TorchAnalyticGaussian()
    ta.schedule = ts
    want, got = run_both(name, ja.eps, ta.eps, _x((3, 6, 4)), js, ts, nfe=10)
    assert_agree(name, want, got, oracle_tol(name))


ADAPTIVE_CASES = {
    "budget 40": dict(nfe=40),
    "loose tolerances": dict(nfe=60, rtol=0.2, atol=0.05),
    "large first step": dict(nfe=30, h_init=1.0),
    "full PID": dict(nfe=40, pcoeff=0.3, icoeff=0.8, dcoeff=0.1),
}


@pytest.mark.parametrize("masked", [False, True], ids=["full", "lengths"])
@pytest.mark.parametrize("case", sorted(ADAPTIVE_CASES))
def test_adaptive_realized_nfe_matches_reference(oracles, case, masked):
    """Rows of different scales converge after different iteration counts
    (e.g. realized NFE 20, 30, 12, 26, 28, 10 at budget 40); each row's
    count must be the reference's, also with its error RMS masked to its
    valid positions."""
    ja, ta = oracles
    x = _x((6, 6, 4)) * np.float32([1, 2, 0.5, 1, 3, 0.2])[:, None, None]
    lengths = np.asarray([6, 3, 6, 1, 5, 6], np.int32) if masked else None
    want, got = run_both("dpm_adaptive", ja.eps, ta.eps, x, ja.schedule,
                         ta.schedule, lengths=lengths, **ADAPTIVE_CASES[case])
    assert_agree("dpm_adaptive", want, got, 1e-4)
    spent = got.aux["realized_nfe"]
    assert spent.dtype == torch.int32 and len(set(spent.tolist())) > 1


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "llama3.2-1b"])
@pytest.mark.parametrize(
    "name,stepped",
    [(n, False) for n in BASELINES] + [(n, True) for n in STEPPED],
    ids=[n for n in BASELINES] + [f"{n}-step-masked" for n in STEPPED],
)
def test_denoiser_matches_reference(denoisers, name, arch, stepped):
    jdlm, params, tdlm = denoisers[arch]
    x = _x((2, 8, tdlm.config.d_model), seed=9)
    want, got = run_both(
        name, jdlm.eps_fn(params), tdlm.eps_fn(), x, jlinear(),
        linear_schedule(), nfe=6, nfes=(6, 4) if stepped else None,
    )
    assert_agree(name, want, got, DENOISER_TOL)


@pytest.mark.parametrize("name,entry", [
    ("ddim", ddim.sample),
    ("explicit_adams", adams.explicit_adams_sample),
    ("implicit_adams_pece", adams.implicit_adams_pece_sample),
    ("dpm_solver_pp2m", dpm_solver.sample_pp2m),
    ("dpm_adaptive", dpm_adaptive.sample),
    ("dpm_solver_fast", lambda *a, device: dpm_solver.sample(*a)),
])
def test_module_entries_equal_the_registry(oracles, name, entry):
    """The modules' functional entries (the reference's public names) run
    the registered program."""
    _, ta = oracles
    x = torch.from_numpy(_x((2, 4, 4)))
    cfg = default_config(name, nfe=6)
    got = entry(ta.eps, x, ta.schedule, cfg, device="cpu")
    want = get_solver(name)(ta.eps, x, ta.schedule, cfg, device="cpu")
    assert torch.equal(got.x0, want.x0) and got.nfe == want.nfe


@pytest.mark.parametrize("nfe", [2, 3, 4, 7, 8, 10])
def test_pece_reports_the_evaluations_it_makes(oracles, nfe):
    """The port's PECE ``nfe`` equals a count of the evaluations.  The
    reference reports one less (``2 * n_steps - 1``); ROADMAP queue 3
    records that quirk, which the port does not mirror."""
    ja, ta = oracles
    calls = []

    def counted(x, t):
        calls.append(1)
        return ta.eps(x, t)

    x = torch.from_numpy(_x((2, 4, 4)))
    out = get_program("implicit_adams_pece").sample(
        counted, x, ta.schedule, default_config("implicit_adams_pece", nfe=nfe),
        device="cpu")
    assert out.nfe == len(calls) == 2 * (nfe // 2)
    ref = jget_solver("implicit_adams_pece")(
        ja.eps, jnp.asarray(x.numpy()), ja.schedule,
        jdefault_config("implicit_adams_pece", nfe=nfe))
    assert int(ref.nfe) == len(calls) - 1


# ---------------------------------------------------------------------------
# serving: capture rules, bucket walls, routing
# ---------------------------------------------------------------------------


def _engine(dlm=None, **kw):
    kw.setdefault("batch_buckets", (2, 4, 8))
    return BatchedSampler(dlm or OracleDenoiser(), linear_schedule(), **kw)


@pytest.mark.parametrize("bucketed", [False, True],
                         ids=["exact", "seq+nfe buckets"])
@pytest.mark.parametrize("name", BASELINES)
def test_bucket_program_makes_no_tensor_from_host_data(denoisers, name,
                                                       bucketed):
    """The loop a bucket graph captures (the smoke qwen2 denoiser and the
    program on its bucket's grid, or its rows' grids) makes no tensor from
    host data: on the card each would be a copy a capture refuses."""
    tdlm = denoisers["qwen2-1.5b"][2]
    engine = _engine(tdlm, batch_buckets=(4,), seq_buckets=(8,),
                     nfe_buckets=(8,) if bucketed else None)
    ex = engine.executor
    masked = bucketed and ex.seq_masked(name)
    stepped = ex.nfe_masked(name)
    assert stepped == (bucketed and name in STEPPED)
    cfg = dataclasses.replace(ex.config_for(name), nfe=8)
    reqs = [(0, SampleRequest(batch=1, seq_len=5, nfe=6, solver=name), 0.0),
            (1, SampleRequest(batch=2, seq_len=8, nfe=8, solver=name), 0.0)]
    x_init = torch.randn(4, 8, tdlm.config.d_model)
    lengths = torch.tensor([5, 8, 8, 8], dtype=torch.int32) if masked else None
    steps = ex._step_mask(name, cfg, reqs, 1) if stepped else None
    key = (name, cfg, 4, 8, masked, stepped)
    ex._run_program(key, x_init, lengths, steps)  # the grid reaches the device
    rec = _HostTensors()
    with rec:
        out = ex._run_program(key, x_init, lengths, steps)
    assert out.x0.shape == x_init.shape
    assert rec.lifted == 0


@pytest.mark.parametrize("name", STEPPED)
def test_mixed_nfe_batch_rows_equal_their_solo_drains(name):
    """Requests of budget 10, 8 and 6 fuse into one 8-row batch of NFE
    bucket 10, and each is bitwise its solo drain through the same bucket
    (the contract ``chip_smoke.py`` holds on the card); ``dpm_adaptive``'s
    ``realized_nfe`` is scoped to each request's rows."""
    engine = _engine(batch_buckets=(8,), seq_buckets=(8,), nfe_buckets=(10,))
    reqs = [SampleRequest(batch=1, seq_len=8, nfe=10, solver=name, seed=1),
            SampleRequest(batch=3, seq_len=6, nfe=8, solver=name, seed=2),
            SampleRequest(batch=4, seq_len=8, nfe=6, solver=name, seed=3)]
    futs = [engine.submit_with_future(r)[1] for r in reqs]
    engine.drain()
    fused = [f.result() for f in futs]
    assert engine.metrics.get("sampler_batches_total").value() == 1
    for req, res in zip(reqs, fused):
        assert (res.padded_batch, res.padded_nfe) == (8, 10)
        _, fut = engine.submit_with_future(req)
        engine.drain()
        solo = fut.result()
        assert torch.equal(res.x0, solo.x0), req
        if name == "dpm_adaptive":
            spent = res.aux["realized_nfe"]
            assert spent.shape == (req.batch,)
            assert torch.equal(spent, solo.aux["realized_nfe"])
            assert int(spent.max()) <= req.nfe


def test_mixed_solver_requests_in_one_drain_route_correctly(oracles):
    """Requests naming different solvers in one drain come back from their
    own solvers (each held to the reference's solo run on the same noise),
    and the solvers' results genuinely differ."""
    ja, _ = oracles
    d = OracleDenoiser.D_MODEL
    engine = _engine(noise_fn=reference_noise(d))
    reqs = {name: SampleRequest(batch=2, seq_len=6, nfe=8, solver=name,
                                seed=i)
            for i, name in enumerate(solver_names())}
    tickets = {name: engine.submit(r) for name, r in reqs.items()}
    results = engine.drain()
    for name, req in reqs.items():
        cfg = jdefault_config(name, nfe=8)
        if name == "era":
            cfg = JERAConfig(nfe=8, per_sample=True, use_fused_update=False)
        x = reference_noise(d)(req)
        want = jget_solver(name)(ja.eps, jnp.asarray(x), ja.schedule, cfg)
        np.testing.assert_allclose(results[tickets[name]].x0.numpy(),
                                   np.asarray(want.x0), atol=oracle_tol(name),
                                   err_msg=f"{name} did not route to {name}")
    a, b = (results[tickets[n]].x0 for n in ("ddim", "dpm_solver_pp2m"))
    assert float((a - b).abs().max()) > 1e-4


def test_mixed_solver_requests_never_share_a_fused_chunk(monkeypatch):
    engine = _engine()
    chunks = []
    orig = engine.executor.run_chunk

    def recording(seq_len, nfe, chunk, results, pad=True):
        chunks.append({req.solver or "era" for _, req, _ in chunk})
        return orig(seq_len, nfe, chunk, results, pad=pad)

    monkeypatch.setattr(engine.executor, "run_chunk", recording)
    for seed, solver in enumerate([None, "ddim", None, "dpm_adaptive", "era",
                                   "ddim", "dpm_solver_fast"]):
        engine.submit(SampleRequest(batch=1, seq_len=6, nfe=8, solver=solver,
                                    seed=seed))
    engine.drain()
    assert sorted(sorted(c) for c in chunks) == [
        ["ddim"], ["dpm_adaptive"], ["dpm_solver_fast"], ["era"]]


def test_unknown_solver_rejected_at_submit():
    engine = _engine()
    with pytest.raises(ValueError, match="unknown solver"):
        engine.submit(SampleRequest(batch=1, seq_len=6, nfe=8, solver="nope"))
    assert engine.pending == 0


@pytest.mark.parametrize("name,nfe,match", [
    ("implicit_adams_pece", 1, "2 NFE per PECE step"),
    ("dpm_solver_pp2m", 1, "order-1 warmup"),
    ("dpm_adaptive", 1, "2 NFE per accept/reject"),
    ("ddim", 0, "nfe must be >= 1"),
])
def test_validate_floors(name, nfe, match):
    """Each program's budget floor rejects at submit; the smallest legal
    budget serves."""
    engine = _engine()
    with pytest.raises(ValueError, match=match):
        engine.submit(SampleRequest(batch=1, seq_len=6, nfe=nfe, solver=name))
    assert engine.pending == 0
    t = engine.submit(SampleRequest(batch=1, seq_len=6, nfe=nfe + 1,
                                    solver=name))
    res = engine.drain()[t]
    assert res.x0.shape == (1, 6, OracleDenoiser.D_MODEL)


@pytest.mark.parametrize("cfg,match", [
    (dict(rtol=0.0), "must be positive"),
    (dict(rtol=1e-6, atol=1e-6), "serveable floor"),
    (dict(accept_safety=2.6), "limiter ceiling"),
])
def test_adaptive_validate_rejects_unserveable_configs(cfg, match):
    engine = _engine(solver="dpm_adaptive",
                     solver_config=AdaptiveDPMConfig(**cfg))
    with pytest.raises(ValueError, match=match):
        engine.submit(SampleRequest(batch=1, seq_len=6, nfe=8))


def test_shared_delta_era_is_not_fusable_but_baselines_pad():
    engine = _engine(solver_config=ERAConfig(per_sample=False),
                     batch_buckets=(8,))
    t1 = engine.submit(SampleRequest(batch=2, seq_len=6, nfe=10, seed=1))
    t2 = engine.submit(SampleRequest(batch=1, seq_len=6, nfe=10,
                                     solver="ddim", seed=2))
    results = engine.drain()
    assert results[t1].padded_batch == 2
    assert results[t2].padded_batch == 8


def test_trajectory_aux_scoped_to_request():
    """A baseline's step-stacked ``trajectory`` is cut to each request's
    rows, valid positions and own step count."""
    engine = _engine(
        solver="ddim", solver_config=default_config("ddim",
                                                    return_trajectory=True),
        batch_buckets=(4,), seq_buckets=(8,), nfe_buckets=(8,))
    ta = engine.submit(SampleRequest(batch=1, seq_len=3, nfe=5, seed=0))
    tb = engine.submit(SampleRequest(batch=2, seq_len=7, nfe=8, seed=1))
    results = engine.drain()
    d = OracleDenoiser.D_MODEL
    assert results[ta].aux[K.TRAJECTORY].shape == (6, 1, 3, d)
    assert results[tb].aux[K.TRAJECTORY].shape == (9, 2, 7, d)
    assert torch.equal(results[ta].aux[K.TRAJECTORY][-1], results[ta].x0)
