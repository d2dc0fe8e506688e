"""The port's ERA solver (repro_torch.core.era) against the JAX reference.

The reference runs with ``use_fused_update=False`` (its fused path needs a
JAX API the installed JAX no longer has); the port's step always goes
through its fused ``era_update`` wrapper, whose plain version runs here.

Tolerances: on the analytic Gaussian oracle everything is float32
elementwise math, so ``x0`` agrees to atol 1e-5.  The ERS error norm is the
norm of a difference of two nearly equal unit-scale noises (observed minus
Lagrange-predicted, the weights of which extrapolate), so float32 rounding
of ~1e-6 an element sets an absolute floor: rtol 1e-4, atol 5e-5.  On the smoke denoiser the
network itself differs by up to ~5e-4 (see test_torch_models), which the
solver carries into ``x0``: atol 2e-3.  An untrained network with a unit-
scale random head is a chaotic ODE right-hand side that amplifies any
rounding difference, so the denoiser cases scale the random ``eps_head``
to 0.05 (the backbone still reaches the output).  ERS selections are integers and
must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import AnalyticGaussian
from repro.core import era as jera
from repro_torch.core import era as tera
from repro_torch.core import schedules as tsched
from repro_torch.core.solver_base import ddim_step
from test_torch_models import build_pair


class TorchAnalyticGaussian:
    """The reference's analytic oracle on the port's schedule:
    x0 ~ N(mu, s^2 I) => eps*(x, t) = (x - alpha mu) sigma / (alpha^2 s^2 +
    sigma^2)."""

    def __init__(self, mu=1.5, s=0.5):
        self.mu, self.s = mu, s
        self.schedule = tsched.linear_schedule()

    def eps(self, x, t):
        a = self.schedule.alpha(t)
        sg = self.schedule.sigma(t)
        return (x - a * self.mu) * sg / (a * a * self.s**2 + sg * sg)


@pytest.fixture(scope="module")
def oracles():
    return AnalyticGaussian(), TorchAnalyticGaussian()


def run_both(j_eps, t_eps, x, jsched, tsch, lengths=None, **cfg):
    jcfg = jera.ERAConfig(use_fused_update=False, **cfg)
    tcfg = tera.ERAConfig(**cfg)
    jx = jnp.asarray(x)
    jl = None if lengths is None else jnp.asarray(lengths)
    want = jera.sample_scan(
        j_eps, jx, *jera.alloc_buffers(jx, jcfg), jsched, jcfg, lengths=jl
    )
    tx = torch.from_numpy(x)
    tl = None if lengths is None else torch.from_numpy(lengths)
    got = tera.sample_scan(
        t_eps, tx, *tera.alloc_buffers(tx, tcfg), tsch, tcfg, lengths=tl
    )
    return want, got


def assert_runs_agree(want, got, x0_tol, per_sample):
    np.testing.assert_allclose(got.x0.numpy(), np.asarray(want.x0), atol=x0_tol)
    np.testing.assert_allclose(
        got.aux["delta_eps_history"].numpy(),
        np.asarray(want.aux["delta_eps_history"]), rtol=1e-4, atol=5e-5,
    )
    if per_sample:
        np.testing.assert_allclose(
            got.aux["delta_eps_history_per_sample"].numpy(),
            np.asarray(want.aux["delta_eps_history_per_sample"]),
            rtol=1e-4, atol=5e-5,
        )
        np.testing.assert_array_equal(
            got.aux["ers_selection_history"].numpy(),
            np.asarray(want.aux["ers_selection_history"]),
        )


ORACLE_CASES = {
    "per-sample nfe10 k4": dict(nfe=10, k=4, per_sample=True),
    "shared nfe10 k4": dict(nfe=10, k=4, per_sample=False),
    "per-sample nfe7 k3": dict(nfe=7, k=3, per_sample=True),
    "shared mean-norm nfe8 k2": dict(nfe=8, k=2, error_norm="mean"),
    "per-sample logsnr": dict(nfe=12, k=4, per_sample=True, scheme="logsnr"),
    "shared quadratic": dict(nfe=9, k=3, scheme="quadratic"),
    "per-sample fixed selection": dict(nfe=8, k=4, per_sample=True,
                                       selection="fixed"),
}


@pytest.mark.parametrize("case", sorted(ORACLE_CASES))
@pytest.mark.parametrize("masked", [False, True], ids=["full", "lengths"])
def test_sample_scan_matches_reference_on_oracle(oracles, case, masked):
    ja, ta = oracles
    x = np.random.default_rng(5).standard_normal((3, 6, 4)).astype(np.float32)
    lengths = np.asarray([6, 4, 1], np.int32) if masked else None
    cfg = ORACLE_CASES[case]
    want, got = run_both(ja.eps, ta.eps, x, ja.schedule, ta.schedule,
                         lengths=lengths, **cfg)
    assert got.nfe == cfg["nfe"]
    assert_runs_agree(want, got, 1e-5, cfg.get("per_sample", False))


@pytest.mark.parametrize("per_sample", [True, False], ids=["per-sample", "shared"])
@pytest.mark.parametrize("masked", [False, True], ids=["full", "lengths"])
def test_sample_scan_matches_reference_on_denoiser(masked, per_sample):
    jdlm, params, tdlm = build_pair("qwen2-1.5b", "naive", "auto", seed=1,
                                    head_scale=0.05)
    d = tdlm.config.d_model
    x = np.random.default_rng(9).standard_normal((2, 8, d)).astype(np.float32)
    lengths = np.asarray([8, 5], np.int32) if masked else None
    jl = None if lengths is None else jnp.asarray(lengths)
    tl = None if lengths is None else torch.from_numpy(lengths)
    want, got = run_both(
        jdlm.eps_fn(params, lengths=jl), tdlm.eps_fn(lengths=tl), x,
        AnalyticGaussian().schedule, tsched.linear_schedule(),
        lengths=lengths, nfe=6, k=3, per_sample=per_sample,
    )
    assert_runs_agree(want, got, 2e-3, per_sample)


def test_batch_of_n_equals_n_solo_runs(oracles):
    """Per-sample ERS decouples rows: each row of a batched run equals its
    solo run, on the oracle (bit for bit) and on the smoke denoiser."""
    _, ta = oracles
    _, _, tdlm = build_pair("llama3.2-1b", "naive", "auto", seed=2,
                            head_scale=0.05)
    cfg = tera.ERAConfig(nfe=8, k=3, per_sample=True)
    rng = np.random.default_rng(11)
    for eps, d, tol in ((ta.eps, 4, 0.0), (tdlm.eps_fn(), tdlm.config.d_model, 1e-5)):
        x = torch.from_numpy(rng.standard_normal((3, 5, d)).astype(np.float32))
        batched = tera.sample(eps, x, ta.schedule, cfg, device="cpu")
        for i in range(3):
            solo = tera.sample(eps, x[i : i + 1], ta.schedule, cfg, device="cpu")
            torch.testing.assert_close(batched.x0[i : i + 1], solo.x0,
                                       atol=tol, rtol=0)
            assert torch.equal(
                batched.aux["ers_selection_history"][:, i : i + 1],
                solo.aux["ers_selection_history"],
            )


def test_era_combine_matches_reference():
    rng = np.random.default_rng(4)
    eps_sel = rng.standard_normal((4, 3, 5)).astype(np.float32)
    e_hist = rng.standard_normal((3, 3, 5)).astype(np.float32)
    t_sel = np.asarray([0.9, 0.6, 0.45, 0.4], np.float32)
    want = jera.era_combine(jnp.asarray(eps_sel), jnp.asarray(t_sel),
                            jnp.asarray(e_hist), jnp.float32(0.3))
    got = tera.era_combine(torch.from_numpy(eps_sel), torch.from_numpy(t_sel),
                           torch.from_numpy(e_hist), torch.tensor(0.3))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_fused_step_equals_combine_then_ddim(oracles):
    """The fused step the solver runs equals era_combine + ddim_step."""
    _, ta = oracles
    from repro_torch.core.lagrange import lagrange_weights
    from repro_torch.kernels.era_update import era_update

    rng = np.random.default_rng(6)
    buf = torch.from_numpy(rng.standard_normal((8, 2, 10)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((2, 10)).astype(np.float32))
    ts = tsched.timesteps(ta.schedule, 7)
    tau = torch.tensor([[0, 2, 4, 5], [1, 3, 4, 5]], dtype=torch.int32)
    t_cur, t_next = ts[5], ts[6]
    lag_w = lagrange_weights(ts[tau.long()], t_next)
    cx, ce = ta.schedule.ddim_coeffs(t_cur, t_next)
    x_next, eps_bar = era_update(x, buf, tau, (5, 4, 3), lag_w, tera.AM4, cx, ce)
    for r in range(2):
        eb, corr = tera.era_combine(buf[tau[r].long(), r], ts[tau[r].long()],
                                    buf[[5, 4, 3], r], t_next)
        torch.testing.assert_close(eps_bar[r], eb, atol=1e-6, rtol=0)
        torch.testing.assert_close(
            x_next[r], ddim_step(ta.schedule, x[r], corr, t_cur, t_next),
            atol=1e-6, rtol=0,
        )


def test_trajectory_and_validation(oracles):
    _, ta = oracles
    x = torch.randn(2, 3, 4)
    out = tera.sample(ta.eps, x, ta.schedule,
                      tera.ERAConfig(nfe=5, k=3, return_trajectory=True),
                      device="cpu")
    assert out.aux["trajectory"].shape == (6, 2, 3, 4)
    assert torch.equal(out.aux["trajectory"][-1], out.x0)
    with pytest.raises(ValueError, match="nfe >= k"):
        tera.sample(ta.eps, x, ta.schedule, tera.ERAConfig(nfe=3, k=4),
                    device="cpu")
    with pytest.raises(ValueError, match="lengths"):
        xf = torch.randn(2, 4)
        tera.sample_scan(ta.eps, xf, *tera.alloc_buffers(xf, tera.ERAConfig()),
                         ta.schedule, tera.ERAConfig(),
                         lengths=torch.tensor([1, 2]))


def test_reference_jax_is_cpu():
    assert jax.default_backend() == "cpu"
