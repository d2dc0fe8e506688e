"""End-to-end behaviour of the port (port of ``tests/test_system.py``): a
denoiser trained with the reference, sampled with every solver of the
port, and the paper's orderings checked on the port alone.

The reference trains the smoke llama3.2-1b for 80 steps in-process (its
own fixture's recipe, about 8 s on the CPU); the weights move to the port
with ``params_from_jax``.  The solver ground truth is a 400-step DDIM run
computed in the port.  Every solver's ``x0`` is also held against the
reference's on the trained model (ERA with ``use_fused_update=False``).
The network differs between the packages by float32 rounding, up to 4e-5
an evaluation on this model, and the trained model's ODE amplifies such
differences: inside the port alone, ``x_T`` moved by 1e-6 moves ``x0`` by
up to 2.0e-3 (DDIM), 4.2e-3 (DPM-Solver-fast) and 1.2e-2 (PECE).  So the
bound is on the element-wise maximum, 2e-2 (worst measured 9.6e-3, PECE),
and on the RMS over all elements, 1e-3 (worst measured 2.8e-4, PECE),
which stays far below the solvers' own errors that the orderings compare.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import ERAConfig as JERAConfig
from repro.core import default_config as jdefault_config
from repro.core import get_solver as jget_solver
from repro.core import linear_schedule as jlinear_schedule
from repro.data import DataConfig, GaussianMixtureLatents
from repro.models import build_model
from repro.models.diffusion import DiffusionLM as JDiffusionLM
from repro.training import OptimizerConfig, make_diffusion_train_step, train
from repro_torch.configs import get_config
from repro_torch.core import (
    ERAConfig,
    default_config,
    get_solver,
    linear_schedule,
    solver_names,
)
from repro_torch.interop import params_from_jax
from repro_torch.models import DiffusionLM

X0_MAX_TOL = 2e-2
X0_RMS_TOL = 1e-3


@pytest.fixture(scope="module")
def trained():
    """The reference's smoke denoiser trained briefly on a known mixture
    (tests/test_system.py's fixture), and the same weights in the port."""
    cfg = jget_config("llama3.2-1b", smoke=True)
    jdlm = JDiffusionLM(build_model(cfg))
    params = jdlm.init(jax.random.PRNGKey(0))
    sched = jlinear_schedule()
    dc = DataConfig(vocab_size=1, seq_len=8, batch_size=16, kind="diffusion",
                    d_model=cfg.d_model, num_modes=2, seed=3)
    step = make_diffusion_train_step(
        jdlm, OptimizerConfig(lr=2e-3, warmup_steps=5, total_steps=80), sched
    )
    res = train(step, params, GaussianMixtureLatents(dc).batches(), 80,
                log_every=1000, print_fn=lambda s: None)
    tcfg = get_config("llama3.2-1b", smoke=True)
    tdlm = DiffusionLM(tcfg, device="cpu")
    tdlm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, res.params),
                                         tcfg))
    x_t = np.array(jax.random.normal(jax.random.PRNGKey(7),
                                       (32, 8, cfg.d_model)))
    return jdlm, res.params, tdlm, x_t


def _config(solver, nfe, **kw):
    return ERAConfig(nfe=nfe, **kw) if solver == "era" else default_config(
        solver, nfe=nfe)


def _sample(trained, solver, nfe, **kw):
    _, _, tdlm, x_t = trained
    return get_solver(solver)(tdlm.eps_fn(), torch.from_numpy(x_t),
                              linear_schedule(), _config(solver, nfe, **kw),
                              device="cpu").x0


@pytest.fixture(scope="module")
def ref(trained):
    """Fine-grained DDIM on the trained model, in the port: the ground
    truth of every solver."""
    return _sample(trained, "ddim", 400)


def _rmse(x0, ref):
    return float(torch.sqrt(torch.mean((x0 - ref) ** 2)))


def test_all_solvers_finite_on_trained_model(trained):
    for solver in solver_names():
        x0 = _sample(trained, solver, 10, **({"k": 3} if solver == "era" else {}))
        assert bool(torch.isfinite(x0).all()), solver


def test_era_beats_high_order_peers_at_low_nfe(trained, ref):
    """The paper's Tables 1-3 ordering on learned noise estimates, as in
    tests/test_system.py: at NFE 10 ERA (k=2) beats implicit-Adams PECE and
    DPM-Solver-fast and stays within 1.6x of DDIM."""
    err = {}
    for solver in ("ddim", "implicit_adams_pece", "dpm_solver_fast", "era"):
        x0 = _sample(trained, solver, 10, **({"k": 2} if solver == "era" else {}))
        err[solver] = _rmse(x0, ref)
    assert err["era"] < err["implicit_adams_pece"], err
    assert err["era"] < err["dpm_solver_fast"], err
    assert err["era"] < 1.6 * err["ddim"], err


def test_high_order_regime_dependence(trained, ref):
    """k=6 degrades badly for both selection strategies on this briefly
    trained model; the paper's low orders stay far more accurate."""

    def err(k, sel):
        x0 = _sample(trained, "era", 20, k=k, lam=5.0, selection=sel,
                     error_norm="mean")
        return _rmse(x0, ref)

    e3, e6_fixed, e6_ers = err(3, "ers"), err(6, "fixed"), err(6, "ers")
    assert np.isfinite(e6_ers) and np.isfinite(e6_fixed)
    assert e3 * 5 < min(e6_fixed, e6_ers), (e3, e6_fixed, e6_ers)


def test_solvers_match_reference(trained):
    """Every solver of the port against the reference's on the trained
    model, from the same noise, at NFE 10."""
    jdlm, params, _, x_t = trained
    for solver in solver_names():
        jcfg = (JERAConfig(nfe=10, k=2, use_fused_update=False)
                if solver == "era" else jdefault_config(solver, nfe=10))
        want = jget_solver(solver)(jdlm.eps_fn(params), jnp.asarray(x_t),
                                   jlinear_schedule(), jcfg).x0
        got = _sample(trained, solver, 10, **({"k": 2} if solver == "era" else {}))
        diff = got.numpy() - np.asarray(want)
        assert np.abs(diff).max() <= X0_MAX_TOL, solver
        assert np.sqrt(np.mean(diff**2)) <= X0_RMS_TOL, solver
