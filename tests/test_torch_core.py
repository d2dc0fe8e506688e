"""Parity of the port's core math (repro_torch.core) with the JAX reference.

Inputs are float32 numpy arrays from a fixed seed, handed to both packages.
Tolerances: time grids and DDIM coefficients agree to float32 rounding
(rtol 1e-6, atol 2e-6); schedule primitives chain up to three
transcendentals (cos, log, expm1) whose float32 results may differ by an ulp
between XLA and PyTorch, so they get rtol 1e-5.  ERS
selections are integers and must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lagrange as jlag
from repro.core import schedules as jsched
from repro.core import solver_base as jbase
from repro_torch.core import lagrange as tlag
from repro_torch.core import schedules as tsched
from repro_torch.core import solver_base as tbase

SCHEDULES = {
    "linear": (jsched.linear_schedule, tsched.linear_schedule),
    "cosine": (jsched.cosine_schedule, tsched.cosine_schedule),
}
T_GRID = np.linspace(1e-3, 1.0, 97, dtype=np.float32)


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
@pytest.mark.parametrize("fn", ["log_alpha_bar", "alpha", "sigma", "lam"])
def test_schedule_primitives(name, fn):
    js, ts = (f() for f in SCHEDULES[name])
    want = getattr(js, fn)(jnp.asarray(T_GRID))
    got = getattr(ts, fn)(torch.from_numpy(T_GRID))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_inv_lam(name):
    js, ts = (f() for f in SCHEDULES[name])
    lams = np.array(js.lam(jnp.asarray(T_GRID[5:-5])), np.float32)
    want = js.inv_lam(jnp.asarray(lams))
    got = ts.inv_lam(torch.from_numpy(lams))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
@pytest.mark.parametrize("scheme", ["uniform", "logsnr", "quadratic"])
@pytest.mark.parametrize("n", [4, 10, 25])
def test_timesteps(name, scheme, n):
    js, ts = (f() for f in SCHEDULES[name])
    want = jsched.timesteps(js, n, scheme)
    got = tsched.timesteps(ts, n, scheme)
    assert got.dtype == torch.float32 and got.shape == (n + 1,)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=2e-6)
    assert float(got[0]) == float(want[0]) and float(got[-1]) == float(want[-1])


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_ddim_coeffs_and_step(name):
    js, ts = (f() for f in SCHEDULES[name])
    grid = np.asarray(jsched.timesteps(js, 12, "uniform"), np.float32)
    for a, b in zip(grid[:-1], grid[1:]):
        jcx, jce = js.ddim_coeffs(jnp.float32(a), jnp.float32(b))
        tcx, tce = ts.ddim_coeffs(torch.tensor(a), torch.tensor(b))
        np.testing.assert_allclose(_np(tcx), _np(jcx), rtol=1e-6)
        np.testing.assert_allclose(_np(tce), _np(jce), rtol=1e-5, atol=1e-7)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5), np.float32)
    e = rng.standard_normal((3, 5), np.float32)
    want = jbase.ddim_step(js, jnp.asarray(x), jnp.asarray(e),
                           jnp.float32(grid[3]), jnp.float32(grid[4]))
    got = tbase.ddim_step(ts, torch.from_numpy(x), torch.from_numpy(e),
                          torch.tensor(grid[3]), torch.tensor(grid[4]))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k", [2, 3, 4, 5])
def test_lagrange_weights_batched(k):
    """Rows of a batched call equal the reference's per-row weights."""
    rng = np.random.default_rng(k)
    nodes = np.sort(rng.uniform(0.05, 1.0, (16, k)).astype(np.float32))[:, ::-1]
    t_eval = rng.uniform(0.0, 0.5, (16,)).astype(np.float32)
    got = _np(tlag.lagrange_weights(torch.from_numpy(nodes.copy()),
                                    torch.from_numpy(t_eval)))
    for r in range(16):
        want = jlag.lagrange_weights(jnp.asarray(nodes[r]), jnp.float32(t_eval[r]))
        np.testing.assert_allclose(got[r], _np(want), rtol=1e-5, atol=1e-6)


def test_interpolate():
    rng = np.random.default_rng(1)
    nodes = np.asarray([0.9, 0.7, 0.4, 0.1], np.float32)
    vals = rng.standard_normal((4, 6), np.float32)
    want = jlag.interpolate(jnp.asarray(vals), jnp.asarray(nodes), jnp.float32(0.05))
    got = tlag.interpolate(torch.from_numpy(vals), torch.from_numpy(nodes),
                           torch.tensor(0.05))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("k", [2, 3, 4, 5, 6])
def test_ers_select_indices_equal(k):
    """ERS selections are equal over a sweep of (i, k, delta_eps), and a
    batched call over delta_eps rows equals per-row reference calls."""
    rng = np.random.default_rng(100 + k)
    lam = 5.0
    des = np.concatenate([
        rng.uniform(0.01, 20.0, 40), [lam, 0.5 * lam, 2 * lam, 1e-3, 50.0]
    ]).astype(np.float32)
    for i in range(k - 1, 41):
        got = _np(tlag.select_bases(i, k, torch.from_numpy(des), lam, "ers"))
        assert got.shape == (len(des), k) and got.dtype == np.int32
        # the reference's per-sample path: the scalar rule vmapped over rows
        want = jax.vmap(
            lambda d: jlag.select_bases(jnp.int32(i), k, d, lam, "ers")
        )(jnp.asarray(des))
        np.testing.assert_array_equal(got, _np(want), err_msg=f"i={i}")


@pytest.mark.parametrize("strategy", ["fixed", "const"])
def test_select_bases_other_strategies(strategy):
    for k in (2, 4):
        for i in range(k - 1, 20):
            want = jlag.select_bases(jnp.int32(i), k, jnp.float32(3.0), 5.0,
                                     strategy, const_power=1.7)
            got = tlag.select_bases(i, k, torch.tensor(3.0), 5.0, strategy,
                                    const_power=1.7)
            np.testing.assert_array_equal(_np(got), _np(want))


def test_buffers_and_step_grid():
    x = torch.zeros(2, 3, 4)
    eps_buf, t_buf = tbase.buffer_init(x, 5, torch.float32)
    assert eps_buf.shape == (5, 2, 3, 4) and t_buf.shape == (5,)
    tbase.buffer_append(eps_buf, t_buf, 2, torch.ones(2, 3, 4), torch.tensor(0.5))
    assert float(eps_buf[2].sum()) == 24.0 and float(t_buf[2]) == 0.5
    ts = torch.linspace(1.0, 0.0, 5)
    idx, t_cur, t_next = tbase.step_grid(ts)
    assert list(idx) == [0, 1, 2, 3]
    assert torch.equal(t_cur, ts[:-1]) and torch.equal(t_next, ts[1:])
