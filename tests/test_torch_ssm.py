"""The port's scans (``repro_torch.models.ssm``: the causal conv, the
chunked linear and selective scans, Mamba, mLSTM and sLSTM) and the
xlstm-350m token model and denoiser, against the JAX reference on the CPU.

The reference initializes the weights (``mamba_specs`` / ``mlstm_specs`` /
``slstm_specs`` / ``build_model(cfg).init``); they move to the port by
their dotted keys (``repro_torch.interop``).  Everything runs in float32 at
smoke size (d_model 128, 4 heads, chunk 32) unless a test says otherwise.

Tolerances:

* The conv and the scans against the reference: ``1e-5 * max|ref| + 1e-6``
  (float32 summation order: the port's blocked scan, ``cumsum`` and
  products associate other than XLA's).  Returned states too.
* Blocks: the same bound; their outputs reach ~5, their states ~1e1.
* Port-internal properties against a float64 sequential loop (the
  reference's own ``tests/test_ssm.py`` bars): 1e-4 for mLSTM, 1e-5 for the
  linear scan, 2e-4 for Mamba seq against step decode.
* Prefix walls inside the port: bitwise (the scans are strictly
  left-to-right and a padded chunk adds identity steps; see the module
  docstring of ``repro_torch.models.ssm``).  The reference's own mlstm
  wall fails on this install (ROADMAP queue 3); the port's holds.
* Token-model logits atol 1e-4 and ERA x0 atol 2e-3 with ERS selections
  equal, as for the dense family (``test_torch_engine``,
  ``test_torch_era``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import AnalyticGaussian
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models import layers as JL
from repro.models import ssm as jssm
from repro.models.diffusion import DiffusionLM as JDiffusionLM
from repro_torch.configs import get_config
from repro_torch.core import linear_schedule
from repro_torch.interop import _leaves, params_from_jax
from repro_torch.launch import serve
from repro_torch.models import DiffusionLM, build_model
from repro_torch.models import layers as TL
from repro_torch.models import ssm as S
from repro_torch.serving import (BatchedSampler, EngineConfig, SampleRequest,
                                 build_engine)
from repro_torch.serving import result_keys as K
from test_torch_bucketing import _HostTensors
from test_torch_engine import LOGIT_TOL, _teacher_forced, _tokens
from test_torch_engine import build_pair as build_model_pair
from test_torch_era import assert_runs_agree, run_both
from test_torch_models import build_pair

ARCH = "xlstm-350m"
SPECS = {"mamba": jssm.mamba_specs, "mlstm": jssm.mlstm_specs,
         "slstm": jssm.slstm_specs}
MODULES = {"mamba": S.Mamba, "mlstm": S.MLSTMBlock, "slstm": S.SLSTMBlock}
ARCH_OF = {"mamba": "hymba-1.5b", "mlstm": ARCH, "slstm": ARCH}


def _x(shape, seed=1, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, rel=1e-5, abs_=1e-6) -> None:
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    bound = rel * float(np.abs(want).max()) + abs_
    err = float(np.abs(got - want).max())
    assert err <= bound, (err, bound)


def _close_state(got: dict, want: dict, **kw) -> None:
    assert set(got) == set(want)
    for k in want:
        if np.all(np.asarray(want[k]) == -1e30):
            assert torch.all(got[k] == -1e30), k
        else:
            _close(got[k], want[k], **kw)


def scan_pair(kind: str, seed: int = 0, **cfg_kw):
    """(reference config, reference params, port config, port module) of a
    scan block on the same weights."""
    jcfg = jget_config(ARCH_OF[kind], smoke=True).with_(**cfg_kw)
    p = JL.init_params(SPECS[kind](jcfg), jax.random.PRNGKey(seed))
    tcfg = get_config(ARCH_OF[kind], smoke=True).with_(**cfg_kw)
    m = MODULES[kind](tcfg, generator=torch.Generator().manual_seed(0),
                      device="cpu", dtype=torch.float32)
    m.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in _leaves(p)})
    return jcfg, p, tcfg, m


def _t(a):
    return torch.from_numpy(np.array(a))


# ---- the conv and the scans, function by function --------------------------


@pytest.mark.parametrize("with_state", [False, True], ids=["pad", "state"])
def test_causal_conv1d_matches_reference(with_state):
    """Left zero pad, or a carried state; the new state is the last W-1
    inputs."""
    w, b = _x((4, 16), 2, 0.3), _x((16,), 3, 0.1)
    x = _x((2, 7, 16), 4)
    st = _x((2, 3, 16), 5) if with_state else None
    jy, js = JL.causal_conv1d({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                              jnp.asarray(x), None if st is None else jnp.asarray(st))
    ty, ts = TL.causal_conv1d(_t(w), _t(b), _t(x), None if st is None else _t(st))
    _close(ty, jy)
    assert np.array_equal(ts.numpy(), np.asarray(js))
    # one token at a time from the carried state gives the sequence's output
    state, outs = None if st is None else _t(st), []
    for i in range(7):
        y1, state = TL.causal_conv1d(_t(w), _t(b), _t(x[:, i : i + 1]), state)
        outs.append(y1)
    _close(torch.cat(outs, 1), jy)


@pytest.mark.parametrize("s,chunk,gate", [(19, 4, "full"), (19, 8, "broadcast"),
                                          (5, 32, "full"), (45, 32, "full"),
                                          (50, 64, "broadcast")],
                         ids=["ragged", "ragged-broadcast", "one-chunk",
                              "two-blocks", "ragged-blocks"])
def test_chunked_linear_scan_matches_reference(s, chunk, gate):
    """Outputs and the last state, with a ragged last chunk (padded with
    identity steps a = 1, b = 0), a gate broadcast over trailing dims, and
    chunks of several blocks (32 = 2 x 16; 50 = 3 x 16 + 2, its last block
    padded)."""
    a = np.random.default_rng(3).uniform(0.5, 1.0, (2, s, 5 if gate == "full" else 1))
    a = a.astype(np.float32)
    b, h0 = _x((2, s, 5), 4), _x((2, 5), 5)
    jh, jl = jssm.chunked_linear_scan(jnp.asarray(a), jnp.asarray(b),
                                      jnp.asarray(h0), chunk)
    th, tl = S.chunked_linear_scan(_t(a), _t(b), _t(h0), chunk)
    _close(th, jh)
    _close(tl, jl)


@pytest.mark.parametrize("s,chunk", [(13, 4), (13, 5), (13, 32), (45, 32),
                                     (50, 64)],
                         ids=["ragged-4", "ragged-5", "one-chunk", "two-blocks",
                              "ragged-blocks"])
def test_chunked_ssm_outputs_matches_reference(s, chunk):
    """The fused selective scan (discretize, recur, read out per chunk),
    from a nonzero state, ragged last chunk padded with dt = 0."""
    rng = np.random.default_rng(6)
    d, n = 12, 4
    dt = np.log1p(np.exp(rng.standard_normal((2, s, d)))).astype(np.float32)
    x, bm, c = _x((2, s, d), 7), _x((2, s, n), 8), _x((2, s, n), 9)
    a = -np.exp(_x((d, n), 10, 0.5))
    h0 = _x((2, d, n), 11)
    jy, jl = jssm.chunked_ssm_outputs(*map(jnp.asarray, (dt, x, a, bm, c, h0)), chunk)
    ty, tl = S.chunked_ssm_outputs(*map(_t, (dt, x, a, bm, c, h0)), chunk)
    _close(ty, jy)
    _close(tl, jl)


def test_mamba_matches_reference_in_train_and_decode():
    """Mamba over a 40-token sequence (two chunks of 32, the last ragged),
    then 6 decode steps from the prefill's state: outputs and states."""
    jcfg, p, _, m = scan_pair("mamba")
    x = _x((2, 46, jcfg.d_model), 12)
    jo, js = jssm.mamba(p, jnp.asarray(x[:, :40]), jcfg)
    to, ts = m(_t(x[:, :40]))
    _close(to, jo)
    _close_state(ts, js)
    for i in range(40, 46):
        jo, js = jssm.mamba(p, jnp.asarray(x[:, i : i + 1]), jcfg, state=js,
                            mode="decode")
        to, ts = m(_t(x[:, i : i + 1]), ts)
        _close(to, jo)
        _close_state(ts, js)


def _mlstm_inputs(seed=0, b=2, s=33, nh=3, hd=8):
    """The reference's ``tests/test_ssm.py`` inputs."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 5)
    q = jax.random.normal(ks[0], (b, s, nh, hd))
    k = jax.random.normal(ks[1], (b, s, nh, hd))
    v = jax.random.normal(ks[2], (b, s, nh, hd))
    ip = jax.random.normal(ks[3], (b, s, nh)) * 2
    lf = -jax.nn.softplus(-jax.random.normal(ks[4], (b, s, nh)) * 2)
    return q, k, v, ip, lf


def _mlstm_sequential(q, k, v, ip, lf):
    """The reference test's float64 loop over the unstabilized recurrence."""
    b, s, nh, hd = q.shape
    c = np.zeros((b, nh, hd, hd))
    n = np.zeros((b, nh, hd))
    hs = []
    qf, kf, vf = (np.asarray(t, np.float64) for t in (q, k, v))
    ipn, lfn = np.asarray(ip, np.float64), np.asarray(lf, np.float64)
    for t in range(s):
        f, i = np.exp(lfn[:, t]), np.exp(ipn[:, t])
        c = c * f[..., None, None] + (i[..., None] * kf[:, t])[..., :, None] * vf[:, t][..., None, :]
        n = n * f[..., None] + i[..., None] * kf[:, t]
        den = np.maximum(np.abs(np.sum(n * qf[:, t], -1)), 1.0)
        hs.append(np.einsum("bnde,bnd->bne", c, qf[:, t]) / den[..., None])
    return np.stack(hs, 1)


def _tstate(jstate):
    return {k: _t(v) for k, v in jstate.items()}


@pytest.mark.parametrize("chunk", [1, 8, 33, 64])
def test_mlstm_chunkwise_matches_reference(chunk):
    """Outputs and the stabilized state (c, n, m) from the zero state and
    from a carried one, at the reference test's chunks."""
    q, k, v, ip, lf = _mlstm_inputs()
    jz = jssm.mlstm_zero_state(2, 3, 8)
    jh, js = jssm.mlstm_chunkwise(q, k, v, ip, lf, jz, chunk)
    th, ts = S.mlstm_chunkwise(*map(_t, (q, k, v, ip, lf)), _tstate(jz), chunk)
    _close(th, jh)
    _close_state(ts, js)
    # from the carried state
    q2, k2, v2, ip2, lf2 = _mlstm_inputs(seed=1, s=20)
    jh, js2 = jssm.mlstm_chunkwise(q2, k2, v2, ip2, lf2, js, chunk)
    th, ts2 = S.mlstm_chunkwise(*map(_t, (q2, k2, v2, ip2, lf2)), _tstate(js), chunk)
    _close(th, jh)
    _close_state(ts2, js2)


def test_mlstm_step_matches_reference():
    q, k, v, ip, lf = _mlstm_inputs(s=20)
    _, js = jssm.mlstm_chunkwise(q, k, v, ip, lf, jssm.mlstm_zero_state(2, 3, 8), 8)
    ts = _tstate(js)
    q1, k1, v1, ip1, lf1 = _mlstm_inputs(seed=2, s=1)
    jh, js1 = jssm.mlstm_step(q1, k1, v1, ip1, lf1, js)
    th, ts1 = S.mlstm_step(*map(_t, (q1, k1, v1, ip1, lf1)), ts)
    _close(th, jh)
    _close_state(ts1, js1)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_blocks_match_reference(kind):
    """The mLSTM and sLSTM blocks over 40 tokens (mLSTM: two chunks),
    then 5 decode steps from the returned state: outputs and states."""
    jcfg, p, _, m = scan_pair(kind)
    block = jssm.mlstm_block if kind == "mlstm" else jssm.slstm_block
    x = _x((2, 45, jcfg.d_model), 13)
    jo, js = block(p, jnp.asarray(x[:, :40]), jcfg)
    cell = m.cell if kind == "mlstm" else (lambda xi, st=None, mode=None: m.cell(xi, st))
    to, ts = cell(_t(x[:, :40]))
    _close(to, jo)
    _close_state(ts, js)
    for i in range(40, 45):
        jo, js = block(p, jnp.asarray(x[:, i : i + 1]), jcfg, state=js, mode="decode")
        to, ts = cell(_t(x[:, i : i + 1]), ts, mode="decode")
        _close(to, jo)
        _close_state(ts, js)


# ---- the reference's tests/test_ssm.py properties, inside the port ----------


@pytest.mark.parametrize("chunk", [1, 8, 33, 64])
def test_mlstm_chunkwise_matches_sequential(chunk):
    q, k, v, ip, lf = _mlstm_inputs()
    ref = _mlstm_sequential(q, k, v, ip, lf)
    h, _ = S.mlstm_chunkwise(*map(_t, (q, k, v, ip, lf)),
                             S.mlstm_zero_state(2, 3, 8), chunk)
    np.testing.assert_allclose(h.numpy(), ref, atol=1e-4)


def test_mlstm_step_matches_chunkwise():
    q, k, v, ip, lf = map(_t, _mlstm_inputs(s=17))
    h_all, _ = S.mlstm_chunkwise(q, k, v, ip, lf, S.mlstm_zero_state(2, 3, 8), 8)
    st = S.mlstm_zero_state(2, 3, 8)
    for t in range(17):
        sl = slice(t, t + 1)
        h1, st = S.mlstm_step(q[:, sl], k[:, sl], v[:, sl], ip[:, sl], lf[:, sl], st)
        np.testing.assert_allclose(h1[:, 0].numpy(), h_all[:, t].numpy(), atol=1e-4)


def test_mlstm_state_carry_across_chunks():
    """Processing [0:S] at once == processing [0:10] then [10:S]."""
    q, k, v, ip, lf = map(_t, _mlstm_inputs(s=24))
    full, _ = S.mlstm_chunkwise(q, k, v, ip, lf, S.mlstm_zero_state(2, 3, 8), 8)
    a, b = slice(0, 10), slice(10, 24)
    h1, st = S.mlstm_chunkwise(q[:, a], k[:, a], v[:, a], ip[:, a], lf[:, a],
                               S.mlstm_zero_state(2, 3, 8), 8)
    h2, _ = S.mlstm_chunkwise(q[:, b], k[:, b], v[:, b], ip[:, b], lf[:, b], st, 8)
    np.testing.assert_allclose(torch.cat([h1, h2], 1).numpy(), full.numpy(), atol=1e-4)


def test_linear_scan_vs_numpy():
    a = np.random.default_rng(3).uniform(0, 1, (2, 19, 5)).astype(np.float32)
    b = _x((2, 19, 5), 4)
    hs, hl = S.chunked_linear_scan(_t(a), _t(b), torch.zeros(2, 5), 4)
    h = np.zeros((2, 5))
    for t in range(19):
        h = a[:, t] * h + b[:, t]
        np.testing.assert_allclose(hs[:, t].numpy(), h, atol=1e-5)
    np.testing.assert_allclose(hl.numpy(), h, atol=1e-5)


def test_mamba_seq_vs_step_decode():
    """Full-sequence Mamba == token-by-token recurrent decode."""
    _, _, tcfg, m = scan_pair("mamba")
    x = _t(_x((2, 12, tcfg.d_model), 1))
    full, _ = m(x)
    st = S.mamba_init_state(tcfg, 2, torch.float32, "cpu")
    outs = []
    for t in range(12):
        o, st = m(x[:, t : t + 1], st)
        outs.append(o[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(), atol=2e-4)


def test_chunk_scan_prefix_is_length_stable():
    """The port's counterpart of the reference's associative-scan wall:
    a prefix of the blocked scan is bitwise the scan of that prefix alone,
    whatever the length and the chunking (chunk = min(chunk, s)), within
    one block and across blocks."""
    a = np.random.default_rng(0).uniform(0, 1, (1, 48, 4)).astype(np.float32)
    b = _x((1, 48, 4), 1)
    h0 = torch.zeros(1, 4)
    for l_exact in (3, 7, 12, 20, 37):
        for chunk in (4, 16, 64):
            he, _ = S.chunked_linear_scan(_t(a[:, :l_exact]), _t(b[:, :l_exact]), h0, chunk)
            hp, _ = S.chunked_linear_scan(_t(a), _t(b), h0, chunk)
            assert torch.equal(hp[:, :l_exact], he), (l_exact, chunk)


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_scan_blocks_prefix_bitwise(kind):
    """Zero right-padding leaves the valid prefix of each scan block
    bitwise unchanged in the port (the reference's own mlstm wall fails
    on this install; ROADMAP queue 3)."""
    _, _, tcfg, m = scan_pair(kind)
    x = _x((2, 9, tcfg.d_model), 1)
    x[:, 5:] = 0.0
    fn = (lambda xi: m(xi)[0]) if kind == "mamba" else (lambda xi: m.cell(xi)[0])
    exact, padded = fn(_t(x[:, :5])), fn(_t(x))
    assert torch.equal(padded[:, :5], exact), kind


# ---- the xlstm token model ---------------------------------------------------


@pytest.mark.parametrize("max_len,prompt_len,steps", [(64, 12, 6), (16, 40, 8)],
                         ids=["short", "two-chunks"])
def test_xlstm_prefill_and_decode_match_reference(max_len, prompt_len, steps):
    """Prefill logits and teacher-forced decode logits against the
    reference engine (the prompt of 40 spans two scan chunks), and the
    final states of every segment."""
    jmodel, params, tmodel = build_model_pair(ARCH)
    jls, tls, jc, tc = _teacher_forced(
        jmodel, params, tmodel, dict(max_len=max_len), prompt_len=prompt_len,
        steps=steps)
    for step, (j, t) in enumerate(zip(jls, tls)):
        np.testing.assert_allclose(t, j, atol=LOGIT_TOL, err_msg=f"step {step}")
    assert set(tc) == set(jc) == {"0_mlstm", "1_slstm"}
    for key in jc:
        got = {k: v[0] for k, v in tc[key].items()}
        want = {k: np.asarray(v)[0] for k, v in jc[key].items()}
        _close_state(got, want, rel=1e-4)


def test_xlstm_decode_matches_forward():
    """The reference's ``test_decode_matches_forward`` in the port: prefill
    of 12 tokens then decode of 4 reproduce the teacher-forcing logits."""
    _, _, tmodel = build_model_pair(ARCH)
    toks = torch.from_numpy(_tokens(tmodel.config.vocab_size, (2, 16), 3))
    full = tmodel(toks)
    lg, cache = tmodel.prefill(toks[:, :12], 64)
    np.testing.assert_allclose(lg[:, 0].numpy(), full[:, 11].numpy(), atol=2e-5)
    for t in range(12, 16):
        lg, cache = tmodel.decode(cache, toks[:, t : t + 1], t)
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, t].numpy(), atol=2e-5)


def test_param_count_matches_reference():
    """The full xlstm-350m token model on the meta device has the
    reference's ``param_count()``; the sLSTM's recurrent weights stay
    float32 in the bf16 stack."""
    model = build_model(get_config(ARCH), device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == jbuild_model(jget_config(ARCH)).param_count()
    assert 0.25e9 < n < 0.6e9
    sl = model.backbone.layers[7]
    assert isinstance(sl, S.SLSTMBlock)
    assert sl.rz.dtype == torch.float32 and sl.wz.w.dtype == torch.bfloat16


# ---- the xlstm denoiser ------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True], ids=["full", "lengths"])
def test_era_on_xlstm_denoiser_matches_reference(masked):
    """One ERA run (nfe 6, k 3, per-sample ERS) on the smoke xlstm denoiser:
    x0 within 2e-3, error histories within tolerance, ERS selections
    equal (the reference's ERA with ``use_fused_update=False``)."""
    jdlm, params, tdlm = build_pair(ARCH, "naive", "auto", seed=1, head_scale=0.05)
    d = tdlm.config.d_model
    x = _x((2, 8, d), 9)
    lengths = np.asarray([8, 5], np.int32) if masked else None
    jl = None if lengths is None else jnp.asarray(lengths)
    tl = None if lengths is None else torch.from_numpy(lengths)
    want, got = run_both(
        jdlm.eps_fn(params, lengths=jl), tdlm.eps_fn(lengths=tl), x,
        AnalyticGaussian().schedule, linear_schedule(), lengths=lengths,
        nfe=6, k=3, per_sample=True)
    assert_runs_agree(want, got, 2e-3, True)


def test_xlstm_eps_prefix_bitwise():
    """Inside the port: a padded, masked batch gives the exact-shape eps on
    the prefix bitwise, and exact zeros on the pad tail (random eps head,
    so the backbone shows)."""
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


@pytest.mark.parametrize("head,atol", [(0.0, 1e-6), (0.05, 5e-6)],
                         ids=["reference-zero-head", "random-head"])
def test_xlstm_eps_ragged_rows_match_solo(head, atol):
    """The reference's ``test_dlm_eps_ragged_rows_match_solo[xlstm-350m]``
    inside the port: rows of lengths 3, 8 and 5 in one masked batch against
    each row alone at its exact length, and zeros past each length.  With
    the reference's zero-initialized eps head at its bar, atol 1e-6; with a
    random head (scaled 0.05, as the solver tests scale it) at the dense
    family's per-row bar, atol 5e-6 (2.6e-6 seen at scale 1): the CPU's
    BLAS blocks the 24-row and the 3- to 8-row projections differently."""
    _, _, tdlm = build_pair(ARCH, "naive", "auto", seed=0, head_scale=head)
    lens = (3, 8, 5)
    x = _x((3, 8, tdlm.config.d_model), 2)
    for i, n in enumerate(lens):
        x[i, n:] = 0.0
    e_pad = tdlm.eps(_t(x), 0.4, lengths=torch.tensor(lens, dtype=torch.int32))
    for i, n in enumerate(lens):
        solo = tdlm.eps(_t(x[i : i + 1, :n]), 0.4)[0]
        torch.testing.assert_close(e_pad[i, :n], solo, atol=atol, rtol=0)
        assert bool((e_pad[i, n:] == 0).all())


def test_bf16_keeps_recurrent_weights_float32_and_eps_near_reference():
    """At bf16 compute (the full-width dtype) the sLSTM's ``rz, ri, rf, ro``
    are stored float32, as the reference computes with them, and eps stays
    near the reference's bf16 eps: within 2 * |ref_bf16 - ref_f32| +
    0.02, the reference's own bf16 rounding plus margin."""
    jcfg = jget_config(ARCH, smoke=True).with_(dtype=jnp.bfloat16,
                                              attention_impl="naive")
    jdlm = JDiffusionLM(jbuild_model(jcfg))
    params = jdlm.init(jax.random.PRNGKey(0))
    d = jcfg.d_model
    rng = np.random.default_rng(0)
    params["eps_head"] = {"w": jnp.asarray(rng.standard_normal((d, d), np.float32) * d**-0.5),
                          "b": jnp.zeros((d,), jnp.float32)}
    tcfg = get_config(ARCH, smoke=True).with_(dtype=torch.bfloat16)
    tdlm = DiffusionLM(tcfg, device="cpu")
    tdlm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), tcfg))
    sl = tdlm.backbone.layers[1]
    assert all(getattr(sl, "r" + g).dtype == torch.float32 for g in "zifo")
    assert sl.wz.w.dtype == torch.bfloat16
    assert tdlm.backbone.layers[0].up.w.dtype == torch.bfloat16
    x = _x((2, 40, d), 3)
    want = np.asarray(jdlm.eps(params, jnp.asarray(x), jnp.float32(0.6)))
    f32 = JDiffusionLM(jbuild_model(jcfg.with_(dtype=jnp.float32)))
    want32 = np.asarray(f32.eps(params, jnp.asarray(x), jnp.float32(0.6)))
    got = tdlm.eps(_t(x), 0.6).numpy()
    ref_err = float(np.abs(want - want32).max())
    assert float(np.abs(got - want).max()) <= 2 * ref_err + 0.02, ref_err


# ---- serving -----------------------------------------------------------------

FUSE_REQS = [dict(batch=1, seq_len=8, nfe=8, seed=3),
             dict(batch=2, seq_len=5, nfe=6, seed=4),
             dict(batch=1, seq_len=3, nfe=8, seed=5)]


def fused_equals_solo(tdlm):
    """Requests of mixed seq_len and nfe fused into one batch of seq bucket
    8 and NFE bucket 8 through ``build_engine``; each equals its solo drain
    through the same engine bitwise (x0 and ERS selections)."""
    eng = build_engine(tdlm, linear_schedule(), EngineConfig(
        batch_buckets=(4,), seq_buckets=(8,), nfe_buckets=(8,)))
    reqs = [SampleRequest(**r) for r in FUSE_REQS]
    futs = [eng.submit_with_future(r)[1] for r in reqs]
    eng.drain()
    assert eng.metrics.get("sampler_batches_total").value() == 1
    for r, f in zip(reqs, futs):
        fused = f.result()
        assert fused.padded_seq_len == 8 and fused.padded_nfe == 8
        _, solo = eng.submit_with_future(r)
        eng.drain()
        assert torch.equal(fused.x0, solo.result().x0), r
        assert torch.equal(fused.aux[K.ERS_SELECTION_HISTORY],
                           solo.result().aux[K.ERS_SELECTION_HISTORY])


def no_host_data(tdlm):
    """The program a seq- and NFE-bucket graph captures makes no tensor
    from host data (``test_torch_bucketing``'s recorder)."""
    engine = BatchedSampler(tdlm, linear_schedule(), batch_buckets=(4,),
                            seq_buckets=(8,), nfe_buckets=(8,))
    ex = engine.executor
    reqs = [(0, SampleRequest(batch=1, seq_len=5, nfe=6), 0.0),
            (1, SampleRequest(batch=2, seq_len=8, nfe=8), 0.0)]
    cfg = dataclasses.replace(ex.config_for("era"), nfe=8)
    x_init = _t(_x((4, 8, tdlm.config.d_model), 10))
    lengths = torch.tensor([5, 8, 8, 8], dtype=torch.int32)
    steps = ex._step_mask("era", cfg, reqs, 1)
    key = ("era", cfg, 4, 8, True, True)
    ex._run_program(key, x_init, lengths, steps)
    rec = _HostTensors()
    with rec:
        out = ex._run_program(key, x_init, lengths, steps)
    assert out.x0.shape == x_init.shape
    assert rec.lifted == 0


def test_xlstm_fused_requests_equal_their_solo_drains():
    _, _, tdlm = build_pair(ARCH, "naive", "auto", seed=4, head_scale=0.05)
    fused_equals_solo(tdlm)


def test_xlstm_bucket_program_makes_no_tensor_from_host_data():
    _, _, tdlm = build_pair(ARCH, "naive", "auto", seed=5, head_scale=0.05)
    no_host_data(tdlm)


@pytest.mark.parametrize("mode", ["ar", "diffusion"])
def test_launcher_serves_xlstm(mode, capsys):
    serve.main(["--smoke", "--device", "cpu", "--arch", ARCH, "--mode", mode,
                "--batch", "2", "--prompt-len", "8", "--gen", "3", "--seq", "8",
                "--nfe", "5"])
    out = capsys.readouterr().out
    assert out.startswith("generated (2, 3)" if mode == "ar"
                          else "sampled latents (2, 8, 128)"), out
