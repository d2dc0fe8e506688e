"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
reference on the CPU, the reference's own MoE tests rewritten for the port,
the mixtral token model, and the reference's MoE padding hazard shown
rather than hidden.

The reference initializes the weights (``moe_specs`` / ``DiffusionLM.init``
/ ``build_model(cfg).init``); they move to the port by their dotted keys
(``repro_torch.interop``).  Everything runs in float32 at smoke size.

Tolerances:

* Router ids, each assignment's rank within its expert, and which
  assignments are kept are integers and booleans: equal.
* Outputs within ``1e-5 * max|ref| + 1e-6``: the reference's fan-in init
  divides by the expert count (4 at smoke size), so expert outputs reach
  ~4e2 and float32 summation order moves them by ~1e-4.
* Aux losses within 1e-5 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import ERAConfig as JERAConfig
from repro.core import linear_schedule as jlinear_schedule
from repro.models import layers as JL
from repro.models import moe as jmoe
from repro.serving import BatchedSampler as JBatchedSampler
from repro.serving import SampleRequest as JSampleRequest
from repro_torch.configs import get_config
from repro_torch.interop import _leaves
from repro_torch.core import linear_schedule
from repro_torch.launch import serve
from repro_torch.models.moe import MoE
from repro_torch.serving import BatchedSampler, SampleRequest
from repro_torch.serving import result_keys as K
from test_torch_bucketing import _HostTensors
from test_torch_engine import LOGIT_TOL, _teacher_forced
from test_torch_engine import build_pair as build_model_pair
from test_torch_models import build_pair
from test_torch_serving import reference_noise

ARCHS = ["deepseek-v2-lite-16b", "mixtral-8x7b"]
DISPATCH = ["dropping", "dense_mix"]


def _with_moe(cfg, **kw):
    return cfg.with_(moe=dataclasses.replace(cfg.moe, **kw))


def moe_pair(arch: str, seed: int = 0, **moe_kw):
    """(reference config, reference params, port config, port MoE) on the
    same weights."""
    jcfg = _with_moe(jget_config(arch, smoke=True), **moe_kw)
    tcfg = _with_moe(get_config(arch, smoke=True), **moe_kw)
    p = JL.init_params(jmoe.moe_specs(jcfg), jax.random.PRNGKey(seed))
    return jcfg, p, tcfg, port_moe(tcfg, p)


def port_moe(tcfg, p) -> MoE:
    m = MoE(tcfg, generator=torch.Generator().manual_seed(0), device="cpu",
            dtype=torch.float32)
    m.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in _leaves(p)})
    return m


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _reference_ranks(flat_e: np.ndarray, e: int) -> np.ndarray:
    """The reference's rank of each assignment within its expert
    (``_dispatch_group``: stable argsort, searchsorted), one group."""
    fe = jnp.asarray(flat_e)
    order = jnp.argsort(fe, stable=True)
    sorted_e = fe[order]
    start = jnp.searchsorted(sorted_e, jnp.arange(e))
    rank_sorted = jnp.arange(fe.shape[0]) - start[sorted_e]
    return np.asarray(jnp.zeros_like(rank_sorted).at[order].set(rank_sorted))


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max() + 1e-6)


# ---- moe_ffn against the reference ----------------------------------------


@pytest.mark.parametrize("dispatch", DISPATCH)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_matches_reference(arch, dispatch):
    """Outputs and aux losses of the port's MoE against ``moe_ffn``, three
    rows of 16 tokens (one dispatch group a row)."""
    jcfg, p, tcfg, m = moe_pair(arch, dispatch=dispatch)
    x = _x((3, 16, jcfg.d_model))
    want, jaux = jmoe.moe_ffn(p, jnp.asarray(x), jcfg)
    got, taux = m(torch.from_numpy(x))
    _close(got, want)
    for key in ("moe_aux", "moe_z"):
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]), rtol=1e-5)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5], ids=["default", "tight"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_plan_matches_reference(arch, capacity_factor):
    """Per group: router ids equal, each assignment's rank equal to the
    reference's argsort rank, and the kept / dropped assignments equal
    (the tight capacity drops some)."""
    jcfg, p, tcfg, m = moe_pair(arch, capacity_factor=capacity_factor)
    x = _x((4, 16, jcfg.d_model), seed=2)
    plan = m.plan(torch.from_numpy(x))
    _, jids, _ = jmoe._router(p, jnp.asarray(x), jcfg.moe)
    np.testing.assert_array_equal(plan.ids.numpy(), np.asarray(jids))
    m_cfg = jcfg.moe
    cap = max(int(16 * m_cfg.top_k / m_cfg.num_experts * capacity_factor), 1)
    assert plan.cap == cap
    dropped = 0
    for g in range(x.shape[0]):
        _, (flat_e, slot, keep, _, _), _ = jmoe._dispatch_group(
            p, jnp.asarray(x[g]), m_cfg)
        rank = _reference_ranks(np.asarray(flat_e), m_cfg.num_experts)
        np.testing.assert_array_equal(plan.rank[g].numpy(), rank)
        np.testing.assert_array_equal(plan.keep[g].numpy(), np.asarray(keep))
        np.testing.assert_array_equal(np.where(np.asarray(keep), rank, cap),
                                      np.asarray(slot))
        dropped += int((~plan.keep[g]).sum())
    if capacity_factor < 1.0:
        assert dropped > 0


def test_dispatch_groups_follow_dispatch_group():
    """Rows cut into groups of ``dispatch_group`` tokens (and a row kept
    whole when the group does not divide it), against the reference."""
    for group, s in ((8, 16), (6, 16)):
        jcfg, p, tcfg, m = moe_pair("mixtral-8x7b", dispatch_group=group)
        x = _x((2, s, jcfg.d_model), seed=3)
        want, _ = jmoe.moe_ffn(p, jnp.asarray(x), jcfg)
        got, _ = m(torch.from_numpy(x))
        _close(got, want)


def test_router_stays_float32_at_full_width():
    """The router weight keeps float32 in a bf16 stack (the reference runs
    it in float32; bf16 routers destabilize top-k)."""
    cfg = _with_moe(get_config("deepseek-v2-lite-16b"), num_experts=8,
                    d_ff_expert=32).with_(d_model=64)
    m = MoE(cfg, generator=torch.Generator().manual_seed(0), device="cpu",
            dtype=torch.bfloat16)
    assert m.router.w.dtype == torch.float32
    assert m.experts.wi.dtype == m.shared.wi.w.dtype == torch.bfloat16
    out, aux = m(torch.randn(2, 8, 64).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    assert aux["moe_z"].dtype == torch.float32


def test_moe_forward_makes_no_tensor_from_host_data():
    """Both dispatches build no tensor from host data, so the forward can
    be captured in a CUDA graph."""
    for dispatch in DISPATCH:
        _, _, _, m = moe_pair("deepseek-v2-lite-16b", dispatch=dispatch)
        x = torch.from_numpy(_x((2, 8, 128)))
        rec = _HostTensors()
        with rec:
            m(x)
        assert rec.lifted == 0, dispatch


# ---- the reference's tests/test_moe.py, rewritten for the port -----------


@pytest.fixture(scope="module")
def mixtral():
    jcfg, p, tcfg, m = moe_pair("mixtral-8x7b")
    x = torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(1), (2, 16, tcfg.d_model))))
    return tcfg, p, x


def test_dropless_dropping_matches_dense_mix(mixtral):
    tcfg, p, x = mixtral
    dense = port_moe(_with_moe(tcfg, dispatch="dense_mix"), p)
    m = tcfg.moe
    drop = port_moe(_with_moe(
        tcfg, capacity_factor=float(m.num_experts) / m.top_k + 1), p)
    ref, aux_ref = dense(x)
    got, aux_got = drop(x)
    torch.testing.assert_close(got, ref, atol=3e-5, rtol=0)
    # aux is averaged per dispatch group vs globally -> close, not identical
    assert abs(float(aux_ref["moe_aux"]) - float(aux_got["moe_aux"])) < 0.05


def test_capacity_drops_reduce_output_norm(mixtral):
    """Tight capacity drops tokens -> strictly less routed mass."""
    tcfg, p, x = mixtral
    out_t, _ = port_moe(_with_moe(tcfg, capacity_factor=0.25), p)(x)
    out_l, _ = port_moe(_with_moe(tcfg, capacity_factor=8.0), p)(x)
    assert float(torch.linalg.norm(out_t)) < float(torch.linalg.norm(out_l))


def test_router_z_loss_scales_with_logits():
    """z-loss penalizes large router logits (keeps the router calibrated)."""
    jcfg, p, tcfg, m = moe_pair("mixtral-8x7b")
    hot = port_moe(tcfg, dict(p, router={"w": p["router"]["w"] * 50.0}))
    x = torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(1), (2, 32, tcfg.d_model))))
    _, aux = m(x)
    _, aux_hot = hot(x)
    assert float(aux_hot["moe_z"]) > float(aux["moe_z"])
    # load-balance loss is O(1) for a near-uniform random router
    assert 0.5 < float(aux["moe_aux"]) < 2.0


def test_shared_experts_always_active():
    jcfg, p, tcfg, m = moe_pair("deepseek-v2-lite-16b")
    x = torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(1), (1, 8, tcfg.d_model))))
    m(x)
    # zero out routed experts: output should become exactly the shared path
    p2 = dict(p, experts=jax.tree.map(jnp.zeros_like, p["experts"]))
    out2, _ = port_moe(tcfg, p2)(x)
    torch.testing.assert_close(out2, m.shared(x), atol=1e-5, rtol=0)


def test_decode_single_token_not_dropped():
    """top-k assignments of a single token always fit capacity."""
    jcfg, p, tcfg, m = moe_pair("deepseek-v2-lite-16b")
    x = torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(1), (4, 1, tcfg.d_model))))
    ref, _ = port_moe(_with_moe(tcfg, dispatch="dense_mix"), p)(x)
    got, _ = m(x)
    assert bool(m.plan(x.reshape(4, 1, -1)).keep.all())
    torch.testing.assert_close(got, ref, atol=3e-5, rtol=0)


# ---- the mixtral token model ----------------------------------------------


@pytest.mark.parametrize("max_len,prompt_len,steps", [(64, 12, 6), (16, 20, 40)],
                         ids=["cache", "ring-wrap"])
def test_mixtral_prefill_and_decode_match_reference(max_len, prompt_len, steps):
    """Prefill logits and teacher-forced decode logits of the mixtral smoke
    model (sliding window 64, MoE FFN) against the reference engine, and the
    same K/V cache positions."""
    jmodel, params, tmodel = build_model_pair("mixtral-8x7b")
    jls, tls, jc, tc = _teacher_forced(
        jmodel, params, tmodel, dict(max_len=max_len), prompt_len=prompt_len,
        steps=steps)
    for step, (j, t) in enumerate(zip(jls, tls)):
        np.testing.assert_allclose(t, j, atol=LOGIT_TOL, err_msg=f"step {step}")
    assert np.array_equal(tc["0_moe"]["pos"].numpy(),
                          np.asarray(jc["0_moe"]["pos"][0]))


@pytest.mark.parametrize("mode", ["ar", "diffusion"])
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "mixtral-8x7b"])
def test_launcher_serves_the_moe_families(arch, mode, capsys):
    serve.main(["--smoke", "--device", "cpu", "--arch", arch, "--mode", mode,
                "--batch", "2", "--prompt-len", "8", "--gen", "3", "--seq", "8",
                "--nfe", "5"])
    out = capsys.readouterr().out
    assert out.startswith("generated (2, 3)" if mode == "ar"
                          else "sampled latents (2, 8, 128)"), out


@pytest.mark.parametrize("mode", ["ar", "diffusion"])
@pytest.mark.parametrize("arch", ["whisper-base", "paligemma-3b"])
def test_launcher_serves_the_audio_and_vlm_families(arch, mode, capsys):
    """Every registry architecture is served: the audio and vlm families
    in both modes, AR with their stub frames / patches drawn from the
    seed."""
    serve.main(["--smoke", "--device", "cpu", "--arch", arch, "--mode", mode,
                "--batch", "2", "--prompt-len", "8", "--gen", "3", "--seq", "8",
                "--nfe", "5"])
    out = capsys.readouterr().out
    assert out.startswith("generated (2, 3)" if mode == "ar"
                          else "sampled latents (2, 8, 128)"), out


# ---- the reference's MoE padding hazard, shown ----------------------------

# the reference's test_real_denoiser_padding_invariance_wall requests
PAD_REQS = [dict(batch=1, seq_len=n, nfe=5, seed=700 + i)
            for i, n in enumerate((3, 8, 5))]
PAD_LADDERS = dict(batch_buckets=(2, 4), seq_buckets=(4, 8))


def test_moe_capacity_comes_from_the_padded_length():
    """In both packages a group's capacity comes from its padded length:
    three valid tokens padded to four keep assignments that the three alone
    drop (capacity 2 against 1 at smoke size), so the valid tokens' outputs
    move (by 280.0 in both, seed 0); the port reproduces the reference's
    output either way.  Eight tokens need no padding and do not move."""
    jcfg, p, tcfg, m = moe_pair("deepseek-v2-lite-16b")
    x = np.array(jax.random.normal(jax.random.PRNGKey(0), (1, 8, jcfg.d_model)))
    moved = {}
    for n, padded in ((3, 4), (8, 8)):
        alone_j = np.asarray(jmoe.moe_ffn(p, jnp.asarray(x[:, :n]), jcfg)[0])
        pad_j = np.asarray(jmoe.moe_ffn(p, jnp.asarray(x[:, :padded]), jcfg)[0])
        alone_t, _ = m(torch.from_numpy(x[:, :n]))
        pad_t, _ = m(torch.from_numpy(x[:, :padded]))
        _close(alone_t, alone_j)
        _close(pad_t, pad_j)
        assert m.plan(torch.from_numpy(x[:, :n])).cap == max(int(n * 2 / 4 * 1.25), 1)
        moved[n] = float(np.abs(pad_j[:, :n] - alone_j).max())
        assert float((pad_t[:, :n] - alone_t).abs().max()) == pytest.approx(
            moved[n], rel=1e-4, abs=1e-5)
    assert moved[3] > 100.0 and moved[8] == 0.0


def test_moe_denoiser_padding_follows_the_reference():
    """The reference's padding-wall requests (lengths 3, 8, 5; nfe 5;
    seeds 700-702) on the deepseek-v2-lite smoke denoiser, seq buckets 4
    and 8.  What holds: the port's bucketed drain equals the reference's
    bucketed drain (x0 atol 2e-3, ERS selections equal), and each request of
    the fused drain equals its solo drain at the same bucket, bitwise.  What
    the reference's wall claims and does not hold: the 3- and 5-token
    requests, padded to 4 and 8, differ from their exact-shape runs (x0 by
    0.292 and 0.179 max abs, seed 0; the MoE capacity follows the padded
    length; ROADMAP queue 3); the 8-token request, not padded, does not."""
    jdlm, params, tdlm = build_pair("deepseek-v2-lite-16b", "naive", "auto",
                                    seed=0, head_scale=0.05)
    d = tdlm.config.d_model
    jeng = JBatchedSampler(
        jdlm, jlinear_schedule(),
        solver_config=JERAConfig(per_sample=True, use_fused_update=False),
        **PAD_LADDERS)
    teng = BatchedSampler(tdlm, linear_schedule(),
                          noise_fn=reference_noise(d), **PAD_LADDERS)
    jf = [jeng.submit_with_future(JSampleRequest(**r))[1] for r in PAD_REQS]
    tf = [teng.submit_with_future(SampleRequest(**r))[1] for r in PAD_REQS]
    jeng.drain(params)
    teng.drain()
    exact = BatchedSampler(tdlm, linear_schedule(), batch_buckets=None,
                           noise_fn=reference_noise(d))
    moved = {}
    for r, j, t in zip(PAD_REQS, (f.result() for f in jf),
                       (f.result() for f in tf)):
        assert t.padded_seq_len == j.padded_seq_len == (4 if r["seq_len"] <= 4 else 8)
        np.testing.assert_allclose(t.x0.numpy(), np.asarray(j.x0), atol=2e-3)
        np.testing.assert_array_equal(
            t.aux[K.ERS_SELECTION_HISTORY].numpy(),
            np.asarray(j.aux[K.ERS_SELECTION_HISTORY]))
        _, solo = teng.submit_with_future(SampleRequest(**r))
        teng.drain()
        assert torch.equal(solo.result().x0, t.x0), r
        _, ex = exact.submit_with_future(SampleRequest(**r))
        exact.drain()
        moved[r["seq_len"]] = float((ex.result().x0 - t.x0).abs().max())
    assert moved[8] == 0.0
    assert moved[3] > 1e-2 and moved[5] > 1e-2, moved
