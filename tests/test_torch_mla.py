"""The port's Multi-head Latent Attention (``repro_torch.models.mla``), the
deepseek-v2-lite denoiser and token model, and the parameter counts of
the four configs of this family slice, against the JAX reference on the
CPU.

The reference initializes the weights (``mla_specs`` / ``DiffusionLM.init``
/ ``build_model(cfg).init``); they move to the port by their dotted keys
(``repro_torch.interop``).  Everything runs in float32 at smoke size
(kv_lora_rank 64, qk 32 + 16 rope dims, v 32).

Tolerances: MLA outputs and the latent cache within ``1e-5 * max|ref| +
1e-6`` (float32 summation order); cache positions equal; token-model logits
atol 1e-4 and ERA x0 atol 2e-3 with ERS selections equal, as for the dense
family (``test_torch_engine``, ``test_torch_era``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models import layers as JL
from repro.models import mla as jmla
from repro_torch.configs import get_config
from repro_torch.interop import _leaves
from repro_torch.core import linear_schedule
from repro_torch.kernels import flash_attention as kf
from repro_torch.models import build_model
from repro_torch.models import attention as A
from repro_torch.models import mla as M
from repro_torch.serving import BatchedSampler, SampleRequest
from test_torch_bucketing import _HostTensors
from test_torch_engine import LOGIT_TOL, _teacher_forced
from test_torch_engine import build_pair as build_model_pair
from test_torch_era import assert_runs_agree, run_both
from test_torch_models import build_pair
from test_torch_moe import _close

from conftest import AnalyticGaussian

ARCH = "deepseek-v2-lite-16b"


def mla_pair(seed: int = 0):
    jcfg = jget_config(ARCH, smoke=True)
    p = JL.init_params(jmla.mla_specs(jcfg), jax.random.PRNGKey(seed))
    tcfg = get_config(ARCH, smoke=True)
    m = M.MLA(tcfg, generator=torch.Generator().manual_seed(0), device="cpu",
              dtype=torch.float32)
    m.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in _leaves(p)})
    return jcfg, p, tcfg, m


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("masked", [False, True], ids=["full", "lengths"])
def test_mla_train_matches_reference(masked):
    jcfg, p, tcfg, m = mla_pair()
    x = _x((3, 12, jcfg.d_model))
    lengths = np.asarray([12, 7, 3], np.int32) if masked else None
    want, _ = jmla.mla_train(
        p, jnp.asarray(x), jcfg, "train",
        lengths=None if lengths is None else jnp.asarray(lengths))
    got = m(torch.from_numpy(x),
            lengths=None if lengths is None else torch.from_numpy(lengths))
    assert got.shape == x.shape
    _close(got, want)


def test_mla_is_causal_whatever_the_caller_asks():
    """The reference's MLA ignores ``causal``: a later token never moves an
    earlier output, so a deepseek-v2-lite denoiser is causal in both
    packages (ROADMAP queue 3)."""
    jdlm, params, tdlm = build_pair(ARCH, "naive", "auto", seed=2)
    assert tdlm.causal is False
    x = _x((1, 10, tdlm.config.d_model), seed=3)
    x2 = x.copy()
    x2[:, -1] += 1.0
    t = np.float32(0.5)
    for eps in (lambda a: np.asarray(jdlm.eps(params, jnp.asarray(a), t)),
                lambda a: tdlm.eps(torch.from_numpy(a), t).numpy()):
        a, b = eps(x), eps(x2)
        assert np.array_equal(a[:, :-1], b[:, :-1])
        assert not np.array_equal(a[:, -1], b[:, -1])


@pytest.mark.parametrize("slots,prompt", [(16, 10), (8, 12)],
                         ids=["fits", "longer-than-cache"])
def test_mla_prefill_cache_and_decode_match_reference(slots, prompt):
    """Prefill fills the latent cache as the reference does (the last
    ``min(S, slots)`` entries from slot 0), then 20 absorbed-form decode
    steps through the ring's wrap give the reference's outputs and cache."""
    jcfg, p, tcfg, m = mla_pair()
    b, d = 2, jcfg.d_model
    x = _x((b, prompt, d), seed=4)
    jc = jmla.mla_init_cache(jcfg, b, slots, jnp.float32)
    want, jc = jmla.mla_train(p, jnp.asarray(x), jcfg, "prefill", jc)
    tc = M.init_cache(tcfg, 1, b, slots, torch.float32, "cpu")
    A.cache_fill(tc, prompt)
    got = m(torch.from_numpy(x), mode="prefill", cache=tc, layer=0)
    _close(got, want)

    def same():
        assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        _close(tc["ckv"][0], jc["ckv"])
        _close(tc["krope"][0], jc["krope"])

    same()
    for pos in range(prompt, prompt + 20):
        x1 = _x((b, 1, d), seed=pos)
        want, jc = jmla.mla_decode(p, jnp.asarray(x1), jcfg, jc, jnp.int32(pos))
        A.cache_insert(tc, pos)
        got = m(torch.from_numpy(x1), mode="decode", cache=tc, layer=0, pos=pos)
        _close(got, want)
        same()


def test_absorbed_decode_equals_expanded_form():
    """The port's absorbed decode (W_kb folded into the query, W_vb into
    the output) equals expanding the latent cache to per-head K/V and
    attending with plain SDPA over the valid slots."""
    _, _, tcfg, m = mla_pair(seed=5)
    a, h = tcfg.mla, tcfg.num_heads
    b, slots, prompt, pos = 2, 16, 9, 9
    tc = M.init_cache(tcfg, 1, b, slots, torch.float32, "cpu")
    A.cache_fill(tc, prompt)
    m(torch.from_numpy(_x((b, prompt, tcfg.d_model), seed=6)), mode="prefill",
      cache=tc, layer=0)
    x1 = torch.from_numpy(_x((b, 1, tcfg.d_model), seed=7))
    A.cache_insert(tc, pos)
    got = m(x1, mode="decode", cache=tc, layer=0, pos=pos)

    q_pos = torch.full((1,), pos, dtype=torch.int32)
    q_nope, q_rope = m._project_q(x1, q_pos)
    kv = m.wkv_b(tc["ckv"][0]).reshape(b, slots, h, -1)
    k_nope, v = torch.split(kv, [a.qk_nope_head_dim, a.v_head_dim], dim=-1)
    k = torch.cat([k_nope, tc["krope"][0][:, :, None, :].expand(
        b, slots, h, a.qk_rope_head_dim)], dim=-1)
    out = A.sdpa(torch.cat([q_nope, q_rope], dim=-1), k, v.contiguous(), q_pos,
                 tc["pos"], causal=True, impl="naive")
    want = m.wo(out.reshape(b, 1, -1))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("impl", ["naive", "chunked", "flash"])
def test_sdpa_takes_a_value_head_dim_unlike_the_query_one(impl):
    """Every SDPA version (and the flash kernel's plain version) takes v of
    another head dim than q/k, and computes what the reference computes by
    padding v to the q/k head dim and slicing the output back."""
    rng = np.random.default_rng(8)
    b, s, h, hd, hd_v = 2, 40, 4, 48, 32
    q, k = (torch.from_numpy(rng.standard_normal((b, s, h, hd), np.float32))
            for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((b, s, h, hd_v), np.float32))
    pos = torch.arange(s, dtype=torch.int32)
    mask = (pos[None, :] < torch.tensor([40, 23])[:, None]).to(torch.int32)
    kw = dict(causal=True, kv_mask=mask, impl=impl, chunk=16)
    got = A.sdpa(q, k, v, pos, pos, **kw)
    padded = torch.nn.functional.pad(v, (0, hd - hd_v))
    want = A.sdpa(q, k, padded, pos, pos, **kw)[..., :hd_v]
    assert got.shape == (b, s, h, hd_v)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


def test_flash_checks_head_dim_pairs():
    """The kernel takes (32,32), (64,64), (128,128) and MLA's (192,128); a
    pair outside them raises before anything else is checked."""
    assert (192, 128) in kf.HEAD_DIM_PAIRS
    pos = torch.arange(4, dtype=torch.int32)
    q = torch.zeros(1, 4, 2, 192)
    for v_dim, match in ((128, "not cuda"), (64, "head dims"), (192, "head dims")):
        with pytest.raises(ValueError, match=match):
            kf._check(q, q, torch.zeros(1, 4, 2, v_dim), pos, pos, None)


# ---- the deepseek-v2-lite token model and denoiser --------------------------


@pytest.mark.parametrize("max_len,prompt_len,steps", [(64, 12, 6), (16, 20, 30)],
                         ids=["cache", "ring-wrap"])
def test_deepseek_prefill_and_decode_match_reference(max_len, prompt_len, steps):
    """Prefill logits and teacher-forced decode logits of the smoke
    deepseek-v2-lite model (MLA + MoE with a shared expert, untied LM head)
    against the reference engine, and the same latent cache."""
    jmodel, params, tmodel = build_model_pair(ARCH)
    assert tmodel.lm_head is not None
    jls, tls, jc, tc = _teacher_forced(
        jmodel, params, tmodel, dict(max_len=max_len), prompt_len=prompt_len,
        steps=steps)
    for step, (j, t) in enumerate(zip(jls, tls)):
        np.testing.assert_allclose(t, j, atol=LOGIT_TOL, err_msg=f"step {step}")
    seg, tseg = jc["0_mla_moe"], tc["0_mla_moe"]
    assert np.array_equal(tseg["pos"].numpy(), np.asarray(seg["pos"][0]))
    _close(tseg["ckv"], seg["ckv"])
    _close(tseg["krope"], seg["krope"])


@pytest.mark.parametrize("masked", [False, True], ids=["full", "lengths"])
def test_era_on_deepseek_denoiser_matches_reference(masked):
    """One ERA run (nfe 6, k 3, per-sample ERS) on the smoke deepseek-v2-lite
    denoiser: x0 and the error histories within tolerance, ERS selections
    equal (the reference's ERA with ``use_fused_update=False``)."""
    jdlm, params, tdlm = build_pair(ARCH, "naive", "auto", seed=1,
                                    head_scale=0.05)
    d = tdlm.config.d_model
    x = _x((2, 8, d), seed=9)
    lengths = np.asarray([8, 5], np.int32) if masked else None
    jl = None if lengths is None else jnp.asarray(lengths)
    tl = None if lengths is None else torch.from_numpy(lengths)
    want, got = run_both(
        jdlm.eps_fn(params, lengths=jl), tdlm.eps_fn(lengths=tl), x,
        AnalyticGaussian().schedule, linear_schedule(), lengths=lengths,
        nfe=6, k=3, per_sample=True)
    assert_runs_agree(want, got, 2e-3, True)


def test_deepseek_bucket_program_makes_no_tensor_from_host_data():
    """The program a seq- and NFE-bucket graph captures on the deepseek-v2-lite
    denoiser (MLA, the MoE dispatch, the ERA loop) builds no tensor from
    host data, as ``test_torch_bucketing`` holds for the dense family."""
    _, _, tdlm = build_pair(ARCH, "naive", "auto", seed=5, head_scale=0.05)
    engine = BatchedSampler(tdlm, linear_schedule(), batch_buckets=(4,),
                            seq_buckets=(8,), nfe_buckets=(8,))
    ex = engine.executor
    reqs = [(0, SampleRequest(batch=1, seq_len=5, nfe=6), 0.0),
            (1, SampleRequest(batch=2, seq_len=8, nfe=8), 0.0)]
    cfg = dataclasses.replace(ex.config_for("era"), nfe=8)
    x_init = torch.from_numpy(_x((4, 8, tdlm.config.d_model), seed=10))
    lengths = torch.tensor([5, 8, 8, 8], dtype=torch.int32)
    steps = ex._step_mask("era", cfg, reqs, 1)
    key = ("era", cfg, 4, 8, True, True)
    ex._run_program(key, x_init, lengths, steps)  # the grid reaches the device
    rec = _HostTensors()
    with rec:
        out = ex._run_program(key, x_init, lengths, steps)
    assert out.x0.shape == x_init.shape
    assert rec.lifted == 0


@pytest.mark.parametrize(
    "arch", ["deepseek-v2-lite-16b", "mixtral-8x7b", "minitron-4b", "deepseek-67b"])
def test_param_count_matches_reference(arch):
    """The port's token model of each full config, built on the meta
    device (shapes only, nothing allocated), has the reference's
    ``param_count()``; its router stays float32 in the bf16 stack."""
    model = build_model(get_config(arch), device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == jbuild_model(jget_config(arch)).param_count()
    if arch == "deepseek-v2-lite-16b":
        assert 16.0e9 < n < 16.5e9
        layer = model.backbone.layers[0]
        assert layer.moe.router.w.dtype == torch.float32
        assert layer.moe.experts.wi.dtype == torch.bfloat16

