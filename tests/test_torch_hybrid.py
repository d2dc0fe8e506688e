"""The port's hybrid family (hymba-1.5b: the ``hymba_swa`` and
``hymba_full`` blocks, the meta-token prefix with its protected ring slots,
per-segment caches) against the JAX reference on the CPU.

The reference initializes the weights (``BLOCKS[kind].specs`` /
``build_model(cfg).init`` / ``DiffusionLM.init``); they move to the port
by their dotted keys (``repro_torch.interop``).  The smoke config runs in
float32: d_model 128, 4 heads over 2 KV heads of 32, window 64, 8 meta
tokens, one ``hymba_full`` and one ``hymba_swa`` layer, chunk 32.

Tolerances: block outputs within ``1e-5 * max|ref| + 1e-6`` (float32
summation order); cache positions and protected slots equal; token-model
logits atol 1e-4 and ERA x0 atol 2e-3 with ERS selections equal, as for the
dense family (``test_torch_engine``, ``test_torch_era``); prefix walls
inside the port bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import AnalyticGaussian
from repro.configs import get_config as jget_config
from repro.models import attention as JA
from repro.models import build_model as jbuild_model
from repro.models import layers as JL
from repro.models.blocks import BLOCKS as JBLOCKS
from repro.models.blocks import BlockCtx
from repro.models.diffusion import DiffusionLM as JDiffusionLM
from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro_torch.configs import get_config
from repro_torch.core import linear_schedule
from repro_torch.interop import _leaves, params_from_jax
from repro_torch.launch import serve
from repro_torch.models import DiffusionLM, build_model
from repro_torch.models import attention as A
from repro_torch.models.blocks import BLOCKS
from repro_torch.serving import Engine, ServeConfig
from test_torch_engine import LOGIT_TOL, _teacher_forced, _tokens
from test_torch_engine import build_pair as build_model_pair
from test_torch_era import assert_runs_agree, run_both
from test_torch_models import build_pair
from test_torch_ssm import _close, _t, _x, fused_equals_solo, no_host_data

ARCH = "hymba-1.5b"
META = 8      # the smoke config's meta tokens
WINDOW = 64   # and its sliding window


def block_pair(kind: str, seed: int = 0):
    jcfg = jget_config(ARCH, smoke=True).with_(attention_impl="naive")
    p = JL.init_params(JBLOCKS[kind].specs(jcfg), jax.random.PRNGKey(seed))
    tcfg = get_config(ARCH, smoke=True)
    m = BLOCKS[kind](tcfg, generator=torch.Generator().manual_seed(0),
                     device="cpu", dtype=torch.float32)
    m.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in _leaves(p)})
    return jcfg, p, m


def test_smoke_config_has_both_segments_and_meta_tokens():
    cfg = get_config(ARCH, smoke=True)
    assert cfg.blocks == (("hymba_full", 1), ("hymba_swa", 1))
    assert (cfg.num_meta_tokens, cfg.sliding_window, cfg.ssm.chunk) == (META, WINDOW, 32)


@pytest.mark.parametrize("kind", ["hymba_swa", "hymba_full"])
@pytest.mark.parametrize("case", ["causal-past-window", "bidirectional-lengths"])
def test_hymba_blocks_match_reference(kind, case):
    """One block against the reference's ``BLOCKS[kind].apply`` in train
    mode: causal over 80 positions with 8 protected (the window of 64
    bites in ``hymba_swa``), and bidirectional with per-row lengths, as
    the denoiser runs it."""
    jcfg, p, m = block_pair(kind)
    if case == "causal-past-window":
        x, lengths, causal, prot = _x((2, 80, jcfg.d_model), 3), None, True, META
    else:
        x, causal, prot = _x((3, 12, jcfg.d_model), 4), False, 0
        lengths = np.asarray([12, 7, 3], np.int32)
    ctx = BlockCtx(mode="train", causal=causal, protected=prot,
                   lengths=None if lengths is None else jnp.asarray(lengths))
    want, _, _ = JBLOCKS[kind].apply(p, jnp.asarray(x), None, ctx, jcfg)
    got = m(_t(x), causal=causal, protected=prot,
            lengths=None if lengths is None else _t(lengths))
    _close(got, want)


# ---- the cache: protected slots, and a prefill longer than the ring ---------


@pytest.mark.parametrize("prompt", [40, 90], ids=["fits", "evicts-protected"])
def test_protected_ring_matches_reference(prompt):
    """cache_fill then 40 cache_insert steps with 8 protected slots in a
    72-slot ring (hymba_swa's window + meta), slot for slot against the
    reference.  A prefill longer than the ring keeps its last 72 entries
    from slot 0, which evicts the protected prefix: the reference's quirk
    (ROADMAP queue 3), mirrored, not fixed."""
    slots, b, kvh, hd = WINDOW + META, 2, 2, 4
    k = _x((b, prompt, kvh, hd), 1)
    jc = JA.cache_fill(JA.init_cache(b, slots, kvh, hd, jnp.float32),
                       jnp.asarray(k), jnp.asarray(k), jnp.int32(0))
    tc = A.init_cache(1, b, slots, kvh, hd, torch.float32, "cpu")
    keep = A.cache_fill(tc, prompt)
    A.cache_write(tc, 0, _t(k[:, prompt - keep :]), _t(k[:, prompt - keep :]), 0)
    for pos in range(prompt, prompt + 40):
        k1 = _x((b, 1, kvh, hd), pos)
        jc = JA.cache_insert(jc, jnp.asarray(k1), jnp.asarray(k1), jnp.int32(pos), META)
        slot = A.cache_insert(tc, pos, META)
        A.cache_write(tc, 0, _t(k1), _t(k1), slot)
        assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"])), pos
        assert np.array_equal(tc["k"][0].numpy(), np.asarray(jc["k"])), pos
    held = tc["pos"][:META].tolist()
    assert (held == list(range(META))) == (prompt + META <= slots)


# ---- the token model --------------------------------------------------------


@pytest.mark.parametrize("max_len,prompt_len,steps", [(64, 12, 6), (40, 20, 30)],
                         ids=["short", "ring-wrap"])
def test_hymba_prefill_and_decode_match_reference(max_len, prompt_len, steps):
    """Prefill logits (meta tokens first) and teacher-forced decode logits
    against the reference engine, through a ring that wraps past its
    protected meta slots; every segment's slot positions and Mamba state."""
    jmodel, params, tmodel = build_model_pair(ARCH)
    jls, tls, jc, tc = _teacher_forced(
        jmodel, params, tmodel, dict(max_len=max_len), prompt_len=prompt_len,
        steps=steps)
    for step, (j, t) in enumerate(zip(jls, tls)):
        np.testing.assert_allclose(t, j, atol=LOGIT_TOL, err_msg=f"step {step}")
    assert set(tc) == set(jc) == {"0_hymba_full", "1_hymba_swa"}
    for key in jc:
        ring = tc[key]["attn"]
        assert np.array_equal(ring["pos"].numpy(), np.asarray(jc[key]["attn"]["pos"][0]))
        assert ring["pos"][:META].tolist() == list(range(META))
        _close(tc[key]["ssm"]["ssm"], jc[key]["ssm"]["ssm"], rel=1e-4)


@pytest.mark.parametrize("prompt_len,steps", [(40, 40), (80, 20)],
                         ids=["swa-wraps-protected-holds", "prefill-evicts"])
def test_hymba_segment_rings_differ_and_match_reference(prompt_len, steps):
    """With 128 slots, more than window + meta (72), the hymba_swa ring has
    72 slots and the hymba_full ring 128: the two segment caches differ.
    Teacher-forced decode logits against the reference's ``Model.prefill``
    / ``decode`` at the same slots, and each ring's positions: a 48-position
    prefill whose decode wraps the swa ring with its 8 protected slots
    held, and an 88-position prefill that the swa ring cannot hold (the
    eviction quirk)."""
    jmodel, params, tmodel = build_model_pair(ARCH)
    cfg = tmodel.config
    toks = _tokens(cfg.vocab_size, (2, prompt_len + steps), 7)
    jl, jc = jmodel.prefill(params, {"tokens": jnp.asarray(toks[:, :prompt_len])}, 128)
    tl, tc = tmodel.prefill(_t(toks[:, :prompt_len]), 128)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL)
    assert tc["0_hymba_full"]["attn"]["pos"].shape == (128,)
    assert tc["1_hymba_swa"]["attn"]["pos"].shape == (WINDOW + META,)
    for i in range(prompt_len, prompt_len + steps):
        pos = META + i
        jl, jc = jmodel.decode(params, jc, {"tokens": jnp.asarray(toks[:, i : i + 1]),
                                            "pos": jnp.int32(pos)})
        tl, tc = tmodel.decode(tc, _t(toks[:, i : i + 1]), pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                                   err_msg=f"pos {pos}")
    for key in jc:
        assert np.array_equal(tc[key]["attn"]["pos"].numpy(),
                              np.asarray(jc[key]["attn"]["pos"][0])), key
    swa = tc["1_hymba_swa"]["attn"]["pos"]
    if prompt_len + META <= WINDOW + META:
        assert swa[:META].tolist() == list(range(META))
        assert int(swa.max()) == META + prompt_len + steps - 1


def test_hymba_decode_matches_forward():
    """The reference's ``test_decode_matches_forward`` in the port: a
    12-token prefill (after the 8 meta tokens) then 4 decode steps at
    positions offset by the meta tokens reproduce the teacher-forcing
    logits."""
    _, _, tmodel = build_model_pair(ARCH)
    toks = _t(_tokens(tmodel.config.vocab_size, (2, 16), 3))
    full = tmodel(toks)
    assert full.shape[1] == META + 16
    lg, cache = tmodel.prefill(toks[:, :12], 64)
    np.testing.assert_allclose(lg[:, 0].numpy(), full[:, META + 11].numpy(), atol=2e-5)
    for t in range(12, 16):
        lg, cache = tmodel.decode(cache, toks[:, t : t + 1], META + t)
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, META + t].numpy(),
                                   atol=2e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_hymba_greedy_generate_matches_reference_tokens(seed):
    """``Engine.generate`` starts decoding at num_meta_tokens + prompt
    length, as the reference's does: the same greedy tokens."""
    jmodel, params, tmodel = build_model_pair(ARCH)
    prompts = _tokens(tmodel.config.vocab_size, (2, 12), seed)
    want = JEngine(jmodel, JServeConfig(max_len=64)).generate(
        params, jnp.asarray(prompts), 12)
    got = Engine(tmodel, ServeConfig(max_len=64)).generate(_t(prompts), 12)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_param_count_matches_reference():
    """The full hymba-1.5b token model on the meta device has the
    reference's ``param_count()`` (meta tokens included); Mamba's ``A_log``
    and ``D`` stay float32 in the bf16 stack."""
    model = build_model(get_config(ARCH), device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == jbuild_model(jget_config(ARCH)).param_count()
    assert 1.2e9 < n < 2.2e9
    assert model.meta.shape == (128, 1600)
    mb = model.backbone.layers[1].mamba
    assert mb.A_log.dtype == mb.D.dtype == torch.float32
    assert mb.in_proj.w.dtype == torch.bfloat16


# ---- the hymba denoiser -------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True], ids=["full", "lengths"])
def test_era_on_hymba_denoiser_matches_reference(masked):
    """One ERA run (nfe 6, k 3, per-sample ERS) on the smoke hymba denoiser
    (bidirectional attention, left-to-right Mamba, no meta tokens): x0
    within 2e-3, ERS selections equal."""
    jdlm, params, tdlm = build_pair(ARCH, "naive", "auto", seed=1, head_scale=0.05)
    x = _x((2, 8, tdlm.config.d_model), 9)
    lengths = np.asarray([8, 5], np.int32) if masked else None
    jl = None if lengths is None else jnp.asarray(lengths)
    tl = None if lengths is None else torch.from_numpy(lengths)
    want, got = run_both(
        jdlm.eps_fn(params, lengths=jl), tdlm.eps_fn(lengths=tl), x,
        AnalyticGaussian().schedule, linear_schedule(), lengths=lengths,
        nfe=6, k=3, per_sample=True)
    assert_runs_agree(want, got, 2e-3, True)


def test_hymba_denoiser_has_no_meta_tokens_and_mamba_runs_left_to_right():
    """The denoiser's state dict has no ``meta`` (interop drops it with the
    embedding).  Its attention is bidirectional, its Mamba left to right:
    a change at the last position moves every earlier eps, where the
    Mamba half alone would move none."""
    _, _, tdlm = build_pair(ARCH, "naive", "auto", seed=0)
    assert not any("meta" in k for k in tdlm.state_dict())
    x = _x((1, 10, tdlm.config.d_model), 5)
    y = x.copy()
    y[:, -1] += 1.0
    e1, e2 = tdlm.eps(_t(x), 0.5), tdlm.eps(_t(y), 0.5)
    assert bool((e1[:, :-1] != e2[:, :-1]).any(dim=-1).all())
    m = tdlm.backbone.layers[0].mamba
    h1, h2 = m(_t(x).to(torch.float32))[0], m(_t(y))[0]
    assert torch.equal(h1[:, :-1], h2[:, :-1])


def test_hymba_eps_prefix_bitwise():
    """Inside the port: a padded, masked batch gives the exact-shape eps on
    the prefix bitwise and exact zeros on the pad tail (random eps head)."""
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


def test_bf16_keeps_a_log_and_d_float32_and_eps_near_reference():
    """At bf16 compute (the full-width dtype) Mamba's ``A_log`` and ``D``
    are stored float32, as the reference computes with them (a bf16
    ``A_log`` would move every decay exp(dt * A)), and eps stays near the
    reference's bf16 eps: within 2 * |ref_bf16 - ref_f32| + 0.02."""
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
    for layer in tdlm.backbone.layers:
        assert layer.mamba.A_log.dtype == layer.mamba.D.dtype == torch.float32
        assert layer.mamba.in_proj.w.dtype == layer.attn.wq.w.dtype == torch.bfloat16
    x = _x((2, 40, d), 3)
    want = np.asarray(jdlm.eps(params, jnp.asarray(x), jnp.float32(0.6)))
    f32 = JDiffusionLM(jbuild_model(jcfg.with_(dtype=jnp.float32)))
    want32 = np.asarray(f32.eps(params, jnp.asarray(x), jnp.float32(0.6)))
    got = tdlm.eps(_t(x), 0.6).numpy()
    ref_err = float(np.abs(want - want32).max())
    assert float(np.abs(got - want).max()) <= 2 * ref_err + 0.02, ref_err


# ---- serving -----------------------------------------------------------------


def test_hymba_fused_requests_equal_their_solo_drains():
    _, _, tdlm = build_pair(ARCH, "naive", "auto", seed=4, head_scale=0.05)
    fused_equals_solo(tdlm)


def test_hymba_bucket_program_makes_no_tensor_from_host_data():
    _, _, tdlm = build_pair(ARCH, "naive", "auto", seed=5, head_scale=0.05)
    no_host_data(tdlm)


@pytest.mark.parametrize("mode", ["ar", "diffusion"])
def test_launcher_serves_hymba(mode, capsys):
    serve.main(["--smoke", "--device", "cpu", "--arch", ARCH, "--mode", mode,
                "--batch", "2", "--prompt-len", "8", "--gen", "3", "--seq", "8",
                "--nfe", "5"])
    out = capsys.readouterr().out
    assert out.startswith("generated (2, 3)" if mode == "ar"
                          else "sampled latents (2, 8, 128)"), out
