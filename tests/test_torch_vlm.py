"""The port's vlm family (paligemma-3b: the Gemma decoder as dense blocks
with geglu MLPs and one KV head, the image-patch prefix, Gemma's embedding
scale) against the JAX reference on the CPU.

The reference initializes the weights (``build_model(cfg).init`` /
``DiffusionLM.init``); they move to the port by their dotted keys
(``repro_torch.interop``).  The smoke config runs in float32: d_model 128,
4 heads over 1 KV head of 32, two layers, 16 stub patches of width 128,
drawn with the port's ``frontend_features`` from one numpy generator for
both packages.

Tolerances: token-model logits atol 1e-4 and ERA x0 atol 2e-3 with ERS
selections equal, as for the dense family (``test_torch_engine``,
``test_torch_era``; the LM head is tied to the 0.02-scale embedding, so the
logits stay small); the bf16 embedding scale bitwise (one rounding of one
product in both packages); the prefix wall inside the port bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import AnalyticGaussian
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models import model as JM
from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro_torch.configs import get_config
from repro_torch.core import linear_schedule
from repro_torch.data import frontend_features
from repro_torch.interop import model_params_from_jax
from repro_torch.models import build_model
from repro_torch.serving import Engine, ServeConfig
from test_torch_audio import era_drain_matches_reference
from test_torch_engine import LOGIT_TOL, _tokens
from test_torch_engine import build_pair as build_model_pair
from test_torch_era import assert_runs_agree, run_both
from test_torch_models import build_pair
from test_torch_ssm import _t, _x, fused_equals_solo, no_host_data

ARCH = "paligemma-3b"
PATCHES = 16  # the smoke config's stub patches


def patches(batch: int, seed: int = 0) -> np.ndarray:
    d = get_config(ARCH, smoke=True).d_model
    return frontend_features(np.random.default_rng(seed), batch, PATCHES, d)


def test_smoke_config_is_gemma_shaped():
    cfg = get_config(ARCH, smoke=True)
    assert cfg.blocks == (("dense", 2),) and cfg.mlp_act == "gelu"
    assert (cfg.num_kv_heads, cfg.resolved_head_dim, cfg.tie_embeddings) == (1, 32, True)
    assert (cfg.frontend.kind, cfg.frontend.num_positions,
            cfg.frontend.feature_dim) == ("vision", PATCHES, 128)
    full = get_config(ARCH)
    assert (full.num_heads, full.num_kv_heads, full.resolved_head_dim) == (8, 1, 256)


def test_gemma_scale_rounds_to_the_compute_dtype():
    """``sqrt(d_model)`` is rounded to the compute dtype before the
    multiply: 45.25 in bf16 at full width (not 45.2548), the reference's
    ``jnp.asarray(d ** 0.5, dtype)``; at smoke size in bf16 the scaled
    embeddings equal the reference's ``_embed_tokens`` bitwise."""
    full = build_model(get_config(ARCH), device="meta")
    assert full.embed_scale == 45.25
    assert full.embed_scale == float(jnp.asarray(2048 ** 0.5, jnp.bfloat16))
    jcfg = jget_config(ARCH, smoke=True).with_(dtype=jnp.bfloat16)
    jmodel = jbuild_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    tcfg = get_config(ARCH, smoke=True).with_(dtype=torch.bfloat16)
    tmodel = build_model(tcfg, device="cpu")
    tmodel.load_state_dict(model_params_from_jax(jax.tree.map(np.asarray, params), tcfg))
    assert tmodel.embed_scale == float(jnp.asarray(128 ** 0.5, jnp.bfloat16))
    toks = _tokens(tcfg.vocab_size, (2, 9), 3)
    want = np.asarray(JM._embed_tokens(params, jnp.asarray(toks), jcfg).astype(jnp.float32))
    got = tmodel._embed(_t(toks), pos=0).to(torch.float32).numpy()
    assert np.array_equal(got, want)


def test_forward_puts_the_patches_first():
    """Teacher-forcing logits over the patches then the tokens (B, P + S,
    V) against the reference's ``forward``; a prefill of the patches and 8
    tokens, then 4 decode steps at positions P + 8.., reproduce them."""
    jmodel, params, tmodel = build_model_pair(ARCH)
    p, toks = patches(2, 1), _tokens(tmodel.config.vocab_size, (2, 12), 2)
    want, _ = jmodel.forward(params, {"tokens": jnp.asarray(toks),
                                      "patches": jnp.asarray(p)})
    full = tmodel(_t(toks), patches=_t(p))
    assert full.shape == (2, PATCHES + 12, tmodel.config.padded_vocab)
    np.testing.assert_allclose(full.numpy(), np.asarray(want), atol=LOGIT_TOL)
    lg, cache = tmodel.prefill(_t(toks[:, :8]), 64, patches=_t(p))
    np.testing.assert_allclose(lg[:, 0].numpy(), full[:, PATCHES + 7].numpy(), atol=2e-5)
    assert cache["0_dense"]["pos"][: PATCHES + 8].tolist() == list(range(PATCHES + 8))
    for t in range(8, 12):
        lg, cache = tmodel.decode(cache, _t(toks[:, t : t + 1]), PATCHES + t)
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, PATCHES + t].numpy(),
                                   atol=2e-5)
    with pytest.raises(ValueError, match="patches"):
        tmodel(_t(toks))


@pytest.mark.parametrize("max_len,prompt_len,steps", [(64, 12, 6), (32, 12, 12)],
                         ids=["short", "ring-wrap"])
def test_paligemma_prefill_and_decode_match_reference(max_len, prompt_len, steps):
    """Prefill logits after the patch prefix, then teacher-forced decode
    logits at positions P + prompt.., step by step against the reference
    engine, also through a ring that wraps over the patch slots."""
    jmodel, params, tmodel = build_model_pair(ARCH)
    cfg = tmodel.config
    je, te = JEngine(jmodel, JServeConfig(max_len=max_len)), Engine(
        tmodel, ServeConfig(max_len=max_len))
    p = patches(2, 3)
    prompts = _tokens(cfg.vocab_size, (2, prompt_len), 1)
    stream = _tokens(cfg.vocab_size, (2, steps), 101)
    jl, jc = je.prefill_step(params, {"tokens": jnp.asarray(prompts),
                                      "patches": jnp.asarray(p)})
    tl, tc = te.prefill_step(_t(prompts), extras={"patches": _t(p)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL)
    for i in range(steps):
        pos = PATCHES + prompt_len + i
        jl, jc = je.decode_step(params, jc, {"tokens": jnp.asarray(stream[:, i : i + 1]),
                                             "pos": jnp.int32(pos)})
        tl, tc = te.decode_step(tc, _t(stream[:, i : i + 1]), pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                                   err_msg=f"pos {pos}")
    assert np.array_equal(tc["0_dense"]["pos"].numpy(),
                          np.asarray(jc["0_dense"]["pos"][0]))


@pytest.mark.parametrize("seed", [0, 1])
def test_paligemma_greedy_generate_matches_reference_tokens(seed):
    """``Engine.generate`` with the patches in ``extras`` starts decoding at
    P + prompt length, as the reference does: the same greedy tokens; a
    first position that did not count the patches gives other logits."""
    jmodel, params, tmodel = build_model_pair(ARCH)
    prompts = _tokens(tmodel.config.vocab_size, (2, 12), seed)
    p = patches(2, seed)
    want = JEngine(jmodel, JServeConfig(max_len=64)).generate(
        params, jnp.asarray(prompts), 12, extras={"patches": jnp.asarray(p)})
    eng = Engine(tmodel, ServeConfig(max_len=64))
    got = eng.generate(_t(prompts), 12, extras={"patches": _t(p)})
    assert np.array_equal(got.numpy(), np.asarray(want))
    lg, cache = eng.prefill_step(_t(prompts), extras={"patches": _t(p)})
    tok = eng.sample_token(lg)[:, None]
    right = tmodel.decode({k: {n: t.clone() for n, t in v.items()}
                           for k, v in cache.items()}, tok, PATCHES + 12)[0]
    wrong = tmodel.decode(cache, tok, 12)[0]
    assert not torch.allclose(right, wrong)


def test_param_count_matches_reference():
    """The full paligemma-3b token model on the meta device has the
    reference's ``param_count()`` (tied embeddings, geglu MLPs)."""
    model = build_model(get_config(ARCH), device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == jbuild_model(jget_config(ARCH)).param_count()
    assert 2.0e9 < n < 3.0e9
    assert model.lm_head is None and model.pos_embed is None
    assert model.backbone.layers[0].attn.wk.w.shape == (2048, 256)


# ---- the paligemma denoiser -------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True], ids=["full", "lengths"])
def test_era_on_paligemma_denoiser_matches_reference(masked):
    """One ERA run (nfe 6, k 3, per-sample ERS) on the smoke paligemma
    denoiser (bidirectional, one KV head, geglu): x0 within 2e-3, ERS
    selections equal."""
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


def test_era_drain_matches_reference():
    """Three requests drained through ``BatchedSampler`` on the paligemma
    denoiser against the reference's sampler on the same noise."""
    era_drain_matches_reference(ARCH)


def test_paligemma_denoiser_is_bidirectional_and_prefix_bitwise():
    """The denoiser attends both ways (a later token moves earlier eps) and
    holds no patches or embedding scale; inside the port a right-padded,
    masked batch gives the exact-shape eps on the prefix bitwise and exact
    zeros on the pad tail."""
    _, _, tdlm = build_pair(ARCH, "naive", "auto", seed=0)
    d = tdlm.config.d_model
    x = _x((2, 5, d), 1)
    y = x.copy()
    y[:, -1] += 1.0
    assert bool((tdlm.eps(_t(x), 0.7)[:, :-1] != tdlm.eps(_t(y), 0.7)[:, :-1]).any())
    xp = np.concatenate([x, np.zeros((2, 4, d), np.float32)], 1)
    lengths = torch.full((2,), 5, dtype=torch.int32)
    exact = tdlm.eps(_t(x), 0.7)
    assert torch.equal(tdlm.eps(_t(x), 0.7, lengths=lengths), exact)
    padded = tdlm.eps(_t(xp), 0.7, lengths=lengths)
    assert torch.equal(padded[:, :5], exact)
    assert bool((padded[:, 5:] == 0).all())


def test_paligemma_fused_requests_equal_their_solo_drains():
    _, _, tdlm = build_pair(ARCH, "naive", "auto", seed=4, head_scale=0.05)
    fused_equals_solo(tdlm)


def test_paligemma_bucket_program_makes_no_tensor_from_host_data():
    _, _, tdlm = build_pair(ARCH, "naive", "auto", seed=5, head_scale=0.05)
    no_host_data(tdlm)
