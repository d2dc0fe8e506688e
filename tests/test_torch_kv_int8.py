"""The port's int8 KV cache (``kv_quant="int8"``) against the JAX
reference on the CPU.

Quantization is elementwise arithmetic on the same float32 inputs in both
packages: the int8 entries are held equal and the scales to 1e-7 relative
(float32 division may round the last bit differently).  The round trip
keeps the reference's own bound, 0.02 of max|x|
(``tests/test_attention.py``).  Decode logits with int8 caches, port
against reference on the reference's weights, are held to the tolerance
the full-cache AR parity tests use for each family (1e-4 for the dense
and hybrid families, 1e-3 for whisper's untied head): K/V that the two
packages compute ~1e-6 apart can land on either side of a rounding
boundary, so a cache entry may differ by one int8 step, which the logits
absorb well inside that tolerance.  The port's int8 cache against its own
full-precision cache stays within the reference's bound, 0.2 of the
logits' scale over 6 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import frontend_features as jfrontend_features
from repro.models import attention as JA
from repro.models import build_model as jbuild_model
from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro_torch.configs import get_config
from repro_torch.interop import model_params_from_jax
from repro_torch.models import attention as A
from repro_torch.models import build_model
from repro_torch.serving import Engine, ServeConfig
from test_torch_engine import _tokens

# family tolerances of the full-cache AR parity tests
LOGIT_TOL = {"llama3.2-1b": 1e-4, "hymba-1.5b": 1e-4, "whisper-base": 1e-3}


def _pair(arch: str, seed: int = 0):
    jcfg = jget_config(arch, smoke=True).with_(kv_quant="int8")
    jmodel = jbuild_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed))
    tcfg = get_config(arch, smoke=True).with_(kv_quant="int8")
    tmodel = build_model(tcfg, device="cpu", seed=seed)
    tmodel.load_state_dict(
        model_params_from_jax(jax.tree.map(np.asarray, params), tcfg))
    return jmodel, params, tmodel


def _extras(cfg, batch: int) -> dict:
    if cfg.family != "audio":
        return {}
    f = jfrontend_features(np.random.default_rng(3), batch,
                           cfg.frontend.num_positions, cfg.d_model)
    return {"frames": np.asarray(f, np.float32)}


@pytest.mark.parametrize("scale", [1e-3, 1.0, 3.0, 1e3])
def test_quantize_matches_reference(scale):
    x = np.random.default_rng(0).standard_normal((2, 8, 4, 32)).astype(
        np.float32) * scale
    x[0, 0, 0] = 0.0          # an all-zero head: the 1e-8 scale floor
    x[1, 2, 1, 5] = 0.5 * 127  # a tie at .5 after the divide (to even)
    jq, js = JA._quantize(jnp.asarray(x))
    tq, ts = A._quantize(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tq.shape == x.shape and ts.shape == x.shape[:-1] + (1,)
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7, atol=0)
    assert float(ts[0, 0, 0, 0]) == np.float32(1e-8)


def test_round_trip_error():
    """The reference's own round-trip bound, on the same draw scale."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 8, 4, 32)).astype(np.float32) * 3.0)
    q, s = A._quantize(x)
    back = A._dequant(q, s, torch.float32)
    rel = float((back - x).abs().max() / x.abs().max())
    assert q.dtype == torch.int8
    assert rel < 0.02
    assert A._dequant(q, s, torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize(
    "arch,kinds",
    [("llama3.2-1b", {"0_dense": "int8"}),
     ("hymba-1.5b", {"0_hymba_full": "int8", "1_hymba_swa": "int8"}),
     ("whisper-base", {"0_xdec": "int8"}),
     ("deepseek-v2-lite-16b", {"0_mla_moe": "latent"})])
def test_cache_layout_mirrors_reference(arch, kinds):
    """Which caches are quantized, and their leaves' shapes and dtypes: the
    reference's ``_attn_cache`` rings (dense, hymba's ring with its
    protected slots, whisper's self-attention), never MLA's latent ring or
    whisper's cross K/V."""
    jcfg = jget_config(arch, smoke=True).with_(kv_quant="int8")
    jc = jbuild_model(jcfg).init_cache(2, 40)
    tmodel = build_model(get_config(arch, smoke=True).with_(kv_quant="int8"),
                         device="meta")
    tc = tmodel.init_cache(2, 40)
    assert set(tc) == set(jc) == set(kinds)
    for key, kind in kinds.items():
        ring = tmodel.rings(tc)[list(kinds).index(key)]
        jseg = jc[key]
        jring = (jseg["attn"] if "attn" in jseg
                 else jseg["self"] if "self" in jseg else jseg)
        if kind == "latent":
            assert "k_scale" not in ring and "k_scale" not in jring
            continue
        for leaf in ("k", "v", "k_scale", "v_scale"):
            assert ring[leaf].dtype == {"k": torch.int8, "v": torch.int8}.get(
                leaf, torch.float32)
            assert str(jring[leaf].dtype) == str(ring[leaf].dtype).split(".")[1]
            assert tuple(ring[leaf].shape) == tuple(jring[leaf].shape), leaf
        if "xk" in jseg:
            assert tc[key]["xk"].dtype == torch.float32   # the smoke dtype
            assert str(jseg["xk"].dtype) == "float32"


def test_cache_bytes_at_full_width():
    """qwen2-1.5b (KV 2, hd 128): 2 x (128 int8 + 4 B of scale) = 264 B a
    K/V pair and slot, 528 with both, against 1,024 in bf16."""
    cfg = get_config("qwen2-1.5b")
    full = build_model(cfg, device="meta").init_cache(1, 1)
    quant = build_model(cfg.with_(kv_quant="int8"), device="meta").init_cache(1, 1)

    def kv_bytes(cache):
        ring = cache["0_dense"]
        return sum(t.numel() * t.element_size() for name, t in ring.items()
                   if name != "pos") / cfg.num_layers

    assert kv_bytes(full) == 1024 and kv_bytes(quant) == 528


@pytest.mark.parametrize(
    "arch,max_len,prompt_len,steps",
    [("llama3.2-1b", 64, 12, 6), ("hymba-1.5b", 40, 20, 30),
     ("whisper-base", 16, 10, 12)],
    ids=["llama", "hymba-protected-ring-wrap", "whisper-ring-wrap"])
def test_int8_decode_matches_reference(arch, max_len, prompt_len, steps):
    """Prefill and teacher-forced decode logits with int8 caches, port
    against reference, through a ring that wraps (hymba: past its protected
    meta slots); the caches' int8 entries within one step and their scales
    and slot positions equal."""
    jmodel, params, tmodel = _pair(arch)
    cfg = tmodel.config
    tol = LOGIT_TOL[arch]
    je = JEngine(jmodel, JServeConfig(max_len=max_len))
    te = Engine(tmodel, ServeConfig(max_len=max_len))
    extras = _extras(cfg, 2)
    prompts = _tokens(cfg.vocab_size, (2, prompt_len), 1)
    stream = _tokens(cfg.vocab_size, (2, steps), 101)
    jl, jc = je.prefill_step(params, {"tokens": jnp.asarray(prompts),
                                      **{k: jnp.asarray(v) for k, v in extras.items()}})
    tl, tc = te.prefill_step(torch.from_numpy(prompts), extras={
        k: torch.from_numpy(v) for k, v in extras.items()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol)
    first = cfg.num_meta_tokens + prompt_len
    for i in range(steps):
        dec = {"tokens": jnp.asarray(stream[:, i : i + 1]),
               "pos": jnp.int32(first + i)}
        jl, jc = je.decode_step(params, jc, dec)
        tl, tc = te.decode_step(tc, torch.from_numpy(stream[:, i : i + 1]),
                                first + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol,
                                   err_msg=f"step {i}")
    for ring, key in zip(tmodel.rings(tc), tc):
        jseg = jc[key]
        jring = jseg.get("attn", jseg.get("self", jseg))
        assert ring["k"].dtype == torch.int8
        assert np.array_equal(ring["pos"].numpy(), np.asarray(jring["pos"][0]))
        for leaf in ("k", "v"):
            diff = np.abs(ring[leaf].numpy().astype(np.int32)
                          - np.asarray(jring[leaf]).astype(np.int32))
            assert diff.max() <= 1 and diff.mean() < 0.01, (leaf, diff.max())
            np.testing.assert_allclose(ring[f"{leaf}_scale"].numpy(),
                                       np.asarray(jring[f"{leaf}_scale"]),
                                       rtol=1e-4)


def _half_steps(cf: dict, cq: dict, slots: slice, layers: slice = slice(None)) -> float:
    """Largest |dequantized int8 - full| over half a quantization step, of
    K and V over ``layers`` and ``slots``: at most 1 (float32 rounding
    aside) when the int8 entries are the full cache's rounded to nearest."""
    ring, qring = cf["0_dense"], cq["0_dense"]
    worst = 0.0
    for name in ("k", "v"):
        q, scale = qring[name][layers, :, slots], qring[f"{name}_scale"][layers, :, slots]
        diff = (q.float() * scale - ring[name][layers, :, slots].float()).abs()
        worst = max(worst, float((diff / (0.5 * scale)).max()))
    return worst


def _teacher_forced(plant: bool):
    """llama3.2-1b (smoke) with the full and the int8 cache on the same
    weights, prompt 12 then 6 greedy steps of the full-cache engine's
    tokens: (worst logits error over max|logit|, both caches)."""
    cfg = get_config("llama3.2-1b", smoke=True)
    full = build_model(cfg, device="cpu")
    quant = build_model(cfg.with_(kv_quant="int8"), device="cpu")
    quant.load_state_dict(full.state_dict())
    ef, eq = Engine(full, ServeConfig(max_len=64)), Engine(quant, ServeConfig(max_len=64))
    prompts = torch.from_numpy(_tokens(cfg.vocab_size, (2, 12), 0))
    lf, cf = ef.prefill_step(prompts)
    lq, cq = eq.prefill_step(prompts)
    if plant:
        cq["0_dense"]["k"][1].zero_()
    worst = 0.0
    for i in range(6):
        nxt = torch.argmax(lf[:, -1, : cfg.vocab_size], dim=-1)[:, None]
        lf, cf = ef.decode_step(cf, nxt, 12 + i)
        lq, cq = eq.decode_step(cq, nxt, 12 + i)
        worst = max(worst, float((lf - lq).abs().max() / lf.abs().max()))
    return worst, cf, cq


def test_int8_against_full_cache_in_the_port():
    """The reference's ``test_int8_kv_decode_matches_full`` on the port: the
    int8 engine's decode logits within 0.2 of the full cache's scale over 6
    greedy steps of the full-cache engine's tokens.  A layer's int8 ``k``
    zeroed after the prefill moves them further (the bound is too loose to
    rely on for that: the cache check below is what must see it)."""
    clean, _, _ = _teacher_forced(plant=False)
    fault, _, _ = _teacher_forced(plant=True)
    assert clean < 0.2
    assert fault > clean


def test_int8_cache_holds_the_full_cache_rounded():
    """Where both engines wrote the same K/V (every layer's prompt slots,
    and layer 0's decode slots, whose K/V come from the same token), the
    int8 entries are the full cache's rounded to nearest.  The check sees a
    layer's ``k`` zeroed after the prefill, and a decode step's K scale
    copied into the next step's slot (a scale written to the wrong slot)."""
    prompt, decode = slice(0, 12), slice(12, 18)
    _, cf, cq = _teacher_forced(plant=False)
    assert _half_steps(cf, cq, prompt) <= 1.001
    assert _half_steps(cf, cq, decode, slice(0, 1)) <= 1.001
    scale = cq["0_dense"]["k_scale"][0]
    scale[:, 15] = scale[:, 14]
    assert _half_steps(cf, cq, decode, slice(0, 1)) > 1.001
    _, cf, cq = _teacher_forced(plant=True)
    assert _half_steps(cf, cq, prompt) > 1.001


def test_int8_generate_runs_and_rejects_other_modes():
    cfg = get_config("llama3.2-1b", smoke=True).with_(kv_quant="int8")
    toks = Engine(build_model(cfg, device="cpu"), ServeConfig(max_len=32)).generate(
        torch.from_numpy(_tokens(cfg.vocab_size, (2, 8), 2)), 5)
    assert toks.shape == (2, 5) and toks.dtype == torch.int32
    with pytest.raises(ValueError, match="kv_quant"):
        build_model(cfg.with_(kv_quant="int4"), device="cpu")
