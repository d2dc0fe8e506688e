"""The port's autoregressive path (KV cache, ``Model.prefill`` /
``Model.decode``, ``Engine``, the serve launcher) against the JAX
reference on the CPU.

The reference initializes the weights (``repro.models.build_model(cfg)
.init``); they move to the port through
``repro_torch.interop.model_params_from_jax``.  Smoke configs run in
float32; the reference runs with ``JAX_PLATFORMS=cpu`` and the port with
``device="cpu"``, so decode goes through the kernel's plain version.

Tolerances:

* Cache writes copy values: exact.
* Logits: atol 1e-4.  With the reference's init the residual stream of the
  smoke models grows to ~1e2-1e3, where float32 summation-order rounding
  is ~1e-5-1e-4 absolute; the final rmsnorm carries it to the unit-scale
  hidden state, and the logits (hidden · 0.02-scale embedding rows, |l| <
  ~1.5) keep it below 1e-4 (3.4e-5 is the largest seen).
* Decode compares teacher-forced logits (the same token stream fed to
  both), as ``tests/test_attention.py`` does: greedy tokens of an untrained
  model are argmax-fragile, so token equality is checked only on chosen
  seeds.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as JA
from repro.models import build_model as jbuild_model
from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro.serving import engine as jengine
from repro_torch.configs import get_config
from repro_torch.interop import model_params_from_jax
from repro_torch.models import attention as A
from repro_torch.models import build_model
from repro_torch.serving import Engine, ServeConfig, cache_slots, resolve_window

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ["qwen2-1.5b", "llama3.2-1b"]
LOGIT_TOL = 1e-4


def build_pair(arch: str, seed: int = 0):
    jcfg = jget_config(arch, smoke=True)
    jmodel = jbuild_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed))
    tcfg = get_config(arch, smoke=True)
    tmodel = build_model(tcfg, device="cpu", seed=seed)
    tmodel.load_state_dict(
        model_params_from_jax(jax.tree.map(np.asarray, params), tcfg)
    )
    return jmodel, params, tmodel


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return build_pair(request.param)


def _tokens(vocab: int, shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _teacher_forced(jmodel, params, tmodel, serve: dict, prompt_len: int,
                    steps: int, seed: int = 1):
    """Prefill a (2, prompt_len) prompt in both packages, then feed both the
    same ``steps``-token stream; returns the per-step logits of each and the
    final caches."""
    cfg = tmodel.config
    je = JEngine(jmodel, JServeConfig(**serve))
    te = Engine(tmodel, ServeConfig(**serve))
    wo = serve.get("window_override", -1)
    prompts = _tokens(cfg.vocab_size, (2, prompt_len), seed)
    stream = _tokens(cfg.vocab_size, (2, steps), seed + 100)
    jl, jc = je.prefill_step(params, {"tokens": jnp.asarray(prompts)}, wo)
    tl, tc = te.prefill_step(torch.from_numpy(prompts), wo)
    jls, tls = [np.asarray(jl)], [tl.numpy()]
    for i in range(steps):
        dec = {"tokens": jnp.asarray(stream[:, i : i + 1]),
               "pos": jnp.int32(prompt_len + i)}
        jl, jc = je.decode_step(params, jc, dec, wo)
        tl, tc = te.decode_step(
            tc, torch.from_numpy(stream[:, i : i + 1]), prompt_len + i, wo
        )
        jls.append(np.asarray(jl))
        tls.append(tl.numpy())
    return jls, tls, jc, tc


def test_model_maps_every_reference_parameter(pair):
    """Strict load fills every parameter; the embedding has padded_vocab
    rows; qwen2 and llama tie the LM head to it."""
    _, params, tmodel = pair
    cfg = tmodel.config
    assert tmodel.embed.shape == (cfg.padded_vocab, cfg.d_model)
    assert params["embed"].shape == tmodel.embed.shape
    assert tmodel.lm_head is None and cfg.tie_embeddings
    assert "backbone.layers.1.attn.wq.w" in tmodel.state_dict()


def test_prefill_and_teacher_forced_decode_match_reference(pair):
    """Prefill logits, then 6 teacher-forced decode steps, against the
    reference ``Engine.prefill_step`` / ``decode_step``."""
    jmodel, params, tmodel = pair
    jls, tls, jc, tc = _teacher_forced(
        jmodel, params, tmodel, dict(max_len=64), prompt_len=12, steps=6
    )
    for step, (j, t) in enumerate(zip(jls, tls)):
        assert t.shape == j.shape == (2, 1, tmodel.config.padded_vocab)
        np.testing.assert_allclose(t, j, atol=LOGIT_TOL, err_msg=f"step {step}")
    seg = jc["0_dense"]
    assert np.array_equal(tc["0_dense"]["pos"].numpy(), np.asarray(seg["pos"][0]))
    assert np.all(np.asarray(seg["pos"]) == np.asarray(seg["pos"][0]))


@pytest.mark.parametrize("prompt_len", [8, 20], ids=["short", "longer-than-ring"])
def test_decode_past_a_16_slot_ring_matches_reference(pair, prompt_len):
    """40 decode steps through a 16-slot ring (max_len 16, so it wraps
    twice), after a prompt shorter and one longer than the ring."""
    jmodel, params, tmodel = pair
    jls, tls, jc, tc = _teacher_forced(
        jmodel, params, tmodel, dict(max_len=16), prompt_len=prompt_len,
        steps=40,
    )
    for step, (j, t) in enumerate(zip(jls, tls)):
        np.testing.assert_allclose(t, j, atol=LOGIT_TOL, err_msg=f"step {step}")
    assert np.array_equal(tc["0_dense"]["pos"].numpy(),
                          np.asarray(jc["0_dense"]["pos"][0]))


def test_windowed_ring_decode_matches_reference(pair):
    """window_override=32 serves from a 32-slot ring; 40 decode steps after
    a 40-token prompt (the reference prefills it through its banded path)."""
    jmodel, params, tmodel = pair
    jls, tls, _, tc = _teacher_forced(
        jmodel, params, tmodel, dict(max_len=128, window_override=32),
        prompt_len=40, steps=40,
    )
    assert tc["0_dense"]["pos"].shape == (32,)
    for step, (j, t) in enumerate(zip(jls, tls)):
        np.testing.assert_allclose(t, j, atol=LOGIT_TOL, err_msg=f"step {step}")


def test_ring_decode_equals_full_attention_within_the_window():
    """Inside the port: decoding from a 32-slot ring with window 32 gives the
    logits of a 128-slot cache masked to the same window.  Before the ring
    wraps the two caches hold the same slots in the same order (the larger
    one adds empty slots, weight exactly 0): bitwise.  After the wrap the
    ring holds them rotated, so its attention sums run in another order:
    float32 rounding (~1e-7 relative) in a residual stream of ~1e2, which
    reaches the logits as ~1e-6 (1.1e-6 seen): atol 1e-5."""
    _, _, tmodel = build_pair("qwen2-1.5b")
    cfg = tmodel.config
    prompts = torch.from_numpy(_tokens(cfg.vocab_size, (2, 20), 5))
    stream = torch.from_numpy(_tokens(cfg.vocab_size, (2, 30), 6))
    ring_l, ring = tmodel.prefill(prompts, 32, window_override=32)
    full_l, full = tmodel.prefill(prompts, 128, window_override=32)
    assert torch.equal(ring_l, full_l)
    for i in range(30):
        pos = 20 + i
        ring_l, ring = tmodel.decode(ring, stream[:, i : i + 1], pos, 32)
        full_l, full = tmodel.decode(full, stream[:, i : i + 1], pos, 32)
        if pos < 32:
            assert torch.equal(ring_l, full_l), pos
        else:
            np.testing.assert_allclose(ring_l.numpy(), full_l.numpy(), atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_generate_matches_reference_tokens(pair, seed):
    jmodel, params, tmodel = pair
    cfg = tmodel.config
    prompts = _tokens(cfg.vocab_size, (2, 12), seed)
    want = JEngine(jmodel, JServeConfig(max_len=64)).generate(
        params, jnp.asarray(prompts), 16
    )
    got = Engine(tmodel, ServeConfig(max_len=64)).generate(
        torch.from_numpy(prompts), 16
    )
    assert got.dtype == torch.int32 and got.shape == (2, 16)
    assert np.array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the cache, slot for slot
# ---------------------------------------------------------------------------


CACHE_CASES = {
    "wraps": dict(slots=16, prompt=10, protected=0),
    "prefill longer than slots": dict(slots=16, prompt=20, protected=0),
    "protected prefix": dict(slots=16, prompt=10, protected=4),
}


@pytest.mark.parametrize("case", sorted(CACHE_CASES))
def test_cache_fill_and_insert_match_reference(case):
    """cache_fill, then 30 cache_insert steps, equal the reference's slot
    for slot (positions and K/V), through the ring's wrap."""
    c = CACHE_CASES[case]
    slots, s, prot = c["slots"], c["prompt"], c["protected"]
    rng = np.random.default_rng(4)
    b, kvh, hd = 2, 2, 8
    k = rng.standard_normal((b, s, kvh, hd), np.float32)
    v = rng.standard_normal((b, s, kvh, hd), np.float32)
    jc = JA.init_cache(b, slots, kvh, hd, jnp.float32)
    jc = JA.cache_fill(jc, jnp.asarray(k), jnp.asarray(v), jnp.int32(0))
    tc = A.init_cache(1, b, slots, kvh, hd, torch.float32, "cpu")
    keep = A.cache_fill(tc, s)
    A.cache_write(tc, 0, torch.from_numpy(k[:, s - keep :]),
                  torch.from_numpy(v[:, s - keep :]), 0)

    def same():
        tk, tv = A.cache_kv(tc, 0)
        assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        assert np.array_equal(tk.numpy(), np.asarray(jc["k"]))
        assert np.array_equal(tv.numpy(), np.asarray(jc["v"]))

    same()
    for pos in range(s, s + 30):
        k1 = rng.standard_normal((b, 1, kvh, hd), np.float32)
        v1 = rng.standard_normal((b, 1, kvh, hd), np.float32)
        jc = JA.cache_insert(jc, jnp.asarray(k1), jnp.asarray(v1),
                             jnp.int32(pos), prot)
        slot = A.cache_insert(tc, pos, prot)
        A.cache_write(tc, 0, torch.from_numpy(k1), torch.from_numpy(v1), slot)
        same()


# ---------------------------------------------------------------------------
# serve config, sampling, launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_slots_and_window_match_reference(arch):
    for smoke in (False, True):
        jcfg, tcfg = jget_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
        for kw in (dict(), dict(max_len=64), dict(max_len=128, window_override=32),
                   dict(max_len=16, window_override=32),
                   dict(window_override=0)):
            js, ts = JServeConfig(**kw), ServeConfig(**kw)
            assert cache_slots(tcfg, ts) == jengine.cache_slots(jcfg, js), kw
            for seq_len in (100, 70000):
                assert (resolve_window(tcfg, ts, seq_len)
                        == jengine.resolve_window(jcfg, js, seq_len)), (kw, seq_len)


def test_temperature_sampling_is_seeded_and_skips_padded_vocab():
    """Sampling draws from softmax(logits / T) over the first vocab_size
    columns: the same generator seed gives the same tokens, a padded column
    is never drawn however large its logit, and the draw frequencies match
    the softmax (20,000 draws; 0.015 is over four standard errors)."""
    cfg = get_config("qwen2-1.5b", smoke=True).with_(vocab_size=500)
    assert cfg.padded_vocab == 512
    tmodel = build_model(cfg, device="cpu")
    eng = Engine(tmodel, ServeConfig(greedy=False, temperature=0.7))
    n = 20000
    logits = torch.full((n, 1, cfg.padded_vocab), -1e4)
    logits[:, :, :4] = torch.tensor([1.0, 0.0, -1.0, 0.5])
    logits[:, :, cfg.vocab_size :] = 1e4
    draw = lambda seed: eng.sample_token(  # noqa: E731
        logits, torch.Generator().manual_seed(seed)
    )
    a, b, c = draw(3), draw(3), draw(4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.dtype == torch.int32 and int(a.max()) < 4
    freq = torch.bincount(a.long(), minlength=4).double() / n
    want = torch.softmax(torch.tensor([1.0, 0.0, -1.0, 0.5]) / 0.7, dim=0)
    np.testing.assert_allclose(freq.numpy(), want.numpy(), atol=0.015)
    prompts = torch.from_numpy(_tokens(cfg.vocab_size, (2, 6), 0))
    g1 = eng.generate(prompts, 8, torch.Generator().manual_seed(9))
    g2 = eng.generate(prompts, 8, torch.Generator().manual_seed(9))
    assert torch.equal(g1, g2) and int(g1.max()) < cfg.vocab_size


def test_serve_launcher_prints_its_line():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mode", "ar",
         "--smoke", "--device", "cpu"],
        capture_output=True, text=True, cwd=str(ROOT), timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert re.search(
        r"^generated \(4, 32\) in [0-9.]+s \([0-9.]+ tok/s\); first row: \[",
        proc.stdout, re.M,
    ), proc.stdout
