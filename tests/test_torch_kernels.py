"""The port's kernel modules against the JAX reference, on the CPU.

A CPU tensor takes each wrapper's plain PyTorch version (the CUDA kernels
are checked against the same plain versions on the card by
``chip_smoke.py``).  Inputs are float32 numpy arrays from a fixed seed.

Tolerances: the fused ERA step uses the reference's own fused-step bar,
1e-5 (``repro.core.era._FUSED_TOL``).  Attention in float32 agrees to
summation-order rounding of a softmax over at most 160 keys: atol 2e-6.
Decode attention takes the reference's own bars (``tests/test_kernels.py``):
atol 2e-5 in float32, and 3e-2 in bfloat16, where both outputs are
rounded to bf16 (one ulp of |o| < 4 is 2^-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.era import AM4 as J_AM4
from repro.kernels import ops, ref
from repro.models import attention as JA
from repro_torch.core.era import AM4
from repro_torch.core.lagrange import lagrange_weights
from repro_torch.kernels import decode_attention as kd
from repro_torch.kernels import era_update as ku
from repro_torch.kernels import flash_attention as kf

ERA_TOL = 1e-5
ATTN_TOL = 2e-6


def _era_case(rows, n, k=4, cap=9, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, n), np.float32)
    buf = rng.standard_normal((cap, rows, n), np.float32)
    # ERS selections at step i = 6 always end at i; t_next is the next knot
    tau = np.stack([
        np.append(np.sort(rng.choice(6, k - 1, replace=False)), 6)
        for _ in range(rows)
    ])
    t_buf = np.linspace(1.0, 0.2, cap).astype(np.float32)
    t_next = t_buf[7]
    cx = rng.uniform(0.9, 1.1, rows).astype(np.float32)
    ce = rng.uniform(-0.1, 0.1, rows).astype(np.float32)
    return x, buf, tau.astype(np.int32), t_buf, t_next, cx, ce


@pytest.mark.parametrize("rows,n", [(1, 96), (3, 100), (4, 4096 + 7)])
def test_era_update_plain_matches_reference(rows, n):
    """Each row of the fused step equals ``ref.era_update_ref`` and the
    reference's fused ``ops.era_step`` (Pallas, interpret mode) on that row."""
    x, buf, tau, t_buf, t_next, cx, ce = _era_case(rows, n)
    hist = (6, 5, 4)
    lag_w = lagrange_weights(torch.from_numpy(t_buf[tau]), torch.tensor(t_next))
    got_x, got_e = ku.era_update(
        torch.from_numpy(x), torch.from_numpy(buf), torch.from_numpy(tau), hist,
        lag_w, AM4, torch.from_numpy(cx), torch.from_numpy(ce),
    )
    assert ku.era_update.launches == 0
    assert AM4 == J_AM4
    am4 = jnp.asarray(J_AM4, jnp.float32)
    for r in range(rows):
        eps_sel = jnp.asarray(buf[tau[r], r])          # (k, N)
        e_hist = jnp.asarray(buf[list(hist), r])       # (3, N)
        want_x, want_e = ref.era_update_ref(
            jnp.asarray(x[r]), eps_sel, jnp.asarray(lag_w[r].numpy()), e_hist,
            am4, jnp.float32(cx[r]), jnp.float32(ce[r]),
        )
        np.testing.assert_allclose(got_x[r].numpy(), want_x, atol=ERA_TOL)
        np.testing.assert_allclose(got_e[r].numpy(), want_e, atol=ERA_TOL)
        fx, fe = ops.era_step(
            jnp.asarray(x[r]), eps_sel, jnp.asarray(t_buf[tau[r]]), e_hist,
            jnp.float32(t_next), jnp.float32(cx[r]), jnp.float32(ce[r]), am4,
        )
        np.testing.assert_allclose(got_x[r].numpy(), fx, atol=ERA_TOL)
        np.testing.assert_allclose(got_e[r].numpy(), fe, atol=ERA_TOL)


def test_era_update_scalar_coefficients_broadcast():
    """One (cx, ce) pair for every row equals passing it per row."""
    x, buf, tau, t_buf, t_next, cx, ce = _era_case(3, 50, seed=1)
    args = (torch.from_numpy(x), torch.from_numpy(buf), torch.from_numpy(tau),
            (6, 5, 4), torch.rand(3, 4), AM4)
    a = ku.era_update(*args, torch.tensor(0.97), torch.tensor(-0.05))
    b = ku.era_update(*args, torch.full((3,), 0.97), torch.full((3,), -0.05))
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_era_update_cuda_checks_reject_cpu_tensors():
    """The kernel path's checks raise on input the kernel does not take."""
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="not cuda"):
        ku._check(x, torch.zeros(3, 2, 8), torch.zeros(2, 4, dtype=torch.int32),
                  (0, 0, 0), torch.zeros(2, 4), torch.zeros(2), torch.zeros(2))


def _attn_case(b, s, h, kvh, hd, seed=0, sk=None, hd_v=None):
    rng = np.random.default_rng(seed)
    sk = s if sk is None else sk
    q = rng.standard_normal((b, s, h, hd), np.float32)
    k = rng.standard_normal((b, sk, kvh, hd), np.float32)
    v = rng.standard_normal((b, sk, kvh, hd if hd_v is None else hd_v), np.float32)
    return q, k, v


def _ring(n, shift, holes):
    """Ring slots: slot j holds position (j - shift) mod n; slots in
    ``holes`` are empty (-1)."""
    pos = np.roll(np.arange(n, dtype=np.int32), shift)
    pos[holes[0]:holes[1]] = -1
    return pos


# the query positions (Sq,) and key positions (Sk,) default to arange; the
# last two cases give positions that are not tile indices, which the CUDA
# kernel's tile skip must read from the positions themselves
FLASH_CASES = {
    "gqa non-causal": dict(b=2, s=40, h=4, kvh=2, hd=32, kw=dict(causal=False)),
    "mha causal": dict(b=1, s=33, h=2, kvh=2, hd=64, kw=dict(causal=True)),
    "kv_mask + fully masked row": dict(
        b=3, s=24, h=4, kvh=1, hd=32, kw=dict(causal=False), lengths=(24, 9, 0)
    ),
    "causal window protected": dict(
        b=1, s=48, h=4, kvh=2, hd=32,
        kw=dict(causal=True, window=8, protected=3),
    ),
    "softcap": dict(b=2, s=20, h=4, kvh=2, hd=32,
                    kw=dict(causal=False, softcap=2.0)),
    "long kv, 128 head dim": dict(b=1, s=160, h=2, kvh=1, hd=128,
                                  kw=dict(causal=False)),
    "queries offset from keys, Sq < Sk, causal": dict(
        b=2, s=10, sk=40, h=4, kvh=2, hd=32, kw=dict(causal=True),
        q_pos=np.arange(30, 40, dtype=np.int32),
    ),
    "wrapped ring with empty slots, causal window protected": dict(
        b=2, s=48, h=4, kvh=2, hd=32,
        kw=dict(causal=True, window=12, protected=3),
        kv_pos=_ring(48, 17, (8, 16)),
    ),
    # paligemma's Gemma heads: hd 256 over one kv head, per-row lengths
    "head dim 256, one kv head, kv_mask": dict(
        b=3, s=40, h=4, kvh=1, hd=256, kw=dict(causal=False), lengths=(40, 17, 0)
    ),
    # whisper's cross-attention prefill: queries at 0 over more keys
    "cross: Sq < Sk, queries at 0, non-causal": dict(
        b=2, s=9, sk=40, h=4, kvh=4, hd=64, kw=dict(causal=False),
        q_pos=np.zeros(9, dtype=np.int32),
    ),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_plain_matches_reference(case):
    c = FLASH_CASES[case]
    sk = c.get("sk", c["s"])
    q, k, v = _attn_case(c["b"], c["s"], c["h"], c["kvh"], c["hd"], sk=sk)
    q_pos = c.get("q_pos", np.arange(c["s"], dtype=np.int32))
    kv_pos = c.get("kv_pos", np.arange(sk, dtype=np.int32))
    kw = dict(c["kw"])
    mask = None
    if "lengths" in c:
        mask = (np.arange(sk)[None, :] < np.asarray(c["lengths"])[:, None]).astype(np.int32)
    got = kf.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(q_pos), torch.from_numpy(kv_pos),
        kv_mask=None if mask is None else torch.from_numpy(mask), **kw,
    ).numpy()
    assert kf.flash_attention.launches == 0
    jm = None if mask is None else jnp.asarray(mask)
    # the oracle, in the kernel layout (B, H, S, hd)
    want = ref.flash_attention_ref(
        jnp.asarray(q.transpose(0, 2, 1, 3)), jnp.asarray(k.transpose(0, 2, 1, 3)),
        jnp.asarray(v.transpose(0, 2, 1, 3)), jnp.asarray(q_pos),
        jnp.asarray(kv_pos), kv_mask=jm, **kw,
    )
    np.testing.assert_allclose(got, np.asarray(want).transpose(0, 2, 1, 3),
                               atol=ATTN_TOL)
    # the Pallas kernel through its wrapper (interpret mode), model layout
    pallas = ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_pos),
        jnp.asarray(kv_pos), kv_mask=jm, **kw,
    )
    np.testing.assert_allclose(got, np.asarray(pallas), atol=ATTN_TOL)
    if "lengths" in c:
        assert np.all(got[2] == 0.0)  # every key masked -> zeros


def test_flash_cuda_checks_reject_bad_input():
    q = torch.zeros(1, 4, 2, 32)
    pos = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="not cuda"):
        kf._check(q, q, q, pos, pos, None)


# the reference's DECODE_CASES (tests/test_kernels.py):
# (b, h, kv, s, hd, window, protected, dtype) — windows, sinks, G=5, bf16
DECODE_CASES = [
    (2, 8, 2, 256, 64, 0, 0, "float32"),
    (1, 4, 4, 300, 128, 64, 0, "float32"),
    (2, 6, 3, 200, 80, 32, 4, "float32"),
    (1, 25, 5, 130, 64, 48, 8, "float32"),   # hymba head counts, G = 5
    (2, 8, 1, 256, 64, 0, 0, "bfloat16"),
    (2, 8, 1, 100, 256, 0, 0, "float32"),   # paligemma heads: G = 8, hd 256
]


def _decode_case(b, h, kv, s, hd, dtype, seed=0):
    """q (B, H, hd), k/v in the cache layout (B, S, KV, hd); the last 10
    slots are empty (-1) and the query sits at s - 11."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, hd), np.float32)
    k = rng.standard_normal((b, s, kv, hd), np.float32)
    v = rng.standard_normal((b, s, kv, hd), np.float32)
    kv_pos = np.where(np.arange(s) < s - 10, np.arange(s), -1).astype(np.int32)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
    return (tq, tk, tv), (jq, jk, jv), kv_pos, s - 11


@pytest.mark.parametrize("q_pos_form", ["int", "tensor"])
@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_decode_plain_matches_reference(case, q_pos_form):
    """The plain version equals ``ref.decode_attention_ref`` (on the same,
    float32-widened inputs) and the Pallas kernel through
    ``ops.decode_attention`` (interpret mode), in the case's dtype, with the
    query position given as a host int or as a (1,) int32 tensor (the
    form the attention layer passes, which the kernel reads on the card)."""
    b, h, kv, s, hd, window, prot, dtype = case
    (tq, tk, tv), (jq, jk, jv), kv_pos, qpos = _decode_case(b, h, kv, s, hd, dtype)
    tpos = qpos if q_pos_form == "int" else torch.tensor([qpos], dtype=torch.int32)
    got = kd.decode_attention(
        tq, tk, tv, tpos, torch.from_numpy(kv_pos), window=window,
        protected=prot,
    )
    assert kd.decode_attention.launches == 0
    assert got.dtype == tq.dtype and got.shape == tq.shape
    got = got.to(torch.float32).numpy()
    atol = 3e-2 if dtype == "bfloat16" else 2e-5
    want = ref.decode_attention_ref(
        jq.astype(jnp.float32),
        jk.transpose(0, 2, 1, 3).astype(jnp.float32),
        jv.transpose(0, 2, 1, 3).astype(jnp.float32),
        jnp.int32(qpos), jnp.asarray(kv_pos), window=window, protected=prot,
    )
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol)
    pallas = ops.decode_attention(
        jq, jk, jv, jnp.int32(qpos), jnp.asarray(kv_pos), window=window,
        protected=prot,
    )
    np.testing.assert_allclose(got, np.asarray(pallas, np.float32), atol=atol)


@pytest.mark.parametrize("q_pos", [5, 37])
def test_decode_non_causal_matches_cross_attention(q_pos):
    """``causal=False`` (whisper's cross-attention at decode): one query
    over all 40 keys whatever its position, as the reference's naive SDPA
    computes it with ``causal=False``; with ``causal=True`` a query at 5
    drops the 34 keys past it."""
    (q, k, v), (jq, jk, jv), _, _ = _decode_case(2, 8, 4, 40, 64, "float32")
    kv_pos = np.arange(40, dtype=np.int32)
    got = kd.decode_attention(q, k, v, q_pos, torch.from_numpy(kv_pos),
                              causal=False)
    want = JA._naive_sdpa(jq[:, None], jk, jv, jnp.asarray([q_pos], jnp.int32),
                          jnp.asarray(kv_pos), window=0, causal=False,
                          softcap=0.0)[:, 0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    causal = kd.decode_attention(q, k, v, q_pos, torch.from_numpy(kv_pos))
    assert torch.equal(causal, got) == (q_pos >= 39)


def test_decode_matches_flash_single_row():
    """Decode == flash attention with Sq = 1 on the same cache (the
    reference's own check, at its tolerance 3e-5)."""
    (q, k, v), _, _, _ = _decode_case(1, 4, 2, 128, 64, "float32")
    kv_pos = torch.arange(128, dtype=torch.int32)
    dec = kd.decode_attention(q, k, v, 127, kv_pos)
    fl = kf.flash_attention(
        q[:, None], k, v, torch.tensor([127], dtype=torch.int32), kv_pos,
        causal=True,
    )[:, 0]
    np.testing.assert_allclose(dec.numpy(), fl.numpy(), atol=3e-5)


def test_decode_wrapped_ring_and_empty_cache():
    """Empty slots anywhere in a wrapped ring are masked (the result equals
    attention over the valid slots alone, reordered), and a query with no
    valid slot gives exact zeros."""
    (q, k, v), _, _, _ = _decode_case(2, 6, 2, 64, 32, "float32", seed=3)
    # ring of 64 slots holding positions 40..99 with 4 holes, query at 99,
    # window 32 with 2 protected sinks that were evicted long ago
    pos = torch.arange(40, 104, dtype=torch.int32)
    pos[[3, 17, 50, 63]] = -1
    ring = torch.roll(pos, 40 % 64)
    kr, vr = torch.roll(k, 40 % 64, dims=1), torch.roll(v, 40 % 64, dims=1)
    got = kd.decode_attention(q, kr, vr, 99, ring, window=32, protected=2)
    keep = (pos >= 0) & (pos > 99 - 32) & (pos <= 99)
    want = kd.decode_attention(q, k[:, keep], v[:, keep], 99, pos[keep])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-6)
    empty = torch.full((64,), -1, dtype=torch.int32)
    assert torch.equal(kd.decode_attention(q, k, v, 99, empty),
                       torch.zeros_like(q))


def test_decode_split_plan_covers_the_cache():
    """A group's cluster is at most ``MAX_CLUSTER`` blocks and one tile a
    block, the groups' blocks make at most one wave where the groups do not
    fill the card alone (then the cluster is one block), the round-robin
    deal gives every tile to exactly one (block, warp), and a warp's ring
    holds all its tiles up to ``MAX_STAGES``."""
    for b, kvh, s, g in [(8, 2, 1024, 6), (1, 2, 130, 6), (64, 8, 4096, 4),
                         (2, 1, 64, 8), (64, 8, 512, 4), (3, 5, 300, 5),
                         (1, 1, 16, 20)]:
        cluster, stages = kd.split_plan(b, kvh, s, g)
        groups = b * kvh * kd.head_chunks(g)
        tiles = -(-s // kd.TILE)
        assert 1 <= cluster <= min(kd.MAX_CLUSTER, tiles)
        if groups >= kd.SMS:
            assert cluster == 1
        else:
            assert groups * cluster <= kd.SMS
        owners = [(t % cluster, (t // cluster) % kd.NWARPS) for t in range(tiles)]
        per_warp = max(owners.count(o) for o in set(owners))
        assert 1 <= stages <= kd.MAX_STAGES
        assert stages == min(kd.MAX_STAGES, per_warp)
    # the AR path: 16 groups x 8 blocks on 132 SMs, 2 tiles a warp when full
    assert kd.split_plan(8, 2, 1024, 6) == (8, 2)
    assert kd.split_plan(64, 8, 512, 4) == (1, 4)
    assert kd.split_plan(8, 2, 1024, 6, cluster=16) == (16, 1)
    assert kd.head_chunks(6) == 1 and kd.head_chunks(8) == 1 and kd.head_chunks(20) == 3


def _split_combine(q, k, v, q_pos, kv_pos, *, cluster, window=0, protected=0):
    """The kernel's split-and-combine arithmetic in plain float32 PyTorch:
    16-slot tiles dealt round robin to the cluster's blocks and their warps
    (tile t to block t % C, warp (t // C) % NWARPS), an online softmax in
    log2 units over each warp's tiles (tiles with no valid slot skipped),
    then every (block, warp) state merged at once, as the block that
    combines an output element merges the states the cluster's warps
    stored into its shared memory.  Returns the output and the (block,
    warp) states' (m, l)."""
    b, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qf = q.reshape(b, kvh, g, hd).to(torch.float32)
    kf32, vf32 = k.to(torch.float32), v.to(torch.float32)
    kp = kv_pos.to(torch.int64)
    valid = (kp >= 0) & (kp <= q_pos)
    if window > 0:
        valid = valid & ((kp > q_pos - window) | (kp < protected))
    mul = hd**-0.5 * np.log2(np.e)
    neg = torch.tensor(kd.NEG_INF)
    m = torch.full((cluster, kd.NWARPS, b, kvh, g), kd.NEG_INF)
    l = torch.zeros(cluster, kd.NWARPS, b, kvh, g)
    acc = torch.zeros(cluster, kd.NWARPS, b, kvh, g, hd)
    for t in range(-(-s // kd.TILE)):
        r, w = t % cluster, (t // cluster) % kd.NWARPS
        sl = slice(t * kd.TILE, min(s, (t + 1) * kd.TILE))
        vt = valid[sl]
        if not bool(vt.any()):
            continue  # a dead tile is never loaded
        sc = torch.einsum("bkgd,bskd->bkgs", qf, kf32[:, sl]) * mul
        sc = torch.where(vt, sc, neg)
        mx = torch.maximum(m[r, w], sc.amax(-1))
        alpha = torch.exp2(m[r, w] - mx)
        p = torch.exp2(sc - mx[..., None])
        l[r, w] = l[r, w] * alpha + p.sum(-1)
        acc[r, w] = acc[r, w] * alpha[..., None] + torch.einsum(
            "bkgs,bskd->bkgd", p, vf32[:, sl])
        m[r, w] = mx

    ms, ls, accs = m.flatten(0, 1), l.flatten(0, 1), acc.flatten(0, 1)
    top = ms.amax(0)
    wt = torch.where(ms > kd.NEG_INF / 2, torch.exp2(ms - top), torch.zeros(()))
    lc, oc = (wt * ls).sum(0), (wt[..., None] * accs).sum(0)
    out = torch.where(lc[..., None] > 0, oc / lc.clamp_min(1e-30)[..., None],
                      torch.zeros(()))
    return out.reshape(b, h, hd), m, l


def _ring_case(b, h, kvh, s, hd, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
               for shape in ((b, h, hd), (b, s, kvh, hd), (b, s, kvh, hd)))
    return q, k, v


# (name, slots, kv_pos of the slot count, q_pos, window, protected): B=2, H=12, KV=2,
# hd=128 (qwen2 heads), the AR path's 1024-slot plan (cluster 8)
SPLIT_CASES = [
    ("half full", 1024, lambda s: np.where(np.arange(s) < 512, np.arange(s), -1), 511, 0, 0),
    ("full", 1024, lambda s: np.arange(s), 1023, 0, 0),
    # 40 valid slots: tiles 0-2, so blocks 3-7 have no valid slot
    ("blocks with no valid slot", 1024,
     lambda s: np.where(np.arange(s) < 40, np.arange(s), -1), 39, 0, 0),
    # window 48 at position 1023: tiles 61-63 (blocks 5-7) and the sinks'
    # tile 0 (block 0); blocks 1-4 are masked whole by the window
    ("blocks masked whole by the window", 1024, lambda s: np.arange(s), 1023, 48, 4),
    # a wrapped ring with holes, 300 slots (not a multiple of 8 x 16)
    ("wrapped ring, 300 slots", 300,
     lambda s: np.where(np.isin(np.arange(s), [5, 77, 160]), -1,
                        np.roll(np.arange(700, 700 + s), 123)), 999, 200, 4),
    ("no valid slot", 1024, lambda s: np.full(s, -1), 1023, 0, 0),
]


@pytest.mark.parametrize("case", SPLIT_CASES, ids=lambda c: c[0])
def test_decode_split_combine_matches_plain(case):
    """The kernel's split-and-combine arithmetic, mirrored in plain PyTorch
    under the plan the kernel gets, equals the unsplit plain version (float32
    summation-order rounding, atol 2e-6); a block with no valid slot holds
    m = -inf, l = 0, and a query with no valid slot gives exact zeros."""
    name, s, build_pos, q_pos, window, prot = case
    b, h, kvh, hd = 2, 12, 2, 128
    q, k, v = _ring_case(b, h, kvh, s, hd, seed=len(name))
    kv_pos = torch.from_numpy(build_pos(s).astype(np.int32))
    cluster, _ = kd.split_plan(b, kvh, s, h // kvh)
    assert cluster == 8
    got, m, l = _split_combine(q, k, v, q_pos, kv_pos, cluster=cluster,
                               window=window, protected=prot)
    want = kd.decode_attention_plain(q, k, v, q_pos, kv_pos, window=window,
                                     protected=prot)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATTN_TOL)
    # a warp with no valid slot leaves m = -inf, l = 0; a block is empty
    # when all its warps are
    assert bool((m[l == 0] == kd.NEG_INF).all()) and bool((l[m == kd.NEG_INF] == 0).all())
    empty = l.flatten(1).amax(1) == 0
    if name == "no valid slot":
        assert bool(empty.all()) and torch.equal(got, torch.zeros_like(got))
    elif name.startswith("blocks"):
        dead = {"blocks with no valid slot": [3, 4, 5, 6, 7],
                "blocks masked whole by the window": [1, 2, 3, 4]}[name]
        assert empty.nonzero().flatten().tolist() == dead
    else:
        assert not bool(empty.any())


def test_decode_cuda_checks_reject_bad_input():
    q = torch.zeros(1, 4, 32)
    k = torch.zeros(1, 8, 2, 32)
    pos = torch.arange(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="not cuda"):
        kd._check(q, k, k, pos[:1], pos)


# ---------------------------------------------------------------------------
# the flash backward's plain version, and the differentiable scan
# ---------------------------------------------------------------------------

# (b, s, sk, h, kvh, hd, options, lengths, q_pos, kv_pos, hd_v or None):
# GQA at G = 6, 5 and 1, every mask, softcap, a row with no valid key, and
# the two pairs whose value head dim is not 32: MLA's (192, 128) at H = KV,
# causal, and paligemma's MQA (256, 256) at G = 8 with per-row lengths
BWD_CASES = {
    "G6 non-causal kv_mask, empty row": (
        3, 24, 24, 12, 2, 32, dict(causal=False), (24, 9, 0), None, None, None),
    "G5 causal window protected": (
        2, 40, 40, 10, 2, 16, dict(causal=True, window=8, protected=3),
        None, None, None, None),
    "G1 causal softcap": (2, 20, 20, 4, 4, 32,
                          dict(causal=True, softcap=2.0), None, None, None, None),
    "wrapped ring, queries offset, window": (
        2, 10, 48, 4, 2, 32, dict(causal=True, window=12, protected=3),
        None, np.arange(38, 48, dtype=np.int32), _ring(48, 17, (8, 16)), None),
    "MLA (192, 128) causal, empty row": (
        3, 20, 20, 4, 4, 192, dict(causal=True), (20, 7, 0), None, None, 128),
    "MQA (256, 256) G8 non-causal lengths": (
        3, 18, 18, 8, 1, 256, dict(causal=False), (18, 11, 5), None, None, None),
}
BWD_TOL = 2e-5


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_flash_bwd_plain_matches_autograd_and_reference(case):
    """``flash_attention_bwd_plain`` (explicit formulas, what the CUDA
    backward is held to on the card) equals autograd of
    ``flash_attention_plain`` and ``jax.vjp`` of the reference's
    ``flash_attention_ref``, in float32 (summation-order rounding of
    O(1) gradients: atol 2e-5, at every head dim); a row with no valid key
    gets zeros.  The reference's output takes q's head dim, so at MLA's
    (192, 128) v and dout go to it padded with zeros and its dv is sliced
    back to 128, as the reference's ``mla_train`` pads v."""
    b, s, sk, h, kvh, hd, kw, lengths, q_pos, kv_pos, hd_v = BWD_CASES[case]
    hd_v = hd if hd_v is None else hd_v
    q, k, v = _attn_case(b, s, h, kvh, hd, sk=sk, seed=3, hd_v=hd_v)
    q_pos = np.arange(s, dtype=np.int32) if q_pos is None else q_pos
    kv_pos = np.arange(sk, dtype=np.int32) if kv_pos is None else kv_pos
    mask = None
    if lengths is not None:
        mask = (np.arange(sk)[None] < np.asarray(lengths)[:, None]).astype(np.int32)
    dout = np.random.default_rng(4).standard_normal((b, s, h, hd_v)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    pos = dict(q_pos=torch.from_numpy(q_pos), kv_pos=torch.from_numpy(kv_pos))
    tmask = None if mask is None else torch.from_numpy(mask)
    out = kf.flash_attention(tq, tk, tv, **pos, kv_mask=tmask, **kw)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    plain = kf.flash_attention_bwd(
        tq.detach(), tk.detach(), tv.detach(), out.detach(),
        torch.from_numpy(dout), **pos, kv_mask=tmask, **kw)
    assert kf.flash_attention.launches == 0
    assert kf.flash_attention_bwd.launches == 0
    jm = None if mask is None else jnp.asarray(mask)
    t = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3))  # noqa: E731
    pad = lambda a: np.pad(a, [(0, 0)] * 3 + [(0, hd - hd_v)])  # noqa: E731
    _, vjp = jax.vjp(
        lambda a, c, e: ref.flash_attention_ref(
            a, c, e, jnp.asarray(q_pos), jnp.asarray(kv_pos), kv_mask=jm, **kw),
        t(q), t(k), t(pad(v)))
    want = [np.asarray(g).transpose(0, 2, 1, 3) for g in vjp(t(pad(dout)))]
    want[2] = want[2][..., :hd_v]
    for name, a, p, w in zip(("dq", "dk", "dv"), grads, plain, want):
        assert p.dtype == torch.float32
        np.testing.assert_allclose(p.numpy(), a.numpy(), atol=BWD_TOL, err_msg=name)
        np.testing.assert_allclose(p.numpy(), w, atol=BWD_TOL, err_msg=name)
    for row, n in enumerate(lengths or ()):
        if n == 0:  # no valid key: zero dq, and its keys give zero dk, dv
            assert all(np.all(g.numpy()[row] == 0.0) for g in plain)


@pytest.mark.parametrize("hd,hd_v", [(192, 128), (256, 256)])
def test_flash_bwd_refuses_pairs_without_an_instance(hd, hd_v):
    """MLA's and paligemma's pairs have a backward instance: the launch
    checks pass their head dims (and stop at the CPU tensors, which the
    kernels do not take) and the dK/dV plan takes them; a pair with no
    forward instance is refused by the forward's check, naming the pairs,
    which are the backward's too."""
    pos = torch.arange(4, dtype=torch.int32)
    k = torch.zeros(1, 4, 2, hd)
    with pytest.raises(ValueError, match="not cuda"):
        kf._check(torch.zeros(1, 4, 2, hd), k, torch.zeros(1, 4, 2, hd_v), pos, pos, None)
    assert kf.bwd_cluster_size(1, 2, 4, 1, 4, hd, 132, hd_v=hd_v) >= 1
    with pytest.raises(ValueError, match="no instance"):
        kf.bwd_cluster_size(1, 2, 4, 1, 4, hd, 132, hd_v=hd_v + 32)
    x = torch.zeros(1, 4, 2, 96)
    with pytest.raises(ValueError, match=r"not in \(\(32, 32\)"):
        kf._check(x, x, x, pos, pos, None)


@pytest.mark.parametrize("n,bshape", [(37, (2, 37, 3, 4)), (5, (1, 5, 2)),
                                      (64, (2, 64, 6))])
@pytest.mark.parametrize("broadcast", [False, True])
def test_scan_grads_match_a_naive_loop(n, bshape, broadcast):
    """``ssm._scan_`` under autograd (the reverse scan on flipped gates)
    gives the gradients of a plain loop ``h = a h + b``, in float64 to
    1e-12; ``a`` broadcasting on the trailing dims gets its summed
    gradient."""
    from repro_torch.models import ssm

    rng = np.random.default_rng(n)
    ashape = bshape[:2] + (1,) * (len(bshape) - 2) if broadcast else bshape
    a0 = torch.from_numpy(rng.uniform(0.5, 1.0, ashape))
    b0 = torch.from_numpy(rng.standard_normal(bshape))
    dh = torch.from_numpy(rng.standard_normal(bshape))
    a, b = a0.clone().requires_grad_(True), b0.clone().requires_grad_(True)
    h = ssm._scan_(a * 1.0, b * 1.0)
    ga, gb = torch.autograd.grad(h, (a, b), dh)
    a2, b2 = a0.clone().requires_grad_(True), b0.clone().requires_grad_(True)
    state, hs = torch.zeros_like(b0[:, 0]), []
    for p in range(n):
        state = a2[:, p] * state + b2[:, p]
        hs.append(state)
    ref_h = torch.stack(hs, dim=1)
    ra, rb = torch.autograd.grad(ref_h, (a2, b2), dh)
    torch.testing.assert_close(h.detach(), ref_h.detach(), rtol=0, atol=1e-12)
    torch.testing.assert_close(ga, ra, rtol=0, atol=1e-12)
    torch.testing.assert_close(gb, rb, rtol=0, atol=1e-12)


def test_scan_forward_under_grad_is_bitwise_the_in_place_scan():
    """The differentiable scan's forward is the serving path's in-place
    scan, bitwise, in float32; without grad ``_scan_`` is that scan."""
    from repro_torch.models import ssm

    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.uniform(0.3, 1.0, (2, 50, 8, 4)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 50, 8, 4)).astype(np.float32))
    old = ssm._scan_inplace(a.clone(), b.clone())
    with torch.no_grad():
        assert torch.equal(ssm._scan_(a.clone(), b.clone()), old)
    ag = a.clone().requires_grad_(True)
    h = ssm._scan_(ag, b.clone())
    assert h.requires_grad and torch.equal(h.detach(), old)
    assert torch.equal(ag.detach(), a)  # the inputs are not clobbered
