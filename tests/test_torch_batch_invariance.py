"""The reference's determinism contract in the port (``docs/serving.md``):
a request's ``x0`` is bitwise the same in every batch bucket.

On the card it rests on the row-invariant GEMM (``kernels/gemm.py``) and
the row reductions (``kernels/rownorm.py``), whose launch depends on the
weight's shape or the row's width alone; ``chip_smoke.py``'s
``phase_batch_invariance`` holds them there.  Here, on the CPU:

* ``gemm_config`` takes no M, and has a configuration for every ``Linear``
  (K, N) of every full-width registry config (``linear_shapes``, config
  arithmetic, checked against the modules of the model built on ``meta``,
  which allocates nothing) and every batched product (``bgemm_shapes``),
  each an instance the library lists (its constants read from
  ``gemm.cu``), with splits that cover K once and the dot instance at
  N = 1;
* the plain versions against the reference's ``x @ w + b``, ``rmsnorm``,
  ``layernorm`` and ``_seq_sq_sums`` (numpy inputs from a seed);
* ``row_sq_sums`` bitwise padding- and batch-invariant, ``gemm_plain``
  row-invariant (the lone row too);
* the smoke qwen2 and llama engines, and those of the families whose
  products do not all go through ``Linear`` (deepseek-v2-lite, mixtral,
  hymba, xlstm: the MoE experts, the mLSTM / sLSTM products and Mamba's
  readout run the batched GEMM, ``bgemm``, whose plain version folds K in
  index order at N = 1 on the CPU), bitwise equal at batch buckets 1, 8
  and 64, and within tolerance of the reference's ``BatchedSampler``;
* ``bgemm_plain`` and ``layers.contract`` against the reference's
  ``jnp.matmul`` / ``jnp.einsum``, Mamba's readout against the reference's einsum,
  ``bgemm_shapes`` against the products a smoke forward of each of those
  families hands ``bgemm``, and a recorder that fails if any matrix
  product of those forwards runs outside the wrappers' plain versions
  (on the card each would be a cuBLAS kernel chosen by the batch);
* a call that asks for a CUDA tensor raises instead of falling back.
"""

import inspect
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import ERAConfig as JERAConfig
from repro.core import era as jera
from repro.core import linear_schedule as jlinear_schedule
from repro.models import layers as jlayers
from repro.serving import BatchedSampler as JBatchedSampler
from repro.serving import SampleRequest as JSampleRequest
from repro_torch.configs import get_config
from repro_torch.configs.registry import arch_names
from repro_torch.core import linear_schedule
from repro_torch.kernels import flash_attention as kf
from repro_torch.kernels import gemm as kg
from repro_torch.kernels import rownorm as kr
from repro_torch.models import DiffusionLM, build_model
from repro_torch.models import attention as A
from repro_torch.models import ssm as SSM
from repro_torch.models import layers as L
from repro_torch.serving import BatchedSampler, SampleRequest
from repro_torch.serving import result_keys as K
from test_torch_models import build_pair
from test_torch_serving import reference_noise

ARCHS = arch_names()
#: the families whose products do not all go through ``Linear``
BATCHED_ARCHS = ("deepseek-v2-lite-16b", "mixtral-8x7b", "hymba-1.5b", "xlstm-350m")
#: float32 products and norms against the reference (summation order)
F32_RTOL, F32_ATOL = 1e-5, 1e-5
#: bf16 products: the two frameworks may round a sum one bf16 step apart
BF16_ATOL = 2 ** -6
#: the smoke engine's x0 against the reference's (the parity tests' bar)
X0_ATOL = 2e-3


# ---------------------------------------------------------------------------
# gemm_config: the weight's shape alone
# ---------------------------------------------------------------------------

def test_gemm_config_takes_no_m():
    assert list(inspect.signature(kg.gemm_config).parameters) == [
        "k", "n", "dtype"]


def _module_shapes(cfg) -> set:
    """(d_in, d_out, dtype) of every Linear of the denoiser and the AR model
    of ``cfg``, built on ``meta``."""
    out = set()
    for model in (DiffusionLM(cfg, device="meta"), build_model(cfg, device="meta")):
        for mod in model.modules():
            if isinstance(mod, L.Linear):
                out.add((mod.w.shape[0], mod.w.shape[1], mod.w.dtype))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_linear_shapes_are_the_modules(arch):
    """``linear_shapes``'s arithmetic finds every Linear of the full-width
    models (serving stores each weight in its compute dtype)."""
    cfg = get_config(arch)
    assert kg.linear_shapes(cfg) == _module_shapes(cfg)


def _held_by_the_rule(k: int, n: int, dt: torch.dtype) -> kg.GemmConfig:
    """``gemm_config(k, n, dt)``, checked against the instances the library
    lists: its tile constants, its split covering K's tiles once (every
    split non-empty), the dot instance exactly at N = 1."""
    c = kg.gemm_config(k, n, dt)
    if dt == torch.float32:
        if n == 1:
            rows = (kg.DOT_THREAD_ROWS if k <= kg.DOT_THREAD_MAX_K
                    else kg.DOT_WARP_ROWS)
            assert c.loader == ("dot_thread" if rows == kg.DOT_THREAD_ROWS
                                else "dot_warp")
            assert (c.bm, c.bn, c.bk, c.split, c.k_per_split) == (rows, 1, k, 1, 1)
            return c
        assert c.loader == "simt"
        assert (c.bm, c.bn, c.bk, c.stages) == kg.F32_TILE
        k_tiles = -(-k // kg.F32_TILE[2])
        assert 1 <= c.split <= kg.F32_MAX_SPLIT
        wide = n >= kg.F32_WIDE_N or n <= kg.F32_NARROW_N
        assert c.split == 1 or (wide and c.k_per_split >= kg.F32_MIN_SPLIT_TILES)
    else:
        assert (c.bm, c.bk) == (kg.BM, kg.BK)
        assert (c.bn, c.stages) in kg.BF16_INSTANCES
        k_tiles = -(-k // kg.BK)
        assert 1 <= c.split <= kg.MAX_SPLIT
        # TMA needs 16-byte row pitches; the guarded loads take the rest
        assert (c.loader == "tma") == (k % 8 == 0 and n % 8 == 0)
    # every split has K tiles, and together they cover K once
    assert (c.split - 1) * c.k_per_split < k_tiles <= c.split * c.k_per_split
    return c


@pytest.mark.parametrize("arch", ARCHS)
def test_gemm_config_covers_every_linear(arch):
    for k, n, dt in sorted(kg.linear_shapes(get_config(arch)), key=str):
        _held_by_the_rule(k, n, dt)


@pytest.mark.parametrize("seq", [256, 128])
@pytest.mark.parametrize("arch", ARCHS)
def test_gemm_config_covers_every_batched_product(arch, seq):
    """Every (K, N, dtype) ``bgemm_shapes`` gives a full-width registry
    config at the path's 256 and 128 positions maps to an instance the
    library lists (the same rule as the ``Linear`` shapes')."""
    for k, n, dt in sorted(kg.bgemm_shapes(get_config(arch), seq), key=str):
        _held_by_the_rule(k, n, dt)


def test_gemm_config_splits_only_narrow_weights():
    """qwen2's wk / wv (N = 256: two column tiles) split K in three; its
    wide weights do not split; another dtype has no instance."""
    assert kg.gemm_config(1536, 256, torch.bfloat16).split == 3
    for k, n in ((1536, 1536), (1536, 8960), (8960, 1536), (2048, 8192)):
        assert kg.gemm_config(k, n, torch.bfloat16).split == 1
    with pytest.raises(TypeError, match="no instance"):
        kg.gemm_config(64, 64, torch.float16)


@pytest.mark.parametrize("k,n,split", [
    (1536, 1536, 8),   # TimeMLP's w2 at a few rows: split
    (256, 1536, 2),    # TimeMLP's w1
    (256, 1024, 2),    # xlstm's sLSTM step (4 x hd)
    (2048, 64, 8),     # deepseek's router: one column tile over a long K
    (4096, 8, 8),      # mixtral's router
    (512, 256, 1),     # xlstm's mLSTM scores: many batches and rows
    (512, 512, 1),     # the mLSTM's inter-chunk product
    (100, 1024, 1),    # too few K tiles to split
])
def test_gemm_config_float32_split(k, n, split):
    """float32 splits K by the width alone: at N >= ``F32_WIDE_N`` and N <=
    ``F32_NARROW_N``, into splits of at least ``F32_MIN_SPLIT_TILES`` K
    tiles; the widths between (the mLSTM's) keep one chain over K."""
    c = _held_by_the_rule(k, n, torch.float32)
    assert c.split == split


@pytest.mark.parametrize("k,loader", [(16, "dot_thread"), (32, "dot_thread"),
                                      (33, "dot_warp"), (256, "dot_warp"),
                                      (512, "dot_warp"), (7, "dot_thread")])
def test_gemm_config_n1_takes_the_dot(k, loader):
    """N = 1 (the mLSTM's ``den`` and normaliser, Mamba's readout) takes the
    dot instance: a warp a row, or a thread a row at K <= 32; bf16 has no
    dot instance and keeps its tile at N = 1."""
    assert _held_by_the_rule(k, 1, torch.float32).loader == loader
    assert kg.gemm_config(k, 1, torch.bfloat16).loader in ("tma", "ldg")
    assert kg.gemm_config(k, 2, torch.float32).loader == "simt"


def _source_constants(text: str, names) -> dict:
    """``constexpr int NAME = value`` of each of ``names`` in ``text``, in
    order (a value may name an earlier one)."""
    values = {}
    for name in names:
        m = re.search(rf"\b{name} = ([^,;]+)[,;]", text)
        assert m, name
        values[name] = int(eval(m.group(1), {}, values))
    return values


def test_library_constants_are_the_sources():
    """The constants ``repro_gemm_constants`` reports (which the wrapper
    checks when it loads the library on the card) are ``gemm.cu``'s, and
    its ``GEMM_INSTANCES`` are ``BF16_INSTANCES``."""
    text = (Path(kg.build.CSRC_DIR) / kg.SOURCE).read_text()
    names = ("BM", "BK", "F_BM", "F_BN", "F_BK", "F_STAGES", "F_THREADS",
             "DOT_WARP_ROWS", "DOT_THREAD_ROWS", "DOT_THREAD_MAX_K")
    values = _source_constants(text, names)
    assert tuple(values[n] for n in names if n != "F_THREADS") == (
        kg.library_constants())
    m = re.search(r"#define GEMM_INSTANCES\(X\) (.+)", text)
    assert tuple(tuple(int(v) for v in pair) for pair in re.findall(
        r"X\((\d+), (\d+)\)", m.group(1))) == kg.BF16_INSTANCES


# ---------------------------------------------------------------------------
# the plain versions against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n,bias", [(1, 64, 96, True), (37, 128, 40, False),
                                        (256, 100, 132, True)])
def test_gemm_plain_matches_reference(m, k, n, bias):
    rng = np.random.default_rng(m + k + n)
    x = rng.standard_normal((m, k), np.float32)
    w = rng.standard_normal((k, n), np.float32) * k ** -0.5
    b = rng.standard_normal((n,), np.float32) if bias else None
    p = {"w": jnp.asarray(w)} | ({"b": jnp.asarray(b)} if bias else {})
    ref = np.asarray(jlayers.linear(p, jnp.asarray(x)))
    tb = None if b is None else torch.from_numpy(b)
    got = kg.gemm(torch.from_numpy(x), torch.from_numpy(w), tb)
    np.testing.assert_allclose(got.numpy(), ref, rtol=F32_RTOL, atol=F32_ATOL)
    # bf16: the product rounded, then the bias add rounded again
    refb = np.asarray(jlayers.linear(
        jax_tree_bf16(p), jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    gotb = kg.gemm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(),
                   None if tb is None else tb.bfloat16()).float()
    np.testing.assert_allclose(gotb.numpy(), refb, rtol=2 ** -7, atol=BF16_ATOL)


def jax_tree_bf16(p: dict) -> dict:
    return {name: v.astype(jnp.bfloat16) for name, v in p.items()}


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_norms_match_reference(dtype):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 5, 96), np.float32) * 2.0 + 0.5
    scale = rng.standard_normal((96,), np.float32)
    bias = rng.standard_normal((96,), np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = torch.from_numpy(x)
    tx = tx.bfloat16() if dtype == "bfloat16" else tx
    tol = dict(rtol=2 ** -7, atol=2 ** -7) if dtype == "bfloat16" else dict(
        rtol=F32_RTOL, atol=F32_ATOL)
    ref = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jx)
    got = kr.rmsnorm(tx, torch.from_numpy(scale))
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), **tol)
    ref = jlayers.layernorm({"scale": jnp.asarray(scale),
                             "bias": jnp.asarray(bias)}, jx)
    got = kr.layernorm(tx, torch.from_numpy(scale), torch.from_numpy(bias))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), **tol)
    # the layers' functions are the wrappers
    assert torch.equal(L.rmsnorm(tx, torch.from_numpy(scale)),
                       kr.rmsnorm(tx, torch.from_numpy(scale)))


@pytest.mark.parametrize("shape,masked", [((4, 12, 6, 5), True),
                                          ((4, 12, 30), False), ((4, 50), False)])
def test_row_sq_sums_matches_reference(shape, masked):
    rng = np.random.default_rng(11)
    d = rng.standard_normal(shape, np.float32)
    valid = None
    if masked:
        valid = np.arange(shape[1])[None, :] < np.array([12, 7, 1, 9])[:, None]
    ref = np.asarray(jera._seq_sq_sums(
        jnp.asarray(d), None if valid is None else jnp.asarray(valid)))
    got = kr.row_sq_sums(torch.from_numpy(d),
                         None if valid is None else torch.from_numpy(valid))
    assert got.dtype == torch.float32 and got.shape == (shape[0],)
    np.testing.assert_allclose(got.numpy(), ref, rtol=F32_RTOL, atol=F32_ATOL)


# ---------------------------------------------------------------------------
# invariance of the plain versions (the CPU route)
# ---------------------------------------------------------------------------

def test_row_sq_sums_padding_and_batch_invariant():
    rng = np.random.default_rng(5)
    d = torch.from_numpy(rng.standard_normal((6, 200, 48), np.float32))
    exact = kr.row_sq_sums(d, None)
    # padded to 256 with junk in the pad positions, masked out
    pad = torch.cat([d, torch.from_numpy(
        rng.standard_normal((6, 56, 48), np.float32))], dim=1)
    valid = (torch.arange(256) < 200)[None].expand(6, 256)
    assert torch.equal(kr.row_sq_sums(pad, valid), exact)
    for m in (1, 2, 5):
        assert torch.equal(kr.row_sq_sums(d[:m], None), exact[:m])


@pytest.mark.parametrize("k,n", [(128, 128), (256, 96), (128, 512)])
def test_gemm_plain_row_invariant(k, n):
    rng = np.random.default_rng(k * n)
    x = torch.from_numpy(rng.standard_normal((300, k), np.float32))
    w = torch.from_numpy(rng.standard_normal((k, n), np.float32))
    b = torch.from_numpy(rng.standard_normal((n,), np.float32))
    full = kg.gemm(x, w, b)
    for m in (1, 2, 7, 64, 255):
        assert torch.equal(kg.gemm(x[:m], w, b), full[:m]), m


# ---------------------------------------------------------------------------
# the batched instance: bgemm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g,m,k,n,bias", [(1, 1, 64, 96, True), (3, 37, 128, 40, False),
                                          (8, 30, 16, 1, False), (4, 5, 100, 132, True)])
def test_bgemm_plain_matches_reference(g, m, k, n, bias):
    rng = np.random.default_rng(g * 1000 + m + k + n)
    x = rng.standard_normal((g, m, k), np.float32)
    w = rng.standard_normal((g, k, n), np.float32) * k ** -0.5
    b = rng.standard_normal((g, n), np.float32) if bias else None
    tb = None if b is None else torch.from_numpy(b)
    got = kg.bgemm(torch.from_numpy(x), torch.from_numpy(w), tb)
    for ref in (jnp.matmul(jnp.asarray(x), jnp.asarray(w)),
                jnp.einsum("gmk,gkn->gmn", jnp.asarray(x), jnp.asarray(w))):
        ref = np.asarray(ref) + (b[:, None, :] if bias else 0.0)
        np.testing.assert_allclose(got.numpy(), ref, rtol=F32_RTOL, atol=F32_ATOL)
    # bf16: the product rounded, then the bias add rounded again
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    refb = jnp.matmul(jx, jw)
    if bias:
        refb = refb + jnp.asarray(b, jnp.bfloat16)[:, None, :]
    gotb = kg.bgemm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(),
                    None if tb is None else tb.bfloat16()).float()
    np.testing.assert_allclose(gotb.numpy(), np.asarray(refb.astype(jnp.float32)),
                               rtol=2 ** -7, atol=BF16_ATOL)


@pytest.mark.parametrize("k,n,rows", [(128, 128, True), (64, 300, True),
                                      (16, 1, False), (512, 1, False)])
def test_bgemm_plain_row_and_batch_invariant(k, n, rows):
    """Batches at every shape; rows at the expert products' widths, the
    only products whose M the models vary with the batch (Mamba's readout
    and the mLSTM's N = 1 products keep M and vary G; at N = 1 and a few
    rows the CPU's product takes another path, the card's kernel does
    not)."""
    rng = np.random.default_rng(k + n)
    x = torch.from_numpy(rng.standard_normal((6, 200, k), np.float32))
    w = torch.from_numpy(rng.standard_normal((6, k, n), np.float32))
    b = torch.from_numpy(rng.standard_normal((6, n), np.float32))
    full = kg.bgemm(x, w, b)
    for m in (1, 2, 7, 64, 199) if rows else ():
        assert torch.equal(kg.bgemm(x[:, :m], w, b), full[:, :m]), m
    for g in (1, 2, 5):
        assert torch.equal(kg.bgemm(x[:g], w[:g], b[:g]), full[:g]), g


@pytest.mark.parametrize("g,max_batch,m,k,n", [
    (8, 3, 5, 16, 7), (3, 3, 2, 8, 4), (kg.MAX_BATCH + 5, kg.MAX_BATCH, 1, 8, 1)])
def test_bgemm_launches_split_the_batch(g, max_batch, m, k, n, monkeypatch):
    """A batch past ``MAX_BATCH`` (the grid's batch axis) runs as launches
    of whole batches, at most ``MAX_BATCH`` each, joined in order: xlstm's
    ``den`` dot at 64 rows of 256 positions is 65,536 batches.  The launch
    is recorded here and computed by the plain version."""
    monkeypatch.setattr(kg, "MAX_BATCH", max_batch)
    sizes = []

    def launch(x, w, b, cfg):
        sizes.append(x.shape[0])
        assert cfg == kg.gemm_config(k, n, x.dtype)
        return kg.bgemm_plain(x, w, b)

    monkeypatch.setattr(kg, "_launch_batch", launch)
    rng = np.random.default_rng(g)
    x = torch.from_numpy(rng.standard_normal((g, m, k), np.float32))
    w = torch.from_numpy(rng.standard_normal((g, k, n), np.float32))
    b = torch.from_numpy(rng.standard_normal((g, n), np.float32))
    y = kg._launch_batched(x, w, b)
    assert sizes == [min(max_batch, g - i) for i in range(0, g, max_batch)]
    assert torch.equal(y, kg.bgemm_plain(x, w, b))


@pytest.mark.parametrize("eq,a,b", [
    ("blnd,bnde->blne", (2, 5, 3, 4), (2, 3, 4, 4)),
    ("blnd,bind->blin", (2, 5, 3, 4), (2, 5, 3, 4)),
    ("blnd,blnd->bln", (2, 5, 3, 4), (2, 5, 3, 4)),
    ("blnd,bln->bnd", (2, 5, 3, 4), (2, 5, 3)),
    ("bsdn,bsn->bsd", (2, 6, 7, 16), (2, 6, 16))])
def test_contract_matches_reference_einsum(eq, a, b):
    """``layers.contract`` (one bgemm over the batch letters) against the
    reference's ``jnp.einsum``; on ``meta`` it is ``torch.einsum``."""
    rng = np.random.default_rng(len(eq))
    na, nb = rng.standard_normal(a, np.float32), rng.standard_normal(b, np.float32)
    ref = np.asarray(jnp.einsum(eq, jnp.asarray(na), jnp.asarray(nb)))
    got = L.contract(eq, torch.from_numpy(na), torch.from_numpy(nb))
    np.testing.assert_allclose(got.numpy(), ref, rtol=F32_RTOL, atol=F32_ATOL)
    meta = L.contract(eq, torch.from_numpy(na).to("meta"), torch.from_numpy(nb).to("meta"))
    assert meta.device.type == "meta" and meta.shape == got.shape


@pytest.mark.parametrize("shape", [(2, 6, 7, 16), (1, 3, 5, 4)])
def test_mamba_readout_fold_matches_reference_einsum(shape):
    """The readout (a ``bgemm`` at N = 1: on the CPU its plain version's
    in-order fold over the states; on the card the dot instance) against
    the reference's ``jnp.einsum("bsdn,bsn->bsd")``, and bitwise
    row-invariant."""
    rng = np.random.default_rng(sum(shape))
    hh = rng.standard_normal(shape, np.float32)
    c = rng.standard_normal((shape[0], shape[1], shape[3]), np.float32)
    ref = np.asarray(jnp.einsum("bsdn,bsn->bsd", jnp.asarray(hh), jnp.asarray(c)))
    got = SSM.mamba_readout(torch.from_numpy(hh), torch.from_numpy(c))
    np.testing.assert_allclose(got.numpy(), ref, rtol=F32_RTOL, atol=F32_ATOL)
    one = SSM.mamba_readout(torch.from_numpy(hh[:1]), torch.from_numpy(c[:1]))
    assert torch.equal(one, got[:1])


def _smoke_forward(arch: str, seq: int):
    """A smoke denoiser of ``arch`` on the CPU (attention through the flash
    wrapper, as on the card), and a call of its ``eps`` on 3 rows of
    ``seq`` positions."""
    cfg = get_config(arch, smoke=True).with_(attention_impl="flash")
    dlm = DiffusionLM(cfg, device="cpu", seed=4)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, seq, cfg.d_model), np.float32))
    return cfg, lambda: dlm.eps(x, 0.5)


@pytest.mark.parametrize("seq", [24, 64])
@pytest.mark.parametrize("arch", BATCHED_ARCHS)
def test_bgemm_shapes_are_the_forward_products(arch, seq, monkeypatch):
    """``bgemm_shapes``'s arithmetic is what a smoke forward hands
    ``bgemm`` (24 positions: the mLSTM in one chunk shorter than its 32;
    64: two whole chunks)."""
    cfg, forward = _smoke_forward(arch, seq)
    seen, plain = set(), kg.bgemm_plain

    def recorded(x, w, b=None):
        seen.add((x.shape[2], w.shape[2], x.dtype))
        return plain(x, w, b)

    monkeypatch.setattr(kg, "bgemm_plain", recorded)
    with torch.no_grad():
        forward()
    assert seen == kg.bgemm_shapes(cfg, seq)
    # every one of these families has a product outside Linear (hymba's:
    # Mamba's readout)
    assert seen


PRODUCTS = {torch.ops.aten.mm, torch.ops.aten.bmm, torch.ops.aten.addmm,
            torch.ops.aten.baddbmm, torch.ops.aten.mv, torch.ops.aten.dot}


class _ProductRecorder(TorchDispatchMode):
    """Records every matrix product that runs while ``inside`` is 0: on the
    card those would be cuBLAS kernels, chosen by the batch."""

    def __init__(self):
        super().__init__()
        self.inside, self.outside = 0, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in PRODUCTS and not self.inside:
            self.outside.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", BATCHED_ARCHS)
def test_no_product_outside_the_kernel_wrappers(arch, monkeypatch):
    """Every matrix product of a smoke forward of these families runs inside
    ``gemm``'s, ``bgemm``'s or the flash kernel's plain version, or the
    CPU's SDPA (MLA asks for impl "auto", which CUDA tensors send to the
    flash kernel): what the CPU runs for the card's kernels.  None runs as
    a bare PyTorch product."""
    _, forward = _smoke_forward(arch, 24)
    rec = _ProductRecorder()

    def inside(fn):
        def wrapped(*args, **kwargs):
            rec.inside += 1
            try:
                return fn(*args, **kwargs)
            finally:
                rec.inside -= 1
        return wrapped

    for mod, name in ((kg, "gemm_plain"), (kg, "bgemm_plain"),
                      (kf, "flash_attention_plain"), (A, "_naive_sdpa"),
                      (A, "_chunked_sdpa")):
        monkeypatch.setattr(mod, name, inside(getattr(mod, name)))
    with torch.no_grad(), rec:
        forward()
    assert rec.outside == []


# ---------------------------------------------------------------------------
# the engines: bitwise across batch buckets, and against the reference
# ---------------------------------------------------------------------------

SEEDS = tuple(range(8))
SEQ, NFE = 8, 6


def _drain(tdlm, bucket: int, reqs):
    eng = BatchedSampler(tdlm, linear_schedule(), batch_buckets=(bucket,),
                         noise_fn=reference_noise(tdlm.config.d_model))
    futs = [eng.submit_with_future(r)[1] for r in reqs]
    eng.drain()
    return [f.result() for f in futs]


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "llama3.2-1b", *BATCHED_ARCHS])
def test_x0_bitwise_across_batch_buckets(arch):
    jdlm, params, tdlm = build_pair(arch, "naive", "auto", seed=3,
                                    head_scale=0.05)
    reqs = [SampleRequest(batch=1, seq_len=SEQ, nfe=NFE, seed=s) for s in SEEDS]
    solo = [_drain(tdlm, 1, [r])[0] for r in reqs]
    fused8 = _drain(tdlm, 8, reqs)
    # 64 rows: the eight among other seeds
    others = [SampleRequest(batch=4, seq_len=SEQ, nfe=NFE, seed=100 + i)
              for i in range(7)]
    fused64 = _drain(tdlm, 64, others[:4] + reqs + others[4:])[4:4 + len(reqs)]
    assert all(r.padded_batch == 8 for r in fused8)
    assert all(r.padded_batch == 64 for r in fused64)
    for one, eight, sixty_four in zip(solo, fused8, fused64):
        assert one.padded_batch == 1
        for other in (eight, sixty_four):
            assert torch.equal(one.x0, other.x0)
            assert torch.equal(one.aux[K.ERS_SELECTION_HISTORY],
                               other.aux[K.ERS_SELECTION_HISTORY])
    # and the reference's sampler (unfused ERA update) agrees within tolerance
    jeng = JBatchedSampler(
        jdlm, jlinear_schedule(),
        solver_config=JERAConfig(per_sample=True, use_fused_update=False))
    jf = [jeng.submit_with_future(JSampleRequest(batch=1, seq_len=SEQ, nfe=NFE,
                                                 seed=s))[1] for s in SEEDS]
    jeng.drain(params)
    for one, j in zip(solo, jf):
        np.testing.assert_allclose(one.x0.numpy(), np.asarray(j.result().x0),
                                   atol=X0_ATOL)


# ---------------------------------------------------------------------------
# no fallback: a CUDA tensor launches the kernel or raises
# ---------------------------------------------------------------------------

class _OnCuda(torch.Tensor):
    """A CPU tensor that says it lies on the card: the wrappers must take
    their kernel path for it, which raises here (no nvcc, no triton, no
    card) instead of computing the plain version."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda(t: torch.Tensor) -> torch.Tensor:
    return t.as_subclass(_OnCuda)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_call_raises_instead_of_falling_back(dtype):
    x, w = torch.ones(4, 64, dtype=dtype), torch.ones(64, 32, dtype=dtype)
    launches = kg.gemm.launches
    with pytest.raises((RuntimeError, AssertionError, ImportError)):
        kg.gemm(_cuda(x), _cuda(w))
    scale = torch.ones(64)
    with pytest.raises((RuntimeError, AssertionError, ImportError)):
        kr.rmsnorm(_cuda(x), _cuda(scale))
    with pytest.raises((RuntimeError, AssertionError, ImportError)):
        kr.row_sq_sums(_cuda(x.reshape(2, 2, 64)), None)
    assert kg.gemm.launches == launches
    # and a CUDA call in a dtype without an instance raises before any launch
    with pytest.raises(TypeError, match="no instance"):
        kg.gemm(_cuda(x.half()), _cuda(w.half()))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bgemm_cuda_call_raises_instead_of_falling_back(dtype):
    x, w = torch.ones(3, 4, 64, dtype=dtype), torch.ones(3, 64, 32, dtype=dtype)
    launches = kg.bgemm.launches
    with pytest.raises((RuntimeError, AssertionError, ImportError)):
        kg.bgemm(_cuda(x), _cuda(w))
    assert kg.bgemm.launches == launches
    with pytest.raises(TypeError, match="no instance"):
        kg.bgemm(_cuda(x.half()), _cuda(w.half()))
    # a meta tensor is no CUDA tensor either: the models keep their own ops
    with pytest.raises(ValueError, match="not cuda"):
        kg.bgemm(x.to("meta"), w.to("meta"))


def test_norm_under_autograd_keeps_the_kernel_value_and_plain_gradient():
    """Under autograd a norm on the card returns its kernel's output (the
    serving forward) and takes the plain version's gradient: the value is
    the second input, the gradient reaches the first unchanged."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 16), np.float32)).requires_grad_()
    scale = torch.from_numpy(rng.standard_normal((16,), np.float32)).requires_grad_()
    plain = kr.rmsnorm_plain(x, scale)
    kernel = plain.detach() + 2 ** -10   # another rounding of the same norm
    out = kr._KernelValue.apply(plain, kernel)
    assert torch.equal(out, kernel)
    out.square().sum().backward()
    gx, gs = torch.autograd.grad(
        kr.rmsnorm_plain(x, scale), (x, scale), grad_outputs=2 * kernel)
    assert torch.equal(x.grad, gx) and torch.equal(scale.grad, gs)
