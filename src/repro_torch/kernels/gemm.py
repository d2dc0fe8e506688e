"""Row-invariant GEMM: ``y = x @ w (+ b)`` for every ``Linear`` on the card.

Replaces no TPU kernel: the reference's products are XLA dots outside any
Pallas kernel.  It keeps the reference's determinism contract
(``docs/serving.md``: a seeded request's ``x0`` depends only on the
compiled shape): each output row depends only on its own input row and the
weights, whatever the number of rows beside it.  cuBLAS chooses its kernel,
tile and split of K from M, so through it a row's sums ran in another order
at batch bucket 1 than at bucket 8.

**The invariance rule.**  :func:`gemm_config` sets the tile (BM, BN, BK),
the stages, the split of K and so the order of the K loop and of the sum
over a split's partials from ``(K, N, dtype)`` alone; it takes no M.  The
kernel (``src/repro_torch/csrc/gemm.cu``, whose header comment gives the
design and its bound) uses no atomics, and the rows past M and the K past
its end read as exact zeros.  Row i of ``gemm(x[:m], w)`` is then bitwise
row i of ``gemm(x, w)`` for every m.

bf16 (x and w bf16, float32 accumulation) rounds as ``x @ w + b`` rounds in
PyTorch: the product to bf16, then the bias add again.  It is a ``wgmma``
kernel, one tile a block, fed by a ring of TMA stages, two consumer
warpgroups taking 64 rows of the tile each.  float32
(TimeMLP, the MoE router, the xLSTM and Mamba products; no TF32) is a
register-tiled SIMT kernel (128 x 64 block tiles, 8 x 4 outputs a thread,
K through a cp.async ring, one fmaf chain an output over its split of K),
or at N = 1 a dot kernel (a warp a row and a fixed shuffle tree, or at K <=
32 a thread a row).
Built with ``nvcc`` for ``sm_90a`` at first use and bound with ctypes; the
C entry point returns ``cudaGetLastError()`` and the wrapper raises if it
is not 0.  Under autograd the wrapper is a ``torch.autograd.Function``
whose backward computes ``dx = dy @ w^T`` and ``dw = x^T @ dy`` with
``torch.matmul``, as the reference leaves them to XLA.

CPU tensors take :func:`gemm_plain`.  An unsupported call on a CUDA tensor
(another dtype, mixed dtypes, mismatched shapes) raises; nothing falls
back.

:func:`bgemm` is the batched instance, ``y[g] = x[g] @ w[g] (+ b[g])`` for
x (G, M, K) and w (G, K, N): the same kernels with the batch folded into
the tile order (a grid axis of the float32 ones), at the same
:func:`gemm_config` (no M, no G), so row i of batch g depends on row i of
x[g] and on w[g] alone.  It runs the products that do not go through
``Linear``: the MoE experts (bf16, G = the experts), the mLSTM products,
the sLSTM's recurrent product and Mamba's readout (float32, G = the batch
times the heads, the heads, or the batch times the positions).  Under
cuBLAS each was a ``bmm`` whose kernel chose by the batch.  :func:`bgemm_shapes` lists the (K, N, dtype) a
config gives it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import build

Tensor = torch.Tensor
SOURCE = "gemm.cu"

#: rows and K of the bf16 instance's tile (a consumer warpgroup's 128 rows,
#: one 128-byte swizzled row of bf16)
BM, BK = 128, 64
#: the bf16 kernel's (BN, stages) instances
BF16_INSTANCES = ((64, 8), (128, 4), (256, 4))
#: N from which a bf16 tile is 256 columns wide (one wgmma m64n256k16 a
#: warpgroup and k16 step): below it, 128 (64 at N <= 64)
BF16_WIDE_N = 4096
#: the float32 tiled kernel: block rows, columns, K a stage, stages
F32_TILE = (128, 64, 16, 3)
#: the float32 dot kernel (N = 1): rows a block of 256 threads, a warp a
#: row or, at K <= ``DOT_THREAD_MAX_K``, a thread a row
DOT_WARP_ROWS, DOT_THREAD_ROWS, DOT_THREAD_MAX_K = 8, 256, 32
#: the float32 instances, by the C entry point's ``mode``
F32_MODES = {"simt": 0, "dot_warp": 1, "dot_thread": 2}
#: most K splits, and the fewest K tiles a split takes (bf16, float32)
MAX_SPLIT, MIN_SPLIT_TILES = 4, 8
F32_MAX_SPLIT, F32_MIN_SPLIT_TILES = 8, 8
#: float32 widths whose products split K: N >= F32_WIDE_N (TimeMLP, the
#: sLSTM step: a few rows, so the column tiles alone leave the card idle)
#: and N <= F32_NARROW_N (the MoE router: one column tile over a long K)
F32_WIDE_N, F32_NARROW_N = 1024, 64
MAX_GRID_Y = 65535


@dataclasses.dataclass(frozen=True)
class GemmConfig:
    """One launch configuration: ``loader`` is ``"tma"`` (2-D tensor maps),
    ``"ldg"`` (guarded loads into the same swizzled tiles, where a row pitch
    is not a multiple of 16 bytes), ``"simt"`` (the float32 tiled kernel),
    ``"dot_warp"`` or ``"dot_thread"`` (the float32 dot at N = 1, a warp or
    a thread a row; ``bm`` rows a block, ``bk`` = K); ``k_per_split`` K
    tiles a split (``split`` of them, summed in order)."""

    bm: int
    bn: int
    bk: int
    stages: int
    split: int
    k_per_split: int
    loader: str


@functools.cache
def gemm_config(k: int, n: int, dtype: torch.dtype) -> GemmConfig:
    """The launch configuration of a (K, N) product in ``dtype``: a
    function of the weight's shape alone, never of M (nor of a batch).
    bf16 splits K (at most :data:`MAX_SPLIT`, each of at least
    :data:`MIN_SPLIT_TILES` K tiles) only where N gives at most two column
    tiles (qwen2's ``wk`` / ``wv``, 1536 -> 256), so that a few rows still
    spread over the card.  float32 takes the dot instance at N = 1, else
    the tiled one, which splits K (at most :data:`F32_MAX_SPLIT`, each of
    at least :data:`F32_MIN_SPLIT_TILES` K tiles) at the widths that leave
    the card idle (:data:`F32_WIDE_N`, :data:`F32_NARROW_N`)."""
    if k < 1 or n < 1:
        raise ValueError(f"gemm: K {k} and N {n} must be positive")
    if dtype == torch.float32:
        if n == 1:
            if k <= DOT_THREAD_MAX_K:
                return GemmConfig(DOT_THREAD_ROWS, 1, k, 1, 1, 1, "dot_thread")
            return GemmConfig(DOT_WARP_ROWS, 1, k, 1, 1, 1, "dot_warp")
        fm, fn, fk, stages = F32_TILE
        return GemmConfig(fm, fn, fk, stages, *_split(
            -(-k // fk), F32_MAX_SPLIT, F32_MIN_SPLIT_TILES,
            n >= F32_WIDE_N or n <= F32_NARROW_N), "simt")
    if dtype != torch.bfloat16:
        raise TypeError(f"gemm: no instance for {dtype} (bf16 and float32 only)")
    bn = 64 if n <= 64 else 256 if n >= BF16_WIDE_N else 128
    stages = dict(BF16_INSTANCES)[bn]
    loader = "tma" if k % 8 == 0 and n % 8 == 0 else "ldg"
    return GemmConfig(BM, bn, BK, stages, *_split(
        -(-k // BK), MAX_SPLIT, MIN_SPLIT_TILES, -(-n // bn) <= 2), loader)


def _split(k_tiles: int, most: int, fewest: int, wanted: bool) -> tuple[int, int]:
    """(splits, K tiles a split): ``k_tiles`` cut into at most ``most``
    splits of at least ``fewest`` tiles each where ``wanted``, else one."""
    split = max(1, min(most, k_tiles // fewest)) if wanted else 1
    return split, -(-k_tiles // split)


def gemm_plain(x: Tensor, w: Tensor, b: Tensor | None = None) -> Tensor:
    """``x @ w (+ b)`` in PyTorch with the kernel's roundings: the product
    in x's dtype, then the bias add.  x (M, K), w (K, N).  On the CPU a lone
    row goes through the GEMM beside a copy of itself: at one row PyTorch's
    CPU matmul takes a matrix-vector path, whose sums run in another order
    than its GEMM's, and the row would then differ from the same row
    among others."""
    if x.shape[0] == 1 and x.device.type == "cpu":
        return gemm_plain(torch.cat([x, x]), w, b)[:1]
    y = x @ w
    if b is not None:
        y = y + b
    return y


def _check(x: Tensor, w: Tensor, b: Tensor | None) -> None:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"gemm: x {tuple(x.shape)} and w {tuple(w.shape)} "
                         "must be (M, K) and (K, N)")
    if b is not None and b.shape != (w.shape[1],):
        raise ValueError(f"gemm: bias {tuple(b.shape)} must be ({w.shape[1]},)")
    for name, t in (("w", w), ("b", b)):
        if t is not None and (t.dtype != x.dtype or t.device != x.device):
            raise ValueError(f"gemm: {name} is {t.dtype} on {t.device}, x is "
                             f"{x.dtype} on {x.device}")


def library_constants() -> tuple[int, ...]:
    """The constants ``repro_gemm_constants`` reports, in its order."""
    return (BM, BK, *F32_TILE, DOT_WARP_ROWS, DOT_THREAD_ROWS, DOT_THREAD_MAX_K)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    lib.repro_gemm_bf16.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.repro_gemm_bf16.restype = ctypes.c_int
    lib.repro_gemm_f32.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.repro_gemm_f32.restype = ctypes.c_int
    lib.repro_bgemm_bf16.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    lib.repro_bgemm_bf16.restype = ctypes.c_int
    lib.repro_bgemm_f32.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.repro_bgemm_f32.restype = ctypes.c_int
    consts = (ctypes.c_int * 9)()
    lib.repro_gemm_constants(consts)
    if tuple(consts) != library_constants():
        raise RuntimeError(f"gemm: the library's tiles {tuple(consts)} are not "
                           f"the wrapper's {library_constants()}")
    return lib


def _aligned(t: Tensor) -> Tensor:
    """``t`` contiguous at a 16-byte aligned address (TMA's rule; a copy
    changes no value)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(x: Tensor, w: Tensor, b: Tensor | None) -> Tensor:
    """One kernel call on CUDA tensors (checked by :func:`gemm`)."""
    m, k = x.shape
    n = w.shape[1]
    y = x.new_empty(m, n)
    if m == 0:
        return y
    cfg = gemm_config(k, n, x.dtype)
    x, w = _aligned(x), _aligned(w)
    b = None if b is None else _aligned(b)
    if cfg.loader == "simt" and -(-m // cfg.bm) > MAX_GRID_Y:
        raise ValueError(f"gemm: {m} rows exceed {MAX_GRID_Y} row tiles")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    bias = None if b is None else b.data_ptr()
    ws = (torch.empty(cfg.split, m, n, dtype=torch.float32, device=x.device)
          if cfg.split > 1 else None)
    wsp = None if ws is None else ws.data_ptr()
    if cfg.loader in F32_MODES:
        err = _library().repro_gemm_f32(
            x.data_ptr(), w.data_ptr(), bias, y.data_ptr(), wsp, m, k, n,
            cfg.split, cfg.k_per_split, F32_MODES[cfg.loader], stream)
    else:
        err = _library().repro_gemm_bf16(
            x.data_ptr(), w.data_ptr(), bias, y.data_ptr(), wsp, m, k, n,
            cfg.bn, cfg.stages, cfg.split, cfg.k_per_split,
            int(cfg.loader == "tma"), stream)
    if err != 0:
        raise RuntimeError(f"gemm launch failed: cudaError {err}")
    gemm.launches += 1
    return y


class _Gemm(torch.autograd.Function):
    """The kernel under autograd; the backward's products are
    ``torch.matmul``, as the reference computes them with XLA."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        ctx.has_bias = b is not None
        return _launch(x, w, b)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dy @ w.t() if ctx.needs_input_grad[0] else None
        dw = x.t() @ dy if ctx.needs_input_grad[1] else None
        db = dy.sum(0) if ctx.has_bias and ctx.needs_input_grad[2] else None
        return dx, dw, db


def gemm(x: Tensor, w: Tensor, b: Tensor | None = None) -> Tensor:
    """``x (M, K) @ w (K, N) (+ b (N,))`` in x's dtype.  CPU tensors take
    :func:`gemm_plain`; CUDA tensors launch the kernel (bf16 or float32, at
    :func:`gemm_config`'s configuration) or raise (``Linear`` gives
    ``meta`` tensors the plain product itself).  Differentiable on CUDA
    through :class:`_Gemm`."""
    _check(x, w, b)
    if x.device.type == "cpu":
        return gemm_plain(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"gemm: x is on {x.device}, not cuda")
    gemm_config(x.shape[1], w.shape[1], x.dtype)   # raises on another dtype
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, b)):
        return _Gemm.apply(x, w, b)
    return _launch(x, w, b)


gemm.launches = 0


# ---------------------------------------------------------------------------
# the batched instance
# ---------------------------------------------------------------------------

#: most batches of one launch (the grid's y extent, or its z extent); a
#: larger batch runs as several launches, each of whole batches
MAX_BATCH = 65535


def bgemm_plain(x: Tensor, w: Tensor, b: Tensor | None = None) -> Tensor:
    """``x @ w (+ b)`` batched, in PyTorch with the kernel's roundings:
    ``torch.bmm`` in x's dtype, then the bias add.  x (G, M, K), w (G, K,
    N), b (G, N).  On the CPU a lone row goes through the product beside a
    copy of itself, as in :func:`gemm_plain`, and so does a lone batch
    (``bmm`` of one batch is a plain matrix product, whose sums at N = 1
    run in another order).  At N = 1 the CPU folds K in index order
    (elementwise ops, the same bits at every batch and row count: its
    ``bmm`` picks a matrix-vector path by the sizes)."""
    if x.device.type == "cpu" and w.shape[2] == 1:
        y = x[..., 0] * w[:, 0]
        for i in range(1, x.shape[2]):
            y.addcmul_(x[..., i], w[:, i])
        y = y[..., None]
        return y if b is None else y + b[:, None, :]
    if x.device.type == "cpu" and x.shape[0] == 1:
        two = None if b is None else torch.cat([b, b])
        return bgemm_plain(torch.cat([x, x]), torch.cat([w, w]), two)[:1]
    if x.shape[1] == 1 and x.device.type == "cpu":
        return bgemm_plain(torch.cat([x, x], dim=1), w, b)[:, :1]
    y = torch.bmm(x, w)
    if b is not None:
        y = y + b[:, None, :]
    return y


def _check_batched(x: Tensor, w: Tensor, b: Tensor | None) -> None:
    if (x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0]
            or x.shape[2] != w.shape[1]):
        raise ValueError(f"bgemm: x {tuple(x.shape)} and w {tuple(w.shape)} "
                         "must be (G, M, K) and (G, K, N)")
    if b is not None and b.shape != (w.shape[0], w.shape[2]):
        raise ValueError(f"bgemm: bias {tuple(b.shape)} must be "
                         f"({w.shape[0]}, {w.shape[2]})")
    for name, t in (("w", w), ("b", b)):
        if t is not None and (t.dtype != x.dtype or t.device != x.device):
            raise ValueError(f"bgemm: {name} is {t.dtype} on {t.device}, x is "
                             f"{x.dtype} on {x.device}")


def _launch_batched(x: Tensor, w: Tensor, b: Tensor | None) -> Tensor:
    """The kernel on CUDA tensors (checked by :func:`bgemm`): one launch
    for each ``MAX_BATCH`` batches.  Each batch's sums are its own, so
    where the launches split the batch changes no value."""
    g, m, k = x.shape
    n = w.shape[2]
    if g == 0 or m == 0:
        return x.new_empty(g, m, n)
    cfg = gemm_config(k, n, x.dtype)
    if cfg.loader == "simt" and -(-m // cfg.bm) > MAX_GRID_Y:
        raise ValueError(f"bgemm: {m} rows exceed {MAX_GRID_Y} row tiles")
    ys = [_launch_batch(x[i:i + MAX_BATCH], w[i:i + MAX_BATCH],
                        None if b is None else b[i:i + MAX_BATCH], cfg)
          for i in range(0, g, MAX_BATCH)]
    return ys[0] if len(ys) == 1 else torch.cat(ys)


def _launch_batch(x: Tensor, w: Tensor, b: Tensor | None, cfg) -> Tensor:
    """One kernel launch over at most ``MAX_BATCH`` batches."""
    g, m, k = x.shape
    n = w.shape[2]
    y = x.new_empty(g, m, n)
    x, w = _aligned(x), _aligned(w)
    b = None if b is None else _aligned(b)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    bias = None if b is None else b.data_ptr()
    ws = (torch.empty(cfg.split, g, m, n, dtype=torch.float32, device=x.device)
          if cfg.split > 1 else None)
    wsp = None if ws is None else ws.data_ptr()
    if cfg.loader in F32_MODES:
        err = _library().repro_bgemm_f32(
            x.data_ptr(), w.data_ptr(), bias, y.data_ptr(), wsp, g, m, k, n,
            cfg.split, cfg.k_per_split, F32_MODES[cfg.loader], stream)
    else:
        err = _library().repro_bgemm_bf16(
            x.data_ptr(), w.data_ptr(), bias, y.data_ptr(), wsp, g, m, k, n,
            cfg.bn, cfg.stages, cfg.split, cfg.k_per_split,
            int(cfg.loader == "tma"), stream)
    if err != 0:
        raise RuntimeError(f"bgemm launch failed: cudaError {err}")
    bgemm.launches += 1
    return y


class _BGemm(torch.autograd.Function):
    """The batched kernel under autograd; the backward's products are
    ``torch.bmm``, as :class:`_Gemm`'s are ``torch.matmul``."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        ctx.has_bias = b is not None
        return _launch_batched(x, w, b)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = torch.bmm(dy, w.transpose(1, 2)) if ctx.needs_input_grad[0] else None
        dw = torch.bmm(x.transpose(1, 2), dy) if ctx.needs_input_grad[1] else None
        db = dy.sum(1) if ctx.has_bias and ctx.needs_input_grad[2] else None
        return dx, dw, db


def bgemm(x: Tensor, w: Tensor, b: Tensor | None = None) -> Tensor:
    """``x (G, M, K) @ w (G, K, N) (+ b (G, N))`` in x's dtype, a product a
    batch.  CPU tensors take :func:`bgemm_plain`; CUDA tensors launch the
    kernel at :func:`gemm_config`'s configuration (bf16 or float32) or
    raise; the models keep their own ops on ``meta``.  Differentiable on
    CUDA through :class:`_BGemm`."""
    _check_batched(x, w, b)
    if x.device.type == "cpu":
        return bgemm_plain(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"bgemm: x is on {x.device}, not cuda")
    gemm_config(x.shape[2], w.shape[2], x.dtype)   # raises on another dtype
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, b)):
        return _BGemm.apply(x, w, b)
    return _launch_batched(x, w, b)


bgemm.launches = 0


def linear_shapes(cfg) -> set[tuple[int, int, torch.dtype]]:
    """Every ``Linear``'s (d_in, d_out, compute dtype) in the diffusion
    denoiser and the AR model of ``cfg``, by config arithmetic (nothing is
    built): the product shapes :func:`gemm` takes on that model's paths."""
    d, dt, f32 = cfg.d_model, cfg.dtype, torch.float32
    hd = cfg.resolved_head_dim
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    out = {(256, d, f32), (d, d, f32),       # TimeMLP
           (d, d, dt)}                       # in_proj, eps_head
    if not cfg.tie_embeddings:
        out.add((d, cfg.padded_vocab, dt))

    def attention():
        out.update({(d, h * hd, dt), (d, kvh * hd, dt), (h * hd, d, dt)})

    def mlp(d_ff):
        out.update({(d, d_ff, dt), (d_ff, d, dt)})

    def moe():
        m = cfg.moe
        out.add((d, m.num_experts, f32))     # the router (used as a matrix)
        if m.num_shared:
            mlp(m.d_ff_expert * m.num_shared)

    for kind, _ in cfg.blocks:
        if kind in ("dense", "enc", "xdec"):
            attention()
            mlp(cfg.d_ff)
        elif kind == "moe":
            attention()
            moe()
        elif kind == "mla_moe":
            a = cfg.mla
            out.update({(d, h * (a.qk_nope_head_dim + a.qk_rope_head_dim), dt),
                        (d, a.kv_lora_rank + a.qk_rope_head_dim, dt),
                        (a.kv_lora_rank, h * (a.qk_nope_head_dim + a.v_head_dim), dt),
                        (h * a.v_head_dim, d, dt)})
            moe()
        elif kind in ("hymba_full", "hymba_swa"):
            attention()
            mlp(cfg.d_ff)
            s = cfg.ssm
            di = s.expand * d
            dt_rank = s.dt_rank or -(-d // 16)
            out.update({(d, 2 * di, dt), (di, dt_rank + 2 * s.state_dim, dt),
                        (dt_rank, di, dt), (di, d, dt)})
        elif kind == "mlstm":
            di = 2 * d
            out.update({(d, 2 * di, dt), (di, di, dt), (di, h, dt), (di, d, dt)})
        elif kind == "slstm":
            out.add((d, d, dt))
        else:
            raise ValueError(f"linear_shapes: unknown block kind {kind!r}")
    return out


def bgemm_shapes(cfg, seq_len: int) -> set[tuple[int, int, torch.dtype]]:
    """Every (K, N, compute dtype) :func:`bgemm` takes on a forward of the
    denoiser or the AR model of ``cfg`` over ``seq_len`` positions, by
    config arithmetic (nothing is built): the MoE experts' three products,
    the mLSTM's seven products over a chunk of ``L = min(chunk, seq_len)``
    positions (inter-chunk, scores, intra-chunk, normaliser, the ``den``
    dot and the two carry products), the sLSTM's recurrent product and
    Mamba's readout (hymba: the states against ``C``, K = the state width,
    N = 1).  Empty for a family whose products all go through ``Linear``."""
    d, dt, f32 = cfg.d_model, cfg.dtype, torch.float32
    out = set()
    for kind, _ in cfg.blocks:
        if kind in ("moe", "mla_moe"):
            ff = cfg.moe.d_ff_expert
            out.update({(d, ff, dt), (ff, d, dt)})
        elif kind == "mlstm":
            hd = 2 * d // cfg.num_heads
            chunk = cfg.ssm.chunk if cfg.ssm else 256
            n = max(min(chunk, seq_len), 1)
            out.update({(hd, hd, f32), (hd, n, f32), (n, hd, f32),
                        (hd, 1, f32), (n, 1, f32)})
        elif kind == "slstm":
            hd = d // cfg.num_heads
            out.add((hd, 4 * hd, f32))
        elif kind in ("hymba_full", "hymba_swa"):
            out.add((cfg.ssm.state_dim, 1, f32))
    return out
