"""Row reductions whose order depends on the row's width alone: RMS norm,
LayerNorm and ERA's per-row squared error norm (Triton).

Replaces no TPU kernel: the reference's norms and ``_seq_sq_sums``
(``src/repro/core/era.py``) are XLA ops outside any Pallas kernel.  They
keep the reference's determinism contract on the card (``docs/serving.md``,
with :mod:`repro_torch.kernels.gemm`): PyTorch's reduce kernel picks its
block shape and its split across blocks from the number of outputs, so
through it a row's sum ran in another order at batch bucket 1 than at
bucket 8.  Here one program reduces one row (or one position), with the
reduction block a constexpr taken from the width: the order of a row's
sum depends on the width alone.

* :func:`rmsnorm`, :func:`layernorm`: one program a row, the whole row in
  one block (``next_pow2(d)``, at most :data:`MAX_NORM_WIDTH`), statistics
  in float32, output in x's dtype.
* :func:`row_sq_sums`: the per-row squared norm of ``d`` (B, S, ...):
  features first (one program a position, the features in blocks of
  ``min(next_pow2(F), 4096)`` summed block by block), masked positions
  ``+0``, then the positions accumulated strictly in order, one program a
  row (a 32-position block loaded at once, folded one position at a time),
  as the reference's ``cumsum`` does.  So a pad position adds an exact
  zero and a padded row sums bitwise as its exact-length self.  Rank-2
  inputs keep the plain per-row sum (one position of F features).

The work is a memory-bound pass (each input read once, the output written
once) with an elementwise prologue and epilogue; Triton fixes the
reduction order by the constexpr block.  Each function has its plain
PyTorch version beside it (the code the port ran before), which CPU tensors
take, and so do ``meta`` tensors (the dry run counts the plain ops).  A
CUDA call launches the kernel or raises.  Under autograd (training) a norm
still returns the kernel's output, so a training step's forward is the
serving forward bitwise, and takes its gradient from the plain version,
which runs beside it for autograd (:class:`_KernelValue`): the kernel has
no backward of its own, and the step saves the tensors the plain version
saves, which the dry run counts.  Triton's launcher checks the launch and
raises on failure.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build

Tensor = torch.Tensor

#: widest row the norms take in one block
MAX_NORM_WIDTH = 16384
#: widest feature block of :func:`row_sq_sums`'s per-position sums
MAX_FEATURE_BLOCK = 4096
#: positions :func:`row_sq_sums` folds from one load
FOLD_BLOCK = 32


def rmsnorm_plain(x: Tensor, scale: Tensor, eps: float = 1e-5) -> Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.to(torch.float32)).to(dt)


def layernorm_plain(x: Tensor, scale: Tensor, bias: Tensor,
                    eps: float = 1e-5) -> Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    xc = x - mu
    var = torch.mean(xc * xc, dim=-1, keepdim=True)
    x = xc * torch.rsqrt(var + eps)
    out = x * scale.to(torch.float32) + bias.to(torch.float32)
    return out.to(dt)


def row_sq_sums_plain(d: Tensor, valid: Tensor | None) -> Tensor:
    """Per-row sum of squared entries, features first, then accumulated
    position by position (``cumsum`` along the sequence) so zero-masked pad
    positions only append exact ``+ 0`` steps.  Rank-2 inputs keep the
    plain squared norm."""
    d = d.to(torch.float32)
    if d.dim() < 3:
        return torch.sum(d.reshape(d.shape[0], -1) ** 2, dim=-1)
    p = torch.sum(d.reshape(d.shape[0], d.shape[1], -1) ** 2, dim=-1)  # (B, S)
    if valid is not None:
        p = torch.where(valid, p, torch.zeros((), device=p.device))
    return torch.cumsum(p, dim=1)[:, -1]


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _warps(block: int, most: int) -> int:
    """Warps of a program reducing ``block`` elements (a function of the
    block alone, so of the width alone)."""
    return max(1, min(most, block // 256))


@functools.cache
def _kernels():
    """Import Triton and define the kernels (first launch only)."""
    build.use_local_triton_cache()
    import triton
    import triton.language as tl

    @triton.jit
    def rms_kernel(x_ptr, s_ptr, y_ptr, d, eps, BLOCK: tl.constexpr):
        row = tl.cast(tl.program_id(0), tl.int64)
        offs = tl.arange(0, BLOCK)
        mask = offs < d
        x = tl.load(x_ptr + row * d + offs, mask=mask, other=0.0).to(tl.float32)
        var = tl.sum(x * x, axis=0) / d
        s = tl.load(s_ptr + offs, mask=mask, other=0.0)
        y = x * tl.math.rsqrt(var + eps) * s
        tl.store(y_ptr + row * d + offs, y.to(y_ptr.dtype.element_ty), mask=mask)

    @triton.jit
    def ln_kernel(x_ptr, s_ptr, b_ptr, y_ptr, d, eps, BLOCK: tl.constexpr):
        row = tl.cast(tl.program_id(0), tl.int64)
        offs = tl.arange(0, BLOCK)
        mask = offs < d
        x = tl.load(x_ptr + row * d + offs, mask=mask, other=0.0).to(tl.float32)
        mu = tl.sum(x, axis=0) / d
        xc = tl.where(mask, x - mu, 0.0)
        var = tl.sum(xc * xc, axis=0) / d
        s = tl.load(s_ptr + offs, mask=mask, other=0.0)
        b = tl.load(b_ptr + offs, mask=mask, other=0.0)
        y = xc * tl.math.rsqrt(var + eps) * s + b
        tl.store(y_ptr + row * d + offs, y.to(y_ptr.dtype.element_ty), mask=mask)

    @triton.jit
    def pos_kernel(d_ptr, v_ptr, p_ptr, f, BLOCK: tl.constexpr,
                   HAS_VALID: tl.constexpr):
        # one position: its features' squares, block by block in order
        pos = tl.cast(tl.program_id(0), tl.int64)
        offs = tl.arange(0, BLOCK)
        acc = tl.sum(tl.zeros([BLOCK], dtype=tl.float32), axis=0)
        for f0 in range(0, f, BLOCK):
            v = tl.load(d_ptr + pos * f + f0 + offs, mask=f0 + offs < f,
                        other=0.0).to(tl.float32)
            acc += tl.sum(v * v, axis=0)
        if HAS_VALID:
            acc = tl.where(tl.load(v_ptr + pos) != 0, acc, 0.0)
        tl.store(p_ptr + pos, acc)

    @triton.jit
    def fold_kernel(p_ptr, o_ptr, s, BS: tl.constexpr):
        # one row: its positions' sums added strictly in order
        row = tl.cast(tl.program_id(0), tl.int64)
        idx = tl.arange(0, BS)
        acc = tl.sum(tl.zeros([BS], dtype=tl.float32), axis=0)
        for s0 in range(0, s, BS):
            v = tl.load(p_ptr + row * s + s0 + idx, mask=s0 + idx < s, other=0.0)
            for i in tl.static_range(BS):
                # one entry and exact zeros: the entry itself
                acc += tl.sum(tl.where(idx == i, v, 0.0), axis=0)
        tl.store(o_ptr + row, acc)

    return rms_kernel, ln_kernel, pos_kernel, fold_kernel


def _norm_rows(x: Tensor, name: str, *params: Tensor) -> tuple[Tensor, int]:
    """x as contiguous (rows, d) after the checks the norm kernels rely on."""
    d = x.shape[-1]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: no instance for {x.dtype}")
    if not 1 <= d <= MAX_NORM_WIDTH:
        raise ValueError(f"{name}: width {d} outside [1, {MAX_NORM_WIDTH}]")
    for p in params:
        if p.shape != (d,) or p.dtype != torch.float32 or p.device != x.device:
            raise ValueError(f"{name}: parameters must be ({d},) float32 on "
                             f"{x.device}")
    return x.reshape(-1, d).contiguous(), d


class _KernelValue(torch.autograd.Function):
    """The kernel's output as the value, the plain version's graph for the
    gradient: forward returns ``kernel``, backward hands the gradient to
    ``plain`` unchanged."""

    @staticmethod
    def forward(ctx, plain, kernel):
        return kernel

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _norm(wrapper, which: int, x: Tensor, params: tuple, eps: float,
          plain) -> Tensor:
    """A norm's routes: CPU and meta tensors take ``plain``; a CUDA tensor
    launches kernel ``which`` of :func:`_kernels` (one program a row),
    counted on ``wrapper``, under autograd with ``plain``'s gradient
    (:class:`_KernelValue`)."""
    name = wrapper.__name__
    if x.device.type in ("cpu", "meta"):
        return plain(x, *params, eps)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x is on {x.device}, not cuda")
    rows, d = _norm_rows(x, name, *params)
    y = torch.empty_like(rows)
    if rows.shape[0]:
        block = _pow2(d)
        _kernels()[which][(rows.shape[0],)](
            rows, *(p.contiguous() for p in params), y, d, float(eps),
            BLOCK=block, num_warps=_warps(block, 16))
        wrapper.launches += 1
    y = y.reshape(x.shape)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *params)):
        return _KernelValue.apply(plain(x, *params, eps), y)
    return y


def rmsnorm(x: Tensor, scale: Tensor, eps: float = 1e-5) -> Tensor:
    """RMS norm over the last axis (statistics in float32, output in x's
    dtype); see the module docstring for the routes."""
    return _norm(rmsnorm, 0, x, (scale,), eps, rmsnorm_plain)


rmsnorm.launches = 0


def layernorm(x: Tensor, scale: Tensor, bias: Tensor, eps: float = 1e-5) -> Tensor:
    """LayerNorm over the last axis with a scale and a bias (statistics in
    float32, output in x's dtype); see the module docstring for the
    routes."""
    return _norm(layernorm, 1, x, (scale, bias), eps, layernorm_plain)


layernorm.launches = 0


def row_sq_sums(d: Tensor, valid: Tensor | None = None) -> Tensor:
    """Per-row squared norm (B,) float32 of ``d`` (B, S, ...) in the
    reference's order (``_seq_sq_sums``), ``valid`` (B, S) bool masking
    pad positions; rank-2 inputs (B, F) are the plain per-row sum.  CPU
    and ``meta`` tensors take :func:`row_sq_sums_plain`; a CUDA tensor
    launches the kernels (one call, two launches) or raises."""
    if d.device.type in ("cpu", "meta"):
        return row_sq_sums_plain(d, valid)
    if d.device.type != "cuda":
        raise ValueError(f"row_sq_sums: d is on {d.device}, not cuda")
    if d.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"row_sq_sums: no instance for {d.dtype}")
    b = d.shape[0]
    if d.dim() < 3:
        s, valid = 1, None
    else:
        s = d.shape[1]
    x = d.reshape(b, s, -1).contiguous()
    f = x.shape[2]
    if valid is not None:
        if valid.dtype != torch.bool or valid.device != d.device:
            raise ValueError(f"row_sq_sums: valid must be bool on {d.device}")
        valid = valid.expand(b, s).contiguous().view(torch.uint8)
    p = torch.empty(b * s, dtype=torch.float32, device=d.device)
    out = torch.empty(b, dtype=torch.float32, device=d.device)
    if b == 0:
        return out
    if s == 0 or f == 0:
        return out.zero_()
    block = min(_pow2(f), MAX_FEATURE_BLOCK)
    _, _, pos_kernel, fold_kernel = _kernels()
    pos_kernel[(b * s,)](x, x if valid is None else valid, p, f, BLOCK=block,
                         HAS_VALID=valid is not None,
                         num_warps=_warps(block, 8))
    fold_kernel[(b,)](p, out, s, BS=FOLD_BLOCK, num_warps=1)
    row_sq_sums.launches += 1
    return out


row_sq_sums.launches = 0
