"""Fused ERA-Solver step: Lagrange predictor + AM4 corrector + DDIM update.

Replaces the TPU kernel ``repro.kernels.era_update._era_kernel`` (called
through ``repro.kernels.ops.era_step``, vmapped over the batch on the
per-sample path).  Per element it computes, in float32::

    eps_bar = sum_m lag_w[m] * eps_buf[tau[m]]              (Eq. 13/14)
    eps_corr = am4 . [eps_bar, eps_buf[h0], eps_buf[h1], eps_buf[h2]]
    x_next  = cx * x + ce * eps_corr                        (Eq. 11, 8)

and returns ``(x_next, eps_bar)``.  With a per-row ``active`` (R,) int32,
a row whose flag is 0 (a spent row of a mixed-NFE batch) stores ``x``
unchanged, bitwise, into ``x_next`` and zeros into ``eps_bar`` (which no
caller reads for it), and reads nothing else; without it every row steps.

Hopper port (Triton): the step is a single elementwise pass with no data
reuse, so it is bound by memory bytes: per element k+4 float32 reads and 2
writes, about 10 * N * 4 bytes a row for k = 4, over 3.35 TB/s.  The design
spends nothing else: one launch covers the whole batch on a 2-D grid
(element block, row); each program loads its row's k Lagrange weights,
selections and DDIM coefficients once; masked block loads give coalesced
16-byte accesses; and the ERS-selected bases are read straight out of the
Lagrange buffer through the on-device selections ``tau``, so the gather
that the reference materializes (``eps_sel``, ``e_hist``) never touches
device memory.  Triton's launcher checks the driver's launch result and
raises on failure.

Layout: rows are the batch under per-sample ERS (``x`` (B, N), buffer
(cap, B, N)); the shared-ERS path passes one row of N = B*S*d elements.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build, on_meta

Tensor = torch.Tensor

BLOCK = 1024
MAX_ROWS = 65535   # grid axis 1


def era_update_plain(
    x: Tensor,          # (R, N) float32
    eps_buf: Tensor,    # (cap, R, N) float32
    tau: Tensor,        # (R, k) int32 selected buffer entries
    hist: tuple[int, int, int],  # buffer entries of eps_i, eps_{i-1}, eps_{i-2}
    lag_w: Tensor,      # (R, k) float32 Lagrange weights at t_{i+1}
    am4: tuple[float, float, float, float],
    cx: Tensor,         # (R,) or () float32
    ce: Tensor,         # (R,) or () float32
    active: Tensor | None = None,  # (R,) int32, 0 = the row is frozen
) -> tuple[Tensor, Tensor]:
    """The kernel's function in plain PyTorch (same summation order)."""
    rows = x.shape[0]
    r = torch.arange(rows, device=x.device)
    eps_bar = torch.zeros_like(x, dtype=torch.float32)
    for m in range(tau.shape[1]):
        sel = eps_buf[tau[:, m].long(), r].to(torch.float32)    # (R, N)
        eps_bar = eps_bar + lag_w[:, m : m + 1] * sel
    eps_corr = (
        am4[0] * eps_bar
        + am4[1] * eps_buf[hist[0]].to(torch.float32)
        + am4[2] * eps_buf[hist[1]].to(torch.float32)
        + am4[3] * eps_buf[hist[2]].to(torch.float32)
    )
    cx = cx.to(torch.float32).reshape(-1, 1)
    ce = ce.to(torch.float32).reshape(-1, 1)
    x_next = (cx * x.to(torch.float32) + ce * eps_corr).to(x.dtype)
    eps_bar = eps_bar.to(x.dtype)
    if active is not None:
        live = (active != 0).reshape(-1, 1)
        x_next = torch.where(live, x_next, x)
        eps_bar = torch.where(live, eps_bar, eps_bar.new_zeros(()))
    return x_next, eps_bar


def _check_shapes(x, eps_buf, tau, hist, lag_w, cx, ce, active) -> None:
    """The shape rules the kernel relies on (checked on every device, so
    a CPU run fails where the card would)."""
    rows, n = x.shape
    cap = eps_buf.shape[0]
    k = tau.shape[1]
    if active is not None and active.shape != (rows,):
        raise ValueError(f"era_update: active must be ({rows},)")
    if eps_buf.shape != (cap, rows, n) or tau.shape != (rows, k):
        raise ValueError(
            f"era_update: shapes x {tuple(x.shape)}, eps_buf "
            f"{tuple(eps_buf.shape)}, tau {tuple(tau.shape)} disagree"
        )
    if lag_w.shape != (rows, k) or cx.shape != (rows,) or ce.shape != (rows,):
        raise ValueError("era_update: lag_w must be (R, k), cx/ce (R,)")
    if not all(0 <= h < cap for h in hist):
        raise ValueError(f"era_update: history entries {hist} outside [0, {cap})")


def _check(x, eps_buf, tau, hist, lag_w, cx, ce, active=None) -> None:
    for name, t in (("x", x), ("eps_buf", eps_buf), ("tau", tau),
                    ("lag_w", lag_w), ("cx", cx), ("ce", ce),
                    ("active", active)):
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"era_update: {name} is on {t.device}, not cuda")
        if not t.is_contiguous():
            raise ValueError(f"era_update: {name} must be contiguous")
    for name, t in (("x", x), ("eps_buf", eps_buf), ("lag_w", lag_w),
                    ("cx", cx), ("ce", ce)):
        if t.dtype != torch.float32:
            raise TypeError(f"era_update: {name} must be float32, got {t.dtype}")
    for name, t in (("tau", tau), ("active", active)):
        if t is not None and t.dtype != torch.int32:
            raise TypeError(f"era_update: {name} must be int32, got {t.dtype}")
    _check_shapes(x, eps_buf, tau, hist, lag_w, cx, ce, active)
    if x.shape[0] > MAX_ROWS:
        raise ValueError(f"era_update: {x.shape[0]} rows exceed {MAX_ROWS}")


@functools.cache
def _kernel():
    """Import Triton and define the kernel (first launch only)."""
    build.use_local_triton_cache()
    import triton
    import triton.language as tl

    @triton.jit
    def era_kernel(
        x_ptr, buf_ptr, tau_ptr, lagw_ptr, cx_ptr, ce_ptr, act_ptr, xo_ptr,
        eb_ptr, n, rows, h0, h1, h2, a0, a1, a2, a3,
        K: tl.constexpr, BLOCK: tl.constexpr, HAS_ACTIVE: tl.constexpr,
    ):
        blk = tl.program_id(0)
        row = tl.cast(tl.program_id(1), tl.int64)
        n64 = tl.cast(n, tl.int64)
        rows64 = tl.cast(rows, tl.int64)
        offs = blk * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        row_base = row * n64
        x = tl.load(x_ptr + row_base + offs, mask=mask, other=0.0)
        live = True
        if HAS_ACTIVE:
            live = tl.load(act_ptr + row) != 0
        if live:
            eps_bar = tl.zeros([BLOCK], dtype=tl.float32)
            for m in tl.static_range(K):
                t = tl.cast(tl.load(tau_ptr + row * K + m), tl.int64)
                w = tl.load(lagw_ptr + row * K + m)
                e = tl.load(buf_ptr + (t * rows64 + row) * n64 + offs,
                            mask=mask, other=0.0)
                eps_bar += w * e
            e0 = tl.load(buf_ptr + (tl.cast(h0, tl.int64) * rows64 + row)
                         * n64 + offs, mask=mask, other=0.0)
            e1 = tl.load(buf_ptr + (tl.cast(h1, tl.int64) * rows64 + row)
                         * n64 + offs, mask=mask, other=0.0)
            e2 = tl.load(buf_ptr + (tl.cast(h2, tl.int64) * rows64 + row)
                         * n64 + offs, mask=mask, other=0.0)
            corr = a0 * eps_bar + a1 * e0 + a2 * e1 + a3 * e2
            cx = tl.load(cx_ptr + row)
            ce = tl.load(ce_ptr + row)
            tl.store(xo_ptr + row_base + offs, cx * x + ce * corr, mask=mask)
            tl.store(eb_ptr + row_base + offs, eps_bar, mask=mask)
        else:
            # a frozen row: x through unchanged, no buffer read
            tl.store(xo_ptr + row_base + offs, x, mask=mask)
            tl.store(eb_ptr + row_base + offs,
                     tl.zeros([BLOCK], dtype=tl.float32), mask=mask)

    return triton, era_kernel


def era_update(
    x: Tensor,
    eps_buf: Tensor,
    tau: Tensor,
    hist: tuple[int, int, int],
    lag_w: Tensor,
    am4: tuple[float, float, float, float],
    cx: Tensor,
    ce: Tensor,
    active: Tensor | None = None,
) -> tuple[Tensor, Tensor]:
    """Fused ERA step over R rows; see the module docstring.  ``cx`` and
    ``ce`` are per-row (R,) or one scalar for every row; ``active`` (R,)
    int32 freezes the rows whose flag is 0.  CPU tensors take
    :func:`era_update_plain`; CUDA tensors launch the Triton kernel;
    ``meta`` tensors go to the registered handler (:func:`on_meta`)."""
    rows = x.shape[0]
    cx = torch.as_tensor(cx, dtype=torch.float32, device=x.device)
    ce = torch.as_tensor(ce, dtype=torch.float32, device=x.device)
    cx = cx.expand(rows).contiguous() if cx.dim() == 0 else cx
    ce = ce.expand(rows).contiguous() if ce.dim() == 0 else ce
    if x.device.type == "cpu":
        _check_shapes(x, eps_buf, tau, hist, lag_w, cx, ce, active)
        return era_update_plain(x, eps_buf, tau, hist, lag_w, am4, cx, ce,
                                active)
    if x.device.type == "meta":   # shapes only: the dry run's counter
        _check_shapes(x, eps_buf, tau, hist, lag_w, cx, ce, active)
        return on_meta("era_update", x, eps_buf, tau, lag_w, cx, ce, active)
    _check(x, eps_buf, tau, hist, lag_w, cx, ce, active)
    triton, kernel = _kernel()
    n = x.shape[1]
    x_next = torch.empty_like(x)
    eps_bar = torch.empty_like(x)
    grid = (triton.cdiv(n, BLOCK), rows)
    kernel[grid](
        x, eps_buf, tau, lag_w, cx, ce, tau if active is None else active,
        x_next, eps_bar, n, rows, hist[0], hist[1], hist[2],
        float(am4[0]), float(am4[1]), float(am4[2]), float(am4[3]),
        K=tau.shape[1], BLOCK=BLOCK, HAS_ACTIVE=active is not None,
        num_warps=4,
    )
    era_update.launches += 1
    return x_next, eps_bar


era_update.launches = 0
