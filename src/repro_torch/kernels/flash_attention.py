"""Flash attention forward (prefill / denoising path), CUDA C++ for Hopper.

Replaces the TPU kernel ``repro.kernels.flash_attention._flash_kernel``
(wrapper ``repro.kernels.ops.flash_attention``).  The kernel source is
``src/repro_torch/csrc/flash_attention.cu``; its header comment gives the
design and what bounds it on the H100.  In short: one block per (batch,
head, 64-query tile), a producer warp that loads Q once by TMA and keeps
the block's live K/V tiles in flight in an ``mbarrier`` ring, and one
consumer warpgroup whose ``wgmma`` products compute Q.K^T from shared
memory and P.V with P in registers, the online softmax, the running max
and sum and the output accumulator all in registers; the next tile's
scores are computed while the previous tile's P.V runs.  kv tiles that no
(query, key) pair of the block can use are skipped, decided from the
positions and ``kv_mask``.  GQA reads kv head ``h // G`` by index, and the
kernel reads and writes the model layout ``(B, S, H, hd)`` with no
transposes (the TMA tensor maps are 4-D over it, encoded on the host in
every call).  The value head dim may differ from the query/key one: the
instances are (32,32), (64,64), (128,128), for MLA (192,128) and for
paligemma (256,256); a CUDA tensor of another pair raises.  It is built
with ``nvcc`` for ``sm_90a`` at first use and bound with ctypes; the C
entry point returns ``cudaGetLastError()`` after the launch and the
wrapper raises if it is not 0.

Training: on CUDA tensors under autograd (grad enabled and q, k or v
requiring grad) the wrapper is a ``torch.autograd.Function``: its forward
is the same kernel, also writing each row's log-sum-exp, and its backward
is the hand-written kernel of ``csrc/flash_attention_bwd.cu`` (see
:func:`flash_attention_bwd`), which has an instance at every pair of
:data:`HEAD_DIM_PAIRS`.  A call under ``no_grad`` is the serving
launch, with no log-sum-exp.  CPU tensors take the plain versions, which
autograd differentiates.

Semantics (shared with :func:`flash_attention_plain`): keys with
``kv_pos < 0`` or a zero ``kv_mask`` entry are invalid; causal, window and
protected-sink predicates apply on positions; an optional tanh softcap
applies to the scaled scores; ``scale = hd ** -0.5`` with ``hd`` the
query/key head dim; a query row with no valid key gives zeros.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, on_meta

Tensor = torch.Tensor
NEG_INF = -1e30
SOURCE = "flash_attention.cu"
BWD_SOURCE = "flash_attention_bwd.cu"
#: (query/key head dim, value head dim) of each kernel instance: the
#: forward's serving and training (log-sum-exp) instances and the backward's
HEAD_DIM_PAIRS = ((32, 32), (64, 64), (128, 128), (192, 128), (256, 256))
MAX_GRID_Y = 65535
#: query rows of a forward block; the forward's grid is (B*H, query tiles)
FWD_TILE = 64
#: rows of the backward's tiles: keys of a dK/dV block, queries of an item
BWD_TILE = 64
#: most blocks of a dK/dV thread-block cluster (the portable limit)
BWD_MAX_CLUSTER = 8


def flash_attention_plain(
    q: Tensor,          # (B, Sq, H, hd)
    k: Tensor,          # (B, Sk, KV, hd)
    v: Tensor,          # (B, Sk, KV, hd_v)
    q_pos: Tensor,      # (Sq,) int
    kv_pos: Tensor,     # (Sk,) int, < 0 = invalid slot
    *,
    kv_mask: Tensor | None = None,  # (B, Sk), nonzero = valid key
    window: int = 0,
    causal: bool = True,
    softcap: float = 0.0,
    protected: int = 0,
) -> Tensor:
    """The kernel's function in plain PyTorch, all math in float32."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qf = q.to(torch.float32).reshape(b, sq, kvh, g, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.to(torch.float32)) * hd**-0.5
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    valid = _valid(q, k, q_pos, kv_pos, kv_mask, window, causal, protected)
    s = torch.where(valid, s, torch.full((), NEG_INF, device=s.device))
    w = torch.softmax(s, dim=-1)
    any_valid = torch.amax(s, dim=-1, keepdim=True) > NEG_INF / 2
    w = torch.where(any_valid, w, torch.zeros((), device=w.device))
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v.to(torch.float32))
    return out.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


def _valid(q, k, q_pos, kv_pos, kv_mask, window, causal, protected):
    """(B, KV, G, Sq, Sk) bool: which (query, key) pairs the masks keep."""
    b, sq, h, _ = q.shape
    kvh = k.shape[2]
    qp = q_pos.to(torch.int64)[:, None]
    kp = kv_pos.to(torch.int64)[None, :]
    valid = kp >= 0
    if causal:
        valid = valid & (kp <= qp)
    if window > 0:
        in_w = kp > qp - window
        if protected > 0:
            in_w = in_w | (kp < protected)
        valid = valid & in_w
    valid = valid[None, None, None]                        # (1,1,1,Sq,Sk)
    if kv_mask is not None:
        valid = valid & (kv_mask != 0)[:, None, None, None, :]
    return valid.expand(b, kvh, h // kvh, sq, k.shape[1])


def flash_attention_bwd_plain(
    q: Tensor, k: Tensor, v: Tensor, out: Tensor, dout: Tensor,
    q_pos: Tensor, kv_pos: Tensor, *, kv_mask: Tensor | None = None,
    window: int = 0, causal: bool = True, softcap: float = 0.0,
    protected: int = 0,
) -> tuple[Tensor, Tensor, Tensor]:
    """The backward kernel's function by explicit formulas, all in float32:
    P recomputed from q and k, ``D = rowsum(dout * out)`` (``out`` is the
    forward's output), ``dS = P * (dout v^T - D)`` times the softcap's
    ``1 - tanh^2`` and the scale, then ``dq = dS k``, ``dk = dS^T q`` and
    ``dv = P^T dout`` summed over each kv head's group.  Returns float32
    (dq, dk, dv) shaped like q, k, v; a row with no valid key gets zeros."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    f32 = torch.float32
    qf = q.to(f32).reshape(b, sq, kvh, g, hd)
    kf, vf = k.to(f32), v.to(f32)
    dof = dout.to(f32).reshape(b, sq, kvh, g, v.shape[-1])
    z = torch.einsum("bqkgd,bskd->bkgqs", qf, kf) * hd**-0.5
    if softcap > 0.0:
        tn = torch.tanh(z / softcap)
        z = softcap * tn
    valid = _valid(q, k, q_pos, kv_pos, kv_mask, window, causal, protected)
    z = torch.where(valid, z, torch.full((), NEG_INF, device=z.device))
    p = torch.softmax(z, dim=-1)
    p = torch.where(valid.any(dim=-1, keepdim=True), p,
                    torch.zeros((), device=p.device))
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vf)
    delta = (dout.to(f32) * out.to(f32)).sum(-1)           # (B, Sq, H)
    delta = delta.reshape(b, sq, kvh, g).permute(0, 2, 3, 1)[..., None]
    ds = p * (dp - delta)
    if softcap > 0.0:
        ds = ds * (1.0 - tn * tn)
    ds = ds * hd**-0.5
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf).reshape(b, sq, h, hd)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf)
    return dq, dk, dv


def bwd_cluster_size(b: int, kvh: int, sk: int, g: int, sq: int, hd: int,
                     sms: int, pair: bool = False, *,
                     hd_v: int | None = None) -> int:
    """Blocks of the dK/dV launch's thread-block cluster, which split each
    64-key tile's (head of the group, query tile) items among them: the
    largest of 1, 2, 4, 8 that keeps the launch to one wave of blocks
    (``blocks * C <= sms``: a dK/dV block's registers fill its SM, so a
    block past the first wave waits for a whole block to finish), and no
    more than a tile has items.  ``pair``: a block takes two key tiles (the
    causal launch's), so there are half as many blocks.  The same 64-key
    tile at every instance, so the head dims (``hd``, and ``hd_v``, by
    default ``hd``'s pair) only have to be a pair of
    :data:`HEAD_DIM_PAIRS`."""
    if not any(d == hd and (hd_v is None or dv == hd_v) for d, dv in HEAD_DIM_PAIRS):
        raise ValueError(f"flash_attention backward: no instance at head dims "
                         f"({hd}, {hd if hd_v is None else hd_v})")
    nk = -(-sk // BWD_TILE)
    blocks = b * kvh * (-(-nk // 2) if pair else nk)
    items = g * -(-sq // BWD_TILE)
    c = 1
    while 2 * c <= BWD_MAX_CLUSTER and 2 * c <= items and blocks * 2 * c <= sms:
        c *= 2
    return c


def bwd_rank_items(rank: int, cluster: int, n_items: int) -> range:
    """The items of a key tile's list that block ``rank`` of its cluster
    takes, as the dK/dV kernel deals them."""
    return range(rank, n_items, cluster)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(q, k, v, q_pos, kv_pos, kv_mask) -> None:
    if (q.shape[-1], v.shape[-1]) not in HEAD_DIM_PAIRS:
        raise ValueError(
            f"flash_attention: head dims (q/k {q.shape[-1]}, v {v.shape[-1]}) "
            f"not in {HEAD_DIM_PAIRS}")
    tensors = [("q", q), ("k", k), ("v", v), ("q_pos", q_pos),
               ("kv_pos", kv_pos)]
    if kv_mask is not None:
        tensors.append(("kv_mask", kv_mask))
    for name, t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention: {name} is on {t.device}, not cuda")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on another card")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention: {name} must be bfloat16, got {t.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be 16-byte aligned")
    for name, t in (("q_pos", q_pos), ("kv_pos", kv_pos), ("kv_mask", kv_mask)):
        if t is not None and t.dtype != torch.int32:
            raise TypeError(f"flash_attention: {name} must be int32, got {t.dtype}")
    b, sq, h, hd = q.shape
    _, sk, kvh, _ = k.shape
    hd_v = v.shape[-1]
    if k.shape != (b, sk, kvh, hd) or v.shape != (b, sk, kvh, hd_v):
        raise ValueError(
            f"flash_attention: k {tuple(k.shape)} / v {tuple(v.shape)} do not "
            f"match q {tuple(q.shape)}"
        )
    if kvh < 1 or h % kvh:
        raise ValueError(f"flash_attention: {h} heads not a multiple of {kvh}")
    if sq < 1 or sk < 1:
        raise ValueError("flash_attention: empty sequence")
    if q_pos.shape != (sq,) or kv_pos.shape != (sk,):
        raise ValueError("flash_attention: q_pos must be (Sq,), kv_pos (Sk,)")
    if kv_mask is not None and kv_mask.shape != (b, sk):
        raise ValueError(f"flash_attention: kv_mask must be ({b}, {sk})")


def _check_fwd_grid(sq: int) -> None:
    """The forward's grid is (B*H, query tiles): its query tiles are the
    y dimension, which holds at most MAX_GRID_Y."""
    if -(-sq // FWD_TILE) > MAX_GRID_Y:
        raise ValueError(f"flash_attention: Sq = {sq} is more than {MAX_GRID_Y} "
                         f"query tiles of {FWD_TILE}")


def _check_bwd_grid(b: int, h: int) -> None:
    """The backward's dQ grid is (query tiles, B*H) and its dK/dV grid
    (key tiles, B*KV): B*H is the y dimension, which holds at most
    MAX_GRID_Y."""
    if b * h > MAX_GRID_Y:
        raise ValueError(f"flash_attention_bwd: B*H = {b * h} exceeds {MAX_GRID_Y}")


@functools.cache
def _library() -> ctypes.CDLL:
    return bind(build.load(SOURCE))


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    return bind_bwd(build.load(BWD_SOURCE))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C entry point's argument types on a loaded library (once, at
    load; ctypes would otherwise cut the pointers to 32-bit ints)."""
    fn = lib.repro_flash_attention_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 7
        + [ctypes.c_int] * 7
        + [ctypes.c_float] * 2
        + [ctypes.c_int] * 3
        + [ctypes.c_void_p] * 2
    )
    fn.restype = ctypes.c_int
    return lib


def bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The backward library's entry point, bound like :func:`bind`."""
    fn = lib.repro_flash_attention_bwd
    fn.argtypes = (
        [ctypes.c_void_p] * 15
        + [ctypes.c_int] * 7
        + [ctypes.c_float] * 2
        + [ctypes.c_int] * 5
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib


def flash_attention(
    q: Tensor,          # (B, Sq, H, hd) model layout
    k: Tensor,          # (B, Sk, KV, hd)
    v: Tensor,          # (B, Sk, KV, hd_v)
    q_pos: Tensor,      # (Sq,)
    kv_pos: Tensor,     # (Sk,)
    *,
    kv_mask: Tensor | None = None,
    window: int = 0,
    causal: bool = True,
    softcap: float = 0.0,
    protected: int = 0,
) -> Tensor:
    """GQA flash attention in the model layout; returns (B, Sq, H, hd_v).
    CPU tensors take :func:`flash_attention_plain`; CUDA tensors launch the
    kernel (bf16, a head-dim pair of :data:`HEAD_DIM_PAIRS`) or raise;
    ``meta`` tensors go to the registered handler (:func:`on_meta`).
    Under autograd a CUDA call is differentiable through the backward
    kernel (:class:`_FlashAttention`)."""
    opts = dict(kv_mask=kv_mask, window=window, causal=causal,
                softcap=softcap, protected=protected)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, q_pos, kv_pos, **opts)
    if q.device.type == "meta":   # shapes only: the dry run's counter
        return on_meta("flash_attention", q, k, v, q_pos, kv_pos, kv_mask=kv_mask,
                              window=window, causal=causal, protected=protected)
    if kv_mask is not None and kv_mask.dtype != torch.int32:
        opts["kv_mask"] = kv_mask.to(torch.int32)
    if torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, q_pos, kv_pos, opts)
    return _forward(q, k, v, q_pos, kv_pos, **opts)[0]


flash_attention.launches = 0


def _forward(q, k, v, q_pos, kv_pos, *, kv_mask, window, causal, softcap,
             protected, with_lse: bool = False):
    """One launch of the forward kernel: (out, lse or None); ``lse`` (B, H,
    Sq) float32 is written only for the backward."""
    _check(q, k, v, q_pos, kv_pos, kv_mask)
    b, sq, h, hd = q.shape
    _check_fwd_grid(sq)
    sk, kvh, hd_v = k.shape[1], k.shape[2], v.shape[3]
    out = q.new_empty(b, sq, h, hd_v)
    lse = (torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
           if with_lse else None)
    err = _library().repro_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        q_pos.data_ptr(), kv_pos.data_ptr(),
        None if kv_mask is None else kv_mask.data_ptr(),
        b, h, kvh, sq, sk, hd, hd_v,
        hd**-0.5, float(softcap), int(window), int(causal), int(protected),
        None if lse is None else lse.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    flash_attention.launches += 1
    return out, lse


class _FlashAttention(torch.autograd.Function):
    """The kernel under autograd: the forward launch also writes the
    log-sum-exp of each row, which the backward kernel reads with q, k, v,
    the output, the positions and the mask."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, opts):
        out, lse = _forward(q, k, v, q_pos, kv_pos, **opts, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, q_pos, kv_pos,
                              opts["kv_mask"])
        ctx.opts = {name: val for name, val in opts.items() if name != "kv_mask"}
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, q_pos, kv_pos, kv_mask = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, dout.contiguous(), q_pos, kv_pos, lse=lse,
            kv_mask=kv_mask, **ctx.opts)
        return dq, dk, dv, None, None, None


def flash_attention_bwd(
    q: Tensor, k: Tensor, v: Tensor, out: Tensor, dout: Tensor,
    q_pos: Tensor, kv_pos: Tensor, *, lse: Tensor | None = None,
    kv_mask: Tensor | None = None, window: int = 0, causal: bool = True,
    softcap: float = 0.0, protected: int = 0,
) -> tuple[Tensor, Tensor, Tensor]:
    """Gradients (dq, dk, dv) of :func:`flash_attention` for the output
    gradient ``dout``.  CPU tensors take :func:`flash_attention_bwd_plain`
    (float32).  CUDA tensors launch the backward kernel, which needs the
    forward's ``lse`` (B, H, Sq) and returns bf16 grads, or raise; one call
    counts one launch (the kernel's three launches: the padded rows and
    positions, dK/dV, dQ).  The dK/dV launch's cluster size comes from
    :func:`bwd_cluster_size`, and under a causal mask each of its blocks
    takes two key tiles; the C entry point encodes the TMA tensor maps of
    q, k, v and dout in every call."""
    opts = dict(kv_mask=kv_mask, window=window, causal=causal,
                softcap=softcap, protected=protected)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, dout, q_pos, kv_pos,
                                         **opts)
    _check(q, k, v, q_pos, kv_pos, kv_mask)
    b, sq, h, hd = q.shape
    _check_bwd_grid(b, h)
    sk, kvh, hd_v = k.shape[1], k.shape[2], v.shape[3]
    for name, t in (("out", out), ("dout", dout)):
        if (t.shape != (b, sq, h, hd_v) or t.dtype != torch.bfloat16
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"flash_attention_bwd: {name} must be a contiguous, "
                             f"16-byte aligned bf16 tensor of shape "
                             f"{(b, sq, h, hd_v)}")
    if (lse is None or lse.shape != (b, h, sq) or lse.dtype != torch.float32
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError("flash_attention_bwd: lse must be the forward's "
                         f"({b}, {h}, {sq}) float32 on the card")
    # TMA reads rows of H and KV heads of hd and hd_v bf16: 16-byte strides
    if any(n * d % 8 for n in (h, kvh) for d in (hd, hd_v)):
        raise ValueError("flash_attention_bwd: H and KV times hd and hd_v must "
                         "be multiples of 8 for the TMA tensor maps")
    sq_pad = -(-sq // BWD_TILE) * BWD_TILE
    sk_pad = -(-sk // BWD_TILE) * BWD_TILE
    dev = q.device
    rows = torch.empty(b, h, sq_pad, 2, dtype=torch.float32, device=dev)
    qp = torch.empty(sq_pad, dtype=torch.int32, device=dev)
    kp = torch.empty(b, sk_pad, dtype=torch.int32, device=dev)
    # under a causal mask the first key tiles of a row have the most items
    # and the last the fewest: a dK/dV block then takes tiles j and nk-1-j
    pair = bool(causal)
    cluster = bwd_cluster_size(b, kvh, sk, h // kvh, sq, hd,
                               _sm_count(dev.index if dev.index is not None
                                         else torch.cuda.current_device()),
                               pair, hd_v=hd_v)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    err = _bwd_library().repro_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), rows.data_ptr(), qp.data_ptr(),
        kp.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        q_pos.data_ptr(), kv_pos.data_ptr(),
        None if kv_mask is None else kv_mask.data_ptr(),
        b, h, kvh, sq, sk, hd, hd_v,
        hd**-0.5, float(softcap), int(window), int(causal), int(protected),
        cluster, int(pair), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: cudaError {err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0

