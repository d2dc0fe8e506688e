"""Single-token decode attention over a ring-buffer KV cache, CUDA C++ for
Hopper.

Replaces the TPU kernel ``repro.kernels.decode_attention._decode_kernel``
(wrapper ``repro.kernels.ops.decode_attention``, which transposes the cache
and pads G to 8 and hd to 128 for the TPU).  The kernel source is
``src/repro_torch/csrc/decode_attention.cu``; its header comment gives the
design and what bounds it on the H100.  In short: one launch, in which the
G query heads that share a kv head are processed together so each cache
slot is read once per group; the slots of a group are dealt in 16-slot
tiles to the blocks of a thread-block cluster, which merge their softmax
states through distributed shared memory; only valid rows are copied, all
of a warp's tiles at once; and the cache is read in its own layout
``(B, S, KV, hd)``.  It is built with ``nvcc`` for ``sm_90a`` at first use
and bound with ctypes; the C entry point returns the launch's
``cudaError_t`` and the wrapper raises if it is not 0.

Semantics (shared with :func:`decode_attention_plain`): one query token at
absolute position ``q_pos`` (a host ``int``, or an int32 tensor of one
element, which the kernel reads on the device); a slot is valid where
``kv_pos >= 0`` and, when ``causal`` (the default: a self-attention ring),
``kv_pos <= q_pos``, and, with ``window > 0``, ``kv_pos > q_pos - window``
or ``kv_pos < protected``; ``causal=False`` serves cross-attention over an
encoder's keys (whisper's decoder), whose positions run past the query's;
``scale = hd ** -0.5``; a query with no valid slot gives zeros.  No
softcap, no kv_mask.  The head dims with an instance are 32, 64, 128 and
256 (paligemma's MQA heads); a CUDA tensor of another raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, on_meta

Tensor = torch.Tensor
NEG_INF = -1e30
SOURCE = "decode_attention.cu"
HEAD_DIMS = (32, 64, 128, 256)
TILE = 16             # cache slots a warp tile (csrc TILE)
NWARPS = 4            # warps a block (csrc NWARPS)
HEADS = 8             # query heads a block (csrc HEADS)
MAX_STAGES = 4        # ring stages a warp (csrc MAX_STAGES)
MAX_CLUSTER = 8       # blocks a cluster: the portable limit
SMS = 132             # the H100's SMs: a wave of blocks
MAX_SMEM = 232448     # bytes of shared memory a block may use on Hopper
MAX_GRID_Y = 65535


def decode_attention_plain(
    q: Tensor,          # (B, H, hd) or (B, 1, H, hd)
    k: Tensor,          # (B, S, KV, hd) cache layout
    v: Tensor,          # (B, S, KV, hd)
    q_pos: int | Tensor,  # host int, or a one-element int tensor
    kv_pos: Tensor,     # (S,) int, < 0 = empty slot
    *,
    window: int = 0,
    protected: int = 0,
    causal: bool = True,
) -> Tensor:
    """The kernel's function in plain PyTorch, all math in float32."""
    shape = q.shape
    b, h, hd = shape[0], shape[-2], shape[-1]
    kvh = k.shape[2]
    qf = q.to(torch.float32).reshape(b, kvh, h // kvh, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qf, k.to(torch.float32)) * hd**-0.5
    kp = kv_pos.to(torch.int64)
    if isinstance(q_pos, Tensor):
        q_pos = q_pos.to(device=kp.device, dtype=torch.int64).reshape(())
    valid = kp >= 0
    if causal:
        valid = valid & (kp <= q_pos)
    if window > 0:
        in_w = kp > q_pos - window
        if protected > 0:
            in_w = in_w | (kp < protected)
        valid = valid & in_w
    s = torch.where(valid, s, torch.full((), NEG_INF, device=s.device))
    w = torch.softmax(s, dim=-1)
    w = torch.where(valid.any(), w, torch.zeros((), device=w.device))
    out = torch.einsum("bkgs,bskd->bkgd", w, v.to(torch.float32))
    return out.reshape(shape).to(q.dtype)


def _check(q, k, v, q_pos, kv_pos) -> None:
    named = (("q", q), ("k", k), ("v", v), ("q_pos", q_pos), ("kv_pos", kv_pos))
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"decode_attention: {name} is on {t.device}, not cuda")
        if t.device != q.device:
            raise ValueError(f"decode_attention: {name} is on another card")
        if not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"decode_attention: {name} must be bfloat16, got {t.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be 16-byte aligned")
    for name, t in (("q_pos", q_pos), ("kv_pos", kv_pos)):
        if t.dtype != torch.int32:
            raise TypeError(f"decode_attention: {name} must be int32, got {t.dtype}")
    if q_pos.numel() != 1:
        raise ValueError(f"decode_attention: q_pos must hold one position, got "
                         f"{tuple(q_pos.shape)}")
    b, h, hd = q.shape
    _, s, kvh, _ = k.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head_dim {hd} not in {HEAD_DIMS}")
    if k.shape != (b, s, kvh, hd) or v.shape != k.shape:
        raise ValueError(
            f"decode_attention: k {tuple(k.shape)} / v {tuple(v.shape)} do not "
            f"match q {tuple(q.shape)}"
        )
    if kvh < 1 or h % kvh:
        raise ValueError(f"decode_attention: {h} heads not a multiple of {kvh}")
    if s < 1:
        raise ValueError("decode_attention: empty cache")
    if kv_pos.shape != (s,):
        raise ValueError(f"decode_attention: kv_pos must be ({s},)")
    groups = b * kvh * head_chunks(h // kvh)
    if groups > MAX_GRID_Y:
        raise ValueError(f"decode_attention: {groups} head groups exceed {MAX_GRID_Y}")


@functools.cache
def _library() -> ctypes.CDLL:
    return bind(build.load(SOURCE))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C entry points' argument types on a loaded library (once, at
    load; ctypes would otherwise cut the pointers to 32-bit ints)."""
    fn = lib.repro_decode_attention_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 6
        + [ctypes.c_int] * 10
        + [ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    lib.repro_decode_attention_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.repro_decode_attention_smem_bytes.restype = ctypes.c_longlong
    lib.repro_decode_attention_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.c_longlong]
    lib.repro_decode_attention_blocks_per_sm.restype = ctypes.c_int
    return lib


@functools.cache
def smem_bytes(hd: int, stages: int, slots: int, cluster: int) -> int:
    """Shared memory a block takes for this plan (from the kernel's own
    layout)."""
    tiles = -(-slots // TILE)
    nloc = -(-tiles // cluster)  # most tiles a block of the cluster holds
    return _library().repro_decode_attention_smem_bytes(hd, stages, nloc, cluster)


def head_chunks(g: int) -> int:
    """8-head chunks of a group of ``g`` query heads: clusters a (b, kv
    head)."""
    return -(-g // HEADS)


def split_plan(
    batch: int, kv_heads: int, slots: int, g: int, cluster: int | None = None,
) -> tuple[int, int]:
    """(blocks a cluster, ring stages a warp).  A group's slots are split
    over a cluster of blocks until the groups' blocks make one wave of the
    card (at most ``MAX_CLUSTER``, at most one 16-slot tile a block; 1 where
    the groups alone fill the card); a warp's ring holds all its tiles, up
    to ``MAX_STAGES``.  ``cluster`` forces the cluster size."""
    groups = batch * kv_heads * head_chunks(g)
    tiles = -(-slots // TILE)
    if cluster is None:
        cluster = max(1, min(MAX_CLUSTER, SMS // groups, tiles))
    per_block = -(-tiles // cluster)
    per_warp = -(-per_block // NWARPS)
    return cluster, max(1, min(MAX_STAGES, per_warp))


def decode_attention(
    q: Tensor,          # (B, H, hd) or (B, 1, H, hd), one token per row
    k: Tensor,          # (B, S, KV, hd) cache layout
    v: Tensor,
    q_pos: int | Tensor,  # host int, or a one-element int32 tensor
    kv_pos: Tensor,     # (S,) int32
    *,
    window: int = 0,
    protected: int = 0,
    causal: bool = True,
) -> Tensor:
    """GQA decode attention over the cache.  CPU tensors take
    :func:`decode_attention_plain`; CUDA tensors launch the kernel (bf16,
    a head_dim of :data:`HEAD_DIMS`) or raise; ``meta`` tensors go to the
    registered handler (:func:`on_meta`).  A host-int ``q_pos`` is
    written to the card first; a tensor is read there by the kernel."""
    if q.device.type == "cpu":
        return decode_attention_plain(
            q, k, v, q_pos, kv_pos, window=window, protected=protected,
            causal=causal,
        )
    if q.device.type == "meta":   # shapes only: the dry run's counter
        return on_meta("decode_attention", q, k, v, kv_pos, window=window,
                           protected=protected, causal=causal)
    if not isinstance(q_pos, Tensor):
        q_pos = torch.full((1,), int(q_pos), dtype=torch.int32, device=q.device)
    shape = q.shape
    q3 = q.reshape(shape[0], shape[-2], shape[-1])
    _check(q3, k, v, q_pos, kv_pos)
    b, h, hd = q3.shape
    s, kvh = k.shape[1], k.shape[2]
    cluster, stages = split_plan(b, kvh, s, h // kvh)
    # a wide head's ring stages may not all fit a block: fewer stages a
    # warp (the ring refills as it is consumed)
    while stages > 1 and smem_bytes(hd, stages, s, cluster) > MAX_SMEM:
        stages -= 1
    smem = smem_bytes(hd, stages, s, cluster)
    if smem > MAX_SMEM:
        raise ValueError(
            f"decode_attention: {s} slots need {smem} bytes of shared memory "
            f"a block, more than {MAX_SMEM}"
        )
    out = torch.empty_like(q3)
    err = _library().repro_decode_attention_fwd(
        q3.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        q_pos.data_ptr(), kv_pos.data_ptr(),
        b, h, kvh, s, hd, cluster, stages, int(window), int(protected),
        int(causal), hd**-0.5, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: cudaError {err}")
    decode_attention.launches += 1
    return out.reshape(shape)


decode_attention.launches = 0
