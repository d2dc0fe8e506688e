"""Single-token decode attention over a ring-buffer KV cache, CUDA C++ for
Hopper.

Replaces the TPU kernel ``repro.kernels.decode_attention._decode_kernel``
(wrapper ``repro.kernels.ops.decode_attention``, which transposes the cache
and pads G to 8 and hd to 128 for the TPU).  The kernel source is
``src/repro_torch/csrc/decode_attention.cu``; its header comment gives the
design and what bounds it on the H100.  In short: the G query heads that
share a kv head are processed together so each cache slot is read once per
group, the slots are split across blocks and a second small kernel combines
the splits' partial softmax states (flash-decoding), and the cache is read
in its own layout ``(B, S, KV, hd)``.  It is built with ``nvcc`` for
``sm_90a`` at first use and bound with ctypes; the C entry point returns
``cudaGetLastError()`` after the launches and the wrapper raises if it is
not 0.

Semantics (shared with :func:`decode_attention_plain`): one query token at
absolute position ``q_pos`` (a host ``int``); a slot is valid where
``kv_pos >= 0`` and ``kv_pos <= q_pos`` and, with ``window > 0``,
``kv_pos > q_pos - window`` or ``kv_pos < protected``; ``scale = hd **
-0.5``; a query with no valid slot gives zeros.  No softcap, no kv_mask.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

Tensor = torch.Tensor
NEG_INF = -1e30
SOURCE = "decode_attention.cu"
HEAD_DIMS = (32, 64, 128)
TILE = 64             # cache slots per staged tile (csrc TILE)
TARGET_BLOCKS = 264   # two blocks per SM of the H100's 132
MAX_SMEM = 232448     # bytes of shared memory a block may use on Hopper
MAX_GRID_Y = 65535


def decode_attention_plain(
    q: Tensor,          # (B, H, hd) or (B, 1, H, hd)
    k: Tensor,          # (B, S, KV, hd) cache layout
    v: Tensor,          # (B, S, KV, hd)
    q_pos: int,
    kv_pos: Tensor,     # (S,) int, < 0 = empty slot
    *,
    window: int = 0,
    protected: int = 0,
) -> Tensor:
    """The kernel's function in plain PyTorch, all math in float32."""
    shape = q.shape
    b, h, hd = shape[0], shape[-2], shape[-1]
    kvh = k.shape[2]
    qf = q.to(torch.float32).reshape(b, kvh, h // kvh, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qf, k.to(torch.float32)) * hd**-0.5
    kp = kv_pos.to(torch.int64)
    valid = (kp >= 0) & (kp <= q_pos)
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


def _check(q, k, v, kv_pos) -> None:
    for name, t in (("q", q), ("k", k), ("v", v), ("kv_pos", kv_pos)):
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
    if kv_pos.dtype != torch.int32:
        raise TypeError(f"decode_attention: kv_pos must be int32, got {kv_pos.dtype}")
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
    if b * kvh > MAX_GRID_Y:
        raise ValueError(f"decode_attention: B*KV = {b * kvh} exceeds {MAX_GRID_Y}")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    fn = lib.repro_decode_attention_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 7
        + [ctypes.c_int] * 10
        + [ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    lib.repro_decode_attention_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.repro_decode_attention_smem_bytes.restype = ctypes.c_longlong
    return lib


@functools.cache
def _smem_bytes(hd: int, g: int) -> int:
    return _library().repro_decode_attention_smem_bytes(hd, g)


def split_plan(batch: int, kv_heads: int, slots: int) -> tuple[int, int]:
    """(number of splits, slots per split): enough blocks to cover the card
    twice, each split a whole number of tiles."""
    tiles = -(-slots // TILE)
    want = max(1, -(-TARGET_BLOCKS // (batch * kv_heads)))
    per = -(-tiles // min(tiles, want))
    chunk = per * TILE
    return -(-slots // chunk), chunk


def decode_attention(
    q: Tensor,          # (B, H, hd) or (B, 1, H, hd), one token per row
    k: Tensor,          # (B, S, KV, hd) cache layout
    v: Tensor,
    q_pos: int,
    kv_pos: Tensor,     # (S,) int32
    *,
    window: int = 0,
    protected: int = 0,
) -> Tensor:
    """GQA decode attention over the cache.  CPU tensors take
    :func:`decode_attention_plain`; CUDA tensors launch the kernel (bf16,
    head_dim 32/64/128) or raise."""
    if q.device.type == "cpu":
        return decode_attention_plain(
            q, k, v, q_pos, kv_pos, window=window, protected=protected
        )
    shape = q.shape
    q3 = q.reshape(shape[0], shape[-2], shape[-1])
    _check(q3, k, v, kv_pos)
    b, h, hd = q3.shape
    s, kvh = k.shape[1], k.shape[2]
    smem = _smem_bytes(hd, h // kvh)
    if smem > MAX_SMEM:
        raise ValueError(
            f"decode_attention: G = {h // kvh} needs {smem} bytes of shared "
            f"memory, more than {MAX_SMEM}"
        )
    nsplit, chunk = split_plan(b, kvh, s)
    out = torch.empty_like(q3)
    g = h // kvh
    if nsplit > 1:
        part_acc = torch.empty(
            (nsplit, b * kvh, g, hd), dtype=torch.float32, device=q.device
        )
        part_ml = torch.empty(
            (nsplit, b * kvh, g, 2), dtype=torch.float32, device=q.device
        )
        parts = (part_acc.data_ptr(), part_ml.data_ptr())
    else:
        parts = (None, None)
    err = _library().repro_decode_attention_fwd(
        q3.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        kv_pos.data_ptr(), *parts,
        b, h, kvh, s, hd, nsplit, chunk,
        int(q_pos), int(window), int(protected), hd**-0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: cudaError {err}")
    decode_attention.launches += 1
    return out.reshape(shape)


decode_attention.launches = 0
