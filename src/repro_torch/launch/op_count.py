"""A FLOP and byte counter for the port's programs (the counterpart of the
reference's ``repro.launch.hlo_analysis``).

The reference compiles each program with XLA and reads the FLOPs of every
``dot`` and the operand and result bytes of every top-level op from the
compiled HLO, loops multiplied out.  The port has no compiler to ask, so
:class:`OpCounter` is a ``TorchDispatchMode`` that sees every aten op a
program runs, forward and backward, eagerly, on any device; on the
``meta`` device nothing is allocated, so a full-width model at a dry-run
shape is counted in seconds.  It counts:

* ``flops``: 2·M·N·K of every product: ``mm``, ``addmm``, ``bmm``,
  ``baddbmm`` (``einsum`` and ``matmul`` lower to them) and the SDPA ops;
  elementwise work is not counted, as the reference counts only ``dot``;
* ``bytes``: the inputs plus the outputs of every op that is not a view
  (nor ``empty``).  For eager code this is an upper bound on HBM traffic:
  an input that an earlier op just wrote may still sit in L2, and the
  reference's fused HLO counts a fusion's operands once.

The kernel wrappers of :mod:`repro_torch.kernels` do not run their plain
versions on ``meta`` tensors: they call the handlers this module
registers in :data:`repro_torch.kernels.META_HANDLERS`.  Each returns an
empty output of the right shape (through :class:`_MetaAttention` under autograd, whose backward
returns empty gradients) and charges the counter with the work of its
plain version (:func:`charge`): attention as the dense Sq×Sk products the
reference's naive SDPA computes (forward Q·K^T and P·V; backward four
products of the same size), and beside them the products of only the
(query, key) pairs the masks keep, ``kept_flops``; ``era_update`` only its
bytes (its math is elementwise).  The kept pairs follow from the masks'
parameters with the positions a program gives on ``meta`` (queries at
the last Sq of Sk positions, every key valid), since meta tensors hold no
values.

A program whose state is placed on a fake ``DeviceMesh``
(:func:`repro_torch.parallel.sharding.distribute`) runs as DTensors: the
counter lets DTensor dispatch each op first (it returns
``NotImplemented`` for DTensor arguments) and so counts the ops DTensor
runs on rank 0's local shards, its sharding propagation (run under a fake
tensor mode) left out.  That gives the partitioned program's work on one
device, as the reference reads it from the partitioned HLO; the kernel
wrappers' handlers take local shards too
(:mod:`repro_torch.parallel.dtensor`).  The collectives DTensor issues
(functional collectives on the local shards) are counted by kind, as the
result bytes of each, the reference's ``hlo_analysis`` measure:
``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all`` and
``collective-permute`` (point to point).

The counter also tracks ``peak_bytes``: the most bytes, at any op, of the
storages that ops inside it allocated and that are still alive (a view
shares its base's storage and counts once; the tensors autograd saves
for the backward stay alive until the backward frees them).  State
handed to the program (weights, moments, cache, inputs) is not in it.
"""

from __future__ import annotations

import contextvars
import math
import weakref

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import META_HANDLERS
from repro_torch.parallel import dtensor as DT

Tensor = torch.Tensor

_ACTIVE: contextvars.ContextVar["OpCounter | None"] = contextvars.ContextVar(
    "repro_torch_op_counter", default=None)

#: ops that move no data of their own
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "_unsafe_view", "detach", "lift_fresh", "alias",
         "_reshape_alias", "set_", "resize_", "wait_tensor",
         "_wrap_tensor_autograd"}

#: the collective ops DTensor issues, by the reference's kind names
COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}
_FAKE = torch._C._TorchDispatchModeKey.FAKE


def _nbytes(t: Tensor) -> int:
    """Bytes of ``t``, or of rank 0's shard of a DTensor."""
    t = DT.local(t)
    return t.numel() * t.element_size()


def _mm_flops(func, args, out) -> float:
    """2·M·N·K of a product op, else 0."""
    name = func.overloadpacket.__name__
    if name in ("mm", "addmm"):
        a = args[1] if name == "addmm" else args[0]
        return 2.0 * out.numel() * a.shape[-1]
    if name in ("bmm", "baddbmm"):
        a = args[1] if name == "baddbmm" else args[0]
        return 2.0 * out.numel() * a.shape[-1]
    if "scaled_dot_product" in name and isinstance(args[0], Tensor):
        q, k, v = args[:3]
        b_h = math.prod(q.shape[:-2])
        return 2.0 * b_h * q.shape[-2] * k.shape[-2] * (q.shape[-1] + v.shape[-1])
    return 0.0


class OpCounter(TorchDispatchMode):
    """Counts FLOPs, bytes, collectives and the peak of live allocations of
    the aten ops run inside ``with OpCounter() as c:`` (see the module
    docstring).  ``by_op`` holds each op's (flops, bytes, calls)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        #: the dense attention products charged by the kernel wrappers, and
        #: those of the pairs the masks keep
        self.attn_flops = 0.0
        self.attn_kept_flops = 0.0
        self.by_op: dict[str, list] = {}
        #: result bytes of each collective kind
        self.collectives: dict[str, float] = {}
        #: storages allocated inside the counter and still alive: key ->
        #: bytes; their sum, and its most so far
        self._live: dict[int, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._token = None

    def __enter__(self):
        self._token = _ACTIVE.set(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.reset(self._token)
        return super().__exit__(*exc)

    def scale(self, k: int) -> None:
        """Everything counted so far, ``k`` times (a repeated part); the
        peak stays, as a repeat reuses its memory."""
        self.flops *= k
        self.bytes *= k
        self.attn_flops *= k
        self.attn_kept_flops *= k
        for row in self.by_op.values():
            row[0] *= k
            row[1] *= k
            row[2] *= k
        for kind in self.collectives:
            self.collectives[kind] *= k

    def add(self, name: str, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.bytes += nbytes
        row = self.by_op.setdefault(name, [0.0, 0.0, 0])
        row[0] += flops
        row[1] += nbytes
        row[2] += 1

    def add_collective(self, kind: str, nbytes: float) -> None:
        self.collectives[kind] = self.collectives.get(kind, 0.0) + nbytes

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key)

    def _track(self, ins: list, outs: list) -> None:
        """Add the outputs' new storages (not an input's: a view or an
        in-place result) to the live set, each until it dies (a storage
        keeps its Python object while it lives, so a finalizer on that
        object runs when the storage is freed); update the peak."""
        seen = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in seen or key in self._live:
                continue
            self._live[key] = st.nbytes()
            self.live_bytes += st.nbytes()
            weakref.finalize(st, self._free, key)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented   # DTensor runs it on the local shards
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(_FAKE) is not None:
            return out              # DTensor's sharding propagation
        name = func.overloadpacket.__name__
        ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, Tensor)]
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, Tensor)]
        self._track(ins, outs)
        kind = COLLECTIVE_KINDS.get(name)
        if kind is not None:
            self.add_collective(kind, sum(map(_nbytes, outs)))
        if func.is_view or name in _FREE:
            return out
        first = outs[0] if outs else None
        flops = _mm_flops(func, args, first) if first is not None else 0.0
        self.add(name, flops, sum(map(_nbytes, ins)) + sum(map(_nbytes, outs)))
        return out

    @property
    def kept_flops(self) -> float:
        """``flops`` with the attention products of the kept pairs only."""
        return self.flops - self.attn_flops + self.attn_kept_flops

    def summary(self) -> dict:
        top = sorted(self.by_op.items(), key=lambda kv: -kv[1][0])
        return {
            "flops": self.flops,
            "kept_flops": self.kept_flops,
            "attention_flops": self.attn_flops,
            "attention_kept_flops": self.attn_kept_flops,
            "bytes": self.bytes,
            "ops": sum(r[2] for r in self.by_op.values()),
            "flops_by_op": {k: v[0] for k, v in top if v[0] > 0},
            "collectives": dict(self.collectives),
            "collective_bytes_total": sum(self.collectives.values()),
            "peak_bytes": self.peak_bytes,
        }


def charge(name: str, flops: float, nbytes: float, attn: float = 0.0,
           attn_kept: float = 0.0) -> None:
    """Add a kernel wrapper's work on ``meta`` tensors to the active
    counter (none active: nothing to do)."""
    counter = _ACTIVE.get()
    if counter is None:
        return
    counter.add(name, flops, nbytes)
    counter.attn_flops += attn
    counter.attn_kept_flops += attn_kept


def kept_pairs(sq: int, sk: int, *, causal: bool, window: int,
               protected: int) -> int:
    """(query, key) pairs the masks keep, queries at positions sk - sq ..
    sk - 1 over keys 0 .. sk - 1, every key valid."""
    p = np.arange(sq, dtype=np.int64) + (sk - sq)
    hi = np.minimum(p, sk - 1) if causal else np.full(sq, sk - 1, np.int64)
    lo = np.maximum(p - window + 1, 0) if window > 0 else np.zeros(sq, np.int64)
    count = np.maximum(hi - lo + 1, 0)
    if window > 0 and protected > 0:   # sinks below the window stay visible
        count = count + np.minimum(np.minimum(protected, lo), hi + 1)
    return int(count.sum())


def _attention_work(q, k, v, *, causal, window, protected):
    """(dense forward FLOPs, kept forward FLOPs) of one attention call,
    q (B, Sq, H, hd), k (B, Sk, KV, hd), v (B, Sk, KV, hd_v)."""
    b, sq, h, hd = q.shape
    sk, hd_v = k.shape[1], v.shape[-1]
    per_pair = 2.0 * b * h * (hd + hd_v)
    kept = kept_pairs(sq, sk, causal=causal, window=window, protected=protected)
    return per_pair * sq * sk, per_pair * kept


class _MetaAttention(torch.autograd.Function):
    """Attention on ``meta`` tensors under autograd: empty outputs and
    gradients, its products charged to the counter (backward: twice the
    forward's, the four products dS, dP·, dQ and dK of the naive SDPA)."""

    @staticmethod
    def forward(ctx, q, k, v, extra_bytes, opts):
        ctx.opts = opts
        ctx.save_for_backward(q, k, v)
        out = q.new_empty(q.shape[:-1] + (v.shape[-1],))
        dense, kept = _attention_work(q, k, v, **opts)
        charge("flash_attention", dense,
               sum(map(_nbytes, (q, k, v, out))) + extra_bytes, dense, kept)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dense, kept = _attention_work(q, k, v, **ctx.opts)
        nbytes = 2 * sum(map(_nbytes, (q, k, v))) + 2 * _nbytes(do)
        charge("flash_attention_bwd", 2 * dense, nbytes, 2 * dense, 2 * kept)
        return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape), None, None


def meta_attention(q, k, v, q_pos, kv_pos, *, kv_mask, window, causal,
                   protected) -> Tensor:
    """:func:`repro_torch.kernels.flash_attention.flash_attention` on
    ``meta`` tensors (DTensors: on rank 0's heads)."""
    if DT.is_dtensor(q):
        return DT.on_local_heads(meta_attention, q, k, v, q_pos, kv_pos,
                                 kv_mask=kv_mask, window=window, causal=causal,
                                 protected=protected)
    extra = _nbytes(q_pos) + _nbytes(kv_pos) + (0 if kv_mask is None else _nbytes(kv_mask))
    opts = dict(causal=causal, window=int(window), protected=int(protected))
    return _MetaAttention.apply(q, k, v, extra, opts)


def meta_decode(q, k, v, kv_pos, *, window, protected, causal) -> Tensor:
    """:func:`repro_torch.kernels.decode_attention.decode_attention` on
    ``meta`` tensors: one query a row over every slot of the cache, full
    (DTensors: :func:`repro_torch.parallel.dtensor.on_local_decode`)."""
    if DT.is_dtensor(q):
        return DT.on_local_decode(meta_decode, q, k, v, kv_pos, window=window,
                                  protected=protected, causal=causal)
    b, h, hd = q.shape[0], q.shape[-2], q.shape[-1]
    q4 = q.reshape(b, 1, h, hd)
    dense, kept = _attention_work(q4, k, v, causal=causal, window=int(window),
                                  protected=int(protected))
    out = q.new_empty(q.shape)
    charge("decode_attention", dense,
           sum(map(_nbytes, (q, k, v, kv_pos, out))), dense, kept)
    return out


def meta_era_update(x, eps_buf, tau, lag_w, cx, ce, active):
    """:func:`repro_torch.kernels.era_update.era_update` on ``meta``
    tensors: its bytes (elementwise math, no products)."""
    x_next, eps_bar = torch.empty_like(x), torch.empty_like(x)
    ins = [t for t in (x, eps_buf, tau, lag_w, cx, ce, active) if t is not None]
    charge("era_update", 0.0, sum(map(_nbytes, ins)) + 2 * _nbytes(x))
    return x_next, eps_bar


META_HANDLERS.update(flash_attention=meta_attention, decode_attention=meta_decode,
                     era_update=meta_era_update)
