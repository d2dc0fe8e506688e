"""Regions of a partitioned dry-run program that run on local shards.

The dry run places a program's state on a fake ``DeviceMesh``
(:func:`repro_torch.parallel.sharding.distribute`) and lets DTensor's
sharding propagation partition the rest, as GSPMD partitions the
reference's program.  A few regions have no propagation rule that keeps
the reference's partition (DTensor would gather a sharded weight or a
sharded activation, or has no rule at all).  Each runs on rank 0's local
shards here, and says in its docstring which collective it stands for:

* the kernel wrappers' ``meta`` handlers (:func:`on_local_heads`,
  :func:`on_local_decode`, called by :mod:`repro_torch.launch.op_count`);
* torch calls on a split dim, routed by the :class:`Regions` mode that
  :func:`partitioned` installs: the vocab-parallel embedding, log-sum-exp
  and gather of the cross-entropy, and a cache write at slots one rank
  holds;
* modules of the model, routed by :func:`install`, which the dry run
  calls on its meta model once the parameters are placed: an fsdp-split
  weight gathered at its use, the norms and the attention projections
  (Megatron's ``f`` and the split into heads), MLA's absorbed decode over
  a slot-split cache, the MoE dispatch, the Mamba scan and the xLSTM
  cells.

The model files know nothing of this: on the card and on the CPU no
module is routed and no mode is installed.
"""

from __future__ import annotations

import contextlib
import types

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication
from torch.overrides import TorchFunctionMode

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models.mla import MLA
from repro_torch.models.mla import cache_write as mla_cache_write
from repro_torch.models.moe import MoE

Tensor = torch.Tensor


def is_dtensor(t) -> bool:
    return isinstance(t, DTensor)


def local(t):
    """Rank 0's shard of a DTensor (no autograd); anything else as it is."""
    return t._local_tensor if is_dtensor(t) else t


def model_dim(t) -> int | None:
    """The index of the ``model`` axis in ``t``'s mesh (None: no such axis)."""
    names = t.device_mesh.mesh_dim_names or ()
    return names.index("model") if "model" in names else None


def tp(t) -> int:
    """The size of ``t``'s ``model`` axis (1 without one)."""
    i = model_dim(t)
    return 1 if i is None else t.device_mesh.size(i)


def on_model(t, placement) -> list:
    """``t``'s placements with the ``model`` axis's entry replaced."""
    out = list(t.placements)
    i = model_dim(t)
    if i is not None:
        out[i] = placement
    return out


def split_on_model(t, dim: int) -> bool:
    """Is ``t`` a DTensor split over ``model`` on ``dim``?"""
    if not is_dtensor(t):
        return False
    i = model_dim(t)
    return i is not None and t.placements[i] == Shard(dim % t.dim())


def to_model(t, placement):
    """``t`` redistributed to ``placement`` on the ``model`` axis (the
    collective, if any, is DTensor's, and is counted)."""
    want = on_model(t, placement)
    return t if list(t.placements) == want else t.redistribute(t.device_mesh, want)


def whole_rows(x):
    """A DTensor replicated on ``model`` (at a norm's input a partial sum
    is reduced once here, where the reference's partition reduces a
    block's output), anything else as it is."""
    return to_model(x, Replicate()) if is_dtensor(x) else x


def placed_like(g, p):
    """A gradient ``g`` placed as its parameter ``p`` (a DTensor's sum
    over the data axes reduced, once); anything but a DTensor as it is."""
    if not is_dtensor(g) or list(g.placements) == list(p.placements):
        return g
    return g.redistribute(p.device_mesh, p.placements)


def same_grads(y):
    """``y`` unchanged in the forward; in the backward its gradient is
    placed as ``y`` before it flows on.  At a norm's output (replicated on
    ``model``) that all-reduces the partial sums the column-parallel
    products that read it return (Megatron's ``f``), so the residual
    stream's gradient stays whole; at a merge of heads it makes the
    gradient's layout one that splits back into heads.  Anything but a
    DTensor as it is."""
    if not is_dtensor(y):
        return y
    i = model_dim(y)
    return from_local(y.to_local(), y, None if i is None else y.placements[i],
                      shape=y.shape)


def for_heads(y, heads: int):
    """A projection's output (..., heads * hd) about to be split into
    heads: gathered on ``model`` where ``heads`` does not divide the axis
    (its shards would cut a head), else as it is (so too anything but a
    DTensor)."""
    if not is_dtensor(y) or heads % tp(y) == 0:
        return y
    return to_model(y, Replicate())


def to_local(t, grad_on_model=None) -> Tensor:
    """Rank 0's shard, differentiable; ``grad_on_model`` is the placement
    of its gradient on the ``model`` axis (default: the tensor's own), as
    ``Partial()`` where each rank's gradient is a share of the sum."""
    grad = None if grad_on_model is None else on_model(t, grad_on_model)
    return t.to_local(grad_placements=grad)


def weight_grad(w, act) -> list:
    """The placements of the gradient of a weight ``w`` used on the local
    shards of ``act``: a share of the sum on each mesh axis where ``w``
    replicates and ``act`` is split (data parallelism), ``w``'s own
    elsewhere."""
    return [Partial() if isinstance(p, Replicate) and isinstance(a, Shard) else p
            for p, a in zip(w.placements, act.placements)]


def whole_on_data(w):
    """A weight gathered over the data axes (an fsdp-split weight is
    all-gathered before its use, and its gradient reduce-scattered back),
    its ``model`` split kept; anything but a DTensor as it is."""
    if not is_dtensor(w):
        return w
    i = model_dim(w)
    want = [p if k == i else Replicate() for k, p in enumerate(w.placements)]
    return w if want == list(w.placements) else w.redistribute(w.device_mesh, want)


def weight_local(w, act) -> Tensor:
    """Rank 0's shard of a weight ``w`` (gathered over the data axes:
    :func:`whole_on_data`) used on the local shards of ``act``,
    differentiable (:func:`weight_grad`)."""
    w = whole_on_data(w)
    return w.to_local(grad_placements=weight_grad(w, act))


def scalar_mean(v: Tensor, like):
    """A scalar computed on rank 0's rows of ``like`` (a mean over them)
    as a DTensor: a share of the mean over the data axes ``like`` is split
    on, whole on the others."""
    pl = [Partial("avg") if isinstance(p, Shard) else Replicate()
          for p in like.placements]
    return DTensor.from_local(v, like.device_mesh, pl, run_check=False,
                              shape=v.shape, stride=v.stride())


def from_local(x: Tensor, like, placement, shape=None):
    """A local result as a DTensor placed as ``like`` but for ``placement``
    on the ``model`` axis; ``shape`` its global shape where the local one
    does not tell it (an uneven split)."""
    pl = on_model(like, placement)
    if shape is None:
        shape = list(x.shape)
        for i, p in enumerate(pl):
            if isinstance(p, Shard):
                shape[p.dim] *= like.device_mesh.size(i)
    return DTensor.from_local(x, like.device_mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def gathered(t: Tensor, like, dim: int):
    """Rank 0's slice ``t`` of a tensor split over ``model`` on ``dim``
    (its other placements ``like``'s), all-gathered whole on ``model``."""
    return to_model(from_local(t, like, Shard(dim)), Replicate())


# ---------------------------------------------------------------------------
# the kernel wrappers' meta handlers on local heads
# ---------------------------------------------------------------------------


def heads_split(q, k):
    """How an attention call's heads sit on the ``model`` axis: (q's
    placement, k/v's placement, how many kv heads rank 0 reads).  Query
    heads are sharded where their count divides the axis, else replicated
    (every rank computes every head, as the partitioned HLO does);
    kv heads are sharded where theirs divides it too, else replicated and
    taken by index (GQA: rank 0's query heads read kv heads 0 .. n-1)."""
    t = tp(q)
    h, kvh = q.shape[-2], k.shape[2]
    if t == 1 or h % t:
        return Replicate(), Replicate(), kvh
    if kvh % t == 0:
        return Shard(q.dim() - 2), Shard(2), kvh // t
    g = h // kvh
    return Shard(q.dim() - 2), Replicate(), (h // t - 1) // g + 1


def on_local_heads(fn, q, k, v, *rest, **kw):
    """``fn(q, k, v, *rest, **kw)`` (an attention over (B, S, H, hd)
    heads) on rank 0's heads: q, k and v go to :func:`heads_split`'s
    placements, the call runs on the local shards (kv heads by index
    where they replicate; their gradient is then a share of the sum) and
    its output comes back placed as q.  Any DTensor in ``rest`` or ``kw``
    (a key mask over the batch) is taken local."""
    qp, kvp, nkv = heads_split(q, k)
    q, k, v = to_model(q, qp), to_model(k, kvp), to_model(v, kvp)
    share = Partial() if isinstance(qp, Shard) and isinstance(kvp, Replicate) else None
    ql, kl, vl = to_local(q), to_local(k, share), to_local(v, share)
    if kl.shape[2] != nkv:
        kl, vl = kl[:, :, :nkv], vl[:, :, :nkv]
    rest = [local(r) for r in rest]
    kw = {n: local(a) for n, a in kw.items()}
    return from_local(fn(ql, kl, vl, *rest, **kw), q, qp)


def _softmax_merge(like, rows: tuple) -> None:
    """The two all-reduces that merge split-K softmaxes: each split's
    running max and its sum of exponentials, (B, H) float32 a row of
    ``like``'s; their values (the rescale) are not needed on ``meta``."""
    stat = torch.empty(rows, dtype=torch.float32, device=local(like).device)
    for op in ("max", "sum"):
        to_model(from_local(stat, like, Partial(op)), Replicate())


def on_local_slots(fn, queries: tuple, layers: tuple, pos, **kw):
    """``fn(*queries, *layers, pos, **kw)``, an attention of one query a
    row (each of ``queries`` (B, 1, H, ...)) over cache ``layers`` (B,
    slots, ...) split over their slots on ``model``, at slot positions
    ``pos``: the query heads are gathered, rank 0 attends over its own
    slots with every head, and its output is a share of the sum over
    ``model`` (split-K decode: the sum is DTensor's, a reduce-scatter into
    the output projection's rows or an all-reduce; the softmax's merge
    adds two all-reduces of a number a head and row)."""
    queries = [to_model(q, Replicate()) for q in queries]
    ls = [to_local(c) for c in layers]
    ql = [to_local(q) for q in queries]
    _softmax_merge(queries[0], (ql[0].shape[0], ql[0].shape[-2]))
    out = fn(*ql, *ls, local(pos)[: ls[0].shape[1]], **kw)
    return from_local(out, queries[0], Partial())


def on_local_decode(fn, q, k, v, kv_pos, **kw):
    """``fn(q, k, v, kv_pos, **kw)`` (decode attention over a cache (B,
    slots, KV, hd)) on rank 0's share: split-K over a cache split over its
    slots (:func:`on_local_slots`), else the heads split as in
    :func:`on_local_heads`."""
    if split_on_model(k, 1):
        return on_local_slots(fn, (q,), (k, v), kv_pos, **kw)
    return on_local_heads(fn, q, k, v, local(kv_pos), **kw)


# ---------------------------------------------------------------------------
# torch calls on a split dim: the Regions mode
# ---------------------------------------------------------------------------


def vocab_parallel_embedding(tokens, table):
    """``F.embedding(tokens, table)`` with the table's rows (the vocab)
    sharded over ``model``: rank 0 looks up the ids its rows hold, zeros
    elsewhere, and the result is a partial sum over ``model`` (Megatron's
    vocab-parallel embedding; the all-reduce comes where a later op needs
    the sum).  DTensor's own rule for this keeps a mask that does not
    survive a dtype cast."""
    tl = to_local(tokens)
    table_l = table.to_local(grad_placements=weight_grad(table, tokens))
    # rank 0 holds rows 0 .. rows - 1: the others' ids read a masked row 0
    held = tl < table_l.shape[0]
    ids = torch.where(held, tl, torch.zeros((), dtype=tl.dtype, device=tl.device))
    out = F.embedding(ids, table_l) * held[..., None]
    split = split_on_model(table, 0)
    return from_local(out.to(table_l.dtype), tokens, Partial() if split else Replicate(),
                      shape=(*tokens.shape, table.shape[1]))


def _reduced(x: Tensor, like, op: str):
    """A local result ``x`` that is a share of an ``op`` over ``model``
    (``like``'s rows), all-reduced."""
    return to_model(from_local(x, like, Partial(op)), Replicate())


def vocab_parallel_logsumexp(logits):
    """``torch.logsumexp(logits, dim=-1)`` over a last dim (the vocab)
    split over ``model``, as Megatron's vocab-parallel cross-entropy: rank
    0 reduces its columns and two all-reduces of a number a row (the max,
    the sum of exponentials) finish it; no rank gathers the logits."""
    lg = to_local(logits)
    m = _reduced(lg.detach().amax(dim=-1), logits, "max")
    se = _reduced(torch.exp(lg - to_local(m)[..., None]).sum(dim=-1), logits, "sum")
    return torch.log(se) + m


def vocab_parallel_gather(logits, index):
    """``torch.gather(logits, -1, index)`` over a last dim split over
    ``model``: rank 0 picks the ids its columns hold, zeros elsewhere, and
    an all-reduce sums the one rank's pick (the target's logit)."""
    lg = to_local(logits)
    idx = to_local(whole_rows(index))
    hit = idx < lg.shape[-1]
    ids = torch.where(hit, idx, torch.zeros((), dtype=idx.dtype, device=idx.device))
    return _reduced(torch.gather(lg, -1, ids) * hit, logits, "sum")


def write_slots(dst, index, value) -> bool:
    """``dst[layer, :, slot : stop] = value`` on a cache (L, B, slots, ...)
    split over its slots on ``model``: the write lands on the rank that
    holds the slots, so rank 0 writes the part in its own slots (none for
    a decode step past them); the value, whole on ``model`` there (every
    rank's cache holds every head), is gathered first.  False (nothing
    written) for any other write, which is DTensor's."""
    if not (split_on_model(dst, 2) and isinstance(index, tuple) and len(index) == 3
            and isinstance(index[2], slice)):
        return False
    layer, _, slots = index
    dl, vl = local(dst), local(to_model(value, Replicate()))
    slot = slots.start or 0
    hi = min(slots.stop, dl.shape[2])
    if slot < hi:
        dl[layer, :, slot:hi] = vl[:, : hi - slot]
    return True


class Regions(TorchFunctionMode):
    """Sends the torch calls that DTensor would partition by gathering
    a split dim to their local regions: ``F.embedding`` of a placed table,
    ``torch.logsumexp(x, dim=-1)`` and ``torch.gather(x, -1, index)`` over
    a last dim split on ``model`` (the model's cross-entropy, made
    vocab-parallel), and a cache write at slots (:func:`write_slots`).
    Every other call runs as it is."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is F.embedding and is_dtensor(args[1]):
            return vocab_parallel_embedding(args[0], args[1])
        if (func is torch.logsumexp and kwargs.get("dim") == -1
                and split_on_model(args[0], -1)):
            return vocab_parallel_logsumexp(args[0])
        if func is torch.gather and args[1] == -1 and split_on_model(args[0], -1):
            return vocab_parallel_gather(args[0], args[2])
        if func is Tensor.__setitem__ and write_slots(*args):
            return None
        return func(*args, **kwargs)


@contextlib.contextmanager
def partitioned():
    """The block runs a partitioned program: plain tensors it makes mix
    with DTensors as replicated ones, and the calls :class:`Regions`
    names run on local shards."""
    with implicit_replication(), Regions():
        yield


# ---------------------------------------------------------------------------
# modules: install
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def swapped(module, tensors: dict):
    """``module``'s parameters named in ``tensors`` (dotted names) replaced
    by those tensors for the block, as ``torch.func.functional_call``
    does, without calling ``forward``."""
    saved = []
    for name, t in tensors.items():
        owner, _, leaf = name.rpartition(".")
        m = module.get_submodule(owner)
        saved.append((m, leaf, m._parameters[leaf]))
        m._parameters[leaf] = t
    try:
        yield
    finally:
        for m, leaf, p in saved:
            m._parameters[leaf] = p


def _localize(tree):
    if isinstance(tree, dict):
        return {k: _localize(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_localize(v) for v in tree)
    return local(tree)


def _globalize(tree, like):
    if isinstance(tree, dict):
        return {k: _globalize(v, like) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_globalize(v, like) for v in tree)
    if isinstance(tree, Tensor):
        if tree.dim() == 0:
            return scalar_mean(tree, like)
        return from_local(tree, like, Replicate(),
                          shape=(like.shape[0], *tree.shape[1:]))
    return tree


def replicated_region(module, x, *args, **kwargs):
    """``module``'s own ``forward`` for a module whose weights all
    replicate on ``model`` (the rules keep the xLSTM cells whole, and a
    Mamba whose ``d_inner`` the axis does not divide): every rank runs the
    whole layer on its own rows, so it runs here on rank 0's rows with
    the weights' local copies (their gradients a share of the sum over
    the data axes), DTensor arguments (a cache, updated in place) taken
    local; tensor results come back batch-first, placed as ``x`` and whole
    on ``model``, scalars as a mean over the rows."""
    params = {n: weight_local(p, x) for n, p in module.named_parameters()
              if is_dtensor(p)}
    with swapped(module, params):
        out = type(module).forward(module, to_local(x), *_localize(args),
                                   **_localize(kwargs))
    return _globalize(out, x)


def _linear(mod, x):
    """``Linear.forward`` with its fsdp-split weight gathered over the
    data axes first (ZeRO-3: :func:`whole_on_data`)."""
    y = x @ whole_on_data(mod.w).to(x.dtype)
    return y if mod.b is None else y + mod.b.to(x.dtype)


def _split_on_data(w) -> bool:
    i = model_dim(w)
    return any(isinstance(p, Shard) for k, p in enumerate(w.placements) if k != i)


def _heads(proj, heads: int) -> None:
    """``proj``'s output split into ``heads`` by its caller (:func:`for_heads`)."""
    proj.register_forward_hook(lambda mod, args, out: for_heads(out, heads))


def _merge_heads(proj) -> None:
    """``proj`` reads merged heads (:func:`same_grads` at its input)."""
    proj.register_forward_pre_hook(lambda mod, args: (same_grads(args[0]), *args[1:]))


def _norm(mod) -> None:
    """A norm reads whole rows and hands on Megatron's ``f``
    (:func:`whole_rows`, :func:`same_grads`)."""
    mod.register_forward_pre_hook(lambda m, args: (whole_rows(args[0]), *args[1:]))
    mod.register_forward_hook(lambda m, args, out: same_grads(out))


def install(root) -> None:
    """Route ``root``'s modules (a meta model whose parameters are placed
    DTensors) through the local regions, in place: a ``Linear`` with an
    fsdp-split weight gathers it (:func:`_linear`); the norms
    (:func:`_norm`); attention's and MLA's projections into heads
    (:func:`for_heads`) and out of them (:func:`same_grads`); MLA's
    absorbed decode (:func:`mla_decode`); the MoE capacity dispatch
    (:func:`moe_dropping`); Mamba (:func:`mamba_forward`); the xLSTM
    blocks (:func:`xlstm_forward`)."""
    for mod in root.modules():
        if isinstance(mod, L.Linear) and is_dtensor(mod.w) and _split_on_data(mod.w):
            mod.forward = types.MethodType(_linear, mod)
        elif isinstance(mod, (L.RMSNorm, L.LayerNorm)):
            _norm(mod)
        elif isinstance(mod, A.Attention):
            _heads(mod.wq, mod.cfg.num_heads)
            _heads(mod.wk, mod.cfg.num_kv_heads)
            _heads(mod.wv, mod.cfg.num_kv_heads)
            _merge_heads(mod.wo)
        elif isinstance(mod, MLA):
            _heads(mod.wq, mod.cfg.num_heads)
            _heads(mod.wkv_b, mod.cfg.num_heads)
            _merge_heads(mod.wo)
            mod._decode = types.MethodType(mla_decode, mod)
        elif isinstance(mod, MoE):
            mod._dropping = types.MethodType(moe_dropping, mod)
        elif isinstance(mod, SSM.Mamba):
            mod.forward = types.MethodType(mamba_forward, mod)
        elif isinstance(mod, (SSM.MLSTMBlock, SSM.SLSTMBlock)):
            mod.forward = types.MethodType(xlstm_forward, mod)


# ---------------------------------------------------------------------------
# the modules' regions
# ---------------------------------------------------------------------------


def _latent_context(q_lat, q_rope, ckv, krope, pos, scale):
    """MLA's absorbed decode attention in latent space (as
    ``MLA._decode``): the latent query ``q_lat`` (B, 1, H, r) and rope
    query over the cache's ``ckv`` (B, T, r) and ``krope`` (B, T, rope),
    slots of ``pos`` < 0 masked; the latent context (B, 1, H, r)."""
    scores = (
        torch.einsum("bshr,btr->bhst", q_lat, ckv.to(q_lat.dtype))
        + torch.einsum("bshr,btr->bhst", q_rope, krope.to(q_rope.dtype))
    ).to(torch.float32) * scale
    scores = torch.where(pos >= 0, scores,
                         torch.full((), A.NEG_INF, device=scores.device))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,btr->bshr", probs.to(ckv.dtype), ckv)


def mla_decode(mla, x, cache: dict, layer: int, pos: int):
    """``MLA._decode``; over a latent cache split over its slots on
    ``model`` the attention in latent space is split-K
    (:func:`on_local_slots`), the rest as the module's own."""
    if not split_on_model(cache["ckv"], 2):
        return type(mla)._decode(mla, x, cache, layer, pos)
    a, cfg = mla.cfg.mla, mla.cfg
    b, s, _ = x.shape
    h = cfg.num_heads
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = mla._project_q(x, positions)
    c_kv, k_rope = mla._compress_kv(x, positions)
    mla_cache_write(cache, layer, c_kv, k_rope, A.cache_slot(pos, cache["pos"].shape[0]))
    w = mla.wkv_b.w.reshape(a.kv_lora_rank, h, a.qk_nope_head_dim + a.v_head_dim)
    w_kb, w_vb = w[..., : a.qk_nope_head_dim], w[..., a.qk_nope_head_dim :]
    q_lat = torch.einsum("bshn,rhn->bshr", q_nope, w_kb.to(q_nope.dtype))
    scale = (a.qk_nope_head_dim + a.qk_rope_head_dim) ** -0.5
    ctx = on_local_slots(_latent_context, (q_lat, q_rope),
                         (cache["ckv"][layer], cache["krope"][layer]), cache["pos"],
                         scale=scale)
    out = torch.einsum("bshr,rhv->bshv", ctx, w_vb.to(ctx.dtype))
    return mla.wo(out.reshape(b, s, h * a.v_head_dim))


def moe_dropping(moe, x):
    """``MoE._dropping`` of a DTensor ``x`` (B, S, d), whole on ``model``,
    on rank 0's shards: every rank routes its own rows (the router
    replicates); with the experts split over ``model`` (expert parallel)
    rank 0 runs its experts on the assignments they take
    (:func:`_expert_parallel`), with their FFN dim split it runs every
    expert on its slice; either way its output is a share of the sum over
    ``model``, which an all-reduce finishes where a later op needs it (the
    reference's partition reaches the same sum through an all-gather of
    the routing and the expert buffers)."""
    x = whole_rows(x)
    names = ("router.w", "experts.wi", "experts.wg", "experts.wo")
    whole = moe.experts.wi.shape
    ws = {n: weight_local(moe.get_parameter(n), x) for n in names}
    with swapped(moe, ws):
        if ws["experts.wi"].shape[0] == moe.cfg.moe.num_experts:
            out, aux = type(moe)._dropping(moe, to_local(x))
        else:
            out, aux = _expert_parallel(moe, to_local(x))
    out = from_local(out, x, Replicate() if ws["experts.wi"].shape == whole else Partial())
    return out, {n: scalar_mean(v, x) for n, v in aux.items()}


def _expert_parallel(moe, x):
    """``MoE._dropping`` on rank 0's experts, the first ``e`` (their
    weights swapped in): the plan routes over every expert, and rank 0
    fills an (e, G, cap) buffer with the assignments its experts take
    (the others' are left to their ranks)."""
    m = moe.cfg.moe
    b, s, d = x.shape
    g = min(m.dispatch_group, s)
    g = g if s % g == 0 else s
    ng = b * (s // g)
    k, e = m.top_k, moe.experts.wi.shape[0]
    xg = x.reshape(ng, g, d)
    p = moe.plan(xg)
    cap = p.cap
    flat_e = p.ids.reshape(ng, g * k)
    keep = p.keep & (flat_e < e)
    group = torch.arange(ng, device=x.device)[:, None]
    row = (flat_e * ng + group) * cap + p.rank.clamp(max=cap - 1)
    dump = e * ng * cap
    dst = row.masked_fill(~keep, dump)
    buf = x.new_zeros(dump + 1, d)
    src = xg.repeat_interleave(k, dim=1).reshape(ng * g * k, d)
    buf.index_copy_(0, dst.reshape(-1), src)
    out_buf = moe.experts(buf[:dump].view(e, ng * cap, d))
    row = row.clamp(max=dump - 1)
    gathered_ = out_buf.reshape(dump, d).index_select(0, row.reshape(-1))
    scale = (keep.to(x.dtype) * p.weights.reshape(ng, g * k).to(x.dtype))
    gathered_ = gathered_ * scale.reshape(-1, 1)
    out = gathered_.view(ng, g, k, d).sum(dim=2)
    return out.reshape(b, s, d), p.aux


def mamba_forward(mamba, x, state: dict | None = None):
    """``Mamba.forward`` of a DTensor ``x`` (B, S, d), whole on ``model``,
    on rank 0's channels: ``in_proj``'s columns split over ``model`` hold
    rank 0's share of ``xi`` and of ``z`` (the columns laid out so,
    Megatron's fused-projection order), the conv, ``A_log``, ``D`` and the
    scan run on its ``d_inner / tp`` channels, ``x_proj``'s rows give a
    share of the sum (an all-reduce), ``dt_proj`` a share of the sum over
    its split rows (a reduce-scatter to the channels) or its columns when
    it replicates, and ``out_proj``'s rows a share of the output's sum;
    the new state, which the cache keeps whole on ``model``, is
    all-gathered.  Weights that replicate (a ``d_inner`` the axis does not
    divide) keep the whole layer on every rank
    (:func:`replicated_region`)."""
    x = whole_rows(x)
    m = mamba.cfg.ssm
    w_in = mamba.in_proj.w
    if tp(x) == 1 or local(w_in).shape[1] == w_in.shape[1]:
        return replicated_region(mamba, x, state)
    xl = to_local(x)

    def wl(w):
        return weight_local(w, x)

    xi, z = (xl @ wl(w_in).to(xl.dtype)).chunk(2, dim=-1)
    di = xi.shape[-1]
    conv0 = None if state is None else local(state["conv"])[..., :di]
    xi, conv_state = L.causal_conv1d(wl(mamba.conv.w), wl(mamba.conv.b), xi, conv0)
    xi = F.silu(xi)
    proj = from_local(xi @ wl(mamba.x_proj.w).to(xi.dtype), x, Partial())
    dt, bmat, cmat = torch.split(
        to_local(to_model(proj, Replicate())),
        [mamba.dt_rank, m.state_dim, m.state_dim], dim=-1)
    w_dt = mamba.dt_proj.w
    if local(w_dt).shape[0] < w_dt.shape[0]:    # rows split: dt's too
        rows = local(w_dt).shape[0]
        dt = from_local(dt[..., :rows] @ wl(w_dt).to(dt.dtype), x, Partial())
        dt = to_local(to_model(dt, Shard(2)))
    else:
        dt = dt @ wl(w_dt)[:, :di].to(dt.dtype)
    dt = F.softplus(dt + wl(mamba.dt_proj.b)[:di].to(dt.dtype))
    if state is None:
        ssm0 = xl.new_zeros((xl.shape[0], di, m.state_dim), dtype=torch.float32)
    else:
        ssm0 = local(state["ssm"])[:, :di]
    a = -torch.exp(wl(mamba.A_log).to(torch.float32))
    x32 = xi.to(torch.float32)
    y, h_last = SSM.chunked_ssm_outputs(
        dt.to(torch.float32), x32, a, bmat.to(torch.float32),
        cmat.to(torch.float32), ssm0, m.chunk)
    y = (y + x32 * wl(mamba.D).to(torch.float32)).to(xi.dtype)
    y = y * F.silu(z)
    out = y @ wl(mamba.out_proj.w).to(y.dtype)
    new = {"conv": conv_state, "ssm": h_last}
    if state is not None:     # the cache keeps every channel
        new = {"conv": gathered(conv_state, x, 2), "ssm": gathered(h_last, x, 1)}
    return from_local(out, x, Partial()), new


def xlstm_forward(block, x, *, mode: str = "train", cache: dict | None = None,
                  layer: int = 0, **_):
    """An xLSTM block's ``forward``: the block whole on rank 0's rows (the
    rules replicate its weights: :func:`replicated_region`)."""
    return replicated_region(block, whole_rows(x), mode=mode, cache=cache, layer=layer)
