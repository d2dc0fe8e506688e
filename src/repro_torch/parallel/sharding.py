"""Logical sharding rules: parameter name + shape -> partition spec (port of
``repro.parallel.sharding``).

A spec is a plain tuple with one entry per dimension: None (replicated),
an axis name, or a tuple of axis names; ``()`` is a replicated scalar.
The axis convention is the reference's:

* batch-like dims -> the data axes (``("data",)``, or ``("pod", "data")``);
* heads / d_ff / vocab -> ``"model"`` (tensor parallel), only where the
  dim divides the model axis (non-divisible dims replicate);
* experts -> ``"model"`` where the expert count divides it (expert
  parallel), else the expert FFN dim;
* with ``fsdp``, each large parameter's biggest unsharded dim that divides
  the ``data`` axis also goes over it.

The rules read the reference's parameter paths (``segs/<i>_<kind>/attn/
wq/w`` ...), so the port's names (``backbone.layers.<n>.attn.wq.w``) are
mapped to them first (:func:`reference_path`, the layout of
:mod:`repro_torch.interop`).  The reference stacks a segment's layers on a
leading axis that it never shards; the port's per-layer tensor has no such
axis, so its spec is the reference's without that leading None.

Serving places only the data axis: parameters replicate
(:class:`ParamReplicator`, one copy on each mesh device) and a fused batch
splits into contiguous row blocks, one per device.  Tensor-parallel specs
are for the dry run: :func:`distribute` turns a program's ``meta`` state
into DTensors placed by the specs (:func:`placements`) on a fake
``DeviceMesh`` (:func:`repro_torch.launch.mesh.device_mesh`), so the
program runs rank 0's share of the partitioned work; a serving mesh whose
``model`` axis is larger than 1 raises (:func:`serving_dp`).
"""

from __future__ import annotations

import contextlib
import copy
import math
from typing import Any, NamedTuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig

Spec = tuple


def data_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def tp_size(mesh) -> int:
    return mesh.shape.get("model", 1)


def dp_size(mesh) -> int:
    out = 1
    for a in data_axes(mesh):
        out *= mesh.shape[a]
    return out


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def round_to_dp(n: int, mesh) -> int:
    """Smallest multiple of the mesh's data-parallel size that is >= n: the
    engine rounds its batch buckets with it, so every fused batch splits
    evenly over the data axes."""
    if mesh is None:
        return n
    dp = dp_size(mesh)
    return -(-n // dp) * dp


def serving_dp(mesh, home) -> int:
    """The data-parallel size a serving engine splits its batches over.  A
    ``model`` axis larger than 1 raises: serving shards only the data
    axis.  So does a mesh whose first device is not ``home``, the device
    of the engine's model: a batch that does not split runs whole there."""
    if mesh.devices is None or not same_device(mesh.devices[0], home):
        raise ValueError(
            f"a serving mesh's first device must be the model's ({home}); "
            f"this one has {None if mesh.devices is None else mesh.devices[0]}")
    if tp_size(mesh) > 1:
        raise ValueError(
            f"a serving mesh shards only its data axes; this one has a model "
            f"axis of {tp_size(mesh)} (ROADMAP, queue 1b, 'Tensor parallelism "
            f"across cards')")
    return dp_size(mesh)


class SamplerSpecs(NamedTuple):
    """Specs of a solver program's carry, the reference's field set: the
    latents ``x`` (batch first), the eps history ``eps_buf`` (cap, B, ...),
    the replicated time grid ``t_buf``, the per-sample solver state
    ``delta_eps``, and the mask channels ``lengths``, ``active_steps`` and
    ``step_ts``, each with its rows."""

    x: Spec
    eps_buf: Spec
    t_buf: Spec
    delta_eps: Spec
    lengths: Spec
    active_steps: Spec
    step_ts: Spec


def sampler_pspecs(mesh, *, batch: int | None = None, per_sample: bool = True,
                   x_ndim: int = 3) -> SamplerSpecs:
    """Carry specs of the batched sampling engine: the batch dim over the
    data axes, the rest replicated; a ``batch`` that does not divide the
    data-parallel size replicates every entry."""
    dp: Any = data_axes(mesh)
    if not dp or (batch is not None and not _div(batch, dp_size(mesh))):
        dp = None
    rest = (None,) * (x_ndim - 1)
    return SamplerSpecs(
        x=(dp, *rest),
        eps_buf=(None, dp, *rest),
        t_buf=(),
        delta_eps=(dp,) if per_sample else (),
        lengths=(dp,),
        active_steps=(dp,),
        step_ts=(dp, None),
    )


def solver_carry_pspecs(mesh, program, config, *, batch: int | None = None,
                        x_ndim: int = 3) -> SamplerSpecs:
    """Carry specs of a solver program: its ``per_sample_state`` decides
    whether ``delta_eps`` goes with the rows."""
    return sampler_pspecs(mesh, batch=batch,
                          per_sample=program.per_sample_state(config),
                          x_ndim=x_ndim)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

#: the denoiser's own leaves; the reference's solver dry run replicates them
DENOISER_HEADS = ("time_mlp", "in_proj", "eps_head")


def reference_path(name: str, cfg: ModelConfig) -> tuple[str, bool]:
    """The reference's tree path of the port's parameter ``name`` (of a
    ``Model`` or a ``DiffusionLM``; a denoiser's ``backbone.`` maps to the
    token model's tree) and whether the reference stacks it on a layer
    axis."""
    parts = name.split(".")
    if parts[0] == "backbone":
        parts = parts[1:]
    if parts[0] == "layers":
        n, rest = int(parts[1]), parts[2:]
        first = 0
        for i, (kind, count) in enumerate(cfg.blocks):
            if n < first + count:
                return "/".join([f"segs/{i}_{kind}", *rest]), True
            first += count
        raise ValueError(f"{name}: layer {n} is past the stack")
    if parts[0] == "encoder" and parts[1] == "layers":
        return "/".join(["encoder/segs/0_enc", *parts[3:]]), True
    if parts == ["lm_head", "w"]:
        return "lm_head", False
    return "/".join(parts), False


class ShardingRules:
    """Parameter, optimizer, batch and cache specs of ``cfg`` on ``mesh``
    (anything with ``axis_names`` and a ``shape`` dict: a :class:`Mesh`,
    abstract or not).  ``fsdp`` also shards each large parameter's biggest
    unsharded dim over ``data``."""

    def __init__(self, cfg: ModelConfig, mesh, fsdp: bool = False):
        self.cfg = cfg
        self.mesh = mesh
        self.tp = tp_size(mesh)
        self.dp = data_axes(mesh)
        self.fsdp = fsdp
        self.fsdp_axis = "data" if "data" in mesh.axis_names else None
        self.fsdp_size = mesh.shape.get("data", 1)

    def _param_spec(self, path: str, shape: tuple[int, ...]) -> Spec:
        """The reference's ``_param_spec``, rule for rule."""
        tp = self.tp
        mdl = "model"
        none = (None,) * len(shape)

        def out_col(ncols):  # shard a (in, out) matmul's out dim
            return (None, mdl) if _div(ncols, tp) else (None, None)

        def in_row(nrows):   # shard a (in, out) matmul's in dim
            return (mdl, None) if _div(nrows, tp) else (None, None)

        leaf = path.rsplit("/", 1)[-1]
        if path.endswith("embed") or path == "embed":
            return (mdl, None) if _div(shape[0], tp) else (None, None)
        if "pos_embed" in path:
            return (mdl, None) if _div(shape[0], tp) else (None, None)
        if "lm_head" in path:
            return out_col(shape[-1])
        if "meta" in path:
            return (None, None)
        if "mlstm" in path or "slstm" in path:
            return none
        if "experts" in path and len(shape) == 3:
            e, a, b = shape
            if _div(e, tp):
                return (mdl, None, None)
            if path.endswith("wo"):
                return (None, mdl, None) if _div(a, tp) else (None, None, None)
            return (None, None, mdl) if _div(b, tp) else (None, None, None)
        if "router" in path:
            return (None, None)
        if any(s in path for s in ("/attn/", "self_attn", "cross_attn", "/mla/")):
            if leaf == "b":
                return (mdl,) if _div(shape[0], tp) else (None,)
            if any(path.endswith(s) for s in ("wq/w", "wk/w", "wv/w", "wkv_b/w")):
                return out_col(shape[-1])
            if path.endswith("wo/w"):
                return in_row(shape[0])
            return none
        if "mamba" in path:
            if path.endswith("in_proj/w"):
                return out_col(shape[-1])
            if path.endswith("out_proj/w"):
                return in_row(shape[0])
            if leaf in ("A_log", "D"):
                if len(shape) == 2 and _div(shape[0], tp):
                    return (mdl, None)
                return (mdl,) if _div(shape[0], tp) else none
            if path.endswith("x_proj/w") or path.endswith("dt_proj/w"):
                return in_row(shape[0])
            if path.endswith("dt_proj/b"):
                return (mdl,) if _div(shape[0], tp) else (None,)
            if "conv" in path:
                if len(shape) == 2 and _div(shape[-1], tp):
                    return (None, mdl)
                return (mdl,) if _div(shape[0], tp) else (None,)
            return none
        if "mlp" in path or "shared" in path:
            if leaf == "b":
                return (mdl,) if _div(shape[0], tp) else (None,)
            if path.endswith("wo/w"):
                return in_row(shape[0])
            return out_col(shape[-1])
        return none

    def _apply_fsdp(self, spec: Spec, shape: tuple[int, ...]) -> Spec:
        if (not self.fsdp or self.fsdp_axis is None
                or math.prod(shape) < (1 << 20)):
            return spec
        parts = list(spec) + [None] * (len(shape) - len(spec))
        for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
            if parts[i] is None and _div(shape[i], self.fsdp_size):
                parts[i] = self.fsdp_axis
                break
        return tuple(parts)

    def param_spec(self, name: str, shape: tuple[int, ...]) -> Spec:
        """The spec of the port's parameter ``name`` of ``shape``."""
        if name.split(".")[0] in DENOISER_HEADS:
            return (None,) * len(shape)
        path, _ = reference_path(name, self.cfg)
        spec = self._param_spec(path, tuple(shape))
        # embedding tables are gathered by token id: never fsdp-sharded
        return spec if "embed" in path else self._apply_fsdp(spec, tuple(shape))

    def param_pspec(self, named: dict) -> dict[str, Spec]:
        """Specs of named tensors (``dict(module.named_parameters())``, or
        anything with a ``shape``)."""
        return {n: self.param_spec(n, tuple(t.shape)) for n, t in named.items()}

    def opt_pspec(self, opt_state: dict) -> dict:
        """AdamW's state mirrors the parameters; ``step`` replicates."""
        return {"m": self.param_pspec(opt_state["m"]),
                "v": self.param_pspec(opt_state["v"]), "step": ()}

    def _dp_if_divisible(self, n: int):
        return self.dp if _div(n, dp_size(self.mesh)) else None

    def batch_pspec(self, batch: dict) -> dict[str, Spec]:
        """Each leaf's leading dim over the data axes where it divides."""
        out = {}
        for name, leaf in batch.items():
            shape = tuple(leaf.shape)
            out[name] = (() if not shape else
                         (self._dp_if_divisible(shape[0]), *([None] * (len(shape) - 1))))
        return out

    def cache_pspec(self, cache) -> Any:
        """Caches (L, B, slots, ...): the batch over the data axes, a slot
        dim of 4,096 or more over ``model``; position vectors replicate."""
        if isinstance(cache, dict):
            return {k: self.cache_pspec(v) for k, v in cache.items()}
        shape = tuple(cache.shape)
        if len(shape) <= 2:
            return (None,) * len(shape)
        rest = [None] * (len(shape) - 2)
        if len(shape) >= 4 and shape[2] >= 4096 and _div(shape[2], self.tp):
            rest[0] = "model"
        return (None, self._dp_if_divisible(shape[1]), *rest)


def shard_bytes(shape, itemsize: int, spec: Spec, mesh) -> float:
    """Bytes of one device's shard of a ``shape`` tensor placed by
    ``spec`` on ``mesh``."""
    parts = 1
    for part in spec:
        for axis in ((part,) if isinstance(part, str) else (part or ())):
            parts *= mesh.shape[axis]
    return math.prod(shape) * itemsize / parts


# ---------------------------------------------------------------------------
# DTensor placements: the dry run's partitioned programs
# ---------------------------------------------------------------------------


def placements(spec: Spec, device_mesh) -> list:
    """A spec as DTensor placements on ``device_mesh``: ``Shard(dim)`` on
    each mesh axis a dim names (a dim over two axes is split by the first,
    then the second, as a ``PartitionSpec`` splits it), ``Replicate()`` on
    the others."""
    from torch.distributed.tensor import Replicate, Shard

    names = device_mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for dim, part in enumerate(spec):
        for axis in ((part,) if isinstance(part, str) else (part or ())):
            i = names.index(axis)
            if device_mesh.size(i) > 1:    # a split in one part is whole
                out[i] = Shard(dim)
    return out


def place(t: torch.Tensor, spec: Spec, device_mesh):
    """A ``meta`` tensor as a DTensor of the same global shape placed by
    ``spec``, whose local tensor is rank 0's shard (``meta`` too)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    if isinstance(t, DTensor):
        return t
    pl = placements(spec, device_mesh)
    local, _ = compute_local_shape_and_global_offset(t.shape, device_mesh, pl)
    return DTensor.from_local(
        torch.empty(local, dtype=t.dtype, device="meta"), device_mesh, pl,
        run_check=False, shape=t.shape, stride=t.stride())


def place_tree(tree: dict, specs: dict, device_mesh) -> None:
    """Each tensor leaf of the nested dict ``tree`` placed by its spec, in
    place."""
    for k, v in tree.items():
        if isinstance(v, dict):
            place_tree(v, specs[k], device_mesh)
        elif isinstance(v, torch.Tensor):
            tree[k] = place(v, specs[k], device_mesh)


def place_module(module: nn.Module, specs: dict, device_mesh) -> None:
    """``module``'s parameters placed by ``specs`` (parameter name ->
    spec) on ``device_mesh``, each swapped on its owner, and its modules
    routed through the local regions of a partitioned program
    (:func:`repro_torch.parallel.dtensor.install`), in place."""
    from repro_torch.parallel import dtensor

    named = dict(module.named_parameters())
    for name, spec in specs.items():
        p = named[name]
        owner, _, leaf = name.rpartition(".")
        setattr(module.get_submodule(owner), leaf,
                nn.Parameter(place(p.detach(), spec, device_mesh),
                             requires_grad=p.requires_grad))
    dtensor.install(module)


def distribute(program, rules: "ShardingRules", device_mesh) -> None:
    """Place a dry-run program's ``meta`` state on ``device_mesh`` by
    ``rules``, in place: the model's parameters (``param_pspec``; the
    program reads them from the model when it runs, see
    :func:`place_module`), AdamW's moments (``opt_pspec``), the cache
    (``cache_pspec``, also of a cache the program builds with
    ``init_cache``, as a prefill does), the batch and any other dict of
    inputs in ``program.args`` (``batch_pspec``)."""
    model = program.model
    place_module(model, rules.param_pspec(dict(model.named_parameters())), device_mesh)
    build = model.init_cache

    def init_cache(batch: int, slots: int) -> dict:
        cache = build(batch, slots)
        place_tree(cache, rules.cache_pspec(cache), device_mesh)
        return cache

    model.init_cache = init_cache
    state = program.state
    if "opt" in state:
        specs = rules.opt_pspec(state["opt"])
        for m in ("m", "v"):
            place_tree(state["opt"][m], specs[m], device_mesh)
    if "cache" in state:
        place_tree(state["cache"], rules.cache_pspec(state["cache"]), device_mesh)
    for tree in (state["batch"], *program.args):
        if isinstance(tree, dict) and tree is not state.get("cache"):
            place_tree(tree, rules.batch_pspec(tree), device_mesh)


# ---------------------------------------------------------------------------
# one copy of the weights on each mesh device
# ---------------------------------------------------------------------------


def same_device(a, b) -> bool:
    """Do ``a`` and ``b`` name the same device (``cuda`` is the current
    card, ``cpu`` any CPU entry)?"""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda" or a.index == b.index:
        return True
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == (cur if b.index is None else b.index)


def device_scope(dev):
    """``dev`` made the current CUDA device for the block (a hand-written
    kernel launches on the current device, whatever its inputs' device);
    nothing to do for another device type."""
    dev = torch.device(dev)
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _copy_to(module: nn.Module, dev: torch.device) -> nn.Module:
    """A deep copy of ``module`` whose parameters and buffers are copied
    straight to ``dev`` (nothing is copied twice on the source)."""
    memo = {}
    for t in (*module.parameters(), *module.buffers()):
        c = t.detach().to(dev, copy=True)
        memo[id(t)] = (nn.Parameter(c, requires_grad=t.requires_grad)
                       if isinstance(t, nn.Parameter) else c)
    return copy.deepcopy(module, memo)


class ParamReplicator:
    """Replicate a module over a mesh's devices, caching the copies.

    ``replicator(module)`` is a list with one module per mesh device: the
    module itself on its own device, a copy on every other.  The cache key
    is every parameter and buffer tensor's identity and version (its
    ``_version``, which each in-place write bumps), so a caller that
    replaces a tensor or changes one in place between calls (a finetune
    and sample loop) gets fresh copies, as the reference keys its placed
    tree on the identity of every leaf.  The tensors are held alongside
    their ids, which are unique only among live objects."""

    def __init__(self, mesh):
        if mesh.devices is None:
            raise ValueError("an abstract mesh has no devices to replicate over")
        self.mesh = mesh
        self._tensors: list | None = None
        self._key: list | None = None
        self._replicas: list[nn.Module] | None = None
        #: how many times the copies were (re)built
        self.builds = 0

    def __call__(self, module: nn.Module) -> list[nn.Module]:
        tensors = [*module.parameters(), *module.buffers()]
        key = [(id(t), t._version) for t in tensors]
        if self._replicas is None or key != self._key or len(tensors) != len(self._tensors):
            home = tensors[0].device
            self._replicas = [module if same_device(dev, home) else _copy_to(module, dev)
                              for dev in self.mesh.devices]
            self._tensors, self._key = tensors, key
            self.builds += 1
        return self._replicas
