"""Device meshes of the port (port of ``repro.launch.mesh``) and the H100's
constants.

A :class:`Mesh` names the axes of a grid of ``torch.device`` entries, as
``jax.sharding.Mesh`` names a grid of JAX devices: the serving mesh has one
``data`` axis over the local cards; ``Mesh.abstract({"data": d, "model":
m})`` is a shape alone, with no devices, for the dry run and for the
sharding rules.  The reference's ``make_production_mesh`` describes TPU v5e
pods and has no counterpart: the dry run takes a layout of H100s
(``--mesh DxM``) as an abstract mesh instead.

Building a mesh touches no device state beyond listing the cards.
:func:`device_mesh` turns an abstract mesh into a ``DeviceMesh`` over a
fake process group, for the dry run's sharded count: no card, no other
process, no network.
"""

from __future__ import annotations

import contextlib
import math

import torch

# H100 SXM (NVIDIA data sheet, dense rates at the 700 W power limit)
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, bf16 / fp16 tensor cores
PEAK_FLOPS_F32 = 67e12          # FLOP/s, float32 outside the tensor cores
HBM_BW = 3.35e12                # B/s
HBM_BYTES = 80e9                # B of device memory
# NVLink 4: 18 links of 25 GB/s each way, 900 GB/s both ways together (the
# data sheet's figure); a collective's bytes leave a card at 450 GB/s, one
# direction
NVLINK_BW = 450e9               # B/s


class Mesh:
    """Named axes over a row-major grid of devices (None: abstract)."""

    def __init__(self, axis_names: tuple[str, ...], shape: tuple[int, ...],
                 devices: list[torch.device] | None = None):
        if len(axis_names) != len(shape) or any(n < 1 for n in shape):
            raise ValueError(f"mesh axes {axis_names} do not fit shape {shape}")
        if devices is not None:
            devices = [torch.device(d) for d in devices]
            if len(devices) != math.prod(shape):
                raise ValueError(f"a {shape} mesh needs {math.prod(shape)} "
                                 f"devices, got {len(devices)}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.devices = devices

    @classmethod
    def abstract(cls, shape: dict[str, int]) -> "Mesh":
        """A mesh of this shape with no devices (spec logic, the dry run)."""
        return cls(tuple(shape), tuple(shape.values()))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def local_devices() -> list[torch.device]:
    """The local cards; raises when there is none (pass ``devices=`` to
    build a mesh of ``cpu`` entries)."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError(
            "no CUDA device is available; pass devices= (e.g. "
            "['cpu', 'cpu']) to build a mesh on the CPU")
    return [torch.device("cuda", i) for i in range(n)]


def make_host_mesh(model_parallel: int = 1,
                   devices: list | None = None) -> Mesh:
    """A (data, model) mesh over the local cards (or ``devices``)."""
    devices = local_devices() if devices is None else list(devices)
    dp = len(devices) // model_parallel
    if dp < 1:
        raise ValueError(f"{len(devices)} devices cannot hold model_parallel="
                         f"{model_parallel}")
    return Mesh(("data", "model"), (dp, model_parallel),
                devices[: dp * model_parallel])


def make_sampler_mesh(max_devices: int | None = None,
                      devices: list | None = None) -> Mesh:
    """The sampling engine's data-only mesh: one ``data`` axis over the
    local cards (or ``devices``), capped at ``max_devices``.  One H100
    gives dp = 1."""
    devices = local_devices() if devices is None else list(devices)
    n = len(devices) if max_devices is None else min(len(devices), max_devices)
    return Mesh(("data",), (n,), devices[:n])


def parse_layout(text: str) -> Mesh:
    """``"DxM"`` -> an abstract (data D, model M) mesh of H100s."""
    try:
        d, m = (int(v) for v in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh takes DxM (e.g. 1x1, 8x1), got {text!r}") from None
    return Mesh.abstract({"data": d, "model": m})


@contextlib.contextmanager
def device_mesh(mesh: Mesh):
    """A ``DeviceMesh`` of ``mesh``'s shape and axis names for the block,
    over a fake process group of world ``mesh.size`` in which this process
    is rank 0: collectives return at once and move nothing, so a program
    run on it does rank 0's share of the partitioned work.  The group is
    destroyed on exit, error or not; one that is already up raises."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    # registers the ``fake`` backend (torch 2.11 and 2.13 keep it here)
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized; the "
                           "dry run's fake group needs the process to itself")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=mesh.size)
    try:
        yield init_device_mesh("cpu", tuple(mesh.shape.values()),
                               mesh_dim_names=mesh.axis_names)
    finally:
        dist.destroy_process_group()
