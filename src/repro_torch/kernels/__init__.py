"""Hand-written Hopper kernels of the port, one module per kernel.

Each module holds the kernel, its plain PyTorch version and its wrapper.
The wrapper takes the plain version only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises.  Each wrapper counts its
launches in a plain integer attribute, ``<wrapper>.launches``.

On ``meta`` tensors (shapes only) a wrapper hands its arguments to the
handler registered under its name in :data:`META_HANDLERS`: the dry run's
counter (:mod:`repro_torch.launch.op_count`) registers one per wrapper,
which returns empty outputs and charges the counter with the work of the
plain version.  With no handler registered a ``meta`` call raises.
"""

from __future__ import annotations

from typing import Callable

#: wrapper name -> its handler for ``meta`` tensors
META_HANDLERS: dict[str, Callable] = {}


def on_meta(name: str, *args, **kwargs):
    """Run wrapper ``name``'s registered handler for ``meta`` tensors."""
    handler = META_HANDLERS.get(name)
    if handler is None:
        raise RuntimeError(
            f"{name} on meta tensors needs a handler in META_HANDLERS; "
            f"importing repro_torch.launch.op_count registers the counter's")
    return handler(*args, **kwargs)
