"""Activation-sharding hints (port of ``repro.parallel.ctx``).

The reference pins activation layouts for GSPMD (``with_sharding_
constraint`` at stack boundaries and on each microbatch), because with
FSDP-sharded weights GSPMD can propagate odd layouts onto activations.  The
port runs each mesh device's rows in one process with no partitioner to
guide: a fused batch is split into row blocks by hand
(:mod:`repro_torch.serving.executor`), so these hints have nothing to pin.
Each keeps the reference's signature and does nothing, so callers (the
train loop, where the reference calls ``constrain_batch``) keep the
reference's shape.
"""

from __future__ import annotations

import contextlib

import torch


def activation_sharding(data_axes: tuple[str, ...],
                        model_axis: str | None = "model",
                        seq_parallel: bool = False):
    """The reference installs the axes its constraints read for the block;
    here a context that does nothing."""
    return contextlib.nullcontext()


def constrain_batch(x: torch.Tensor, batch_dim: int = 0) -> torch.Tensor:
    """The reference pins ``batch_dim`` to the data axes; in one process
    the rows already sit where their block runs, so ``x`` comes back
    unchanged."""
    return x


def constrain_dims(x: torch.Tensor, dims: tuple) -> torch.Tensor:
    """The reference pins dims by role ("dp", "tp", None); unchanged here,
    as :func:`constrain_batch`."""
    return x
