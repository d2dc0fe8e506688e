"""One engine-construction path for every serve mode (port of
``repro.serving.factory``).

An :class:`EngineConfig` holds every engine-shape decision as one frozen,
hashable value, and :func:`build_engine` turns it into the port's
:class:`~repro_torch.serving.diffusion_sampler.BatchedSampler`, so the
launcher and any caller serve the same engine: the same solver config and
the same batch, seq and NFE ladders.  The reference's compile-cache fields
have no counterpart (CUDA graphs do not persist across processes).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import (
    ERAConfig,
    NoiseSchedule,
    SolverConfig,
    default_config,
)
from repro_torch.models.diffusion import DiffusionLM
from repro_torch.serving.diffusion_sampler import BatchedSampler
from repro_torch.serving.executor import (
    DEFAULT_MAX_BATCH,
    DEFAULT_MAX_NFE,
    DEFAULT_MAX_SEQ_LEN,
)
from repro_torch.serving.metrics import MetricsRegistry

#: legal values of :attr:`EngineConfig.warmup`
WARMUP_MODES = ("none", "grid")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Everything that shapes a serving engine, in one frozen value.

    * ``solver`` / ``nfe``: the default solver program and its budget
      (``SampleRequest.solver`` still routes per request).
    * ``k`` / ``lam`` / ``per_sample``: ERA's Lagrange order, selection
      weight and per-sample ERS (the serving default, which keeps every
      row of a fused batch independent); the other solvers take their
      registry defaults at ``nfe``.
    * ``batch_buckets``: the batch ladder (None: exact size, no fusion).
    * ``seq_buckets`` / ``nfe_buckets``: the opt-in mixed-seq-len and
      mixed-NFE ladders (None: exact seq_len / nfe per fuse group);
      requests above a ladder's top are rejected at submit.
    * ``max_batch`` / ``max_nfe`` / ``max_seq_len``: per-request ceilings
      enforced at submit (None: unbounded); ``max_seq_len`` applies only
      without a seq ladder.
    * ``warmup``: ``"grid"`` asks callers to capture the configured graph
      grid at boot (``engine.warmup(**warmup_kwargs(cfg))``), ``"none"``
      leaves each bucket to its first chunk; ``warmup_nfes`` /
      ``warmup_seq_lens`` extend the grid beyond the defaults.
    """

    solver: str = "era"
    nfe: int = 10
    k: int = 4
    lam: float = 5.0
    per_sample: bool = True
    batch_buckets: tuple[int, ...] | None = (1, 8, 64)
    seq_buckets: tuple[int, ...] | None = None
    nfe_buckets: tuple[int, ...] | None = None
    max_batch: int | None = DEFAULT_MAX_BATCH
    max_nfe: int | None = DEFAULT_MAX_NFE
    max_seq_len: int | None = DEFAULT_MAX_SEQ_LEN
    warmup: str = "none"
    warmup_nfes: tuple[int, ...] | None = None
    warmup_seq_lens: tuple[int, ...] | None = None


def make_solver_config(cfg: EngineConfig) -> SolverConfig:
    """The default solver's config: a full :class:`ERAConfig` for ``era``,
    the registry default at ``cfg.nfe`` for everything else."""
    if cfg.solver == "era":
        return ERAConfig(
            nfe=cfg.nfe, k=cfg.k, lam=cfg.lam, per_sample=cfg.per_sample
        )
    return default_config(cfg.solver, nfe=cfg.nfe)


def build_engine(
    dlm: DiffusionLM,
    schedule: NoiseSchedule,
    cfg: EngineConfig | None = None,
    metrics: MetricsRegistry | None = None,
    mesh=None,
) -> BatchedSampler:
    """The engine every serve mode shares, on ``dlm``'s device (its fused
    batches split over ``mesh``'s data axis when one is given: a mesh is a
    runtime resource, not engine shape, so it rides beside the config as in
    the reference).  Building captures nothing: ``cfg.warmup`` is policy,
    and a caller warms with ``engine.warmup(**warmup_kwargs(cfg))``."""
    cfg = cfg if cfg is not None else EngineConfig()
    if cfg.warmup not in WARMUP_MODES:
        raise ValueError(
            f"EngineConfig.warmup must be one of {WARMUP_MODES}, "
            f"got {cfg.warmup!r}"
        )
    return BatchedSampler(
        dlm,
        schedule,
        cfg.solver,
        make_solver_config(cfg),
        batch_buckets=cfg.batch_buckets,
        seq_buckets=cfg.seq_buckets,
        nfe_buckets=cfg.nfe_buckets,
        metrics=metrics,
        max_batch=cfg.max_batch,
        max_nfe=cfg.max_nfe,
        max_seq_len=cfg.max_seq_len,
        mesh=mesh,
    )


def warmup_kwargs(cfg: EngineConfig) -> dict | None:
    """The ``warmup(...)`` keywords an :class:`EngineConfig` implies, or
    None when ``cfg.warmup == "none"``.  With an nfe ladder the grid's
    budgets are the ladder; without one traffic groups by exact nfe, so
    the config's nfe is warmed."""
    if cfg.warmup == "none":
        return None
    default_nfes = None if cfg.nfe_buckets else (cfg.nfe,)
    return {
        "nfes": cfg.warmup_nfes or default_nfes,
        "seq_lens": cfg.warmup_seq_lens,
    }
