"""Fused-execution core of the diffusion sampling engine (port of
``repro.serving.executor``).

:class:`FusedExecutor` owns everything below the request queue: request
validation, batch-bucket selection, host-side batch assembly, chunk
execution and per-request aux scoping.  Requests fuse by the group key
``(solver, seq_len, nfe)``; each fused chunk is padded to a batch bucket and
runs one sampling loop on the device.

Each request's initial noise depends only on its seed and shape: it is
drawn from its own ``torch.Generator`` seeded with ``req.seed`` at the
request's exact ``(batch, seq_len, d_model)`` shape, so the batch it lands
in never changes it.  ``noise_fn`` replaces that draw (the parity tests feed
the reference's ``jax.random`` noise through it).

The port runs eagerly, so the reference's per-bucket compile cache, AOT
``warmup`` and persistent compile cache have no counterpart yet; seq-len
bucketing, NFE bucketing and mesh placement wait for later slices.
Chunk execution serializes under one re-entrant lock.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import NoiseSchedule, SolverConfig, get_program
from repro_torch.core.program import SolverProgram
from repro_torch.models.diffusion import DiffusionLM
from repro_torch.serving import result_keys as K
from repro_torch.serving.metrics import MetricsRegistry

Tensor = torch.Tensor

#: the seed range the serving contract accepts (signed 64-bit, as the
#: reference's PRNGKey requires); validate() rejects anything outside
SEED_MIN = -(2**63)
SEED_MAX = 2**63 - 1

#: server-side ceilings on the request's resource fields (None opts out)
DEFAULT_MAX_BATCH = 4096
DEFAULT_MAX_NFE = 1000
DEFAULT_MAX_SEQ_LEN = 8192


@dataclasses.dataclass(frozen=True)
class SampleRequest:
    """One sampling request.  ``seed`` fully determines its initial noise."""

    batch: int
    seq_len: int
    nfe: int = 10
    solver: str | None = None   # None = the engine's default solver
    seed: int = 0


@dataclasses.dataclass
class SampleResult:
    """Per-request output of a drained batch, scoped to this request's rows.
    ``batch_wall_s`` / ``padded_*`` describe the fused batch it rode in."""

    x0: Tensor               # (batch, seq_len, d_model), on the engine's device
    aux: dict[str, Any]      # solver diagnostics, this request's rows only
    latency_s: float         # submit -> result wall time
    batch_wall_s: float      # wall time of the fused batch
    padded_batch: int        # batch bucket the batch ran at
    padded_seq_len: int      # seq length the batch ran at
    padded_nfe: int          # NFE budget the batch ran at

    @property
    def info(self) -> dict[str, Any]:
        """Engine telemetry + solver ``aux`` under the result-key constants."""
        return {
            K.WALL_S: self.batch_wall_s,
            K.LATENCY_S: self.latency_s,
            K.PADDED_BATCH: self.padded_batch,
            K.PADDED_SEQ_LEN: self.padded_seq_len,
            K.PADDED_NFE: self.padded_nfe,
            **self.aux,
        }


# A queued request: (ticket, request, submit-time).
QueueItem = tuple[int, SampleRequest, float]


def resolve_future(fut: Future, result=None, exception=None) -> None:
    """Resolve a delivery future, tolerating client-side cancellation."""
    try:
        if exception is not None:
            fut.set_exception(exception)
        else:
            fut.set_result(result)
    except InvalidStateError:
        pass


class FusedExecutor:
    """Fused-chunk runner.  Every public method may be called from any
    thread; chunk execution serializes under one re-entrant lock and
    ``run_chunk`` returns once the fused result is finished on the device."""

    def __init__(
        self,
        dlm: DiffusionLM,
        schedule: NoiseSchedule,
        solver: str = "era",
        solver_config: SolverConfig | None = None,
        batch_buckets: tuple[int, ...] | None = (1, 8, 64),
        metrics: MetricsRegistry | None = None,
        max_batch: int | None = DEFAULT_MAX_BATCH,
        max_nfe: int | None = DEFAULT_MAX_NFE,
        max_seq_len: int | None = DEFAULT_MAX_SEQ_LEN,
        noise_fn: Callable[[SampleRequest], np.ndarray] | None = None,
    ):
        self.dlm = dlm
        self.device = dlm.device
        self.schedule = schedule
        self.solver_name = solver
        self.max_batch = max_batch
        self.max_nfe = max_nfe
        self.max_seq_len = max_seq_len
        self.noise_fn = noise_fn
        self._configs: dict[str, SolverConfig] = {
            solver: (
                get_program(solver).engine_config()
                if solver_config is None else solver_config
            )
        }
        self.batch_buckets = (
            tuple(sorted(set(batch_buckets))) if batch_buckets else None
        )
        self._lock = threading.RLock()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._m_batches = self.metrics.counter(
            "sampler_batches_total", "fused batches executed"
        )
        self._m_rows = self.metrics.counter(
            "sampler_batch_rows_total",
            "real (non-pad) request rows executed across fused batches",
        )
        self._m_occupancy = self.metrics.histogram(
            "sampler_fuse_occupancy_ratio",
            "real rows / padded rows per fused batch (1.0 = no pad waste)",
            buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0),
        )
        self._m_wall = self.metrics.histogram(
            "sampler_batch_wall_seconds", "device wall time per fused batch"
        )

    # ---- solver routing --------------------------------------------------
    def resolve_solver(self, req: SampleRequest) -> str:
        return req.solver or self.solver_name

    def program_for(self, solver: str | None) -> SolverProgram:
        return get_program(solver or self.solver_name)

    def config_for(self, solver: str | None) -> SolverConfig:
        name = solver or self.solver_name
        cfg = self._configs.get(name)
        if cfg is None:
            cfg = self._configs[name] = get_program(name).engine_config()
        return cfg

    def fusable_for(self, solver: str | None) -> bool:
        return self.program_for(solver).fusable(self.config_for(solver))

    @property
    def max_bucket(self) -> int | None:
        return self.batch_buckets[-1] if self.batch_buckets else None

    # ---- request policy --------------------------------------------------
    def group_key(self, req: SampleRequest) -> tuple[str, int, int]:
        """The fuse-group key ``(solver, seq_len, nfe)``."""
        return (self.resolve_solver(req), req.seq_len, req.nfe)

    def validate(self, req: SampleRequest) -> None:
        """Reject an invalid request at submit time, so it can never fail
        the fused batch of its neighbours at drain time."""
        if req.batch < 1:
            raise ValueError(f"batch must be >= 1, got {req.batch}")
        if self.max_batch is not None and req.batch > self.max_batch:
            raise ValueError(
                f"batch {req.batch} exceeds the engine's max_batch "
                f"{self.max_batch}"
            )
        if req.seq_len < 1:
            raise ValueError(f"seq_len must be >= 1, got {req.seq_len}")
        if self.max_seq_len is not None and req.seq_len > self.max_seq_len:
            raise ValueError(
                f"seq_len {req.seq_len} exceeds the engine's max_seq_len "
                f"{self.max_seq_len}"
            )
        if self.max_nfe is not None and req.nfe > self.max_nfe:
            raise ValueError(
                f"nfe {req.nfe} exceeds the engine's max_nfe {self.max_nfe}"
            )
        if not isinstance(req.seed, int) or isinstance(req.seed, bool):
            raise ValueError(f"seed must be an int, got {req.seed!r}")
        if not SEED_MIN <= req.seed <= SEED_MAX:
            raise ValueError(
                f"seed must fit in a signed 64-bit integer "
                f"({SEED_MIN} <= seed <= {SEED_MAX}), got {req.seed}"
            )
        program = self.program_for(req.solver)  # unknown solver raises here
        program.validate(req, self.config_for(req.solver))

    def pack(self, items: list[QueueItem]) -> list[tuple[list[QueueItem], bool]]:
        """Split same-group items into ``(chunk, pad)`` pairs: fusable
        configs pack greedily up to the largest batch bucket, non-fusable
        ones run one exact-size chunk per request."""
        if not items:
            return []
        if not self.fusable_for(items[0][1].solver):
            return [([item], False) for item in items]
        chunks: list[tuple[list[QueueItem], bool]] = []
        chunk: list[QueueItem] = []
        total = 0
        for item in items:
            b = item[1].batch
            if chunk and self.max_bucket and total + b > self.max_bucket:
                chunks.append((chunk, True))
                chunk, total = [], 0
            chunk.append(item)
            total += b
        if chunk:
            chunks.append((chunk, True))
        return chunks

    def bucket_batch(self, n: int) -> int:
        """Smallest batch bucket >= n (an oversize chunk runs exact-size)."""
        for b in self.batch_buckets or ():
            if n <= b:
                return b
        return n

    # ---- fused execution -------------------------------------------------
    def noise(self, req: SampleRequest) -> Tensor:
        """The request's initial noise at its exact shape, on the device."""
        shape = (req.batch, req.seq_len, self.dlm.config.d_model)
        if self.noise_fn is not None:
            noise = np.array(self.noise_fn(req), dtype=np.float32)
            if noise.shape != shape:
                raise ValueError(f"noise_fn gave {noise.shape}, need {shape}")
            return torch.from_numpy(noise).to(self.device)
        gen = torch.Generator(device=self.device).manual_seed(req.seed)
        return torch.randn(
            shape, generator=gen, device=self.device, dtype=torch.float32
        )

    def run_chunk(
        self,
        seq_len: int,
        nfe: int,
        chunk: list[QueueItem],
        results: dict[int, SampleResult],
        pad: bool = True,
    ) -> None:
        """Run one same-group chunk as a single fused batch; fill
        ``results`` by ticket.  Blocks until the batch is finished."""
        with self._lock:
            self._run_chunk_locked(seq_len, nfe, chunk, results, pad)

    def _run_chunk_locked(self, seq_len, nfe, chunk, results, pad):
        d = self.dlm.config.d_model
        solver = self.resolve_solver(chunk[0][1])
        program = self.program_for(solver)
        total = sum(req.batch for _, req, _ in chunk)
        padded = self.bucket_batch(total) if pad else total
        parts = [self.noise(req) for _, req, _ in chunk]
        if padded > total:
            parts.append(torch.zeros(
                (padded - total, seq_len, d), dtype=torch.float32,
                device=self.device,
            ))
        x_init = torch.cat(parts, dim=0)
        cfg = dataclasses.replace(self.config_for(solver), nfe=nfe)

        t0 = time.perf_counter()
        buffers = program.alloc_buffers(x_init, cfg)
        out = program.sample_scan(
            self.dlm.eps_fn(), x_init, buffers, self.schedule, cfg
        )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        self._m_batches.inc()
        self._m_rows.inc(total)
        self._m_occupancy.observe(total / padded, solver=solver)
        self._m_wall.observe(wall, solver=solver)

        done = time.perf_counter()
        off = 0
        for ticket, req, t_submit in chunk:
            results[ticket] = SampleResult(
                x0=out.x0[off : off + req.batch],
                aux=program.scope_aux(out.aux, off, req.batch),
                latency_s=done - t_submit,
                batch_wall_s=wall,
                padded_batch=padded,
                padded_seq_len=seq_len,
                padded_nfe=nfe,
            )
            off += req.batch
