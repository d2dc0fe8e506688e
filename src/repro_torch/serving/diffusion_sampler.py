"""Diffusion sampling service (port of ``repro.serving.diffusion_sampler``).

* :class:`BatchedSampler` — the sync engine: ``submit_with_future()``
  enqueues a request (from any thread) and returns its Future
  (``submit()`` returns only its ticket); ``drain()``
  groups pending requests by ``(solver, seq, nfe)``, packs each group
  into chunks padded to a batch bucket, and runs every chunk through the
  shared :class:`~repro_torch.serving.executor.FusedExecutor`.
  ``seq_buckets`` and ``nfe_buckets`` let requests of different
  ``seq_len`` and ``nfe`` share a chunk (``seq`` and ``nfe`` in the key
  are then buckets); on the card every bucket runs as one captured CUDA
  graph, which ``warmup()`` captures ahead of traffic.
* Per-request isolation inside a fused batch comes from per-sample ERS
  (``ERAConfig(per_sample=True)``, the engine default): each row measures
  its own delta_eps and selects its own Lagrange bases, so a batch of N
  equals N solo runs.
* :class:`SamplerService` — the one-call facade (exact-size batches, paper
  config).

The engine runs on its denoiser's device: the card unless the model was
built with ``device="cpu"``.  With ``mesh=`` (a data-axis
:class:`~repro_torch.launch.mesh.Mesh`) its batch buckets round up to
multiples of dp and each fused batch runs as dp row blocks, one on each
mesh device (:class:`~repro_torch.serving.executor.FusedExecutor`).  The model owns its weights, so ``drain()``
and ``warmup()`` take no parameter tree.  The continuous-batching
scheduler (:mod:`~repro_torch.serving.scheduler`) and the HTTP front door
(:mod:`~repro_torch.serving.frontdoor`) run over the same executor.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Any, Callable

import numpy as np

from repro_torch.core import NoiseSchedule, SolverConfig, get_program
from repro_torch.models.diffusion import DiffusionLM
from repro_torch.serving.executor import (
    DEFAULT_MAX_BATCH,
    DEFAULT_MAX_NFE,
    DEFAULT_MAX_SEQ_LEN,
    FusedExecutor,
    QueueItem,
    SampleRequest,
    SampleResult,
    resolve_future,
)
from repro_torch.serving.metrics import MetricsRegistry


class BatchedSampler:
    """Request-batching diffusion sampling engine (submit / drain).

    ``submit_with_future`` may be called from any thread; concurrent
    ``drain()`` callers are safe (each drains what is pending when it takes
    the queue; chunk execution serializes inside the executor)."""

    def __init__(
        self,
        dlm: DiffusionLM,
        schedule: NoiseSchedule,
        solver: str = "era",
        solver_config: SolverConfig | None = None,
        batch_buckets: tuple[int, ...] | None = (1, 8, 64),
        seq_buckets: tuple[int, ...] | None = None,
        nfe_buckets: tuple[int, ...] | None = None,
        metrics: MetricsRegistry | None = None,
        max_batch: int | None = DEFAULT_MAX_BATCH,
        max_nfe: int | None = DEFAULT_MAX_NFE,
        max_seq_len: int | None = DEFAULT_MAX_SEQ_LEN,
        noise_fn: Callable[[SampleRequest], np.ndarray] | None = None,
        mesh=None,
    ):
        self.executor = FusedExecutor(
            dlm, schedule, solver, solver_config, batch_buckets,
            seq_buckets=seq_buckets, nfe_buckets=nfe_buckets,
            metrics=metrics, max_batch=max_batch, max_nfe=max_nfe,
            max_seq_len=max_seq_len, noise_fn=noise_fn, mesh=mesh,
        )
        self._queue_lock = threading.Lock()
        self._pending: list[QueueItem] = []
        self._futures: dict[int, Future] = {}
        self._next_ticket = 0

    @property
    def dlm(self) -> DiffusionLM:
        return self.executor.dlm

    @property
    def schedule(self) -> NoiseSchedule:
        return self.executor.schedule

    @property
    def mesh(self):
        return self.executor.mesh

    @property
    def dp(self) -> int:
        return self.executor.dp

    @property
    def solver_name(self) -> str:
        return self.executor.solver_name

    @property
    def solver_config(self) -> SolverConfig:
        return self.executor.config_for(None)

    @property
    def batch_buckets(self) -> tuple[int, ...] | None:
        return self.executor.batch_buckets

    @property
    def seq_buckets(self) -> tuple[int, ...] | None:
        return self.executor.seq_buckets

    @property
    def nfe_buckets(self) -> tuple[int, ...] | None:
        return self.executor.nfe_buckets

    @property
    def metrics(self) -> MetricsRegistry:
        return self.executor.metrics

    # ---- request queue ---------------------------------------------------
    def submit(self, req: SampleRequest) -> int:
        """Validate, enqueue, and return the request's ticket: the key of
        its result in the map that ``drain()`` returns."""
        return self.submit_with_future(req)[0]

    def submit_with_future(self, req: SampleRequest) -> tuple[int, Future]:
        """Validate, enqueue, and hand back the request's delivery Future."""
        self.executor.validate(req)
        with self._queue_lock:
            ticket = self._next_ticket
            self._next_ticket += 1
            self._pending.append((ticket, req, time.perf_counter()))
            fut = self._futures[ticket] = Future()
        return ticket, fut

    @property
    def pending(self) -> int:
        with self._queue_lock:
            return len(self._pending)

    def drain(self) -> dict[int, SampleResult]:
        """Run all pending requests, fused per (solver, seq, nfe) group,
        and resolve each drained ticket's Future.  A chunk that fails fails
        only its own tickets; the first failure re-raises at the end."""
        with self._queue_lock:
            pending, self._pending = self._pending, []
        groups: dict[tuple[str, int, int], list[QueueItem]] = {}
        for item in pending:
            groups.setdefault(self.executor.group_key(item[1]), []).append(item)

        results: dict[int, SampleResult] = {}
        failure: Exception | None = None
        for (_solver, seq_len, nfe), items in groups.items():
            for chunk, pad in self.executor.pack(items):
                try:
                    self.executor.run_chunk(seq_len, nfe, chunk, results, pad=pad)
                except Exception as e:  # noqa: BLE001 - delivered via futures
                    if failure is None:
                        failure = e
                    with self._queue_lock:
                        futs = [self._futures.pop(t) for t, _, _ in chunk]
                    for fut in futs:
                        resolve_future(fut, exception=e)
        with self._queue_lock:
            futures = {t: self._futures.pop(t) for t in results}
        for ticket, fut in futures.items():
            resolve_future(fut, results[ticket])
        if failure is not None:
            raise failure
        return results

    # ---- cold start ------------------------------------------------------
    def warmup(
        self,
        *,
        solvers: tuple[str, ...] | None = None,
        seq_lens: tuple[int, ...] | None = None,
        nfes: tuple[int, ...] | None = None,
        progress=None,
    ) -> dict[str, Any]:
        """Capture the (solver x batch bucket x seq bucket x nfe) graph grid
        ahead of traffic (on the CPU: validate it); see
        :meth:`FusedExecutor.warmup`.  Returns the warmup report."""
        return self.executor.warmup(
            solvers=solvers, seq_lens=seq_lens, nfes=nfes, progress=progress,
        )

    def warmup_status(self) -> dict[str, Any]:
        """Warmup progress snapshot."""
        return self.executor.warmup_status()

    # ---- introspection (tests / chip_smoke) ------------------------------
    def compile_cache(self):
        """Bucket key -> captured graph."""
        return self.executor.compile_cache()

    def compile_stats(self) -> dict[str, int]:
        """Graph acquisitions by source: fresh captures, memory replays."""
        return self.executor.compile_stats()


class SamplerService:
    """One-call facade over :class:`BatchedSampler` with exact-size buckets.
    ``sample()`` submits, drains and returns the request's result.  With no
    ``solver_config`` it runs the paper config (shared delta_eps).
    ``engine=`` injects a pre-built engine instead, whose batch, seq and
    NFE ladders and graph cache the facade then shares."""

    def __init__(
        self,
        dlm: DiffusionLM | None = None,
        schedule: NoiseSchedule | None = None,
        solver: str = "era",
        solver_config: SolverConfig | None = None,
        engine: BatchedSampler | None = None,
    ):
        if engine is None:
            if dlm is None or schedule is None:
                raise ValueError(
                    "SamplerService needs (dlm, schedule) or a pre-built engine="
                )
            if solver_config is None:
                solver_config = get_program(solver).default_config()
            engine = BatchedSampler(
                dlm, schedule, solver, solver_config, batch_buckets=None
            )
        self._engine = engine
        self.dlm = engine.dlm
        self.schedule = engine.schedule
        self.solver_name = engine.solver_name
        self.solver_config = engine.solver_config

    def sample(self, req: SampleRequest) -> SampleResult:
        """Generate ``req.batch`` sequences of latents; blocking."""
        _, fut = self._engine.submit_with_future(req)
        self._engine.drain()
        return fut.result()
