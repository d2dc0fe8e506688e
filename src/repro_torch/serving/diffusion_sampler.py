"""Diffusion sampling service (port of ``repro.serving.diffusion_sampler``).

* :class:`BatchedSampler` — the sync engine: ``submit_with_future()``
  enqueues a request (from any thread) and returns its Future
  (``submit()`` returns only its ticket); ``drain()``
  groups pending requests by ``(solver, seq_len, nfe)``, packs each group
  into chunks padded to a batch bucket, and runs every chunk through the
  shared :class:`~repro_torch.serving.executor.FusedExecutor`.
* Per-request isolation inside a fused batch comes from per-sample ERS
  (``ERAConfig(per_sample=True)``, the engine default): each row measures
  its own delta_eps and selects its own Lagrange bases, so a batch of N
  equals N solo runs.
* :class:`SamplerService` — the one-call facade (exact-size batches, paper
  config).

The engine runs on its denoiser's device: the card unless the model was
built with ``device="cpu"``.  The model owns its weights, so ``drain()``
takes no parameter tree.  The continuous-batching scheduler, the HTTP
front door and ``warmup`` wait for later slices.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Callable

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
        metrics: MetricsRegistry | None = None,
        max_batch: int | None = DEFAULT_MAX_BATCH,
        max_nfe: int | None = DEFAULT_MAX_NFE,
        max_seq_len: int | None = DEFAULT_MAX_SEQ_LEN,
        noise_fn: Callable[[SampleRequest], np.ndarray] | None = None,
    ):
        self.executor = FusedExecutor(
            dlm, schedule, solver, solver_config, batch_buckets,
            metrics=metrics, max_batch=max_batch, max_nfe=max_nfe,
            max_seq_len=max_seq_len, noise_fn=noise_fn,
        )
        self._queue_lock = threading.Lock()
        self._pending: list[QueueItem] = []
        self._futures: dict[int, Future] = {}
        self._next_ticket = 0

    @property
    def dlm(self) -> DiffusionLM:
        return self.executor.dlm

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
        """Run all pending requests, fused per (solver, seq_len, nfe) group,
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


class SamplerService:
    """One-call facade over :class:`BatchedSampler` with exact-size buckets.
    ``sample()`` submits, drains and returns the request's result.  With no
    ``solver_config`` it runs the paper config (shared delta_eps)."""

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

    def sample(self, req: SampleRequest) -> SampleResult:
        """Generate ``req.batch`` sequences of latents; blocking."""
        _, fut = self._engine.submit_with_future(req)
        self._engine.drain()
        return fut.result()
