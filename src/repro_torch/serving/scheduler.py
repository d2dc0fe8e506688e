"""Continuous-batching scheduler for the diffusion sampling engine (port of
``repro.serving.scheduler``).

The sync :class:`~repro_torch.serving.diffusion_sampler.BatchedSampler`
fuses only the requests pending at one ``drain()``, so an open-loop stream
degenerates to batch-of-1 drains.  :class:`AsyncBatchedSampler` fuses
requests across arrival time:

* ``submit()`` is callable from any thread and returns a
  :class:`concurrent.futures.Future` that resolves to a
  :class:`~repro_torch.serving.executor.SampleResult`;
* requests land in queues keyed by the executor's group key ``(solver,
  seq, nfe)`` (``seq`` / ``nfe`` are buckets under seq / NFE bucketing),
  so only requests that may share a bucket graph share a queue;
* a background drain thread launches a queue when it reaches the policy's
  target bucket occupancy, or when its oldest request has waited
  ``max_wait_ms`` (a lone request never starves);
* ready queues launch highest-priority first (a queue's priority is its
  most urgent request's), then oldest first; inside a queue higher
  ``priority`` boards first (FIFO among equals), and one launch takes at
  most one largest bucket's rows (the rest keep their arrival times).

**Admission control** (``SchedulerPolicy.max_queue_rows``): a ``submit()``
that would push its queue past the bound raises :class:`QueueFullError`
(HTTP 429 with ``Retry-After`` at the front door).  **Deadlines**
(``SampleRequest.deadline_ms``): a request still queued past its deadline
fails with :class:`DeadlineExceededError` at the next drain pass, without
taking a seat in a batch.  Neither touches an admitted request's result.

Execution goes through the engine's shared, thread-safe
:class:`~repro_torch.serving.executor.FusedExecutor`, so the bucket graphs
are the sync path's, and a request's ``x0`` is bitwise the same whether it
runs through ``drain()``, through this scheduler under any arrival order,
or solo at the same batch bucket.

Differences from the reference: the port's engine owns its weights, so
``AsyncBatchedSampler(engine, policy=None, clock=...)`` takes no
``params`` and :meth:`AsyncBatchedSampler.warmup` calls
``engine.warmup(...)`` without them, as the port's ``BatchedSampler``
does.  And every result the scheduler delivers lies on the host: the
executor copies ``x0`` and ``aux`` to the CPU under its lock
(``run_chunk(..., to_host=True)``), so a thread that reads a result never
touches the card while another thread captures a bucket graph.

Every policy decision reads an injectable ``clock`` and is reachable
through :meth:`AsyncBatchedSampler.drain_once`, so the scheduling logic is
testable with a fake clock and no thread.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable

from repro_torch.serving import result_keys as K
from repro_torch.serving.diffusion_sampler import BatchedSampler
from repro_torch.serving.executor import (
    QueueItem,
    SampleRequest,
    SampleResult,
    resolve_future,
)


class QueueFullError(RuntimeError):
    """Admission control rejected a submit: the request's fuse-group queue
    is at ``SchedulerPolicy.max_queue_rows``.  ``retry_after_s`` is the
    server's backoff hint (the front door sends it as ``Retry-After``).
    ``message`` overrides the formatted text: the wire client rebuilds this
    error from a 429 whose body carries the server's message."""

    def __init__(
        self,
        key,
        rows: int,
        limit: int,
        retry_after_s: float,
        message: str | None = None,
    ):
        self.key = key
        self.rows = rows
        self.limit = limit
        self.retry_after_s = retry_after_s
        super().__init__(
            message
            if message is not None
            else f"queue {key} is full ({rows} rows >= limit {limit}); "
            f"retry in {retry_after_s:.1f}s"
        )


class DeadlineExceededError(RuntimeError):
    """A request waited longer than its ``deadline_ms`` in the queue and
    was failed instead of boarding a batch.  ``message`` overrides the
    formatted text (the wire client rebuilds this error from a 504)."""

    def __init__(
        self, req: SampleRequest, waited_ms: float, message: str | None = None
    ):
        self.req = req
        self.waited_ms = waited_ms
        super().__init__(
            message
            if message is not None
            else f"request (seed={req.seed}, "
            f"solver={req.solver or 'default'}) "
            f"expired in queue: waited {waited_ms:.1f}ms > "
            f"deadline_ms={req.deadline_ms:g}"
        )


def open_loop(gaps, emit, clock=time.perf_counter, sleep=time.sleep) -> float:
    """Drive an open-loop client: call ``emit(i)`` at each cumulative
    arrival offset of ``gaps``.  Sleeps only while ahead of schedule and
    catches up back to back when behind (``sleep(0)`` still yields the
    interpreter to a colocated drain thread).  Returns the stream's start
    time on ``clock``."""
    t_start = clock()
    offset = 0.0
    for i, gap in enumerate(gaps):
        offset += gap
        delay = t_start + offset - clock()
        sleep(delay if delay > 0 else 0.0)
        emit(i)
    return t_start


@dataclasses.dataclass(frozen=True)
class SchedulerPolicy:
    """When does a queue of compatible requests launch as one fused batch?

    * ``max_wait_ms``: the longest any request waits before its queue is
      launched whatever its size (lower: better tail latency; higher:
      fuller batches).
    * ``target_occupancy``: the fraction of the largest batch bucket at
      which a queue launches at once.
    * ``max_queue_rows``: admission bound per queue (None: unbounded).
    """

    max_wait_ms: float = 10.0
    target_occupancy: float = 1.0
    max_queue_rows: int | None = None

    def target_rows(self, max_bucket: int | None) -> int | None:
        """Rows that launch a queue at once (None: deadline only, for an
        engine without batch buckets)."""
        if max_bucket is None:
            return None
        return max(1, math.ceil(self.target_occupancy * max_bucket))

    def deadline(self, oldest_t: float) -> float:
        return oldest_t + self.max_wait_ms / 1e3

    def should_launch(
        self, now: float, oldest_t: float, rows: int, max_bucket: int | None
    ) -> bool:
        target = self.target_rows(max_bucket)
        if target is not None and rows >= target:
            return True
        return now >= self.deadline(oldest_t)

    def retry_after_s(self) -> float:
        """Backoff hint for a rejected client: one launch deadline, at
        least a second."""
        return max(1.0, self.max_wait_ms / 1e3)


class AsyncBatchedSampler:
    """Continuous-batching front end over a :class:`BatchedSampler`.

    ``submit`` / ``pending`` / ``stats`` never block on execution and are
    callable from any thread; batches run on the drain thread (``start()``
    / ``stop()``, or a ``with`` block), or on the caller's thread through
    ``drain_once()``.  Sharing the engine with sync ``drain()`` callers is
    safe: both serialize in the executor and share its bucket graphs.
    ``stop()`` flushes every queued request (all futures resolve) and
    joins the drain thread; a scheduler is one-shot."""

    def __init__(
        self,
        engine: BatchedSampler,
        policy: SchedulerPolicy | None = None,
        clock: Callable[[], float] = time.perf_counter,
    ):
        self.engine = engine
        self.policy = policy or SchedulerPolicy()
        self._clock = clock
        self._cv = threading.Condition()
        self._queues: dict[
            tuple[str, int, int], deque[tuple[QueueItem, Future]]
        ] = {}
        self._next_ticket = 0
        self._thread: threading.Thread | None = None
        self._stopping = False
        self._batches = 0
        self._rows = 0
        # get-or-create in the executor's registry: the front door and the
        # sync drains scrape the same /metrics
        m = engine.executor.metrics
        self._m_depth = m.gauge(
            "sampler_queue_depth_rows",
            "pending request rows per fuse-group queue (solver, seq, nfe)",
        )
        self._m_submitted = m.counter(
            "sampler_requests_submitted_total", "requests admitted by submit()"
        )
        self._m_rejects = m.counter(
            "sampler_admission_rejects_total",
            "submits rejected by the max_queue_rows admission bound",
        )
        self._m_expired = m.counter(
            "sampler_deadline_expired_total",
            "queued requests failed fast past their deadline_ms",
        )
        self._m_latency = m.histogram(
            "sampler_request_latency_seconds",
            "arrival-to-result latency per delivered request",
        )

    # ---- client surface -------------------------------------------------
    def submit(self, req: SampleRequest) -> Future:
        """Enqueue from any thread.  The Future resolves to the request's
        :class:`SampleResult` (on the host), or raises: with the failure of
        the batch it rode in, or :class:`DeadlineExceededError`.  An invalid
        request raises ``ValueError`` here, so it never poisons a batch; a
        full queue raises :class:`QueueFullError`; a stopped scheduler
        RuntimeError."""
        self.engine.executor.validate(req)
        fut: Future = Future()
        key = self.engine.executor.group_key(req)
        label = self._key_labels(key)
        with self._cv:
            if self._stopping:
                raise RuntimeError("scheduler is stopped")
            limit = self.policy.max_queue_rows
            if limit is not None:
                q = self._queues.get(key)
                rows = sum(item[1].batch for item, _ in q) if q else 0
                if rows + req.batch > limit:
                    self._m_rejects.inc(**label)
                    raise QueueFullError(
                        key, rows, limit, self.policy.retry_after_s()
                    )
            ticket = self._next_ticket
            self._next_ticket += 1
            item: QueueItem = (ticket, req, self._clock())
            self._queues.setdefault(key, deque()).append((item, fut))
            self._m_submitted.inc()
            self._set_depth_locked(key)
            self._cv.notify()
        return fut

    @staticmethod
    def _key_labels(key) -> dict:
        solver, seq, nfe = key
        return {"solver": solver, "seq": seq, "nfe": nfe}

    def _set_depth_locked(self, key) -> None:
        q = self._queues.get(key)
        rows = sum(item[1].batch for item, _ in q) if q else 0
        self._m_depth.set(rows, **self._key_labels(key))

    @property
    def pending(self) -> int:
        with self._cv:
            return sum(len(q) for q in self._queues.values())

    def stats(self) -> dict:
        with self._cv:
            batches, rows = self._batches, self._rows
            submitted = self._next_ticket
        return {
            K.SUBMITTED: submitted,
            K.BATCHES: batches,
            K.ROWS: rows,
            K.MEAN_BATCH_ROWS: (rows / batches) if batches else 0.0,
        }

    # ---- cold start ------------------------------------------------------
    def warmup(
        self,
        *,
        solvers: tuple[str, ...] | None = None,
        seq_lens: tuple[int, ...] | None = None,
        nfes: tuple[int, ...] | None = None,
        progress=None,
    ):
        """Capture the engine's bucket-graph grid ahead of traffic (on the
        CPU: validate it); see :meth:`FusedExecutor.warmup`.  Safe beside
        live traffic: grid points a request captured first are skipped.
        The front door runs this on a background thread and gates
        ``/readyz`` on it."""
        return self.engine.warmup(
            solvers=solvers, seq_lens=seq_lens, nfes=nfes, progress=progress,
        )

    def warmup_status(self) -> dict:
        """Warmup progress of the executor (what ``/readyz`` reports)."""
        return self.engine.warmup_status()

    # ---- lifecycle (one-shot) ---------------------------------------------
    def start(self) -> "AsyncBatchedSampler":
        with self._cv:
            if self._stopping:
                raise RuntimeError(
                    "scheduler is stopped — schedulers are one-shot, "
                    "construct a new AsyncBatchedSampler to serve again"
                )
            if self._thread is not None:
                raise RuntimeError("scheduler already started")
            self._thread = threading.Thread(
                target=self._loop, name="era-scheduler", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        """Flush every queued request (their futures all resolve), then
        join the drain thread."""
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join()
        else:
            # never started: flush here so no future is orphaned
            now = self._clock()
            with self._cv:
                expired = self._expire_locked(now)
                batches = self._pop_all()
            self._fail_expired(expired, now)
            self._run_batches(batches)

    def __enter__(self) -> "AsyncBatchedSampler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ---- scheduling core (fake-clock testable, no thread required) ------
    def drain_once(self, now: float | None = None) -> int:
        """Fail every queued request past its deadline, then launch every
        queue the policy finds ready at ``now``; returns the number of
        fused batches launched.  The drain thread's step function."""
        with self._cv:
            t = self._clock() if now is None else now
            expired = self._expire_locked(t)
            batches = self._pop_ready(t)
        self._fail_expired(expired, t)
        return self._run_batches(batches)

    def _expire_locked(self, now: float):
        """Take the deadline-expired requests out of every queue; they are
        failed outside the lock."""
        expired: list[tuple[QueueItem, Future]] = []
        for key, q in self._queues.items():
            if not q:
                continue
            keep = deque()
            for entry in q:
                (_, req, t_submit), _ = entry
                if (
                    req.deadline_ms is not None
                    and now - t_submit > req.deadline_ms / 1e3
                ):
                    expired.append(entry)
                else:
                    keep.append(entry)
            if len(keep) != len(q):
                self._queues[key] = keep
                self._set_depth_locked(key)
        return expired

    def _fail_expired(self, expired, now: float) -> None:
        for (_, req, t_submit), fut in expired:
            self._m_expired.inc()
            resolve_future(
                fut,
                exception=DeadlineExceededError(req, (now - t_submit) * 1e3),
            )

    def _pop_ready(self, now: float):
        """Pop the ready chunks, highest-priority queue first, the oldest
        arrival breaking ties."""
        exe = self.engine.executor
        ready: list[tuple[int, float, tuple[str, int, int]]] = []
        for key, q in self._queues.items():
            if not q:
                continue
            rows = sum(item[1].batch for item, _ in q)
            oldest = q[0][0][2]
            if self.policy.should_launch(now, oldest, rows, exe.max_bucket):
                prio = max(item[1].priority for item, _ in q)
                ready.append((-prio, oldest, key))
        ready.sort()
        batches = []
        for _, _, key in ready:
            batches.extend(self._pop_chunks(key, full_queue=False))
        return batches

    def _pop_all(self):
        batches = []
        for key in list(self._queues):
            batches.extend(self._pop_chunks(key, full_queue=True))
        return batches

    def _pop_chunks(self, key, full_queue: bool):
        """Take up to one largest bucket's rows from one queue, higher
        ``priority`` boarding first (FIFO among equals); the rest keep
        their arrival order and times.  A flush takes the whole queue."""
        exe = self.engine.executor
        entries = list(self._queues[key])
        order = sorted(
            range(len(entries)),
            key=lambda i: (-entries[i][0][1].priority, i),
        )
        taken_idx: list[int] = []
        total = 0
        for i in order:
            b = entries[i][0][1].batch
            if (
                not full_queue
                and taken_idx
                and exe.max_bucket
                and total + b > exe.max_bucket
            ):
                break
            taken_idx.append(i)
            total += b
        taken_set = set(taken_idx)
        taken = [entries[i] for i in taken_idx]
        self._queues[key] = deque(
            e for i, e in enumerate(entries) if i not in taken_set
        )
        self._set_depth_locked(key)
        futures = {item[0]: fut for item, fut in taken}
        return [
            (key, chunk, pad, futures)
            for chunk, pad in exe.pack([item for item, _ in taken])
        ]

    def _run_batches(self, batches) -> int:
        """Run popped chunks outside the queue lock, results to the host,
        and resolve their futures.  A failed chunk fails its own futures
        and nothing else; it is not run again on another path."""
        for (_solver, seq_len, nfe), chunk, pad, futures in batches:
            results: dict[int, SampleResult] = {}
            try:
                self.engine.executor.run_chunk(
                    seq_len, nfe, chunk, results, pad=pad, to_host=True
                )
            except Exception as e:  # noqa: BLE001 - delivered via futures
                for ticket, _, _ in chunk:
                    resolve_future(futures[ticket], exception=e)
                continue
            with self._cv:
                self._batches += 1
                self._rows += sum(req.batch for _, req, _ in chunk)
            for ticket, _, _ in chunk:
                self._m_latency.observe(results[ticket].latency_s)
                resolve_future(futures[ticket], results[ticket])
        return len(batches)

    def _next_deadline_s(self, now: float) -> float | None:
        """Seconds to the nearest wakeup: a queue's launch deadline or a
        request's expiry, whichever comes first (None: nothing queued)."""
        deadlines = []
        for q in self._queues.values():
            if not q:
                continue
            deadlines.append(self.policy.deadline(q[0][0][2]))
            for (_, req, t_submit), _ in q:
                if req.deadline_ms is not None:
                    deadlines.append(t_submit + req.deadline_ms / 1e3)
        if not deadlines:
            return None
        return max(0.0, min(deadlines) - now)

    def _loop(self) -> None:
        while True:
            batches, expired, now = [], [], self._clock()
            with self._cv:
                while not self._stopping:
                    now = self._clock()
                    expired = self._expire_locked(now)
                    batches = self._pop_ready(now)
                    if batches or expired:
                        break
                    self._cv.wait(timeout=self._next_deadline_s(now))
                stopping = self._stopping
                if stopping:
                    now = self._clock()
                    expired.extend(self._expire_locked(now))
                    batches = self._pop_all()
            self._fail_expired(expired, now)
            self._run_batches(batches)
            if stopping:
                return
