"""Fused-execution core of the diffusion sampling engine (port of
``repro.serving.executor``).

:class:`FusedExecutor` owns everything below the request queue: request
validation, bucket selection, host-side batch assembly, the bucket graph
cache, chunk execution and per-request aux scoping.  Requests fuse by the
group key ``(solver, seq, nfe)``; each fused chunk is padded to a batch
bucket and runs one sampling loop on the device.

**Seq bucketing** (``seq_buckets=(128, 256, ...)``): requests of different
``seq_len`` fuse into one batch.  Each request's noise is drawn at its
exact shape and right-padded with zeros to the smallest bucket that fits;
a per-row ``lengths`` vector masks pad keys out of every attention softmax
(``DiffusionLM.eps(lengths=...)``) and pad positions out of the solvers'
sequence reductions (ERA's error norms, adaptive DPM's error RMS), and
results are sliced back to each request's ``seq_len``.

**NFE bucketing** (``nfe_buckets=(10, 20, ...)``): requests of different
``nfe`` fuse into one batch that runs the bucket's step count under a
per-row :class:`~repro_torch.core.program.StepMask`: each row steps
through its own exact-NFE grid and freezes bitwise once its own steps are
spent; step-stacked diagnostics are cut back to each request's own count.
Batch pad rows run fully active on the bucket's grid.

Either ladder falls back, per solver, to exact grouping when the solver
cannot guarantee the masking contract (a non-fusable config, a program
without ``supports_lengths`` / ``supports_steps``, an unmaskable
denoiser); each verdict is counted once on
``sampler_masked_fallback_total``.

**One CUDA graph per bucket.**  On the card a chunk does not dispatch its
loop op by op from Python: every bucket ``(solver, config, padded batch,
seq, masked, stepped)`` is captured once as a ``torch.cuda.CUDAGraph`` of
a whole sampling run (the reference compiles one XLA program per bucket
instead), by its first chunk or ahead of time by :meth:`warmup`.  A chunk
copies its inputs into the graph's static inputs, replays it and copies
the results out: a :class:`SampleResult` never views graph memory, which
the bucket's next replay overwrites.  Every capture follows one eager run
of the same program on the capture stream, which builds the Triton kernel,
sets the flash kernel's shared-memory attribute and creates the cuBLAS
handles outside the capture.  The graphs share one memory pool: replays
run one at a time under the executor's lock and results are copied out
before the next replay.  A capture or a replay that fails raises; nothing
falls back to eager execution on the card.  On the CPU (an engine whose
denoiser was built with ``device="cpu"``) a chunk runs its program
eagerly and :meth:`warmup` only validates its grid.

**Threads and captures.**  A capture runs in CUDA's global capture mode,
under which a device call from any other thread (a copy to the host, a
``cudaMalloc`` of the caching allocator, a synchronize) fails the call or
invalidates the capture.  So every device touch of the serving stack
happens under the executor's lock, which each capture holds: the chunk's
noise, the replay, the copy out of graph memory, and, for a caller that
asks with ``run_chunk(..., to_host=True)`` (the scheduler always does), the
copy of its results to the host.  A thread that holds such a result, an
HTTP handler encoding it, touches no device.  The sync ``drain()`` hands
back results on the device: its caller reads them while no other thread
captures.  Each chunk and each capture ends in a device synchronize, so no
thread relies on stream order across threads.  Warmup progress has a lock
of its own, so a readiness probe never waits out a capture.

Each request's initial noise depends only on its seed and shape: it is
drawn from its own ``torch.Generator`` seeded with ``req.seed`` at the
request's exact ``(batch, seq_len, d_model)`` shape, so the batch it lands
in never changes it.  ``noise_fn`` replaces that draw (the parity tests feed
the reference's ``jax.random`` noise through it).  Graphs do not persist
across processes, so the reference's persistent compile cache has no
counterpart.

**Mesh** (``mesh=``, a :class:`~repro_torch.launch.mesh.Mesh` with a
``data`` axis over devices): the reference shards a fused batch's rows over
the data axes and replicates the parameters.  Here batch buckets round up
to multiples of dp (:func:`~repro_torch.parallel.sharding.round_to_dp`); a
fused batch is split into dp contiguous row blocks, block i runs on
``mesh.devices[i]`` against that device's copy of the weights
(:class:`~repro_torch.parallel.sharding.ParamReplicator`), each with its own
graph per (device, bucket), and the results are gathered in row order on
the engine's device (``merge_aux`` joins the diagnostics).  A fusable
program's rows do not read each other, so the split computes what the
whole batch does.  Without a mesh, at dp = 1, and for a chunk that does not
split (a non-fusable program's rows share state; a batch dp does not
divide) the chunk is one block: the engine's denoiser on its own device,
which must be the mesh's first, with no copy and no gather.  That is what
the reference's replicated placement computes.  A mesh with a ``model``
axis larger than 1 raises.  On the card, graphs of a split (dp > 1) are
captured per device under ``torch.cuda.device`` (``chip_smoke.py
--mesh-only`` on several cards holds such a drain to the unsplit one).
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import NoiseSchedule, SolverConfig, get_program
from repro_torch.core.program import SolverProgram, StepMask
from repro_torch.core.solver_base import SolverOutput
from repro_torch.device import resolve_device
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.era_update import era_update
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gemm import bgemm, gemm
from repro_torch.kernels.rownorm import layernorm, rmsnorm, row_sq_sums
from repro_torch.models.diffusion import DiffusionLM
from repro_torch.parallel.sharding import ParamReplicator, round_to_dp, serving_dp
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

#: the kernel wrappers whose ``launches`` count launches on the device; a
#: graph's capture records its launches and each replay adds them
COUNTED_KERNELS = (era_update, flash_attention, decode_attention, gemm, rmsnorm,
                   layernorm, row_sq_sums, bgemm)


@dataclasses.dataclass(frozen=True)
class SampleRequest:
    """One sampling request.  ``seed`` fully determines its initial noise.

    ``priority`` and ``deadline_ms`` are hints for the continuous-batching
    scheduler (and travel verbatim over the front door's wire): when a
    fuse-group queue launches, higher-priority requests board first, and a
    request still queued ``deadline_ms`` after submit fails fast with
    :class:`~repro_torch.serving.scheduler.DeadlineExceededError`.  Neither
    reaches the bucket key, the noise or any result, and the sync
    ``drain()`` ignores both."""

    batch: int
    seq_len: int
    nfe: int = 10
    solver: str | None = None   # None = the engine's default solver
    seed: int = 0
    priority: int = 0
    deadline_ms: float | None = None


@dataclasses.dataclass
class SampleResult:
    """Per-request output of a drained batch, scoped to this request's rows,
    positions and steps.  ``batch_wall_s`` / ``padded_*`` describe the
    fused batch it rode in: its batch bucket, seq bucket and NFE bucket."""

    x0: Tensor               # (batch, seq_len, d_model), on the engine's
                             # device (on the host from the scheduler);
                             # never a view of graph memory
    aux: dict[str, Any]      # solver diagnostics of this request alone
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

# A bucket: (solver, config with the bucket's nfe, padded batch, seq,
# masked, stepped).
BucketKey = tuple[str, SolverConfig, int, int, bool, bool]


@dataclasses.dataclass
class BucketGraph:
    """One captured bucket: the CUDA graph of a whole sampling run, the
    static tensors it reads (``x_init``, ``lengths``, ``steps``; the time
    grid and the solver buffers live inside it) and writes (``x0``,
    ``aux``), and the kernel launches one replay makes, in the order of
    :data:`COUNTED_KERNELS`."""

    graph: torch.cuda.CUDAGraph
    x_init: Tensor
    lengths: Tensor | None
    steps: StepMask | None
    x0: Tensor
    aux: dict[str, Tensor]
    launches: tuple[int, ...]
    #: the denoiser (a mesh device's copy) the graph reads its weights from
    dlm: Any = None


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
    thread; chunk execution, captures and replays serialize under one
    re-entrant lock, and ``run_chunk`` returns once the fused result is
    finished on the device."""

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
        self.dlm = dlm
        self.device = dlm.device
        self.mesh = mesh
        self.dp = 1 if mesh is None else serving_dp(mesh, self.device)
        self._replicate = None if mesh is None else ParamReplicator(mesh)
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
            tuple(sorted({round_to_dp(b, mesh) for b in batch_buckets}))
            if batch_buckets else None
        )
        self.seq_buckets = tuple(sorted(seq_buckets)) if seq_buckets else None
        self.nfe_buckets = tuple(sorted(nfe_buckets)) if nfe_buckets else None
        # per-solver verdicts: may this solver's traffic seq- / nfe-bucket?
        self._seq_masked: dict[str, bool] = {}
        self._nfe_masked: dict[str, bool] = {}
        # (solver, nfe) -> the exact step grid, on the host and the device
        self._row_times: dict[tuple[str, int], Tensor] = {}
        self._grids: dict[tuple[str, int, str], Tensor] = {}
        # bucket key -> graph; on a mesh (device index, block key) -> graph
        self._graphs: dict[Any, BucketGraph] = {}
        # one capture stream and one memory pool per device for every bucket
        # graph: the allocator reuses a block only on the stream it came from
        self._streams: dict[str, tuple[torch.cuda.Stream, Any]] = {}
        self._lock = threading.RLock()
        self._state_lock = threading.Lock()   # guards _warmup_state only
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._m_compile_hits = self.metrics.counter(
            "sampler_compile_cache_hits_total",
            "fused chunks served by replaying an already-captured bucket graph",
        )
        self._m_compile_misses = self.metrics.counter(
            "sampler_compile_cache_misses_total",
            "bucket graphs captured, labelled by source (fresh: a capture)",
        )
        self._m_compile_programs = self.metrics.counter(
            "sampler_compile_programs_total",
            "bucket graph acquisitions by source: memory (a replay of a "
            "captured graph), fresh (a capture)",
        )
        self._m_compile_wall = self.metrics.histogram(
            "sampler_compile_seconds",
            "wall time of each capture, its eager run included",
            buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0),
        )
        self._m_warmup_total = self.metrics.gauge(
            "sampler_warmup_grid_programs",
            "programs in the configured warmup grid (0 until warmup() runs)",
        )
        self._m_warmup_done = self.metrics.gauge(
            "sampler_warmup_compiled_programs",
            "warmup grid programs captured (or validated, on the CPU) so far",
        )
        self._m_warmup_inflight = self.metrics.gauge(
            "sampler_warmup_in_progress", "1 while warmup() walks the grid",
        )
        self._m_warmup_wall = self.metrics.gauge(
            "sampler_warmup_duration_seconds",
            "wall time of the last completed warmup()",
        )
        self._m_warmup_programs = self.metrics.counter(
            "sampler_warmup_programs_total",
            "bucket graphs captured by warmup(), by solver",
        )
        self._compile_counts = {"fresh": 0, "memory": 0}
        self._warmup_state: dict[str, Any] = {
            "state": "none", "done": 0, "total": 0,
        }
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
        self._m_masked_fallback = self.metrics.counter(
            "sampler_masked_fallback_total",
            "engine seq-bucketing / nfe-bucketing verdicts that force "
            "exact-shape or exact-NFE grouping, by impl and reason",
        )
        self._m_nfe_pad_rows = self.metrics.counter(
            "sampler_nfe_padding_rows_total",
            "request rows padded to a larger NFE bucket than requested "
            "(per-row step masks freeze their surplus steps)",
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

    # ---- seq and NFE bucketing -------------------------------------------
    def seq_masked(self, solver: str | None) -> bool:
        """Does this solver's traffic fuse across seq_lens (padded and
        length-masked), or group by exact seq_len?  Needs a seq ladder, a
        fusable config, a program that supports lengths and a denoiser
        whose blocks can all be masked."""
        if not self.seq_buckets:
            return False
        name = solver or self.solver_name
        verdict = self._seq_masked.get(name)
        if verdict is None:
            program = self.program_for(name)
            cfg = self.config_for(name)
            fusable = program.fusable(cfg)
            lengths_ok = program.supports_lengths(cfg)
            maskable = bool(getattr(self.dlm, "supports_length_masking", False))
            verdict = self._seq_masked[name] = fusable and lengths_ok and maskable
            if not verdict:
                reason = (
                    "non-fusable-config" if not fusable
                    else "program-no-lengths" if not lengths_ok
                    else "denoiser-unmaskable"
                )
                self._m_masked_fallback.inc(impl="seq-bucketing", reason=reason)
        return verdict

    def bucket_seq(self, n: int) -> int:
        """Smallest seq bucket >= n (longer requests are rejected at
        submit)."""
        for s in self.seq_buckets:
            if n <= s:
                return s
        raise ValueError(
            f"seq_len {n} exceeds the largest seq bucket {self.seq_buckets[-1]}"
        )

    def nfe_masked(self, solver: str | None) -> bool:
        """Does this solver's traffic fuse across NFEs (the bucket's step
        count under a per-row step mask), or group by exact nfe?  Needs an
        nfe ladder, a fusable config and a program that supports steps."""
        if not self.nfe_buckets:
            return False
        name = solver or self.solver_name
        verdict = self._nfe_masked.get(name)
        if verdict is None:
            program = self.program_for(name)
            cfg = self.config_for(name)
            fusable = program.fusable(cfg)
            steps_ok = program.supports_steps(cfg)
            verdict = self._nfe_masked[name] = fusable and steps_ok
            if not verdict:
                reason = (
                    "non-fusable-config" if not fusable else "program-no-steps"
                )
                self._m_masked_fallback.inc(impl="nfe-bucketing", reason=reason)
        return verdict

    def bucket_nfe(self, n: int) -> int:
        """Smallest nfe bucket >= n (larger budgets are rejected at
        submit)."""
        for b in self.nfe_buckets:
            if n <= b:
                return b
        raise ValueError(
            f"nfe {n} exceeds the largest nfe bucket {self.nfe_buckets[-1]}"
        )

    # ---- request policy --------------------------------------------------
    def group_key(self, req: SampleRequest) -> tuple[str, int, int]:
        """The fuse-group key ``(solver, seq, nfe)``: ``seq`` is the seq
        bucket under seq bucketing, else the exact ``seq_len``; ``nfe`` the
        NFE bucket under NFE bucketing, else the exact ``nfe``."""
        solver = self.resolve_solver(req)
        seq = (
            self.bucket_seq(req.seq_len) if self.seq_masked(solver)
            else req.seq_len
        )
        nfe = self.bucket_nfe(req.nfe) if self.nfe_masked(solver) else req.nfe
        return (solver, seq, nfe)

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
        if self.max_nfe is not None and req.nfe > self.max_nfe:
            raise ValueError(
                f"nfe {req.nfe} exceeds the engine's max_nfe {self.max_nfe}"
            )
        if self.nfe_buckets and req.nfe > self.nfe_buckets[-1]:
            # the ladder is the serving contract: an over-budget request
            # would need a bucket graph of its own
            raise ValueError(
                f"nfe {req.nfe} exceeds the largest nfe bucket "
                f"{self.nfe_buckets[-1]}; extend nfe_buckets or submit "
                f"requests within the ladder"
            )
        if self.seq_buckets and req.seq_len > self.seq_buckets[-1]:
            raise ValueError(
                f"seq_len {req.seq_len} exceeds the largest seq bucket "
                f"{self.seq_buckets[-1]}; extend seq_buckets or submit "
                f"requests within the ladder"
            )
        if (
            not self.seq_buckets
            and self.max_seq_len is not None
            and req.seq_len > self.max_seq_len
        ):
            # no ladder bounds the graph cache here, so cap the axis
            raise ValueError(
                f"seq_len {req.seq_len} exceeds the engine's max_seq_len "
                f"{self.max_seq_len}"
            )
        if not isinstance(req.seed, int) or isinstance(req.seed, bool):
            raise ValueError(f"seed must be an int, got {req.seed!r}")
        if not SEED_MIN <= req.seed <= SEED_MAX:
            raise ValueError(
                f"seed must fit in a signed 64-bit integer "
                f"({SEED_MIN} <= seed <= {SEED_MAX}), got {req.seed}"
            )
        if not isinstance(req.priority, int) or isinstance(req.priority, bool):
            raise ValueError(f"priority must be an int, got {req.priority!r}")
        if req.deadline_ms is not None and not (
            isinstance(req.deadline_ms, (int, float))
            and not isinstance(req.deadline_ms, bool)
            and math.isfinite(req.deadline_ms)
            and req.deadline_ms > 0
        ):
            raise ValueError(
                f"deadline_ms must be a positive finite number of "
                f"milliseconds (or None), got {req.deadline_ms!r}"
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
        """Smallest batch bucket >= n (an oversize chunk runs exact-size,
        rounded up to a multiple of dp on a mesh)."""
        for b in self.batch_buckets or ():
            if n <= b:
                return b
        return round_to_dp(n, self.mesh)

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
        to_host: bool = False,
    ) -> None:
        """Run one same-group chunk as a single fused batch; fill
        ``results`` by ticket.  ``seq_len`` / ``nfe`` are the group's (a
        bucket under bucketing).  Blocks until the batch is finished.
        ``to_host`` copies the results to the CPU before the lock is let
        go (see the module's note on threads and captures)."""
        with self._lock:
            self._run_chunk_locked(seq_len, nfe, chunk, results, pad, to_host)

    def _on_card(self) -> bool:
        """True when chunks replay bucket graphs; an engine placed on the
        card raises here when no card is present."""
        return resolve_device(self.device).type == "cuda"

    def _step_times_host(self, solver: str, nfe: int) -> Tensor:
        """The exact grid a run of budget ``nfe`` steps through, computed
        once per (solver, nfe) on the host."""
        key = (solver, nfe)
        ts = self._row_times.get(key)
        if ts is None:
            ts = self._row_times[key] = self.program_for(solver).step_times(
                self.schedule, nfe, self.config_for(solver)
            )
        return ts

    def _grid(self, solver: str, nfe: int, device=None) -> Tensor:
        """The same grid on the device (the engine's, or ``device``), copied
        there once: the loop (and a captured graph) reads it without a
        host-to-device copy."""
        device = self.device if device is None else device
        key = (solver, nfe, str(device))
        ts = self._grids.get(key)
        if ts is None:
            ts = self._grids[key] = self._step_times_host(solver, nfe).to(
                device
            )
        return ts

    def _step_mask(
        self, solver: str, cfg: SolverConfig, chunk: list[QueueItem],
        pad_rows: int,
    ) -> StepMask:
        """Per-row step counts and exact grids for a chunk whose group runs
        ``cfg.nfe``'s steps: each request row its own grid, terminal-padded;
        batch pad rows the bucket's grid, fully active."""
        program = self.program_for(solver)
        cap = program.steps_for_nfe(cfg.nfe, cfg)
        acts: list[int] = []
        rows_ts: list[Tensor] = []
        padded_rows = 0
        for _, req, _ in chunk:
            n_r = program.steps_for_nfe(req.nfe, cfg)
            ts_r = self._step_times_host(solver, req.nfe)
            if n_r < cap:
                ts_r = torch.cat([ts_r, ts_r[-1:].expand(cap - n_r)])
                padded_rows += req.batch
            acts += [n_r] * req.batch
            rows_ts += [ts_r] * req.batch
        acts += [cap] * pad_rows
        rows_ts += [self._step_times_host(solver, cfg.nfe)] * pad_rows
        if padded_rows:
            self._m_nfe_pad_rows.inc(padded_rows, solver=solver)
        return StepMask(
            active_steps=torch.tensor(acts, dtype=torch.int32).to(self.device),
            ts=torch.stack(rows_ts).to(self.device),
        )

    def _run_chunk_locked(self, seq_len, nfe, chunk, results, pad, to_host):
        on_card = self._on_card()
        d = self.dlm.config.d_model
        solver = self.resolve_solver(chunk[0][1])
        program = self.program_for(solver)
        masked = self.seq_masked(solver)
        stepped = self.nfe_masked(solver)
        total = sum(req.batch for _, req, _ in chunk)
        padded = self.bucket_batch(total) if pad else total
        # each request's noise at its exact shape, right-padded with zeros
        # to the chunk's seq; pad rows are zeros of full length
        parts, row_lengths = [], []
        for _, req, _ in chunk:
            parts.append(F.pad(self.noise(req), (0, 0, 0, seq_len - req.seq_len)))
            row_lengths += [req.seq_len] * req.batch
        if padded > total:
            parts.append(torch.zeros(
                (padded - total, seq_len, d), dtype=torch.float32,
                device=self.device,
            ))
            row_lengths += [seq_len] * (padded - total)
        x_init = torch.cat(parts, dim=0)
        lengths = (
            torch.tensor(row_lengths, dtype=torch.int32).to(self.device)
            if masked else None
        )
        cfg = dataclasses.replace(self.config_for(solver), nfe=nfe)
        steps = (
            self._step_mask(solver, cfg, chunk, padded - total)
            if stepped else None
        )
        key = (solver, cfg, padded, seq_len, masked, stepped)
        t0, x0, aux = self._run_blocks(key, x_init, lengths, steps, on_card)
        wall = time.perf_counter() - t0
        if to_host:
            x0 = x0[:total].cpu()  # the requests' rows, not the pad rows
            aux = {k: v.cpu() if isinstance(v, Tensor) else v
                   for k, v in aux.items()}
        self._m_batches.inc()
        self._m_rows.inc(total)
        self._m_occupancy.observe(total / padded, solver=solver)
        self._m_wall.observe(wall, solver=solver)

        done = time.perf_counter()
        padded_steps = program.steps_for_nfe(nfe, cfg) if stepped else None
        off = 0
        for ticket, req, t_submit in chunk:
            cut = masked and req.seq_len < seq_len
            results[ticket] = SampleResult(
                x0=x0[off : off + req.batch, : req.seq_len],
                aux=program.scope_aux(
                    aux, off, req.batch,
                    seq_len=req.seq_len if cut else None,
                    n_steps=(
                        program.steps_for_nfe(req.nfe, cfg) if stepped else None
                    ),
                    padded_steps=padded_steps,
                ),
                latency_s=done - t_submit,
                batch_wall_s=wall,
                padded_batch=padded,
                padded_seq_len=seq_len,
                padded_nfe=nfe,
            )
            off += req.batch

    # ---- row blocks -----------------------------------------------------
    def _blocks(self, key: BucketKey) -> list[tuple[int | None, slice, BucketKey]]:
        """(mesh device index, rows, block key) of each block a bucket runs
        as: on a mesh, dp contiguous row blocks of a fusable batch that dp
        divides; otherwise one block, index None, the whole batch on the
        engine's device (the mesh's first)."""
        solver, cfg, padded, seq, masked, stepped = key
        if (self.dp == 1 or padded % self.dp
                or not self.program_for(solver).fusable(cfg)):
            return [(None, slice(0, padded), key)]
        n = padded // self.dp
        return [(i, slice(i * n, (i + 1) * n),
                 (solver, cfg, n, seq, masked, stepped)) for i in range(self.dp)]

    def _block_models(self, blocks) -> list[DiffusionLM]:
        """The denoiser each block runs: the engine's own for one block,
        each mesh device's copy of it for a split."""
        if len(blocks) == 1:
            return [self.dlm]
        replicas = self._replicate(self.dlm)
        return [replicas[i] for i, _, _ in blocks]

    def _block_device(self, index: int | None) -> torch.device:
        return self.device if index is None else self.mesh.devices[index]

    def _run_blocks(self, key, x_init, lengths, steps, on_card):
        """Run a chunk's blocks on their devices (graph replays on the
        card: each device's replay is queued before any is waited for) and
        gather the results in row order on the engine's device; one block
        runs on the chunk's own tensors.  Returns (start time, x0, aux); the
        start follows any capture."""
        blocks = self._blocks(key)
        models = self._block_models(blocks)
        graphs = [self._graph_for(bkey, i, dlm) if on_card else None
                  for (i, _, bkey), dlm in zip(blocks, models)]
        t0 = time.perf_counter()
        outs = []
        for (i, rows, bkey), dlm, graph in zip(blocks, models, graphs):
            xb, lb, sb = x_init, lengths, steps
            if len(blocks) > 1:
                dev = self._block_device(i)
                xb = x_init[rows].to(dev)
                lb = None if lengths is None else lengths[rows].to(dev)
                sb = None if steps is None else StepMask(
                    steps.active_steps[rows].to(dev), steps.ts[rows].to(dev))
            if graph is not None:
                outs.append(self._replay(graph, xb, lb, sb))
            else:
                out = self._run_program(bkey, xb, lb, sb, dlm)
                outs.append((out.x0, out.aux))
        if on_card:
            for i, _, _ in blocks:
                torch.cuda.synchronize(self._block_device(i))
        if len(outs) == 1:
            return (t0, *outs[0])
        x0 = torch.cat([o[0].to(self.device) for o in outs])
        aux = self.program_for(key[0]).merge_aux([
            {k: v.to(self.device) if isinstance(v, Tensor) else v
             for k, v in o[1].items()} for o in outs])
        return t0, x0, aux

    def _run_program(
        self, key: BucketKey, x_init: Tensor, lengths: Tensor | None,
        steps: StepMask | None, dlm: DiffusionLM | None = None,
    ) -> SolverOutput:
        """One sampling run of a bucket's program, eagerly: fresh buffers,
        then the loop on the bucket's grid (or the rows' own grids), with
        ``dlm`` (default: the engine's denoiser; or a mesh device's copy) on
        ``x_init``'s device."""
        solver, cfg, _, _, _, stepped = key
        program = self.program_for(solver)
        dlm = self.dlm if dlm is None else dlm
        return program.sample_scan(
            dlm.eps_fn(lengths=lengths),
            x_init,
            program.alloc_buffers(x_init, cfg),
            self.schedule,
            cfg,
            lengths=lengths,
            steps=steps,
            ts=None if stepped else self._grid(solver, cfg.nfe, x_init.device),
        )

    # ---- bucket graphs ---------------------------------------------------
    def _graph_for(self, key: BucketKey, replica: int | None,
                   dlm: DiffusionLM) -> BucketGraph:
        """Block ``key``'s captured graph on the engine's device (``replica``
        None) or on mesh device ``replica``, reading the weights of ``dlm``,
        captured now if this is its first chunk or the device's copy of the
        weights was rebuilt.  Callers hold the executor lock."""
        graph = self._graphs.get(key if replica is None else (replica, key))
        if graph is None or graph.dlm is not dlm:
            return self._capture(key, replica, dlm)
        self._m_compile_hits.inc(solver=key[0])
        self._m_compile_programs.inc(solver=key[0], source="memory")
        self._compile_counts["memory"] += 1
        return graph

    def _capture(self, key: BucketKey, replica: int | None,
                 dlm: DiffusionLM) -> BucketGraph:
        """Capture one whole sampling run of the bucket as a CUDA graph, on
        a side stream, after one eager run of the same program there.  The
        buffers are allocated inside the capture, so each replay starts
        from fresh zeros.  The graph is block ``key``'s on the engine's
        device (``replica`` None) or on mesh device ``replica``, with the
        weights of ``dlm``.  Callers hold the executor lock."""
        solver, cfg, batch, seq, masked, stepped = key
        program = self.program_for(solver)
        dev = self._block_device(replica)
        t0 = time.perf_counter()
        # static inputs, outside the graph pool: each chunk copies into them
        x_init = torch.zeros(
            (batch, seq, self.dlm.config.d_model), dtype=torch.float32,
            device=dev,
        )
        lengths = (
            torch.full((batch,), seq, dtype=torch.int32, device=dev)
            if masked else None
        )
        steps = None
        if stepped:
            grid = self._grid(solver, cfg.nfe, dev)
            steps = StepMask(
                active_steps=torch.full(
                    (batch,), program.steps_for_nfe(cfg.nfe, cfg),
                    dtype=torch.int32, device=dev,
                ),
                ts=grid.expand(batch, -1).contiguous(),
            )
        with torch.cuda.device(dev):
            if str(dev) not in self._streams:
                self._streams[str(dev)] = (torch.cuda.Stream(dev),
                                           torch.cuda.graph_pool_handle())
            side, pool = self._streams[str(dev)]
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._run_program(key, x_init, lengths, steps, dlm)
            before = tuple(f.launches for f in COUNTED_KERNELS)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool, stream=side):
                out = self._run_program(key, x_init, lengths, steps, dlm)
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)
        # the wrappers counted launches the capture only recorded: take
        # them back, and let every replay add them
        launches = []
        for f, b in zip(COUNTED_KERNELS, before):
            launches.append(f.launches - b)
            f.launches = b
        entry = BucketGraph(
            graph=graph, x_init=x_init, lengths=lengths, steps=steps,
            x0=out.x0, aux=out.aux, launches=tuple(launches), dlm=dlm,
        )
        self._graphs[key if replica is None else (replica, key)] = entry
        wall = time.perf_counter() - t0
        self._compile_counts["fresh"] += 1
        self._m_compile_misses.inc(solver=solver, source="fresh")
        self._m_compile_programs.inc(solver=solver, source="fresh")
        self._m_compile_wall.observe(wall, solver=solver, source="fresh")
        return entry

    def _replay(
        self, graph: BucketGraph, x_init: Tensor, lengths: Tensor | None,
        steps: StepMask | None,
    ) -> tuple[Tensor, dict[str, Tensor]]:
        """Copy a chunk's inputs into the graph's static inputs, replay it
        and copy its results out of graph memory."""
        graph.x_init.copy_(x_init)
        if graph.lengths is not None:
            graph.lengths.copy_(lengths)
        if graph.steps is not None:
            graph.steps.active_steps.copy_(steps.active_steps)
            graph.steps.ts.copy_(steps.ts)
        graph.graph.replay()
        for f, n in zip(COUNTED_KERNELS, graph.launches):
            f.launches += n
        return graph.x0.clone(), {k: v.clone() for k, v in graph.aux.items()}

    # ---- ahead-of-time warmup --------------------------------------------
    def warmup(
        self,
        *,
        solvers: tuple[str, ...] | None = None,
        seq_lens: tuple[int, ...] | None = None,
        nfes: tuple[int, ...] | None = None,
        progress=None,
    ) -> dict[str, Any]:
        """Capture the bucket grid ahead of traffic, into the same graph
        cache chunks read, so the first request of any warmed bucket
        replays instead of capturing.  On the CPU nothing is captured: the
        grid is validated and reported.

        Grid, per solver in ``solvers`` (default: the engine's default):
        the nfe ladder when the solver nfe-buckets (explicit ``nfes`` folded
        onto their buckets), else ``nfes`` (default: the config's nfe); the
        seq ladder when it seq-buckets, else ``seq_lens`` (default: the
        ladder's values as exact lengths; neither raises); the batch
        ladder for fusable configs, else batch 1.  Every grid point is
        validated through the program's request policy first, so an
        unserveable grid fails before anything is captured.

        ``progress`` (optional ``fn(done, total)``) and the
        ``sampler_warmup_*`` instruments report progress.  Returns the grid
        size, captures (``fresh``) and already-captured points
        (``memory``), the wall seconds and the grid itself."""
        on_card = self._on_card()
        solver_list = tuple(solvers) if solvers else (self.solver_name,)
        grid: list[BucketKey] = []
        for solver in solver_list:
            program = self.program_for(solver)  # unknown solver raises
            base = self.config_for(solver)
            masked = self.seq_masked(solver)
            stepped = self.nfe_masked(solver)
            seqs = (
                self.seq_buckets if masked
                else (tuple(seq_lens) if seq_lens else self.seq_buckets)
            )
            if not seqs:
                raise ValueError(
                    f"warmup needs seq_lens= when the engine has no seq-bucket "
                    f"ladder (solver {solver!r} groups by exact seq_len)"
                )
            batches = (
                self.batch_buckets
                if self.batch_buckets and program.fusable(base) else (1,)
            )
            if stepped:
                nfe_points = (
                    tuple(sorted({self.bucket_nfe(n) for n in nfes}))
                    if nfes else self.nfe_buckets
                )
            else:
                nfe_points = tuple(nfes) if nfes else (base.nfe,)
            for nfe in nfe_points:
                cfg = dataclasses.replace(base, nfe=nfe)
                for seq in seqs:
                    for b in batches:
                        program.validate(
                            SampleRequest(batch=b, seq_len=seq, nfe=nfe,
                                          solver=solver),
                            cfg,
                        )
                        point = (solver, cfg, b, seq, masked, stepped)
                        if point not in grid:
                            grid.append(point)

        total = len(grid)
        counts = {"fresh": 0, "memory": 0}
        t0 = time.perf_counter()
        with self._state_lock:
            self._warmup_state = {"state": "running", "total": total, "done": 0}
        self._m_warmup_total.set(total)
        self._m_warmup_done.set(0)
        self._m_warmup_inflight.set(1)
        done = 0
        try:
            for key in grid:
                with self._lock:
                    blocks = self._blocks(key)
                    for (i, _, bkey), dlm in zip(blocks,
                                                 self._block_models(blocks)):
                        graph = self._graphs.get(bkey if i is None else (i, bkey))
                        if graph is not None and graph.dlm is dlm:
                            counts["memory"] += 1
                        elif on_card:
                            self._capture(bkey, i, dlm)
                            counts["fresh"] += 1
                            self._m_warmup_programs.inc(solver=key[0])
                done += 1
                with self._state_lock:
                    self._warmup_state["done"] = done
                self._m_warmup_done.set(done)
                if progress is not None:
                    progress(done, total)
            wall = time.perf_counter() - t0
            with self._state_lock:
                self._warmup_state = {
                    "state": "done", "total": total, "done": done,
                    K.WALL_S: wall, **counts,
                }
            self._m_warmup_wall.set(wall)
        except BaseException as e:
            with self._state_lock:
                self._warmup_state = {
                    "state": "failed", "total": total, "done": done,
                    "error": f"{type(e).__name__}: {e}",
                }
            raise
        finally:
            self._m_warmup_inflight.set(0)
        return {
            "programs": total,
            K.WALL_S: wall,
            "grid": [
                {"solver": s, "batch": b, "seq_len": q, "nfe": c.nfe}
                for s, c, b, q, _, _ in grid
            ],
            **counts,
        }

    def warmup_status(self) -> dict[str, Any]:
        """Warmup progress: ``state`` none|running|done|failed, done/total,
        and the capture counts and wall seconds once done."""
        with self._state_lock:
            return dict(self._warmup_state)

    # ---- introspection (tests / chip_smoke) ------------------------------
    def compile_cache(self) -> dict[Any, BucketGraph]:
        """Bucket key -> captured graph (each captured once, by warmup or
        by its first chunk; empty on the CPU); on a mesh (device index,
        block key) -> graph."""
        with self._lock:
            return dict(self._graphs)

    def compile_stats(self) -> dict[str, int]:
        """Graph acquisitions since boot: ``fresh`` captures and
        ``memory`` replays of a graph captured before."""
        with self._lock:
            return dict(self._compile_counts)
