"""The port's continuous-batching scheduler, against the reference and
inside the port.

* Policy and fake-clock walls of ``tests/test_scheduler.py`` and the queue
  policy of ``tests/test_frontdoor.py`` (priorities, deadlines, admission),
  on the port's CPU oracle engine.
* Launch decisions: the reference's ``AsyncBatchedSampler`` and the port's
  take the same submit sequence (priorities, deadlines, batches, mixed
  solvers, seq and NFE buckets, an admission bound) under the same fake
  clock, with ``run_chunk`` recorded on both executors so nothing samples;
  they launch the same chunks, in the same order, with the same tickets,
  and fail the same requests as expired or rejected.
* End to end against the reference's sync ``BatchedSampler`` on the smoke
  denoiser (its ERA with ``use_fused_update=False``), with the tolerances
  of ``tests/test_torch_serving.py``: ``x0`` atol 2e-3, ERS selections
  equal.
* Arrival determinism inside the port (the port of
  ``tests/test_arrival_determinism.py``): sync drain == scheduler under
  racing, shuffled arrivals == solo, bitwise, for mixed solvers and mixed
  seq_len; for mixed NFE bitwise at the same batch bucket and within 1e-6
  across buckets, as the reference's step-masked contract says.
* Concurrent submits lose and duplicate no ticket; ``stop()`` flushes;
  schedulers are one-shot.

Every wait on a future or a thread has a timeout.
"""

import dataclasses
import random
import threading
import time
import types

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from conftest import AnalyticGaussian
from conftest import OracleDenoiser as JOracleDenoiser
from repro.core import ERAConfig as JERAConfig
from repro.core import linear_schedule as jlinear_schedule
from repro.serving import AsyncBatchedSampler as JAsyncBatchedSampler
from repro.serving import BatchedSampler as JBatchedSampler
from repro.serving import DeadlineExceededError as JDeadlineExceededError
from repro.serving import QueueFullError as JQueueFullError
from repro.serving import SampleRequest as JSampleRequest
from repro.serving import SchedulerPolicy as JSchedulerPolicy
from repro_torch.core import ERAConfig, linear_schedule
from repro_torch.serving import (
    AsyncBatchedSampler,
    BatchedSampler,
    DeadlineExceededError,
    QueueFullError,
    SampleRequest,
    SamplerService,
    SchedulerPolicy,
    open_loop,
    result_keys as K,
)
from test_torch_bucketing import OracleDenoiser
from test_torch_models import build_pair
from test_torch_serving import REQS, reference_noise

D_MODEL = OracleDenoiser.D_MODEL
WAIT_S = 60


def make_engine(buckets=(2, 4, 8), **kw):
    return BatchedSampler(OracleDenoiser(), linear_schedule(),
                          batch_buckets=buckets, **kw)


def req(seed, seq_len=6, nfe=8, batch=1, **kw):
    return SampleRequest(batch=batch, seq_len=seq_len, nfe=nfe, seed=seed, **kw)


class FakeClock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


def manual(policy=None, **engine_kw):
    """An unstarted scheduler on a fake clock: ``drain_once(now=...)`` is
    the only pump."""
    clock = FakeClock()
    sched = AsyncBatchedSampler(
        make_engine(**engine_kw), policy or SchedulerPolicy(max_wait_ms=10.0),
        clock=clock,
    )
    return sched, clock


# ---------------------------------------------------------------------------
# policy (pure)
# ---------------------------------------------------------------------------


def test_policy_target_rows():
    assert SchedulerPolicy(target_occupancy=1.0).target_rows(8) == 8
    assert SchedulerPolicy(target_occupancy=0.5).target_rows(8) == 4
    assert SchedulerPolicy(target_occupancy=0.01).target_rows(8) == 1
    assert SchedulerPolicy().target_rows(None) is None


def test_policy_should_launch():
    p = SchedulerPolicy(max_wait_ms=10.0, target_occupancy=1.0)
    assert not p.should_launch(now=1.0, oldest_t=1.0, rows=3, max_bucket=8)
    assert p.should_launch(now=1.0, oldest_t=1.0, rows=8, max_bucket=8)
    assert p.should_launch(now=1.0101, oldest_t=1.0, rows=1, max_bucket=8)
    assert not p.should_launch(now=1.0, oldest_t=1.0, rows=100, max_bucket=None)
    assert p.should_launch(now=1.011, oldest_t=1.0, rows=1, max_bucket=None)
    assert p.retry_after_s() == 1.0
    assert SchedulerPolicy(max_wait_ms=2500.0).retry_after_s() == 2.5


def test_open_loop_emits_on_schedule_and_catches_up():
    clock = FakeClock()
    slept, emitted = [], []

    def sleep(s):
        slept.append(s)
        clock.now += s

    def emit(i):
        emitted.append((i, clock.now))
        clock.now += 0.5 if i == 1 else 0.0  # the second emit runs late

    t0 = open_loop([0.1, 0.2, 0.1, 0.3], emit, clock=clock, sleep=sleep)
    assert t0 == 100.0
    assert [i for i, _ in emitted] == [0, 1, 2, 3]
    assert emitted[0][1] == pytest.approx(100.1)
    assert emitted[1][1] == pytest.approx(100.3)
    # behind schedule: sleep(0) and emit at once, then back on schedule
    assert slept[2] == 0.0 and emitted[2][1] == pytest.approx(100.8)
    assert emitted[3][1] == pytest.approx(100.8)


# ---------------------------------------------------------------------------
# scheduling decisions under a fake clock (no thread)
# ---------------------------------------------------------------------------


def test_deadline_launch_under_fake_clock():
    sched, clock = manual(SchedulerPolicy(max_wait_ms=50.0))
    fut = sched.submit(req(seed=1))
    assert sched.drain_once(now=clock.now + 0.049) == 0
    assert not fut.done()
    assert sched.drain_once(now=clock.now + 0.051) == 1
    res = fut.result(timeout=0)
    assert res.x0.shape == (1, 6, D_MODEL) and res.x0.device.type == "cpu"


def test_occupancy_launch_under_fake_clock():
    sched, clock = manual(SchedulerPolicy(max_wait_ms=1e6, target_occupancy=0.5))
    futs = [sched.submit(req(seed=s)) for s in range(3)]
    assert sched.drain_once(now=clock.now) == 0  # 3 rows < target 4
    futs.append(sched.submit(req(seed=3)))
    assert sched.drain_once(now=clock.now) == 1
    assert all(f.done() for f in futs)
    assert futs[0].result(timeout=0).padded_batch == 4


def _record(engine, order, fail_seq=None):
    """Wrap the executor's run_chunk: record each call, optionally fail
    chunks of one seq length."""
    orig = engine.executor.run_chunk

    def recording(seq_len, nfe, chunk, results, pad=True, to_host=False):
        order.append((seq_len, nfe, [t for t, _, _ in chunk], to_host))
        if seq_len == fail_seq:
            raise RuntimeError("injected kernel failure")
        return orig(seq_len, nfe, chunk, results, pad=pad, to_host=to_host)

    engine.executor.run_chunk = recording


def test_oldest_queue_served_first_and_results_go_to_the_host():
    sched, clock = manual()
    order = []
    _record(sched.engine, order)
    sched.submit(req(seed=0, seq_len=4))
    clock.now += 0.002
    sched.submit(req(seed=1, seq_len=6))
    clock.now += 0.002
    sched.submit(req(seed=2, seq_len=8))
    assert sched.drain_once(now=clock.now + 0.02) == 3
    assert order == [(4, 8, [0], True), (6, 8, [1], True), (8, 8, [2], True)]


def test_launch_takes_at_most_one_max_bucket():
    sched, clock = manual(
        SchedulerPolicy(max_wait_ms=10.0, target_occupancy=1e9), buckets=(4,)
    )
    futs = [sched.submit(req(seed=s)) for s in range(6)]
    assert sched.drain_once(now=clock.now + 0.02) == 1  # 4 of 6 rows
    assert sum(f.done() for f in futs) == 4
    assert sched.pending == 2
    assert sched.drain_once(now=clock.now + 0.04) == 1
    assert all(f.done() for f in futs)
    assert futs[0].result(timeout=0).padded_batch == 4


def test_chunk_failure_is_isolated_and_not_run_again():
    """A failed launch fails only its own chunk's futures, and the chunk is
    not run a second time on another path."""
    sched, clock = manual()
    order = []
    _record(sched.engine, order, fail_seq=4)
    bad = sched.submit(req(seed=0, seq_len=4))
    good = sched.submit(req(seed=1, seq_len=6))
    assert sched.drain_once(now=clock.now + 0.02) == 2
    with pytest.raises(RuntimeError, match="injected"):
        bad.result(timeout=0)
    assert bool(torch.isfinite(good.result(timeout=0).x0).all())
    assert [o[0] for o in order] == [4, 6]
    assert sched.stats()[K.BATCHES] == 1


def test_priority_boards_first():
    sched, clock = manual(buckets=(1, 2))
    futs = [
        sched.submit(req(seed=0, priority=0)),
        sched.submit(req(seed=1, priority=0)),
        sched.submit(req(seed=2, priority=5)),
    ]
    clock.now += 1.0
    assert sched.drain_once(now=clock.now) == 1
    assert sched.drain_once(now=clock.now) == 1
    assert [f.result(timeout=5).padded_batch for f in futs] == [2, 1, 2]


def test_priority_orders_ready_queues():
    sched, clock = manual(buckets=(1, 2))
    order = []
    lo = sched.submit(req(seed=0, nfe=6, priority=0))
    hi = sched.submit(req(seed=1, nfe=7, priority=3))  # another fuse group
    lo.add_done_callback(lambda f: order.append("lo"))
    hi.add_done_callback(lambda f: order.append("hi"))
    clock.now += 1.0
    sched.drain_once(now=clock.now)
    assert order == ["hi", "lo"]


def test_deadline_expired_fails_fast():
    sched, clock = manual()
    doomed = sched.submit(req(seed=0, deadline_ms=50.0))
    healthy = sched.submit(req(seed=1))
    clock.now += 0.2
    sched.drain_once(now=clock.now)
    with pytest.raises(DeadlineExceededError, match="expired in queue"):
        doomed.result(timeout=5)
    assert healthy.result(timeout=5).x0.shape == (1, 6, D_MODEL)
    assert sched.engine.metrics.get("sampler_deadline_expired_total").value() == 1


def test_deadline_not_expired_is_untouched():
    sched, clock = manual()
    fut = sched.submit(req(seed=0, deadline_ms=500.0))
    clock.now += 0.1
    sched.drain_once(now=clock.now)
    assert fut.result(timeout=5).x0.shape == (1, 6, D_MODEL)


@pytest.mark.parametrize("field,bad", [
    ("deadline_ms", 0.0), ("deadline_ms", -5.0), ("deadline_ms", float("inf")),
    ("deadline_ms", float("nan")), ("deadline_ms", "soon"),
    ("deadline_ms", True), ("priority", 1.5), ("priority", "high"),
    ("priority", True),
])
def test_priority_and_deadline_validated_at_submit(field, bad):
    engine = make_engine()
    sched = AsyncBatchedSampler(engine)
    with pytest.raises(ValueError, match=field):
        sched.submit(req(seed=0, **{field: bad}))
    with pytest.raises(ValueError, match=field):
        engine.submit_with_future(req(seed=0, **{field: bad}))
    assert sched.pending == 0 and engine.pending == 0


def test_sync_drain_ignores_priority_and_deadline():
    """Neither hint reaches the graph key, the noise or the result: the
    sync drain serves an expired-looking request as any other."""
    engine = make_engine()
    _, plain = engine.submit_with_future(req(seed=4))
    _, hinted = engine.submit_with_future(req(seed=4, priority=9,
                                              deadline_ms=1e-3))
    time.sleep(0.01)
    engine.drain()
    a, b = plain.result(timeout=0), hinted.result(timeout=0)
    assert torch.equal(a.x0, b.x0)
    assert engine.executor.group_key(req(seed=4)) == engine.executor.group_key(
        req(seed=4, priority=9, deadline_ms=1e-3))


def test_admission_bound_rejects_then_recovers():
    sched, clock = manual(SchedulerPolicy(max_wait_ms=10.0, max_queue_rows=2))
    admitted = [sched.submit(req(seed=s)) for s in range(2)]
    with pytest.raises(QueueFullError) as ei:
        sched.submit(req(seed=9))
    assert ei.value.rows == 2 and ei.value.limit == 2
    assert ei.value.retry_after_s >= 1.0
    clock.now += 1.0
    sched.drain_once(now=clock.now)
    for f in admitted:
        assert f.result(timeout=5).x0.shape == (1, 6, D_MODEL)
    fut = sched.submit(req(seed=10))
    clock.now += 1.0
    sched.drain_once(now=clock.now)
    assert fut.result(timeout=5).x0.shape == (1, 6, D_MODEL)
    m = sched.engine.metrics.get("sampler_admission_rejects_total")
    assert m.value(solver="era", seq=6, nfe=8) == 1.0


# ---------------------------------------------------------------------------
# the same launch decisions as the reference, under the same fake clock
# ---------------------------------------------------------------------------

# (clock advance in s before the event, event): ("submit", request fields)
# or ("drain", None).  Mixed solvers, priorities, deadlines, batches, seq
# lengths across seq buckets (4, 8) and budgets across nfe buckets (8, 12).
EVENTS = [
    (0.000, ("submit", dict(batch=1, seq_len=3, nfe=6, seed=1))),
    (0.001, ("submit", dict(batch=2, seq_len=8, nfe=8, seed=2, priority=1))),
    (0.001, ("submit", dict(batch=1, seq_len=4, nfe=12, seed=3,
                            solver="ddim"))),
    (0.001, ("submit", dict(batch=3, seq_len=7, nfe=5, seed=4,
                            deadline_ms=4.0))),
    (0.002, ("drain", None)),
    (0.001, ("submit", dict(batch=1, seq_len=2, nfe=10, seed=5,
                            solver="dpm_solver_pp2m", priority=3))),
    (0.001, ("submit", dict(batch=2, seq_len=4, nfe=7, seed=6))),
    (0.001, ("submit", dict(batch=4, seq_len=6, nfe=11, seed=7, priority=2))),
    (0.003, ("drain", None)),
    (0.002, ("submit", dict(batch=1, seq_len=5, nfe=8, seed=8,
                            deadline_ms=1.0))),
    (0.001, ("submit", dict(batch=2, seq_len=8, nfe=9, seed=9,
                            solver="era"))),
    (0.001, ("submit", dict(batch=2, seq_len=8, nfe=9, seed=10))),
    (0.001, ("submit", dict(batch=3, seq_len=1, nfe=12, seed=11,
                            solver="ddim", priority=-1))),
    (0.001, ("submit", dict(batch=1, seq_len=3, nfe=4, seed=12,
                            solver="ddim"))),
    (0.008, ("drain", None)),
    (0.001, ("submit", dict(batch=1, seq_len=8, nfe=12, seed=13,
                            solver="dpm_solver_pp2m"))),
    (0.001, ("submit", dict(batch=1, seq_len=4, nfe=6, seed=14, priority=4,
                            deadline_ms=50.0))),
    (0.020, ("drain", None)),
    (0.020, ("drain", None)),
    (0.020, ("flush", None)),
]


def _drive(sched, clock, new_req, fail_types):
    """Play EVENTS into one scheduler; return the admission log and the
    futures' outcomes by submit index."""
    log, futs = [], {}
    for i, (dt, (what, fields)) in enumerate(EVENTS):
        clock.now += dt
        if what == "submit":
            try:
                futs[i] = sched.submit(new_req(**fields))
                log.append((i, "admitted"))
            except fail_types[0] as e:
                log.append((i, "rejected", e.rows, e.limit, e.retry_after_s))
        elif what == "drain":
            log.append((i, "drained", sched.drain_once(now=clock.now)))
        else:
            sched.stop()
            log.append((i, "flushed"))
    outcomes = {}
    for i, fut in futs.items():
        e = fut.exception(timeout=5)
        outcomes[i] = (
            ("expired", round(e.waited_ms, 6)) if isinstance(e, fail_types[1])
            else ("served",)
        )
    return log, outcomes, sched.stats()


def test_launch_decisions_match_reference():
    policy = dict(max_wait_ms=5.0, target_occupancy=0.75, max_queue_rows=6)
    buckets = dict(batch_buckets=(1, 4, 8), seq_buckets=(4, 8),
                   nfe_buckets=(8, 12))
    jclock, tclock = FakeClock(), FakeClock()
    jeng = JBatchedSampler(JOracleDenoiser(AnalyticGaussian()),
                           jlinear_schedule(), **buckets)
    teng = BatchedSampler(OracleDenoiser(), linear_schedule(), **buckets)
    jruns, truns = [], []

    def jrun(params, seq_len, nfe, chunk, results, pad=True):
        jruns.append((seq_len, nfe, pad, [
            (t, dataclasses.asdict(r), ts) for t, r, ts in chunk]))
        for t, _, _ in chunk:
            results[t] = types.SimpleNamespace(latency_s=0.0)

    def trun(seq_len, nfe, chunk, results, pad=True, to_host=False):
        assert to_host
        truns.append((seq_len, nfe, pad, [
            (t, dataclasses.asdict(r), ts) for t, r, ts in chunk]))
        for t, _, _ in chunk:
            results[t] = types.SimpleNamespace(latency_s=0.0)

    jeng.executor.run_chunk = jrun
    teng.executor.run_chunk = trun
    jsched = JAsyncBatchedSampler(jeng, None, JSchedulerPolicy(**policy),
                                  clock=jclock)
    tsched = AsyncBatchedSampler(teng, SchedulerPolicy(**policy), clock=tclock)
    want = _drive(jsched, jclock, JSampleRequest,
                  (JQueueFullError, JDeadlineExceededError))
    got = _drive(tsched, tclock, SampleRequest,
                 (QueueFullError, DeadlineExceededError))
    assert truns == jruns
    assert got == want
    # the sequence exercises what it claims to
    log, outcomes, _ = got
    assert any(e[1] == "rejected" for e in log)
    assert ("expired",) == outcomes[3][:1] and ("expired",) == outcomes[9][:1]
    assert len({(s, n) for s, n, _, _ in truns}) >= 4
    assert any(len(c) > 1 for _, _, _, c in truns)
    for name in ("sampler_queue_depth_rows", "sampler_admission_rejects_total",
                 "sampler_deadline_expired_total",
                 "sampler_requests_submitted_total"):
        assert (teng.metrics.get(name).render()
                == jeng.metrics.get(name).render()), name


# ---------------------------------------------------------------------------
# end to end against the reference on the smoke denoiser
# ---------------------------------------------------------------------------


def test_scheduler_matches_reference_batched_sampler():
    jdlm, params, tdlm = build_pair("qwen2-1.5b", "naive", "auto", seed=3,
                                    head_scale=0.05)
    jeng = JBatchedSampler(
        jdlm, jlinear_schedule(),
        solver_config=JERAConfig(per_sample=True, use_fused_update=False),
    )
    jf = [jeng.submit_with_future(JSampleRequest(**r))[1] for r in REQS]
    jeng.drain(params)
    clock = FakeClock()
    sched = AsyncBatchedSampler(
        BatchedSampler(tdlm, linear_schedule(),
                       noise_fn=reference_noise(tdlm.config.d_model)),
        SchedulerPolicy(max_wait_ms=10.0), clock=clock,
    )
    tf = [sched.submit(SampleRequest(**r)) for r in REQS]
    # one pass past every deadline: the sync drain's chunks, fused alike
    assert sched.drain_once(now=clock.now + 1.0) == 2
    for r, j, t in zip(REQS, jf, tf):
        j, t = j.result(timeout=0), t.result(timeout=0)
        assert t.x0.device.type == "cpu"
        assert t.x0.shape == (r["batch"], r["seq_len"], 128)
        np.testing.assert_allclose(t.x0.numpy(), np.asarray(j.x0), atol=2e-3)
        np.testing.assert_array_equal(
            t.aux[K.ERS_SELECTION_HISTORY].numpy(),
            np.asarray(j.aux[K.ERS_SELECTION_HISTORY]),
        )
        assert (t.padded_batch, t.padded_seq_len, t.padded_nfe) == (
            j.padded_batch, j.padded_seq_len, j.padded_nfe
        )


# ---------------------------------------------------------------------------
# arrival determinism inside the port
# ---------------------------------------------------------------------------

MIXED_SOLVERS = (None, "ddim", "dpm_solver_pp2m", "era")


def _engine(seq_buckets=None, nfe_buckets=None):
    return make_engine(seq_buckets=seq_buckets, nfe_buckets=nfe_buckets)


def _sync_results(reqs, **kw):
    engine = _engine(**kw)
    tickets = [engine.submit(r) for r in reqs]
    results = engine.drain()
    return [results[t] for t in tickets]


def _async_results(reqs, delay_seed, **kw):
    """The scheduler with two racing client threads and random delays:
    arbitrary arrival interleavings and batch compositions."""
    engine = _engine(**kw)
    rng = random.Random(delay_seed)
    futures, lock = {}, threading.Lock()
    with AsyncBatchedSampler(
        engine, SchedulerPolicy(max_wait_ms=2.0, target_occupancy=0.5)
    ) as sched:

        def client(my_reqs):
            for i, r in my_reqs:
                time.sleep(rng.uniform(0.0, 0.004))
                fut = sched.submit(r)
                with lock:
                    futures[i] = fut

        indexed = list(enumerate(reqs))
        rng.shuffle(indexed)
        threads = [threading.Thread(target=client, args=(indexed[k::2],))
                   for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
        assert not any(t.is_alive() for t in threads)
        out = {i: f.result(timeout=WAIT_S) for i, f in futures.items()}
    return [out[i] for i in range(len(reqs))]


def _solo_x0(reqs):
    svc = SamplerService(OracleDenoiser(), linear_schedule(),
                         solver_config=ERAConfig(per_sample=True))
    return [svc.sample(r).x0 for r in reqs]


def _assert_bitwise(asyn, sync, solo, label):
    for i, (a, s, o) in enumerate(zip(asyn, sync, solo)):
        assert torch.equal(a.x0, s.x0), f"{label}: async vs sync, request {i}"
        assert torch.equal(a.x0, o), f"{label}: async vs solo, request {i}"


@settings(max_examples=3, deadline=None)
@given(
    st.integers(min_value=3, max_value=6),       # co-arriving requests
    st.integers(min_value=2, max_value=8),       # seq_len
    st.integers(min_value=0, max_value=4),       # nfe headroom above k=4
    st.integers(min_value=0, max_value=10_000),  # request seed base
    st.integers(min_value=0, max_value=10_000),  # arrival-delay seed
)
def test_x0_bit_identical_for_mixed_solver_streams(n, seq_len, extra, seed0,
                                                   delay_seed):
    reqs = [SampleRequest(batch=1, seq_len=seq_len, nfe=5 + extra,
                          solver=MIXED_SOLVERS[i % len(MIXED_SOLVERS)],
                          seed=seed0 + i) for i in range(n)]
    _assert_bitwise(_async_results(reqs, delay_seed), _sync_results(reqs),
                    _solo_x0(reqs), f"mixed solvers n={n} seq={seq_len}")


@settings(max_examples=3, deadline=None)
@given(
    st.integers(min_value=3, max_value=6),
    st.integers(min_value=1, max_value=8),       # first request's seq_len
    st.integers(min_value=0, max_value=4),
    st.integers(min_value=0, max_value=10_000),
    st.integers(min_value=0, max_value=10_000),
)
def test_x0_bit_identical_for_mixed_seq_len_streams(n, seq0, extra, seed0,
                                                    delay_seed):
    buckets = (4, 8)
    reqs = [SampleRequest(batch=1, seq_len=(seq0 + 3 * i) % 8 + 1,
                          nfe=5 + extra, seed=seed0 + i) for i in range(n)]
    _assert_bitwise(
        _async_results(reqs, delay_seed, seq_buckets=buckets),
        _sync_results(reqs, seq_buckets=buckets), _solo_x0(reqs),
        f"mixed seq_len n={n}")


NFE_BUCKETS = (18, 32)
NFE_STREAM = (10, 18, 25)  # 10 and 18 share the 18 bucket; 25 rides the 32


@settings(max_examples=3, deadline=None)
@given(
    st.integers(min_value=3, max_value=6),
    st.integers(min_value=2, max_value=8),
    st.integers(min_value=0, max_value=10_000),
    st.integers(min_value=0, max_value=10_000),
)
def test_x0_deterministic_for_mixed_nfe_streams(n, seq_len, seed0, delay_seed):
    """Bitwise whenever the scheduler formed the sync drain's batch bucket;
    within 1e-6 when it formed another (a per-row time column's
    transcendentals round by batch shape), as in the reference."""
    reqs = [SampleRequest(batch=1, seq_len=seq_len,
                          nfe=NFE_STREAM[i % len(NFE_STREAM)], seed=seed0 + i)
            for i in range(n)]
    sync = _sync_results(reqs, nfe_buckets=NFE_BUCKETS)
    asyn = _async_results(reqs, delay_seed, nfe_buckets=NFE_BUCKETS)
    solo = _solo_x0(reqs)
    for i, (a, s, o) in enumerate(zip(asyn, sync, solo)):
        assert a.padded_nfe in NFE_BUCKETS and a.padded_nfe == s.padded_nfe
        if a.padded_batch == s.padded_batch:
            assert torch.equal(a.x0, s.x0), f"request {i}"
        else:
            torch.testing.assert_close(a.x0, s.x0, atol=1e-6, rtol=0)
        torch.testing.assert_close(a.x0, o, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# liveness, thread safety and shutdown (real drain thread)
# ---------------------------------------------------------------------------


def test_lone_request_is_not_starved():
    with AsyncBatchedSampler(make_engine(),
                             SchedulerPolicy(max_wait_ms=5.0)) as sched:
        res = sched.submit(req(seed=42)).result(timeout=WAIT_S)
    assert res.x0.shape == (1, 6, D_MODEL)
    assert sched.stats()[K.BATCHES] == 1


def test_concurrent_submit_stress_no_lost_or_duplicate_tickets():
    """More client threads than cores, a short switch interval: every
    future resolves to its own request's rows (bitwise its solo run), and
    the scheduler counts exactly one ticket and one row a submit."""
    import sys

    n_threads, per_thread = 12, 4
    futures, lock = {}, threading.Lock()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with AsyncBatchedSampler(
            make_engine(),
            SchedulerPolicy(max_wait_ms=3.0, target_occupancy=0.5),
        ) as sched:

            def client(tid):
                for i in range(per_thread):
                    seed = 1000 * tid + i
                    fut = sched.submit(req(seed=seed))
                    with lock:
                        futures[seed] = fut
                    time.sleep(0.001 * (tid % 3))

            threads = [threading.Thread(target=client, args=(t,))
                       for t in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=WAIT_S)
            assert not any(t.is_alive() for t in threads)
            results = {s: f.result(timeout=WAIT_S) for s, f in futures.items()}
    finally:
        sys.setswitchinterval(old)
    total = n_threads * per_thread
    assert len(results) == total
    stats = sched.stats()
    assert stats[K.SUBMITTED] == total and stats[K.ROWS] == total
    solo = SamplerService(OracleDenoiser(), linear_schedule(),
                          solver_config=ERAConfig(per_sample=True))
    for seed in (0, 1003, 5002, 11003):
        assert torch.equal(results[seed].x0, solo.sample(req(seed=seed)).x0)


def test_clean_shutdown_flushes_in_flight_work():
    sched = AsyncBatchedSampler(
        make_engine(), SchedulerPolicy(max_wait_ms=60_000.0)
    ).start()
    futs = [sched.submit(req(seed=s)) for s in range(3)]
    sched.stop()
    assert all(f.done() for f in futs)
    for f in futs:
        assert f.result(timeout=0).x0.shape == (1, 6, D_MODEL)
    with pytest.raises(RuntimeError, match="stopped"):
        sched.submit(req(seed=9))


def test_stop_without_start_flushes():
    sched = AsyncBatchedSampler(make_engine())
    fut = sched.submit(req(seed=5))
    sched.stop()
    assert fut.result(timeout=0).x0.shape == (1, 6, D_MODEL)


def test_schedulers_are_one_shot():
    sched = AsyncBatchedSampler(make_engine()).start()
    with pytest.raises(RuntimeError, match="already started"):
        sched.start()
    sched.stop()
    with pytest.raises(RuntimeError, match="one-shot"):
        sched.start()
    sched.stop()  # a second stop is a no-op


def test_cancelled_future_does_not_kill_the_drain_thread():
    with AsyncBatchedSampler(make_engine(),
                             SchedulerPolicy(max_wait_ms=20.0)) as sched:
        gone = sched.submit(req(seed=0))
        assert gone.cancel()
        survivor = sched.submit(req(seed=1))
        assert survivor.result(timeout=WAIT_S).x0.shape == (1, 6, D_MODEL)
        later = sched.submit(req(seed=2))
        assert later.result(timeout=WAIT_S).x0.shape == (1, 6, D_MODEL)


def test_warmup_forwards_to_the_engine_without_params():
    sched = AsyncBatchedSampler(make_engine(buckets=(1, 2)))
    seen = []
    rep = sched.warmup(seq_lens=(6,), nfes=(8,),
                       progress=lambda d, t: seen.append((d, t)))
    assert rep["programs"] == 2 and seen == [(1, 2), (2, 2)]
    assert sched.warmup_status()["state"] == "done"
