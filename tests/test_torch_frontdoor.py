"""The port's HTTP front door, against the reference's wire schema and
client, and inside the port.

* The array codec round-trips bitwise (NaN, inf, -0.0, every dtype the
  results carry), between the port's and the reference's codecs both ways;
  a tensor off the host is refused.
* Schema v1: the reference's ``encode_request`` decodes in the port and
  the port's ``encode_result`` decodes in the reference's
  ``decode_result``; unknown fields, versions and field types are
  rejected.
* The reference's ``FrontDoorClient`` against a port server: 200 with
  ``x0`` bitwise the in-process result, 400, 429 with ``Retry-After``, 504
  and 404, each typed.  (Only the reference's client: a reference server
  returns 500 on the installed JAX.)  The port's own client maps the same
  errors, and 500 for a failed batch.
* The idle keep-alive connection is reclaimed; no 500 is appended after a
  started response; ``/metrics`` and ``/healthz``; ``/readyz`` 503 -> 200
  on a warmup, 503 with the error when the warmup raises, 200 at once
  without one (the port of ``tests/test_coldstart.py``'s readiness walls).

Every server is stopped in ``finally``; every socket, future and thread
wait has a timeout.
"""

import json
import socket
import threading
import time
from http.client import HTTPConnection

import numpy as np
import pytest
import torch

from repro.serving import DeadlineExceededError as JDeadlineExceededError
from repro.serving import FrontDoorClient as JFrontDoorClient
from repro.serving import QueueFullError as JQueueFullError
from repro.serving import SampleRequest as JSampleRequest
from repro.serving.frontdoor import decode_array as jdecode_array
from repro.serving.frontdoor import decode_request as jdecode_request
from repro.serving.frontdoor import decode_result as jdecode_result
from repro.serving.frontdoor import encode_array as jencode_array
from repro.serving.frontdoor import encode_request as jencode_request
from repro_torch.configs import get_config
from repro_torch.core import linear_schedule
from repro_torch.models import DiffusionLM
from repro_torch.serving import (
    SCHEMA_VERSION,
    AsyncBatchedSampler,
    BatchedSampler,
    DeadlineExceededError,
    EngineConfig,
    FrontDoor,
    FrontDoorClient,
    QueueFullError,
    SampleRequest,
    SamplerService,
    SchedulerPolicy,
    SchemaError,
    build_engine,
    decode_request,
    decode_result,
    encode_request,
    encode_result,
    serve_frontdoor,
    result_keys as K,
    warmup_kwargs,
)
from repro_torch.serving.frontdoor import decode_array, encode_array
from test_torch_bucketing import OracleDenoiser

D_MODEL = OracleDenoiser.D_MODEL
WAIT_S = 60
CFG = EngineConfig(nfe=6, k=3, batch_buckets=(1, 2, 4))


def make_engine(dlm=None, **overrides):
    fields = {f: getattr(CFG, f) for f in CFG.__dataclass_fields__}
    return build_engine(dlm or OracleDenoiser(), linear_schedule(),
                        EngineConfig(**{**fields, **overrides}))


def req(seed=0, batch=1, seq_len=6, nfe=6, **kw):
    return SampleRequest(batch=batch, seq_len=seq_len, nfe=nfe, seed=seed, **kw)


def jreq(seed=0, batch=1, seq_len=6, nfe=6, **kw):
    return JSampleRequest(batch=batch, seq_len=seq_len, nfe=nfe, seed=seed, **kw)


def same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


@pytest.fixture(scope="module")
def smoke_dlm():
    cfg = get_config("qwen2-1.5b", smoke=True).with_(num_layers=1)
    return DiffusionLM(cfg, device="cpu", seed=0)


# ---------------------------------------------------------------------------
# wire schema (no server)
# ---------------------------------------------------------------------------

ARRAYS = [
    np.random.default_rng(0).standard_normal((3, 4, 5)).astype(np.float32),
    np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 1e-45], dtype=np.float32),
    np.arange(7, dtype=np.int32),
    np.arange(-3, 3, dtype=np.int64).reshape(2, 3),
    np.random.default_rng(1).standard_normal((2, 2)),  # float64
    np.array(2.5, dtype=np.float32),                    # 0-d
    np.zeros((0, 3), dtype=np.float32),                 # empty
]


@pytest.mark.parametrize("arr", ARRAYS, ids=lambda a: f"{a.dtype}{a.shape}")
def test_array_codec_bitwise_both_ways(arr):
    t = torch.from_numpy(arr.copy())
    if arr.ndim == 0:
        # both codecs go through np.ascontiguousarray, which gives a 0-d
        # array one dimension: the wire carries shape [1]
        arr = arr.reshape(1)
    for enc in (encode_array(arr), encode_array(t)):
        assert enc == jencode_array(arr)  # the same bytes on the wire
        back = decode_array(json.loads(json.dumps(enc)))
        assert isinstance(back, torch.Tensor) and back.device.type == "cpu"
        assert same_bits(back.numpy(), arr)
        assert same_bits(jdecode_array(enc), arr)
    assert same_bits(decode_array(jencode_array(arr)).numpy(), arr)


def test_array_codec_takes_views_and_refuses_device_tensors():
    base = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    view = base[1:3, ::2]  # not contiguous
    assert same_bits(decode_array(encode_array(view)).numpy(), view.numpy())
    with pytest.raises(ValueError, match="host tensors"):
        encode_array(torch.empty(2, device="meta"))
    with pytest.raises(SchemaError, match="encoded array"):
        decode_array([1, 2])


def test_request_round_trip_and_reference_interop():
    r = req(seed=9, batch=3, solver="ddim", priority=2, deadline_ms=125.0)
    wire = json.loads(json.dumps(encode_request(r)))
    assert wire["v"] == SCHEMA_VERSION == 1
    assert decode_request(wire) == r
    j = jreq(seed=9, batch=3, solver="ddim", priority=2, deadline_ms=125.0)
    assert jencode_request(j) == wire
    assert decode_request(jencode_request(j)) == r
    assert jdecode_request(wire) == j


def test_request_schema_errors():
    wire = encode_request(req())
    with pytest.raises(SchemaError, match="prioritty"):
        decode_request({**wire, "prioritty": 7})
    for v in (None, 0, SCHEMA_VERSION + 1, "1"):
        with pytest.raises(SchemaError, match="schema version"):
            decode_request({**wire, "v": v})
    with pytest.raises(SchemaError):
        decode_request([wire])
    for field, bad in (("batch", "2"), ("seed", 1.5), ("priority", True),
                       ("deadline_ms", "soon"), ("solver", 3)):
        with pytest.raises(SchemaError, match=field):
            decode_request({**wire, field: bad})
    with pytest.raises(SchemaError):
        decode_request({k: v for k, v in wire.items() if k != "batch"})


def test_result_round_trip_bitwise_and_reference_decodes_it(smoke_dlm):
    engine = make_engine(smoke_dlm)
    _, fut = engine.submit_with_future(req(seed=3, batch=2))
    engine.drain()
    res = fut.result(timeout=0)
    wire = json.loads(json.dumps(encode_result(res)))
    back = decode_result(wire)
    jback = jdecode_result(wire)
    assert set(back.aux) == set(jback.aux) == set(res.aux) == {
        K.DELTA_EPS_HISTORY, K.DELTA_EPS_HISTORY_PER_SAMPLE,
        K.ERS_SELECTION_HISTORY}
    for got in (back.x0.numpy(), jback.x0):
        assert same_bits(got, res.x0.numpy())
    for k in res.aux:
        assert same_bits(back.aux[k].numpy(), res.aux[k].numpy())
        assert same_bits(jback.aux[k], res.aux[k].numpy())
    # the reference's dtypes on the wire
    assert wire["x0"]["dtype"] == "<f4"
    assert wire["aux"][K.ERS_SELECTION_HISTORY]["dtype"] == "<i4"
    for r in (back, jback):
        assert (r.latency_s, r.batch_wall_s, r.padded_batch, r.padded_seq_len,
                r.padded_nfe) == (res.latency_s, res.batch_wall_s,
                                  res.padded_batch, res.padded_seq_len,
                                  res.padded_nfe)
    with pytest.raises(SchemaError, match="unknown result"):
        decode_result({**wire, "extra": 1})
    with pytest.raises(SchemaError, match="missing result"):
        decode_result({k: v for k, v in wire.items() if k != "x0"})


# ---------------------------------------------------------------------------
# loopback servers
# ---------------------------------------------------------------------------


@pytest.fixture()
def door():
    d = serve_frontdoor(make_engine(), SchedulerPolicy(max_wait_ms=5.0))
    try:
        yield d
    finally:
        d.stop()


def held_door(policy, engine=None):
    """A front door over an unstarted scheduler on a fake clock: its queue
    holds until the test pumps ``drain_once``."""
    clk = [0.0]
    sched = AsyncBatchedSampler(engine or make_engine(), policy,
                                clock=lambda: clk[0])
    return FrontDoor(sched), sched, clk


def wait_pending(sched, n):
    deadline = time.time() + 10
    while sched.pending < n and time.time() < deadline:
        time.sleep(0.005)
    assert sched.pending == n


def call_in_thread(fn):
    out = {}

    def run():
        try:
            out["res"] = fn()
        except Exception as e:  # noqa: BLE001 - asserted on by the caller
            out["err"] = e

    th = threading.Thread(target=run)
    th.start()
    return th, out


def test_reference_client_gets_a_bitwise_result(smoke_dlm):
    """The reference's client decodes a port response of the smoke
    denoiser, bitwise the in-process result of the same engine config."""
    r = req(seed=7, batch=2, seq_len=5)
    d = serve_frontdoor(make_engine(smoke_dlm), SchedulerPolicy(max_wait_ms=5.0))
    try:
        wire = JFrontDoorClient(d.url, timeout=WAIT_S).sample(
            jreq(seed=7, batch=2, seq_len=5))
        ported = FrontDoorClient(d.url, timeout=WAIT_S).sample(r)
    finally:
        d.stop()
    local = SamplerService(engine=make_engine(smoke_dlm)).sample(r)
    assert same_bits(wire.x0, local.x0.numpy())
    assert same_bits(ported.x0.numpy(), local.x0.numpy())
    for k in local.aux:
        assert same_bits(wire.aux[k], local.aux[k].numpy())
    assert wire.info[K.PADDED_BATCH] == 2


def test_wire_concurrent_requests_fuse_and_stay_isolated(door):
    client = FrontDoorClient(door.url, timeout=WAIT_S)
    calls = {s: call_in_thread(lambda s=s: client.sample(req(seed=s)))
             for s in (11, 12)}
    for th, _ in calls.values():
        th.join(timeout=WAIT_S)
        assert not th.is_alive()
    for seed, (_, out) in calls.items():
        solo = SamplerService(engine=make_engine()).sample(req(seed=seed))
        assert torch.equal(out["res"].x0, solo.x0)


@pytest.mark.parametrize("client_cls,errors", [
    (JFrontDoorClient, (JQueueFullError, JDeadlineExceededError)),
    (FrontDoorClient, (QueueFullError, DeadlineExceededError)),
], ids=["reference-client", "port-client"])
def test_429_and_504_come_back_typed(client_cls, errors):
    """A burst past ``max_queue_rows``: 429 with ``Retry-After`` while the
    admitted requests complete; a request whose deadline expires in the
    held queue: 504.  Both typed, with the server's message."""
    queue_full, deadline = errors
    new = jreq if client_cls is JFrontDoorClient else req
    d, sched, clk = held_door(SchedulerPolicy(max_wait_ms=10.0,
                                              max_queue_rows=2))
    with d:
        client = client_cls(d.url, timeout=WAIT_S)
        doomed = call_in_thread(
            lambda: client.sample(new(seed=0, deadline_ms=20.0)))
        kept = call_in_thread(lambda: client.sample(new(seed=1)))
        wait_pending(sched, 2)

        conn = HTTPConnection(d.host, d.port, timeout=30)
        conn.request("POST", "/v1/sample",
                     json.dumps(encode_request(req(seed=9))).encode())
        resp = conn.getresponse()
        assert resp.status == 429 and int(resp.getheader("Retry-After")) >= 1
        assert json.loads(resp.read())["error"]["type"] == "queue_full"
        conn.close()
        with pytest.raises(queue_full) as ei:
            client.sample(new(seed=10))
        assert "is full" in str(ei.value) and ei.value.retry_after_s >= 1.0

        clk[0] = 1.0  # far past the 20 ms deadline and max_wait_ms
        assert sched.drain_once(now=clk[0]) == 1
        for th, _ in (doomed, kept):
            th.join(timeout=WAIT_S)
            assert not th.is_alive()
    sched.stop()
    assert isinstance(doomed[1].get("err"), deadline)
    assert "expired in queue" in str(doomed[1]["err"])
    assert "nan" not in str(doomed[1]["err"])
    solo = SamplerService(engine=make_engine()).sample(req(seed=1))
    assert same_bits(np.asarray(kept[1]["res"].x0), solo.x0.numpy())


@pytest.mark.parametrize("client_cls", [JFrontDoorClient, FrontDoorClient],
                         ids=["reference-client", "port-client"])
def test_400_and_404_come_back_typed(door, client_cls):
    client = client_cls(door.url, timeout=WAIT_S)
    new = jreq if client_cls is JFrontDoorClient else req
    with pytest.raises(ValueError, match="solver"):
        client.sample(new(solver="nope"))
    with pytest.raises(ValueError, match="batch"):
        client.sample(new(batch=0))
    conn = HTTPConnection(door.host, door.port, timeout=30)
    conn.request("POST", "/v1/sample", b"{not json")
    r = conn.getresponse()
    assert r.status == 400
    assert json.loads(r.read())["error"]["type"] == "invalid_request"
    conn.request("POST", "/v1/sample",
                 json.dumps({**encode_request(req()), "bogus": 1}).encode())
    r = conn.getresponse()
    assert r.status == 400 and r.read()
    conn.request("GET", "/nope")
    r = conn.getresponse()
    assert r.status == 404
    assert json.loads(r.read())["error"]["type"] == "not_found"
    conn.close()


def test_failed_batch_is_a_typed_500():
    """A chunk that raises fails its requests with a typed 500; the batch
    is not run again on another path."""
    engine = make_engine()
    calls = []

    def boom(*args, **kw):
        calls.append(args[0])
        raise RuntimeError("injected replay failure")

    engine.executor.run_chunk = boom
    d = serve_frontdoor(engine, SchedulerPolicy(max_wait_ms=1.0))
    try:
        with pytest.raises(RuntimeError, match="500.*injected replay failure"):
            FrontDoorClient(d.url, timeout=WAIT_S).sample(req(seed=1))
        with pytest.raises(RuntimeError, match="500"):
            JFrontDoorClient(d.url, timeout=WAIT_S).sample(jreq(seed=2))
    finally:
        d.stop()
    assert calls == [6, 6]


def test_wire_poison_request_400_not_500(door):
    client = FrontDoorClient(door.url, timeout=WAIT_S)
    good = call_in_thread(lambda: client.sample(req(seed=21)))
    conn = HTTPConnection(door.host, door.port, timeout=30)
    for field, value in (("seed", 2**63), ("seed", -(2**63) - 1),
                         ("batch", 10**8), ("nfe", 10**7), ("seq_len", 10**6)):
        conn.request("POST", "/v1/sample",
                     json.dumps({**encode_request(req()), field: value}).encode())
        r = conn.getresponse()
        body = json.loads(r.read())
        assert r.status == 400, (field, value)
        assert body["error"]["type"] == "invalid_request"
    conn.close()
    good[0].join(timeout=WAIT_S)
    solo = SamplerService(engine=make_engine()).sample(req(seed=21))
    assert torch.equal(good[1]["res"].x0, solo.x0)


def test_idle_keepalive_connection_reclaimed():
    sched = AsyncBatchedSampler(make_engine(), SchedulerPolicy(max_wait_ms=5.0))
    sched.start()
    try:
        with FrontDoor(sched, idle_timeout_s=0.3) as d:
            conn = HTTPConnection(d.host, d.port, timeout=30)
            conn.request("POST", "/v1/sample",
                         json.dumps(encode_request(req(seed=31))).encode())
            r = conn.getresponse()
            assert r.status == 200
            r.read()
            sock = conn.sock
            sock.settimeout(10)
            assert sock.recv(1) == b""  # EOF from the server, not a hang
            conn.close()
            s = socket.create_connection((d.host, d.port), timeout=10)
            assert s.recv(1) == b""
            s.close()
    finally:
        sched.stop()


class _FakeHandler:
    """Enough of BaseHTTPRequestHandler for FrontDoor._handle: records the
    status codes sent, and can fail while writing the body."""

    def __init__(self, path, fail_body_write=False):
        self.path = path
        self.headers = {}
        self.close_connection = False
        self.codes = []

        class _W:
            def write(self, data):
                if fail_body_write:
                    raise ConnectionResetError("peer reset mid-body")

        self.wfile = _W()

    def send_response(self, code):
        self.codes.append(code)

    def send_header(self, *a):
        pass

    def end_headers(self):
        pass


def test_partial_response_failure_does_not_append_500():
    sched = AsyncBatchedSampler(make_engine(), SchedulerPolicy(max_wait_ms=5.0))
    d = FrontDoor(sched)
    try:
        h = _FakeHandler("/healthz", fail_body_write=True)
        d._handle(h, "GET")
        assert h.codes == [200] and h.close_connection is True
        d.scheduler.stats = lambda: (_ for _ in ()).throw(RuntimeError("boom"))
        h2 = _FakeHandler("/healthz")
        d._handle(h2, "GET")
        assert h2.codes == [500]
    finally:
        d._server.server_close()
        sched.stop()


@pytest.mark.parametrize("client_cls", [JFrontDoorClient, FrontDoorClient],
                         ids=["reference-client", "port-client"])
def test_metrics_and_healthz(door, client_cls):
    client = client_cls(door.url, timeout=WAIT_S)
    client.sample(jreq(seed=1) if client_cls is JFrontDoorClient else req(seed=1))
    health = client.healthz()
    assert health["ok"] is True and health["stats"][K.SUBMITTED] >= 1
    text = client.metrics()
    for name in (
        "sampler_queue_depth_rows",
        "sampler_fuse_occupancy_ratio",
        "sampler_batches_total",
        "sampler_compile_cache_hits_total",
        "sampler_warmup_grid_programs",
        "sampler_warmup_in_progress",
        "sampler_admission_rejects_total",
        "sampler_deadline_expired_total",
        "sampler_requests_submitted_total",
        "sampler_request_latency_seconds_bucket",
        "frontdoor_http_requests_total",
    ):
        assert name in text, name
    assert "# TYPE sampler_request_latency_seconds histogram" in text
    assert 'frontdoor_http_requests_total{code="200",route="/v1/sample"}' in text
    assert 'le="+Inf"' in text and text.endswith("\n")


def test_client_rejects_non_http_url():
    with pytest.raises(ValueError, match="base_url"):
        FrontDoorClient("ftp://example:1")


# ---------------------------------------------------------------------------
# /readyz gates on the warmup; /healthz stays liveness
# ---------------------------------------------------------------------------


def _ready_door(warmup, **engine_kw):
    engine = BatchedSampler(OracleDenoiser(), linear_schedule(),
                            batch_buckets=(2, 4), seq_buckets=(4, 8),
                            **engine_kw)
    return serve_frontdoor(engine, SchedulerPolicy(max_wait_ms=5.0),
                           warmup=warmup)


def poll_ready(client, attempts=600):
    for _ in range(attempts):
        payload = client.readyz()
        if payload["ready"]:
            return payload
        time.sleep(0.05)
    return client.readyz()


@pytest.mark.parametrize("client_cls", [JFrontDoorClient, FrontDoorClient],
                         ids=["reference-client", "port-client"])
def test_readyz_gates_on_warmup(client_cls):
    release, started = threading.Event(), threading.Event()

    def slow_warmup():
        started.set()
        assert release.wait(timeout=WAIT_S)
        return {"programs": 0}

    d = _ready_door(slow_warmup)
    try:
        client = client_cls(d.url, timeout=WAIT_S)
        assert started.wait(timeout=WAIT_S)
        not_ready = client.readyz()
        assert not_ready["ready"] is False and "warmup" in not_ready
        assert client.healthz()["ok"] is True
        assert d.ready is False
        release.set()
        assert poll_ready(client)["ready"] is True and d.ready is True
    finally:
        release.set()
        d.stop()


def test_readyz_stays_503_when_warmup_fails():
    def broken_warmup():
        raise RuntimeError("no such solver")

    d = _ready_door(broken_warmup)
    try:
        client = FrontDoorClient(d.url, timeout=WAIT_S)
        d._warmup_thread.join(timeout=WAIT_S)
        assert not d._warmup_thread.is_alive()
        payload = client.readyz()
        assert payload["ready"] is False
        assert "no such solver" in payload["error"]
        assert client.healthz()["ok"] is True
        conn = HTTPConnection(d.host, d.port, timeout=30)
        conn.request("GET", "/readyz")
        assert conn.getresponse().status == 503
        conn.close()
    finally:
        d.stop()


def test_readyz_reports_a_failed_grid_warmup():
    """The executor's own warmup failing (an unserveable grid) leaves the
    replica at 503 with the error and the warmup state ``failed``."""
    d = _ready_door({"solvers": ("nope",)})
    try:
        client = FrontDoorClient(d.url, timeout=WAIT_S)
        d._warmup_thread.join(timeout=WAIT_S)
        payload = client.readyz()
        assert payload["ready"] is False and "nope" in payload["error"]
    finally:
        d.stop()


def test_readyz_immediate_without_warmup():
    d = _ready_door(None)
    try:
        assert FrontDoorClient(d.url, timeout=WAIT_S).readyz()["ready"] is True
    finally:
        d.stop()


def test_readyz_with_real_grid_warmup():
    cfg = EngineConfig(nfe=6, k=3, batch_buckets=(2, 4), seq_buckets=(4, 8),
                       warmup="grid")
    engine = build_engine(OracleDenoiser(), linear_schedule(), cfg)
    d = serve_frontdoor(engine, SchedulerPolicy(max_wait_ms=5.0),
                        warmup=warmup_kwargs(cfg))
    try:
        client = JFrontDoorClient(d.url, timeout=WAIT_S)
        payload = poll_ready(client)
        assert payload["ready"] is True
        assert payload["warmup"]["state"] == "done"
        assert payload["warmup"]["total"] == 4
        res = client.sample(jreq(batch=2, seq_len=8, nfe=6, seed=3))
        assert res.x0.shape == (2, 8, D_MODEL)
    finally:
        d.stop()


def test_readiness_probe_does_not_wait_on_the_executor_lock():
    """``warmup_status()`` has a lock of its own: a probe answers while a
    chunk or a capture holds the executor's lock."""
    d = _ready_door(None)
    try:
        lock = d.scheduler.engine.executor._lock
        assert lock.acquire(timeout=5)
        try:
            payload = FrontDoorClient(d.url, timeout=5).readyz()
        finally:
            lock.release()
        assert payload["ready"] is True
    finally:
        d.stop()
