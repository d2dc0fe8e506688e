"""HTTP front door for the sampling engine (port of
``repro.serving.frontdoor``).

A :class:`FrontDoor` puts a stdlib ``ThreadingHTTPServer`` in front of an
:class:`~repro_torch.serving.scheduler.AsyncBatchedSampler` and speaks the
reference's **wire schema, version 1**, unchanged: the JSON body of a
request is exactly the fields of
:class:`~repro_torch.serving.executor.SampleRequest`, and the body of a
result exactly the fields of
:class:`~repro_torch.serving.executor.SampleResult`.  A client of either
package talks to a server of either.  Endpoints:

* ``POST /v1/sample``: submit one request; the handler thread waits on its
  future and answers with the encoded result.  Admission rejects answer
  **429** with ``Retry-After``, an expired ``deadline_ms`` **504**
  (``deadline_exceeded``), an invalid request **400**, a failed batch
  **500** (``internal``).
* ``GET /metrics``: the engine's Prometheus text exposition.
* ``GET /healthz``: liveness and scheduler stats; 200 from the first byte.
* ``GET /readyz``: readiness; 503 with the warmup's progress until the
  bucket-graph grid is captured, 200 after (at once without a warmup); a
  warmup that raised leaves it at 503 with the error.

Arrays travel as base64 of their raw little-endian bytes with dtype and
shape, so a wire result is bitwise the in-process one.  The port's results
carry the reference's dtypes: ``x0`` and the delta_eps histories float32
(``"<f4"``), ERA's ``ers_selection_history`` and adaptive DPM's
``realized_nfe`` int32 (``"<i4"``).  :func:`encode_array` takes host
tensors only (and numpy arrays): the scheduler hands the front door results
already copied to the CPU under the executor's lock, and a device tensor
here would mean an HTTP thread touching the card, which a bucket-graph
capture on another thread must not meet.  :func:`decode_array` gives CPU
tensors.

:class:`FrontDoorClient` is the matching stdlib client (``launch/serve.py
--connect``).  It raises the server's typed errors as the scheduler's own
exception classes, so retry logic is the same in process and on the wire.
Error bodies are ``{"v": 1, "error": {"type": ..., "message": ...}}`` with
``type`` one of ``invalid_request`` / ``queue_full`` / ``deadline_exceeded``
/ ``not_found`` / ``internal``.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import math
import threading
from http.client import HTTPConnection
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlsplit

import numpy as np
import torch

from repro_torch.serving.executor import SampleRequest, SampleResult
from repro_torch.serving.scheduler import (
    AsyncBatchedSampler,
    DeadlineExceededError,
    QueueFullError,
)

#: wire schema version; bump on any incompatible request/response change
SCHEMA_VERSION = 1

METRICS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_REQUEST_FIELDS = {f.name: f for f in dataclasses.fields(SampleRequest)}
_RESULT_FIELDS = {f.name: f for f in dataclasses.fields(SampleResult)}
_INT_FIELDS = ("batch", "seq_len", "nfe", "seed", "priority")


class SchemaError(ValueError):
    """The payload does not conform to the versioned wire schema."""


# ---------------------------------------------------------------------------
# wire schema: SampleRequest / SampleResult <-> JSON
# ---------------------------------------------------------------------------


def encode_array(x) -> dict:
    """Host tensor or numpy array -> JSON-safe dict: raw bytes in base64
    with an explicit byte order, so decoding is bitwise for every dtype.
    A tensor on another device raises ``ValueError``."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError(
                f"encode_array takes host tensors, got one on {x.device}: "
                f"results reach the wire already copied to the host"
            )
        x = x.detach().numpy()
    a = np.ascontiguousarray(np.asarray(x))
    return {
        "__nd__": True,
        "dtype": a.dtype.str,  # byte order explicit, e.g. "<f4"
        "shape": list(a.shape),
        "data": base64.b64encode(a.tobytes()).decode("ascii"),
    }


def decode_array(d: dict) -> torch.Tensor:
    """Encoded array -> CPU tensor with the same bytes."""
    if not (isinstance(d, dict) and d.get("__nd__")):
        raise SchemaError(f"expected an encoded array, got {type(d).__name__}")
    dtype = np.dtype(d["dtype"])
    a = np.frombuffer(base64.b64decode(d["data"]), dtype=dtype)
    # a writable copy in native byte order (the same values, bit for bit)
    a = a.astype(dtype.newbyteorder("="), copy=True).reshape(d["shape"])
    return torch.from_numpy(a)


def _check_version(payload) -> dict:
    if not isinstance(payload, dict):
        raise SchemaError(
            f"payload must be a JSON object, got {type(payload).__name__}"
        )
    v = payload.get("v")
    if v != SCHEMA_VERSION:
        raise SchemaError(
            f"unsupported schema version {v!r}; this endpoint speaks "
            f"v={SCHEMA_VERSION}"
        )
    return {k: payload[k] for k in payload if k != "v"}


def encode_request(req: SampleRequest) -> dict:
    """``SampleRequest`` -> versioned JSON body (exactly its fields)."""
    return {"v": SCHEMA_VERSION, **dataclasses.asdict(req)}


def decode_request(payload) -> SampleRequest:
    """Versioned JSON body -> ``SampleRequest``.  Rejects (``SchemaError``)
    a wrong or missing ``v``, unknown fields and fields of the wrong JSON
    type; range checks stay in ``FusedExecutor.validate`` at submit."""
    body = _check_version(payload)
    unknown = set(body) - set(_REQUEST_FIELDS)
    if unknown:
        raise SchemaError(
            f"unknown request fields {sorted(unknown)}; the v{SCHEMA_VERSION} "
            f"schema has {sorted(_REQUEST_FIELDS)}"
        )
    for name in _INT_FIELDS:
        if name in body and (
            isinstance(body[name], bool) or not isinstance(body[name], int)
        ):
            raise SchemaError(f"field {name!r} must be an integer")
    if "solver" in body and not (
        body["solver"] is None or isinstance(body["solver"], str)
    ):
        raise SchemaError("field 'solver' must be a string or null")
    if "deadline_ms" in body and not (
        body["deadline_ms"] is None
        or (
            isinstance(body["deadline_ms"], (int, float))
            and not isinstance(body["deadline_ms"], bool)
        )
    ):
        raise SchemaError("field 'deadline_ms' must be a number or null")
    try:
        return SampleRequest(**body)
    except TypeError as e:  # missing required fields
        raise SchemaError(str(e)) from None


def _encode_value(v):
    if hasattr(v, "shape"):
        return encode_array(v)
    if isinstance(v, dict):
        return {k: _encode_value(x) for k, x in v.items()}
    return v


def _decode_value(v):
    if isinstance(v, dict):
        if v.get("__nd__"):
            return decode_array(v)
        return {k: _decode_value(x) for k, x in v.items()}
    return v


def encode_result(res: SampleResult) -> dict:
    """``SampleResult`` -> versioned JSON body, field by field of the
    dataclass; arrays (inside ``aux`` too) go base64."""
    return {
        "v": SCHEMA_VERSION,
        **{f: _encode_value(getattr(res, f)) for f in _RESULT_FIELDS},
    }


def decode_result(payload) -> SampleResult:
    """Versioned JSON body -> ``SampleResult`` of CPU tensors, bitwise the
    server's.  Unknown or missing fields are rejected."""
    body = _check_version(payload)
    unknown = set(body) - set(_RESULT_FIELDS)
    if unknown:
        raise SchemaError(
            f"unknown result fields {sorted(unknown)}; the v{SCHEMA_VERSION} "
            f"schema has {sorted(_RESULT_FIELDS)}"
        )
    missing = set(_RESULT_FIELDS) - set(body)
    if missing:
        raise SchemaError(f"missing result fields {sorted(missing)}")
    return SampleResult(**{f: _decode_value(v) for f, v in body.items()})


def encode_error(kind: str, message: str) -> dict:
    return {"v": SCHEMA_VERSION, "error": {"type": kind, "message": message}}


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------


class FrontDoor:
    """HTTP server over an :class:`AsyncBatchedSampler`.

    One handler thread a connection; a ``POST /v1/sample`` handler waits on
    its request's future while the drain thread fuses batches, so
    concurrent wire requests fuse as in-process submits do.  ``port=0``
    binds an ephemeral port (:attr:`url` reports it).  ``idle_timeout_s``
    bounds how long a keep-alive connection may sit idle or trickle a
    request before its thread is reclaimed; it never limits a sample in
    flight, which waits on the future, not the socket (None: no bound).
    ``start()`` / ``stop()`` (or a ``with`` block) run the accept loop on
    a daemon thread; ``stop()`` also stops the scheduler when the front
    door owns it (:func:`serve_frontdoor` sets that up).

    ``warmup`` (a zero-argument callable, typically
    ``lambda: scheduler.warmup(...)``) gates readiness: ``start()`` runs it
    on a background thread while the listener already answers, and
    ``/readyz`` serves 503 with ``scheduler.warmup_status()`` until it
    returns, 200 after.  If it raises, the replica stays not ready and
    ``/readyz`` carries the error.  None: ready from the first byte.
    """

    def __init__(
        self,
        scheduler: AsyncBatchedSampler,
        host: str = "127.0.0.1",
        port: int = 0,
        owns_scheduler: bool = False,
        idle_timeout_s: float | None = 30.0,
        warmup=None,
    ):
        self.scheduler = scheduler
        self._owns_scheduler = owns_scheduler
        self._warmup_fn = warmup
        self._warmup_thread: threading.Thread | None = None
        self._warmup_error: str | None = None
        self._ready = threading.Event()
        if warmup is None:
            self._ready.set()
        self._m_http = scheduler.engine.metrics.counter(
            "frontdoor_http_requests_total",
            "HTTP requests served, by route and status code",
        )
        frontdoor = self

        class Handler(BaseHTTPRequestHandler):
            # socket timeout for reading a request (the next request line
            # of a keep-alive connection, or a trickling body): without it
            # every idle connection pins a handler thread; http.server turns
            # a timed-out read into close_connection
            timeout = idle_timeout_s
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # noqa: A003 - BaseHTTP API
                pass  # metrics, not stderr

            def do_GET(self):  # noqa: N802 - BaseHTTP API
                frontdoor._handle(self, "GET")

            def do_POST(self):  # noqa: N802 - BaseHTTP API
                frontdoor._handle(self, "POST")

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self._thread: threading.Thread | None = None

    # ---- lifecycle ------------------------------------------------------
    @property
    def host(self) -> str:
        return self._server.server_address[0]

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "FrontDoor":
        if self._thread is not None:
            raise RuntimeError("front door already started")
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="era-frontdoor",
            daemon=True,
        )
        self._thread.start()
        if self._warmup_fn is not None and self._warmup_thread is None:
            # the listener already accepts: /healthz answers during the
            # captures, and /readyz turns 200 when the grid is in
            self._warmup_thread = threading.Thread(
                target=self._run_warmup, name="era-warmup", daemon=True
            )
            self._warmup_thread.start()
        return self

    def _run_warmup(self) -> None:
        """Run the warmup; a failure is reported through ``/readyz`` and
        leaves the replica not ready (nothing else is tried)."""
        try:
            self._warmup_fn()
        except Exception as e:  # noqa: BLE001 - surfaced via /readyz
            self._warmup_error = f"{type(e).__name__}: {e}"
        else:
            self._ready.set()

    @property
    def ready(self) -> bool:
        """Has the warmup finished (or was none configured)?"""
        return self._ready.is_set()

    def readiness(self) -> dict:
        """The ``/readyz`` payload: ``ready``, the scheduler's warmup
        progress, and ``error`` if the warmup raised."""
        payload = {
            "v": SCHEMA_VERSION,
            "ready": self.ready,
            "warmup": self.scheduler.warmup_status(),
        }
        if self._warmup_error is not None:
            payload["error"] = self._warmup_error
        return payload

    def stop(self) -> None:
        """Stop accepting, join the accept loop and, when it owns the
        scheduler, stop it (which flushes every queued request)."""
        if self._thread is not None:
            self._server.shutdown()
            self._thread.join()
            self._thread = None
        self._server.server_close()
        if self._owns_scheduler:
            self.scheduler.stop()

    def __enter__(self) -> "FrontDoor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ---- request handling ----------------------------------------------
    def _handle(self, handler: BaseHTTPRequestHandler, method: str) -> None:
        route = urlsplit(handler.path).path
        handler._response_started = False  # set by _respond_text
        try:
            if method == "POST" and route == "/v1/sample":
                self._handle_sample(handler, route)
            elif method == "GET" and route == "/metrics":
                self._respond_text(
                    handler, route, 200,
                    self.scheduler.engine.metrics.render(),
                    METRICS_CONTENT_TYPE,
                )
            elif method == "GET" and route == "/healthz":
                self._respond_json(
                    handler, route, 200,
                    {"v": SCHEMA_VERSION, "ok": True,
                     "stats": self.scheduler.stats()},
                )
            elif method == "GET" and route == "/readyz":
                payload = self.readiness()
                self._respond_json(
                    handler, route, 200 if payload["ready"] else 503, payload
                )
            else:
                self._respond_json(
                    handler, route, 404,
                    encode_error("not_found", f"no route {method} {route}"),
                )
        except BrokenPipeError:
            pass  # the client hung up mid-response
        except Exception as e:  # noqa: BLE001 - must answer, not crash
            if handler._response_started:
                # a status line went out already: a second one would
                # corrupt the stream, so drop the connection instead
                handler.close_connection = True
                return
            try:
                self._respond_json(
                    handler, route, 500, encode_error("internal", str(e))
                )
            except Exception:  # noqa: BLE001 - socket already gone
                pass

    def _handle_sample(self, handler, route: str) -> None:
        length = int(handler.headers.get("Content-Length") or 0)
        raw = handler.rfile.read(length) if length else b""
        try:
            payload = json.loads(raw.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            self._respond_json(
                handler, route, 400,
                encode_error("invalid_request", f"body is not JSON: {e}"),
            )
            return
        try:
            req = decode_request(payload)
            fut = self.scheduler.submit(req)
        except (SchemaError, ValueError) as e:
            self._respond_json(
                handler, route, 400, encode_error("invalid_request", str(e))
            )
            return
        except QueueFullError as e:
            self._respond_json(
                handler, route, 429, encode_error("queue_full", str(e)),
                headers={"Retry-After": str(max(1, math.ceil(e.retry_after_s)))},
            )
            return
        try:
            res = fut.result()
        except DeadlineExceededError as e:
            self._respond_json(
                handler, route, 504, encode_error("deadline_exceeded", str(e))
            )
            return
        except Exception as e:  # noqa: BLE001 - a failed batch -> typed 500
            self._respond_json(
                handler, route, 500, encode_error("internal", str(e))
            )
            return
        self._respond_json(handler, route, 200, encode_result(res))

    # ---- response plumbing ----------------------------------------------
    def _respond_text(
        self, handler, route, code, text: str, content_type: str,
        headers: dict | None = None,
    ) -> None:
        body = text.encode("utf-8")
        # from here on a failure must not send a second status line
        handler._response_started = True
        handler.send_response(code)
        handler.send_header("Content-Type", content_type)
        handler.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            handler.send_header(k, v)
        handler.end_headers()
        handler.wfile.write(body)
        self._m_http.inc(route=route, code=str(code))

    def _respond_json(
        self, handler, route, code, payload: dict,
        headers: dict | None = None,
    ) -> None:
        self._respond_text(
            handler, route, code, json.dumps(payload),
            "application/json", headers,
        )


def serve_frontdoor(
    engine,
    policy=None,
    host: str = "127.0.0.1",
    port: int = 0,
    warmup=None,
) -> FrontDoor:
    """Start a scheduler over ``engine`` and a :class:`FrontDoor` that owns
    it; ``stop()`` on the front door tears both down.  ``warmup`` gates
    ``/readyz``: a dict is keyword arguments of the scheduler's grid warmup
    (what :func:`~repro_torch.serving.factory.warmup_kwargs` gives), a
    callable runs as it is, None means ready at once.  The warmup runs on
    a background thread, so this returns once the listener is bound.
    Unlike the reference it takes no ``params``: the engine owns its
    weights."""
    scheduler = AsyncBatchedSampler(engine, policy).start()
    warmup_fn = warmup
    if isinstance(warmup, dict):
        kw = dict(warmup)

        def warmup_fn():
            return scheduler.warmup(**kw)

    try:
        return FrontDoor(
            scheduler, host=host, port=port, owns_scheduler=True,
            warmup=warmup_fn,
        ).start()
    except Exception:
        scheduler.stop()
        raise


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------


class FrontDoorClient:
    """Stdlib HTTP client of the front door.

    ``sample()`` raises the server's typed errors as the scheduler's own
    classes (:class:`QueueFullError` with ``retry_after_s`` from the
    header, :class:`DeadlineExceededError`, ``ValueError`` for a 400),
    carrying the server's message.  One connection per call."""

    def __init__(self, base_url: str, timeout: float | None = None):
        parts = urlsplit(base_url)
        if parts.scheme != "http" or not parts.netloc:
            raise ValueError(
                f"base_url must be http://host:port, got {base_url!r}"
            )
        self._netloc = parts.netloc
        self._timeout = timeout

    def _request(self, method: str, path: str, body: bytes | None = None):
        conn = HTTPConnection(self._netloc, timeout=self._timeout)
        try:
            headers = {"Content-Type": "application/json"} if body else {}
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            return resp.status, dict(resp.getheaders()), resp.read()
        finally:
            conn.close()

    @staticmethod
    def _error_payload(raw: bytes) -> dict:
        try:
            payload = json.loads(raw.decode("utf-8"))
            return payload.get("error") or {}
        except (UnicodeDecodeError, json.JSONDecodeError):
            return {}

    def sample(self, req: SampleRequest) -> SampleResult:
        """POST the request and wait for its result (CPU tensors)."""
        body = json.dumps(encode_request(req)).encode("utf-8")
        status, headers, raw = self._request("POST", "/v1/sample", body)
        if status == 200:
            return decode_result(json.loads(raw.decode("utf-8")))
        err = self._error_payload(raw)
        message = err.get("message", f"HTTP {status}")
        if status == 429:
            retry = float(headers.get("Retry-After", "1"))
            raise QueueFullError(
                key=None, rows=-1, limit=-1, retry_after_s=retry,
                message=message,
            )
        if status == 504:
            raise DeadlineExceededError(
                req, waited_ms=float("nan"), message=message
            )
        if status == 400:
            raise ValueError(message)
        raise RuntimeError(f"front door error {status}: {message}")

    def metrics(self) -> str:
        status, _, raw = self._request("GET", "/metrics")
        if status != 200:
            raise RuntimeError(f"/metrics returned HTTP {status}")
        return raw.decode("utf-8")

    def healthz(self) -> dict:
        """GET /healthz: liveness (200 even while warming up)."""
        status, _, raw = self._request("GET", "/healthz")
        if status != 200:
            raise RuntimeError(f"/healthz returned HTTP {status}")
        return json.loads(raw.decode("utf-8"))

    def readyz(self) -> dict:
        """GET /readyz: the readiness payload.  A 503 is a state, not a
        transport error, so 200 and 503 both return the payload (check
        ``payload["ready"]``); any other status raises."""
        status, _, raw = self._request("GET", "/readyz")
        if status not in (200, 503):
            raise RuntimeError(f"/readyz returned HTTP {status}")
        payload = json.loads(raw.decode("utf-8"))
        payload["ready"] = bool(payload.get("ready")) and status == 200
        return payload
