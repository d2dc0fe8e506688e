"""Prometheus-style metrics for the serving stack (stdlib only).

A copy of ``repro.serving.metrics``: the port keeps its own so it imports
nothing of the reference package.

A :class:`MetricsRegistry` holds named counters, gauges, and histograms;
``render()`` emits the Prometheus text exposition format that the front
door serves at ``GET /metrics``.  One registry rides with each
:class:`~repro_torch.serving.executor.FusedExecutor`, so every layer above it —
sync drains, the continuous-batching scheduler, the HTTP front door —
instruments into the same scrape:

* executor: compile-cache hits/misses, fused-batch count/rows, fuse
  occupancy (real rows / padded rows), batch wall time;
* scheduler: per-fuse-group queue depth, admission rejects, deadline
  expirations, arrival-to-result latency histogram;
* front door: HTTP request counts by route and status code.

Thread-safety: every mutation and ``render()`` takes the instrument's (or
registry's) lock — instruments are safe to hit from the drain thread, HTTP
handler threads, and client threads concurrently.  Registration is
get-or-create: asking for an existing name returns the same instrument
(so a scheduler and a front door sharing an executor never double-register),
and asking with a different instrument type fails loudly.

This is deliberately a small, dependency-free subset of the Prometheus
client library: enough for counters/gauges/histograms with labels, the
text format, and a bucket-interpolated ``quantile()`` helper for p50/p99
readouts in benchmarks and tests.
"""

from __future__ import annotations

import math
import threading
from bisect import bisect_left

LabelKey = tuple[tuple[str, str], ...]


def _fmt(v: float) -> str:
    """Prometheus sample value: integers without a trailing .0."""
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_str(key: LabelKey, extra: str = "") -> str:
    parts = [f'{k}="{_escape(v)}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _Metric:
    """Base: one named instrument, one value (or histogram state) per
    label set.  Labels are passed as keyword arguments to the mutators and
    stringified — ``depth.set(3, solver="era", nfe=8)``."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._values: dict[LabelKey, float] = {}

    @staticmethod
    def _key(labels: dict) -> LabelKey:
        return tuple(sorted((k, str(v)) for k, v in labels.items()))

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def _render_header(self) -> list[str]:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {_escape(self.help)}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        return lines

    def render(self) -> list[str]:
        lines = self._render_header()
        with self._lock:
            items = sorted(self._values.items())
        for key, v in items:
            lines.append(f"{self.name}{_label_str(key)} {_fmt(v)}")
        return lines


class Counter(_Metric):
    """Monotonically increasing count (``_total`` naming convention)."""

    kind = "counter"

    def inc(self, n: float = 1.0, **labels) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (n={n})")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + n


class Gauge(_Metric):
    """A value that goes up and down (queue depth, in-flight requests)."""

    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        with self._lock:
            self._values[self._key(labels)] = float(v)

    def inc(self, n: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + n

    def dec(self, n: float = 1.0, **labels) -> None:
        self.inc(-n, **labels)


#: latency-flavored default buckets (seconds), Prometheus client defaults
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class Histogram(_Metric):
    """Fixed-bucket histogram: cumulative ``_bucket{le=...}`` series plus
    ``_sum`` / ``_count``, and a bucket-interpolated :meth:`quantile` for
    in-process p50/p99 readouts (benchmarks, tests — a real deployment
    computes quantiles scrape-side)."""

    kind = "histogram"

    def __init__(self, name, help="", buckets: tuple[float, ...] = DEFAULT_BUCKETS):
        super().__init__(name, help)
        self.buckets = tuple(sorted(buckets))
        # per label set: [per-bucket counts..., +Inf count], sum
        self._counts: dict[LabelKey, list[int]] = {}
        self._sums: dict[LabelKey, float] = {}

    def observe(self, v: float, **labels) -> None:
        key = self._key(labels)
        i = bisect_left(self.buckets, v)
        with self._lock:
            counts = self._counts.get(key)
            if counts is None:
                counts = self._counts[key] = [0] * (len(self.buckets) + 1)
                self._sums[key] = 0.0
            counts[i] += 1
            self._sums[key] += v

    def count(self, **labels) -> int:
        with self._lock:
            return sum(self._counts.get(self._key(labels), ()))

    def sum(self, **labels) -> float:
        with self._lock:
            return self._sums.get(self._key(labels), 0.0)

    def quantile(self, q: float, **labels) -> float:
        """Linear-interpolated quantile from the cumulative buckets (the
        same estimate Prometheus' ``histogram_quantile`` computes).  NaN
        with no observations; the largest finite bound when the quantile
        lands in the +Inf bucket."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            counts = list(self._counts.get(self._key(labels), ()))
        total = sum(counts)
        if total == 0:
            return math.nan
        rank = q * total
        seen = 0.0
        for i, c in enumerate(counts):
            if seen + c >= rank and c > 0:
                if i >= len(self.buckets):  # +Inf bucket
                    return self.buckets[-1]
                lo = 0.0 if i == 0 else self.buckets[i - 1]
                hi = self.buckets[i]
                return lo + (hi - lo) * max(0.0, rank - seen) / c
            seen += c
        return self.buckets[-1]

    def render(self) -> list[str]:
        lines = self._render_header()
        with self._lock:
            items = sorted(
                (k, list(c), self._sums[k]) for k, c in self._counts.items()
            )
        for key, counts, total in items:
            cum = 0
            for bound, c in zip(self.buckets, counts):
                cum += c
                le = _label_str(key, f'le="{_fmt(bound)}"')
                lines.append(f"{self.name}_bucket{le} {cum}")
            cum += counts[-1]
            le = _label_str(key, 'le="+Inf"')
            lines.append(f"{self.name}_bucket{le} {cum}")
            lines.append(f"{self.name}_sum{_label_str(key)} {_fmt(total)}")
            lines.append(f"{self.name}_count{_label_str(key)} {cum}")
        return lines


class MetricsRegistry:
    """Named instruments + the text exposition the front door scrapes."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def _get_or_create(self, cls, name, help, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(
        self, name: str, help: str = "",
        buckets: tuple[float, ...] = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> _Metric | None:
        with self._lock:
            return self._metrics.get(name)

    def render(self) -> str:
        """The full Prometheus text exposition (``text/plain; version=0.0.4``)."""
        with self._lock:
            metrics = sorted(self._metrics.items())
        lines: list[str] = []
        for _, m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"
