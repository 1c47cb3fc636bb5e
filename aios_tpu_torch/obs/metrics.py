"""Thread-safe Prometheus-style metrics: Counter, Gauge, Histogram.

A copy of ``aios_tpu/obs/metrics.py``. The port's ``REGISTRY`` is its own
object, so the port's instruments and the JAX package's can carry the same
names in one process without registering twice in one registry.

Self-contained (the image has no prometheus_client); the exposition
format follows the Prometheus text format 0.0.4 so any scraper or human
reading ``/metrics`` sees the standard shape:

    # HELP aios_tpu_engine_ttft_seconds Time to first token
    # TYPE aios_tpu_engine_ttft_seconds histogram
    aios_tpu_engine_ttft_seconds_bucket{le="0.1",model="m"} 3
    ...

Design points:
  * one process-wide default ``REGISTRY``; tests build private registries;
  * label children are created on demand via ``labels(**kv)`` and cached —
    hot paths resolve the child ONCE and call ``inc()``/``observe()`` on
    it, which is a single locked float add;
  * a Gauge child can be backed by a callback (``set_function``), so slot
    occupancy / queue depth / KV-page gauges read live state at scrape
    time instead of requiring the hot loop to push updates;
  * per-metric child caps guard label-cardinality blowups (a runaway
    label turns into a capped, counted overflow series, not an OOM).
"""

from __future__ import annotations

import math
import re
import threading
from typing import Callable, Dict, Iterable, List, Optional, Tuple

_NAME_RE = re.compile(r"^[a-z_:][a-z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-z_][a-z0-9_]*$")

# Bounds the children one metric may hold: labels are sometimes derived
# from external input (tool names, model names) and an unbounded child
# map is a slow memory leak. The 1024th distinct label set collapses
# into a single overflow child.
MAX_CHILDREN = 1024
_OVERFLOW_KEY = ("__overflow__",)

# Latency-shaped default buckets (seconds): decode dispatches are
# O(10 ms), RPC fan-outs O(100 ms), XLA compiles O(10 s).
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _format_labels(names: Tuple[str, ...], values: Tuple[str, ...],
                   extra: str = "") -> str:
    pairs = [
        f'{n}="{_escape_label_value(v)}"' for n, v in zip(names, values)
    ]
    if extra:
        pairs = [extra] + pairs
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _format_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Child:
    """One (metric, label-values) time series."""

    __slots__ = ("_lock", "_value", "_fn")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:  # scrape must never take the service down
                return float("nan")
        with self._lock:
            return self._value


class CounterChild(_Child):
    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters can only increase")
        with self._lock:
            self._value += amount


class GaugeChild(_Child):
    def set(self, value: float) -> None:
        with self._lock:
            self._fn = None
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def set_function(self, fn: Callable[[], float]) -> None:
        """Pull the gauge's value from ``fn`` at scrape time (live state —
        occupancy, queue depth — without hot-path pushes). Re-registering
        replaces the previous callback (model reload)."""
        with self._lock:
            self._fn = fn


class HistogramChild:
    __slots__ = ("_lock", "buckets", "counts", "_sum", "_count")

    def __init__(self, buckets: Tuple[float, ...]) -> None:
        self._lock = threading.Lock()
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)  # +1 for +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self._sum += v
            self._count += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self.counts[i] += 1
                    return
            self.counts[-1] += 1

    @property
    def sample_count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sample_sum(self) -> float:
        with self._lock:
            return self._sum


class Metric:
    """Base: a named family of children keyed by label values."""

    kind = "untyped"

    def __init__(
        self,
        name: str,
        help: str,
        labelnames: Iterable[str] = (),
        registry: Optional["MetricsRegistry"] = None,
    ) -> None:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.help = help
        self.labelnames: Tuple[str, ...] = tuple(labelnames)
        for ln in self.labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()
        self.overflows = 0
        if not self.labelnames:
            # the unlabeled series exists from registration (renders 0)
            self._children[()] = self._new_child()
        if registry is None:
            registry = REGISTRY
        registry.register(self)

    def _new_child(self):
        raise NotImplementedError

    def labels(self, **labelvalues: str):
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(sorted(labelvalues))}"
            )
        key = tuple(str(labelvalues[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                if len(self._children) >= MAX_CHILDREN:
                    # cardinality guard: collapse the runaway label set
                    self.overflows += 1
                    child = self._children.get(_OVERFLOW_KEY)
                    if child is None:
                        child = self._new_child()
                        self._children[_OVERFLOW_KEY] = child
                    return child
                child = self._new_child()
                self._children[key] = child
            return child

    def remove(self, **labelvalues: str) -> None:
        """Drop one child series. For pull-gauges whose owner is going
        away for good (e.g. a replica pool shrinking on hot-swap) —
        without this the dead series scrapes as a misleading constant
        forever. No-op when the series does not exist."""
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(sorted(labelvalues))}"
            )
        key = tuple(str(labelvalues[n]) for n in self.labelnames)
        with self._lock:
            self._children.pop(key, None)

    def _iter_children(self):
        with self._lock:
            return list(self._children.items())

    def _unlabeled(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; use .labels()"
            )
        return self._children[()]


class Counter(Metric):
    kind = "counter"

    def _new_child(self) -> CounterChild:
        return CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._unlabeled().inc(amount)

    @property
    def value(self) -> float:
        return sum(c.value for _, c in self._iter_children())


class Gauge(Metric):
    kind = "gauge"

    def _new_child(self) -> GaugeChild:
        return GaugeChild()

    def set(self, value: float) -> None:
        self._unlabeled().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._unlabeled().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._unlabeled().dec(amount)

    def set_function(self, fn: Callable[[], float]) -> None:
        self._unlabeled().set_function(fn)

    @property
    def value(self) -> float:
        return sum(c.value for _, c in self._iter_children())


class Histogram(Metric):
    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        labelnames: Iterable[str] = (),
        buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
        registry: Optional["MetricsRegistry"] = None,
    ) -> None:
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket")
        super().__init__(name, help, labelnames, registry=registry)

    def _new_child(self) -> HistogramChild:
        return HistogramChild(self.buckets)

    def observe(self, value: float) -> None:
        self._unlabeled().observe(value)


class MetricsRegistry:
    """Collection of metrics with text exposition.

    ``REGISTRY`` is the process-wide default every instrument in
    ``obs.instruments`` registers into; tests pass private registries.
    """

    def __init__(self) -> None:
        self._metrics: Dict[str, Metric] = {}
        self._lock = threading.Lock()

    def register(self, metric: Metric) -> None:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None and existing is not metric:
                raise ValueError(f"duplicate metric name {metric.name!r}")
            self._metrics[metric.name] = metric

    def unregister(self, name: str) -> None:
        with self._lock:
            self._metrics.pop(name, None)

    def collect(self) -> List[Metric]:
        with self._lock:
            return [self._metrics[n] for n in sorted(self._metrics)]

    # -- test/inspection helpers -------------------------------------------

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def sample(self, name: str, labels: Optional[Dict[str, str]] = None) -> float:
        """Current value of one series (counters/gauges) — test helper."""
        m = self.get(name)
        if m is None:
            raise KeyError(name)
        key = tuple(str((labels or {})[n]) for n in m.labelnames)
        child = m._children.get(key)
        if child is None:
            return 0.0
        return child.value

    def render(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        out: List[str] = []
        for m in self.collect():
            out.append(f"# HELP {m.name} {m.help}")
            out.append(f"# TYPE {m.name} {m.kind}")
            for key, child in sorted(m._iter_children()):
                if key == _OVERFLOW_KEY:
                    names, values = ("overflow",), ("true",)
                else:
                    names, values = m.labelnames, key
                if isinstance(child, HistogramChild):
                    with child._lock:
                        counts = list(child.counts)
                        s, n = child._sum, child._count
                    cum = 0
                    for b, c in zip(
                        list(m.buckets) + [math.inf], counts
                    ):
                        cum += c
                        le = _format_value(b)
                        lbl = _format_labels(names, values, f'le="{le}"')
                        out.append(f"{m.name}_bucket{lbl} {cum}")
                    lbl = _format_labels(names, values)
                    out.append(f"{m.name}_sum{lbl} {_format_value(s)}")
                    out.append(f"{m.name}_count{lbl} {n}")
                else:
                    lbl = _format_labels(names, values)
                    out.append(f"{m.name}{lbl} {_format_value(child.value)}")
        return "\n".join(out) + "\n"


REGISTRY = MetricsRegistry()
