"""Black-box metrics time series: a bounded in-process ring over the
metric registry.

Every observability layer below this one is *current-value only*:
``/metrics`` exposes the instant, a flight-recorder snapshot freezes
request timelines — but nothing in the process can answer "what did the
burn rate do over the last five minutes" after the fact. This module is
that memory: a background sampler walks **every registered instrument**
on a fixed cadence and appends one point per live series —

  * **counters** (and histogram buckets / counts / sums) as **deltas**
    since the previous pass, with Prometheus-style counter-reset
    handling (a respawned process's lower total becomes the delta,
    never a negative spike);
  * **gauges** raw (fn-backed gauges evaluate at sample time; a NaN —
    the scrape-must-never-crash sentinel — is skipped, not stored);

into a two-level store with a fixed memory budget: a **raw ring**
(default 1 s step x 5 min) cascading into a **downsampled wheel**
(default 10 s buckets x 1 h) that keeps sum/count/min/max per bucket, so
windowed queries stay exact after the raw points have rotated out. A
cardinality cap bounds the series map; series past the cap are counted
on ``aios_tpu_tsdb_dropped_series_total`` — never silently truncated.

Armed by ``AIOS_TPU_TSDB`` (the faults/devprof pattern): the module
global :data:`TSDB` stays ``None`` when off, every integration point is
one attribute-is-None check, and the sampler only *reads* the registry —
token streams, dispatch counts, and compile counters are pinned
identical ON vs OFF (tests/test_tsdb.py).

Queried at ``GET /debug/tsdb`` with a small closed-verb expression form
(:data:`QUERY_VERBS` — select by name + label matchers, then ``raw`` /
``rate`` / ``avg`` / ``min`` / ``max`` / ``pNN`` over a window), and
federated fleet-wide at ``/debug/tsdb/fleet`` with the host label
injected (the exposition-merge discipline). Incident bundles
(obs/incidents.py) freeze :meth:`Tsdb.window_snapshot` ranges around
their trigger.

Locking: ``_lock`` (registry role "tsdb") guards the series map and the
per-series deques only. Registry reads (which take metric locks) and
metric emission happen OUTSIDE it; queries copy points under it and
aggregate after release.
"""

from __future__ import annotations

import logging
import math
import os
import re
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from ..analysis.locks import make_lock
from .metrics import (
    _OVERFLOW_KEY,
    Gauge,
    Histogram,
    HistogramChild,
    MetricsRegistry,
    REGISTRY,
)

log = logging.getLogger("aios.tsdb")

# THE closed query-verb enum (pinned by test_obs_lint, AST-iterated at
# metric registration): ``raw`` returns the windowed points themselves,
# ``rate`` is summed deltas / window (delta-kind series only), the
# aggregates fold gauge points (raw or wheel), and the ``pNN`` verbs
# compute a Prometheus-style histogram quantile from summed bucket
# deltas over the window. A new verb is a reviewed enum change, never a
# stray string in a query parser.
QUERY_VERBS = ("raw", "rate", "avg", "min", "max", "p50", "p90", "p95",
               "p99")

_PNN_RE = re.compile(r"^p(\d{2})$")

# How a series' samples are produced — "delta" covers counters,
# histogram buckets, and histogram count/sum (monotonic sources sampled
# as per-pass deltas); "gauge" is sampled raw.
SERIES_KINDS = ("delta", "gauge")

# Hard ceiling on points one ``raw`` query or window snapshot returns
# per series (the raw ring itself is the real bound; this guards a
# misconfigured huge ring from ballooning one HTTP response).
_MAX_POINTS = 4096

# Bound on the distinct-dropped-keys set backing the dropped_series
# counter: past it, drops still count but new keys stop being tracked
# individually (the set itself must not become the leak it guards).
_MAX_DROPPED_KEYS = 65536


def _env_float(name: str, default: float, lo: float, hi: float) -> float:
    try:
        v = float(os.environ.get(name, "") or default)
    except ValueError:
        return default
    return min(max(v, lo), hi)


class TsdbConfig:
    """Knobs (docs/CONFIG.md "Black-box time series" rows). Read live
    from the environment at construction — tests and deploy scripts
    reconfigure per process."""

    def __init__(self) -> None:
        self.enabled = os.environ.get(
            "AIOS_TPU_TSDB", ""
        ).lower() in ("1", "true", "on")
        self.step_secs = _env_float("AIOS_TPU_TSDB_STEP_SECS", 1.0,
                                    0.05, 60.0)
        self.raw_secs = _env_float("AIOS_TPU_TSDB_RAW_SECS", 300.0,
                                   1.0, 3600.0)
        self.wheel_step_secs = _env_float(
            "AIOS_TPU_TSDB_WHEEL_STEP_SECS", 10.0, 1.0, 600.0
        )
        self.wheel_secs = _env_float("AIOS_TPU_TSDB_WHEEL_SECS", 3600.0,
                                     10.0, 86400.0)
        self.max_series = int(_env_float(
            "AIOS_TPU_TSDB_MAX_SERIES", 4096, 16, 1 << 20
        ))

    @property
    def raw_slots(self) -> int:
        return max(int(self.raw_secs / self.step_secs), 1)

    @property
    def wheel_slots(self) -> int:
        return max(int(self.wheel_secs / self.wheel_step_secs), 1)


class _Series:
    """One sampled time series: identity + previous raw value (for
    deltas) + the raw ring + the downsampled wheel. All mutable state is
    guarded by the owning :class:`Tsdb`'s ``_lock``."""

    __slots__ = ("name", "labels", "kind", "prev", "raw", "wheel",
                 "bucket_t", "b_sum", "b_count", "b_min", "b_max")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...],
                 kind: str, raw_slots: int, wheel_slots: int) -> None:
        self.name = name
        self.labels = labels
        self.kind = kind
        self.prev: Optional[float] = None
        self.raw: deque = deque(maxlen=raw_slots)  # (t, v)
        self.wheel: deque = deque(maxlen=wheel_slots)
        self.bucket_t: Optional[float] = None  # open wheel bucket start
        self.b_sum = 0.0
        self.b_count = 0
        self.b_min = math.inf
        self.b_max = -math.inf

    def append(self, t: float, v: float, wheel_step: float) -> None:
        self.raw.append((t, v))
        bt = math.floor(t / wheel_step) * wheel_step
        if self.bucket_t is not None and bt != self.bucket_t:
            self.wheel.append((self.bucket_t, self.b_sum, self.b_count,
                               self.b_min, self.b_max))
            self.bucket_t = None
        if self.bucket_t is None:
            self.bucket_t = bt
            self.b_sum, self.b_count = 0.0, 0
            self.b_min, self.b_max = math.inf, -math.inf
        self.b_sum += v
        self.b_count += 1
        self.b_min = min(self.b_min, v)
        self.b_max = max(self.b_max, v)

    def points(self, start: float, end: float) -> List[Tuple[float, float]]:
        """Raw points in [start, end], falling back to wheel buckets
        (rendered as (bucket_start, avg)) for the part of the window the
        raw ring no longer covers."""
        raw = [(t, v) for t, v in self.raw if start <= t <= end]
        raw_t0 = raw[0][0] if raw else end
        out = [
            (bt, (s / c if self.kind == "gauge" else s))
            for bt, s, c, _, _ in self.wheel
            if start <= bt <= end and bt < raw_t0 and c
        ]
        out.extend(raw)
        return out[-_MAX_POINTS:]


def _series_key(name: str, labels: Tuple[Tuple[str, str], ...]) -> tuple:
    return (name, labels)


class Tsdb:
    """The sampler + store + query engine. ``clock`` is injectable (and
    the sampler thread optional) for deterministic ring/wheel tests."""

    def __init__(self, cfg: Optional[TsdbConfig] = None,
                 registry: Optional[MetricsRegistry] = None,
                 clock: Callable[[], float] = time.time) -> None:
        self.cfg = cfg or TsdbConfig()
        self.registry = registry if registry is not None else REGISTRY
        self.clock = clock
        self._lock = make_lock("tsdb")
        self._series: Dict[tuple, _Series] = {}  #: guarded_by _lock
        self._dropped: set = set()  #: guarded_by _lock
        self._dropped_total = 0  #: guarded_by _lock
        self._passes = 0  #: guarded_by _lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._register_metrics()

    def _register_metrics(self) -> None:
        """Pre-register every query-verb child by iterating the closed
        QUERY_VERBS enum (the autoscale/SLO registration pattern, pinned
        by test_obs_lint) and wire the live-state gauges."""
        from . import instruments

        for verb in QUERY_VERBS:
            instruments.TSDB_QUERIES.labels(verb=verb)
        instruments.TSDB_SERIES.set_function(self.series_count)
        instruments.TSDB_DROPPED.set_function(
            lambda: float(self._dropped_total)
        )

    # -- sampling -------------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()  # restartable: bench/test arms cycle stop/start
        self._thread = threading.Thread(
            target=self._loop, name="tsdb-sampler", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.sample_once()
            except Exception:  # noqa: BLE001 - the sampler must outlive
                # any single bad pass; the log carries the evidence
                log.exception("tsdb sample pass failed")
            self._stop.wait(self.cfg.step_secs)

    def sample_once(self, now: Optional[float] = None) -> int:
        """One sampler pass: read every registered instrument (metric
        locks only — the registry is the sole contact surface with the
        serving plane), then fold the batch into the ring under the tsdb
        lock. Returns the number of points appended."""
        t = self.clock() if now is None else now
        batch: List[Tuple[str, Tuple[Tuple[str, str], ...], str, float]] = []
        for metric in self.registry.collect():
            try:
                self._read_metric(metric, batch)
            except Exception:  # noqa: BLE001 - one sick instrument must
                # not stop the pass; the rest of the registry still lands
                log.debug("tsdb read of %s failed", metric.name,
                          exc_info=True)
        appended = self._ingest(t, batch)
        from . import instruments

        instruments.TSDB_SAMPLES.inc()
        return appended

    def _read_metric(self, metric, batch: list) -> None:
        """Flatten one metric into (name, labels, kind, raw_value) rows.
        Histograms expand into per-bucket rows (``le`` label, cumulative
        counts — deltas computed downstream) plus _count/_sum rows."""
        is_hist = isinstance(metric, Histogram)
        kind = "gauge" if isinstance(metric, Gauge) else "delta"
        for key, child in metric._iter_children():
            if key == _OVERFLOW_KEY:
                labels: Tuple[Tuple[str, str], ...] = (("overflow", "true"),)
            else:
                labels = tuple(zip(metric.labelnames, key))
            if is_hist and isinstance(child, HistogramChild):
                with child._lock:
                    counts = list(child.counts)
                    h_sum, h_count = child._sum, child._count
                cum = 0
                for b, c in zip(list(metric.buckets) + [math.inf], counts):
                    cum += c
                    le = "+Inf" if b == math.inf else repr(float(b))
                    batch.append((
                        f"{metric.name}_bucket",
                        labels + (("le", le),), "delta", float(cum),
                    ))
                batch.append((f"{metric.name}_count", labels, "delta",
                              float(h_count)))
                batch.append((f"{metric.name}_sum", labels, "delta",
                              float(h_sum)))
            else:
                v = child.value
                if v != v:  # NaN: a failing fn-backed gauge — skip
                    continue
                batch.append((metric.name, labels, kind, float(v)))

    def _ingest(self, t: float, batch: list) -> int:
        cfg = self.cfg
        appended = 0
        dropped = 0
        with self._lock:
            for name, labels, kind, value in batch:
                key = _series_key(name, labels)
                s = self._series.get(key)
                if s is None:
                    if len(self._series) >= cfg.max_series:
                        # the explicit-drop contract: count, never
                        # silently truncate (one count per NEW series)
                        if key not in self._dropped:
                            if len(self._dropped) < _MAX_DROPPED_KEYS:
                                self._dropped.add(key)
                            self._dropped_total += 1
                            dropped += 1
                        continue
                    s = self._series[key] = _Series(
                        name, labels, kind, cfg.raw_slots, cfg.wheel_slots
                    )
                if kind == "delta":
                    prev = s.prev
                    s.prev = value
                    if prev is None:
                        continue  # rate needs two observations
                    # counter-reset (respawn): the new total IS the
                    # delta since the reset — never a negative spike
                    delta = value - prev if value >= prev else value
                    s.append(t, delta, cfg.wheel_step_secs)
                else:
                    s.append(t, value, cfg.wheel_step_secs)
                appended += 1
            self._passes += 1
        if dropped:
            log.warning("tsdb cardinality cap (%d): %d new series dropped",
                        cfg.max_series, dropped)
        return appended

    # -- introspection --------------------------------------------------------

    def series_count(self) -> float:
        with self._lock:
            return float(len(self._series))

    def dropped_series(self) -> int:
        with self._lock:
            return self._dropped_total

    def stats(self) -> dict:
        with self._lock:
            return {
                "series": len(self._series),
                "dropped_series": self._dropped_total,
                "passes": self._passes,
                "step_secs": self.cfg.step_secs,
                "raw_secs": self.cfg.raw_secs,
                "wheel_step_secs": self.cfg.wheel_step_secs,
                "wheel_secs": self.cfg.wheel_secs,
                "max_series": self.cfg.max_series,
            }

    # -- queries --------------------------------------------------------------

    def _select(self, name: str,
                matchers: Optional[Dict[str, str]]) -> List[_Series]:
        """Series whose name matches exactly and whose labels are a
        superset of the matchers. Caller must NOT hold ``_lock``."""
        want = matchers or {}
        with self._lock:
            out = []
            for s in self._series.values():
                if s.name != name:
                    continue
                have = dict(s.labels)
                if all(have.get(k) == v for k, v in want.items()):
                    out.append(s)
            return out

    def query(self, name: str, matchers: Optional[Dict[str, str]] = None,
              verb: str = "raw", window: Optional[float] = None,
              now: Optional[float] = None) -> dict:
        """The closed-verb expression form behind ``GET /debug/tsdb``:
        select series by name + label matchers, then apply one verb over
        the trailing ``window`` seconds. Unknown verbs raise ValueError
        (the HTTP layer renders a 400 listing QUERY_VERBS)."""
        if verb not in QUERY_VERBS:
            raise ValueError(
                f"unknown verb {verb!r}; one of {', '.join(QUERY_VERBS)}"
            )
        t = self.clock() if now is None else now
        w = float(window) if window else self.cfg.raw_secs
        start = t - w
        from . import instruments

        instruments.TSDB_QUERIES.labels(verb=verb).inc()
        m = _PNN_RE.match(verb)
        if m:
            series = self._quantile_series(
                name, matchers, int(m.group(1)) / 100.0, start, t
            )
        else:
            series = []
            for s in self._select(name, matchers):
                with self._lock:
                    pts = s.points(start, t)
                    kind = s.kind
                    labels = dict(s.labels)
                entry: dict = {"name": name, "labels": labels, "kind": kind}
                if verb == "raw":
                    entry["points"] = [[round(pt, 3), pv] for pt, pv in pts]
                elif verb == "rate":
                    entry["value"] = (
                        sum(pv for _, pv in pts) / w if kind == "delta"
                        else None
                    )
                elif not pts:
                    entry["value"] = None
                elif verb == "avg":
                    entry["value"] = sum(pv for _, pv in pts) / len(pts)
                elif verb == "min":
                    entry["value"] = min(pv for _, pv in pts)
                else:  # max
                    entry["value"] = max(pv for _, pv in pts)
                series.append(entry)
        series.sort(key=lambda e: sorted(e["labels"].items()))
        return {"name": name, "verb": verb, "window_secs": w,
                "now": round(t, 3), "series": series}

    def _quantile_series(self, name: str,
                         matchers: Optional[Dict[str, str]], q: float,
                         start: float, end: float) -> List[dict]:
        """pNN over a histogram family: group the ``<name>_bucket``
        delta series by labels-minus-le, sum each bucket's deltas over
        the window, and interpolate the quantile inside its bucket (the
        Prometheus histogram_quantile shape)."""
        groups: Dict[tuple, List[Tuple[float, float]]] = {}
        for s in self._select(f"{name}_bucket", matchers):
            with self._lock:
                total = sum(pv for _, pv in s.points(start, end))
                labels = dict(s.labels)
            le = labels.pop("le", "")
            bound = math.inf if le == "+Inf" else float(le)
            groups.setdefault(tuple(sorted(labels.items())), []).append(
                (bound, total)
            )
        out = []
        for labelkey, buckets in groups.items():
            buckets.sort()
            # de-cumulate: sampled values are cumulative counts, so the
            # summed deltas are cumulative too
            total = buckets[-1][1] if buckets else 0.0
            value: Optional[float] = None
            if total > 0:
                rank = q * total
                prev_bound, prev_cum = 0.0, 0.0
                for bound, cum in buckets:
                    if cum >= rank:
                        if bound == math.inf:
                            value = prev_bound
                        else:
                            span = cum - prev_cum
                            frac = ((rank - prev_cum) / span) if span else 0.0
                            value = prev_bound + (bound - prev_bound) * frac
                        break
                    prev_bound, prev_cum = bound, cum
            out.append({"name": name, "labels": dict(labelkey),
                        "kind": "delta", "value": value,
                        "samples": total})
        return out

    def window_snapshot(self, start: float, end: float,
                        max_series: int = 512) -> dict:
        """Every series' raw/wheel points inside [start, end] — the
        incident-bundle freeze. Bounded: at most ``max_series`` series
        land in the snapshot (name-sorted, so truncation is stable), the
        rest are counted in ``truncated`` — no silent loss."""
        with self._lock:
            all_series = sorted(
                self._series.values(),
                key=lambda s: (s.name, s.labels),
            )
        out = []
        truncated = 0
        for s in all_series:
            with self._lock:
                pts = s.points(start, end)
                labels = dict(s.labels)
                kind = s.kind
            if not pts:
                continue
            if len(out) >= max_series:
                truncated += 1
                continue
            out.append({
                "name": s.name, "labels": labels, "kind": kind,
                "points": [[round(pt, 3), pv] for pt, pv in pts],
            })
        return {"start": round(start, 3), "end": round(end, 3),
                "series": out, "truncated": truncated}

    def clear(self) -> None:
        """Test isolation."""
        with self._lock:
            self._series.clear()
            self._dropped.clear()
            self._dropped_total = 0
            self._passes = 0


# -- process-wide instance ----------------------------------------------------

# The one ring obs/http.py, incidents, and autoscale annotations read;
# None until maybe_start() arms it — every integration point is a single
# attribute-is-None check (the faults/devprof pattern), so an unarmed
# process pays nothing.
TSDB: Optional[Tsdb] = None


def enabled() -> bool:
    return TSDB is not None


def maybe_start() -> Optional[Tsdb]:
    """Arm the ring for this process when ``AIOS_TPU_TSDB`` asks for it
    (called by maybe_start_metrics_server — every real serving process
    passes through there). Idempotent."""
    global TSDB
    cfg = TsdbConfig()
    if TSDB is not None or not cfg.enabled:
        return TSDB
    TSDB = Tsdb(cfg)
    TSDB.start()
    log.info(
        "tsdb armed: step=%.2fs raw=%.0fs wheel=%.0fs/%.0fs max_series=%d",
        cfg.step_secs, cfg.raw_secs, cfg.wheel_step_secs, cfg.wheel_secs,
        cfg.max_series,
    )
    return TSDB


def install(t: Optional[Tsdb]) -> Optional[Tsdb]:
    """Swap the process-wide ring (tests); returns the previous."""
    global TSDB
    prev, TSDB = TSDB, t
    return prev


def handle_query(query: Dict[str, List[str]]) -> Tuple[dict, int]:
    """Map a parsed ``/debug/tsdb`` query string onto the expression
    form — ``?name=<metric>`` selects, repeated ``match=key:value``
    filters, ``verb=`` one of :data:`QUERY_VERBS` (default ``raw``),
    ``window=<secs>`` bounds. No ``name`` returns the ring's stats.
    Returns (payload, http_status); shared by obs/http.py and the
    fleet federation (each peer answers the SAME query locally)."""
    t = TSDB
    if t is None:
        return {"error": "tsdb not armed (set AIOS_TPU_TSDB=1)"}, 404

    def q(key: str, default: str = "") -> str:
        return query.get(key, [default])[0]

    name = q("name")
    if not name:
        return {"stats": t.stats()}, 200
    matchers: Dict[str, str] = {}
    for m in query.get("match", []):
        k, sep, v = m.partition(":")
        if not sep or not k:
            return {"error": f"bad matcher {m!r}; want key:value"}, 400
        matchers[k] = v
    raw_window = q("window")
    try:
        window = float(raw_window) if raw_window else None
    except ValueError:
        return {"error": f"bad window {raw_window!r}"}, 400
    try:
        return t.query(name, matchers or None, verb=q("verb", "raw"),
                       window=window), 200
    except ValueError as exc:  # unknown verb -> 400 listing QUERY_VERBS
        return {"error": str(exc)}, 400


def trend(name: str, matchers: Optional[Dict[str, str]] = None,
          window: float = 60.0) -> Optional[dict]:
    """Compact first/last/avg over the trailing window for ONE series —
    the autoscale-decision annotation ("the burn trend it acted on").
    None when the ring is off or the series has no points."""
    t = TSDB
    if t is None:
        return None
    now = t.clock()
    best: Optional[dict] = None
    for s in t._select(name, matchers):
        with t._lock:
            pts = s.points(now - window, now)
        if not pts:
            continue
        vals = [pv for _, pv in pts]
        cand = {
            "first": round(vals[0], 6), "last": round(vals[-1], 6),
            "avg": round(sum(vals) / len(vals), 6),
            "points": len(vals), "window_secs": window,
        }
        if best is None or cand["last"] > best["last"]:
            best = cand  # worst (highest) series wins the annotation
    return best
