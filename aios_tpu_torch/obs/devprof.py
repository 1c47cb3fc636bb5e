"""Device-time attribution on the card: a per-graph cost ledger, dispatch
timing from CUDA events, and the roofline shares of the card.

The counterpart of ``aios_tpu/obs/devprof.py``, redesigned for CUDA graphs.
The API and its semantics are the JAX module's: the closed
:data:`GRAPH_KINDS` enum, :class:`DevprofLedger` with ``register`` /
``note`` / ``sample`` / ``mean_s`` / ``totals``, ``ledgers_for``,
``snapshot_all``, ``enabled`` (``AIOS_TPU_DEVPROF``) and ``sample_every``
(``AIOS_TPU_DEVPROF_SAMPLE``, default 32), and the engine's hot-path
contract: one attribute ``None`` check when it is off. What differs:

  * **Timing.** A sampled dispatch records a pair of CUDA events around its
    graph replays on the stream they run on; the elapsed time is read where
    the dispatch already reads its result back, so a sample adds no
    synchronization. The JAX module times host wall to block-until-ready.
    A megagraph dispatch is timed whole, never tick by tick. On the CPU the
    bodies run inline and a sample is their host wall time.
  * **Cost.** The JAX engine registers ``compiled.cost_analysis()`` per
    executable. Here each captured graph registers its capture seconds and
    an analytic cost from the model's configuration and the dispatch's
    shapes (:func:`forward_cost`): FLOPs are 2 x the weight elements x the
    rows for the projections and the lm_head, plus attention's QK^T and PV
    over the rows each query attends; bytes are the serving weights, the
    K/V rows read and the logits written. A dispatch charges the cost of
    the rows it really attends (the slots' lengths at dispatch); a
    megagraph charges its ticks that ran (k) times a tick's cost.
  * **Peaks.** :data:`DEVICE_PEAKS` holds the card the port runs on, keyed
    by ``torch.cuda.get_device_name()``; an unknown device keeps raw
    seconds and omits the MFU / HBM-utilization gauges.
  * **Capture.** ``/debug/profile?secs=N`` runs a bounded, one-at-a-time
    ``torch.profiler`` trace (CUDA activity) into
    ``AIOS_TPU_DEVPROF_DUMP_DIR``. The profiler can drop events under load:
    a capture is a triage aid and feeds no gauge. It starts and stops the
    profiler only while no engine dispatches (every live engine's lock
    held, :func:`track_engine`): a stop that raced a CUDA graph replay on a
    serving thread hung the whole process on the card, the capture thread
    inside the profiler's stop and the scheduler inside ``replay``.

With devprof on, token streams and dispatch counts are those with it off.
This module imports no torch when it is imported.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
import weakref
from typing import Dict, Optional, Tuple

from ..analysis.locks import make_lock

log = logging.getLogger("aios.obs")

__all__ = [
    "GRAPH_KINDS", "DEVICE_PEAKS", "CAPTURE_MAX_SECS", "DevprofLedger",
    "CaptureBusy", "CaptureDisabled", "enabled", "sample_every",
    "local_device_kind", "ledgers_for", "snapshot_all", "start_capture",
    "capture_status", "forward_cost", "prepare_capture",
]

# The closed enum of serving-graph kinds, the JAX module's (the port has no
# sequence-sharded prefill, so "seq_prefill" never dispatches here). Call
# sites pass these literals; ``register`` rejects anything else.
GRAPH_KINDS = (
    "step",          # plain/unified decode (the dispatch-worker path)
    "masked",        # grammar-masked 1-step decode
    "prefill",       # whole-prompt prefill buckets
    "seq_prefill",   # sequence-sharded (sp-axis) prefill twins
    "chunk",         # chunked-admission mid/final chunks
    "spec",          # n-gram speculative verify rounds
    "draft_spec",    # fused draft-model propose+verify rounds
    "draft_ingest",  # bulk draft-KV catch-up writes
    "jump",          # grammar jump-ahead multi-token verify
    "mega",          # multi-tick decode megagraph (K ticks per dispatch)
    "restore",       # host-tier KV restore scatters
    "hist",          # prefix-hit history backfill
)

# Published peaks of the card, keyed by ``torch.cuda.get_device_name()``:
# (dense bf16 FLOP/s, HBM bytes/s). An unmatched device keeps raw
# device-seconds and omits the ratio gauges rather than invent a
# denominator.
DEVICE_PEAKS: Dict[str, Tuple[float, float]] = {
    "NVIDIA H100 80GB HBM3": (989e12, 3.35e12),
}

# /debug/profile hard cap: a bounded capture, never one left running.
CAPTURE_MAX_SECS = 60.0

_DEFAULT_SAMPLE_EVERY = 32


def enabled() -> bool:
    """Whether ``AIOS_TPU_DEVPROF`` arms the ledger (read when an engine is
    built: a live engine never grows instrumentation mid-serving)."""
    return os.environ.get("AIOS_TPU_DEVPROF", "").lower() in (
        "1", "on", "true", "yes"
    )


def sample_every() -> int:
    """``AIOS_TPU_DEVPROF_SAMPLE``: time every Nth dispatch (default 32,
    floor 1 = every dispatch)."""
    raw = os.environ.get("AIOS_TPU_DEVPROF_SAMPLE", "").strip()
    if not raw:
        return _DEFAULT_SAMPLE_EVERY
    try:
        return max(int(raw), 1)
    except ValueError:
        log.warning(
            "AIOS_TPU_DEVPROF_SAMPLE=%r ignored (expected a positive "
            "integer)", raw,
        )
        return _DEFAULT_SAMPLE_EVERY


def local_device_kind(device=None) -> str:
    """``torch.cuda.get_device_name`` of ``device`` (the current CUDA
    device when None), or "" on a host without CUDA. A CUDA device that
    cannot be named raises."""
    import torch

    if device is not None and getattr(device, "type", "cuda") != "cuda":
        return ""
    if not torch.cuda.is_available():
        return ""
    return torch.cuda.get_device_name(device)


def resolve_peaks(device_kind: str) -> Optional[Tuple[float, float]]:
    """(peak FLOP/s, peak HBM bytes/s) of a device, or None when it is not
    in the table (the utilization gauges are then omitted)."""
    if not device_kind:
        return None
    return DEVICE_PEAKS.get(device_kind)


def forward_cost(cfg, rows: int, attended: float, logit_rows: int,
                 weight_bytes: float, kv_rows_read: float,
                 kv_row_bytes: float) -> Tuple[float, float]:
    """(FLOPs, bytes) of one forward over ``rows`` token rows.

    FLOPs: 2 x the weight elements a token row multiplies (q, k, v, o and
    the FFN of every layer; for a mixture-of-experts layer the router and
    the ``num_experts_per_tok`` experts it picks) x ``rows``, plus
    2 x E x V for each of ``logit_rows`` lm_head rows, plus QK^T and PV,
    4 x H x D per layer for each (query row, attended row) pair, of which
    there are ``attended``. Bytes: ``weight_bytes`` (the serving leaves the
    dispatch streams), ``kv_rows_read`` K/V rows of ``kv_row_bytes`` each
    (every layer's K and V of one position, scales included), and the f32
    logits written."""
    E, L = cfg.hidden_size, cfg.num_layers
    attn_w = E * cfg.q_dim * 2 + E * cfg.kv_dim * 2
    if cfg.moe:
        ffn_w = E * cfg.num_experts + (
            cfg.num_experts_per_tok * 3 * E * cfg.expert_dim)
    else:
        ffn_w = 3 * E * cfg.intermediate_size
    flops = (2.0 * L * (attn_w + ffn_w) * rows
             + 2.0 * E * cfg.vocab_size * logit_rows
             + 4.0 * L * cfg.num_heads * cfg.head_dim * attended)
    nbytes = (float(weight_bytes) + float(kv_rows_read) * kv_row_bytes
              + 4.0 * cfg.vocab_size * logit_rows)
    return flops, nbytes


class _GraphStat:
    """Per-graph-kind accumulators. ``sampled_*`` sum over the sampled
    dispatches only; the estimated total device time extrapolates their
    mean over every dispatch."""

    __slots__ = (
        "dispatches", "est_flops", "est_bytes", "compiles",
        "compile_seconds", "samples", "sampled_seconds", "sampled_flops",
        "sampled_bytes",
    )

    def __init__(self) -> None:
        self.dispatches = 0
        self.est_flops = 0.0
        self.est_bytes = 0.0
        self.compiles = 0
        self.compile_seconds = 0.0
        self.samples = 0
        self.sampled_seconds = 0.0
        self.sampled_flops = 0.0
        self.sampled_bytes = 0.0


# per-model WeakSets of live ledgers (one per replica engine): the scrape
# gauges and /debug/devprof sum over them. Plain lock: registration happens
# at engine construction and debug reads only, never on a dispatch path.
_LEDGERS: Dict[str, "weakref.WeakSet[DevprofLedger]"] = {}
_reg_lock = threading.Lock()


def ledgers_for(model: str) -> "weakref.WeakSet[DevprofLedger]":
    with _reg_lock:
        return _LEDGERS.setdefault(model, weakref.WeakSet())


# every live engine: a profiler capture starts and stops only while it holds
# each one's dispatch lock (``quiesced``), so that no replay or launch runs
# on a serving thread meanwhile
_ENGINES: "weakref.WeakSet" = weakref.WeakSet()


def track_engine(engine) -> None:
    """Register ``engine`` (an object with a ``quiesced()`` context manager
    that holds off its dispatches) with the on-demand capture."""
    with _reg_lock:
        _ENGINES.add(engine)


@contextlib.contextmanager
def _engines_quiesced():
    """Hold off every live engine's dispatches for the block: each one's
    ``quiesced()`` entered in a fixed order (by id), none while another
    lock of this module is held."""
    with _reg_lock:
        engines = sorted(_ENGINES, key=id)
    with contextlib.ExitStack() as stack:
        for engine in engines:
            stack.enter_context(engine.quiesced())
        yield


Cost = Optional[Tuple[float, float]]


class DevprofLedger:
    """One engine's device-time ledger: per-graph dispatch counters, the
    analytic cost of each captured graph, and sampled device timings. All
    methods are O(1) dict work under the ledger's own lock, never a
    dispatch or a readback."""

    def __init__(self, model: str, device_kind: Optional[str] = None,
                 sample_n: Optional[int] = None) -> None:
        self.model = model
        self.device_kind = (
            device_kind if device_kind is not None else local_device_kind()
        )
        self.peaks = resolve_peaks(self.device_kind)
        self.sample_n = sample_n if sample_n is not None else sample_every()
        self._lock = make_lock("devprof")
        self._graphs: Dict[str, _GraphStat] = {}  #: guarded_by _lock
        # (kind, graph key) -> (flops, bytes) of one replay at the graph's
        # own shapes, registered at capture
        self._costs: Dict[Tuple[str, object], Tuple[float, float]] = {}  #: guarded_by _lock
        self._backlog = 0  #: guarded_by _lock
        self._last: Optional[Tuple[str, float]] = None  #: guarded_by _lock
        ledgers_for(model).add(self)

    # -- registration (warmup / first use) -----------------------------------

    def register(self, kind: str, key, cost: Cost, compile_s: float) -> None:
        """Record one captured graph: its capture seconds and the analytic
        cost of one replay (``cost`` (flops, bytes), or None). ``kind``
        must be a :data:`GRAPH_KINDS` member."""
        if kind not in GRAPH_KINDS:
            raise ValueError(
                f"unknown devprof graph kind {kind!r} (closed enum "
                f"GRAPH_KINDS — extend it with review)"
            )
        with self._lock:
            g = self._graphs.setdefault(kind, _GraphStat())
            g.compiles += 1
            g.compile_seconds += float(compile_s)
            if cost is not None:
                self._costs[(kind, key)] = cost

    # -- hot path ------------------------------------------------------------

    def note(self, kind: str, key=None, cost: Cost = None) -> bool:
        """Count one dispatch of ``kind``, charging ``cost`` (this
        dispatch's (flops, bytes)) or else the cost registered for
        ``key``; True when this dispatch is due a timing sample (the 1st,
        then every Nth)."""
        with self._lock:
            g = self._graphs.setdefault(kind, _GraphStat())
            g.dispatches += 1
            if cost is None:
                cost = self._costs.get((kind, key))
            if cost is not None:
                g.est_flops += cost[0]
                g.est_bytes += cost[1]
            return (g.dispatches - 1) % self.sample_n == 0

    def charge(self, kind: str, cost: Tuple[float, float]) -> None:
        """Charge a cost known only after the dispatch (a megagraph's k
        ticks) to the dispatch ``note`` counted with no cost."""
        with self._lock:
            g = self._graphs.setdefault(kind, _GraphStat())
            g.est_flops += cost[0]
            g.est_bytes += cost[1]

    def sample(self, kind: str, key, secs: float, cost: Cost = None) -> None:
        """Land one device-timing sample for ``kind`` with the dispatch's
        cost (else the cost registered for ``key``)."""
        with self._lock:
            g = self._graphs.setdefault(kind, _GraphStat())
            g.samples += 1
            g.sampled_seconds += secs
            if cost is None:
                cost = self._costs.get((kind, key))
            if cost is not None:
                g.sampled_flops += cost[0]
                g.sampled_bytes += cost[1]
            self._last = (kind, secs)

    def take_last_sample(self) -> Optional[Tuple[str, float]]:
        """Pop the most recent (kind, seconds) sample: the batcher joins it
        onto the flight-recorder event of the dispatch it just issued."""
        with self._lock:
            last, self._last = self._last, None
            return last

    # dispatch-worker backlog (the depth-2 double buffer): the worker samples
    # only when nothing is queued behind it

    def enqueue(self) -> None:
        with self._lock:
            self._backlog += 1

    def dequeue(self) -> None:
        with self._lock:
            self._backlog = max(self._backlog - 1, 0)

    def queue_depth(self) -> int:
        with self._lock:
            return self._backlog

    # -- reads ---------------------------------------------------------------

    def mean_s(self, kind: str) -> Optional[float]:
        """Mean sampled device-seconds per dispatch of ``kind`` (None
        before the first sample)."""
        with self._lock:
            g = self._graphs.get(kind)
            if g is None or not g.samples:
                return None
            return g.sampled_seconds / g.samples

    def totals(self, kind: str) -> Tuple[float, float, float, float, float,
                                         float, float]:
        """(dispatches, est_flops, est_bytes, samples, sampled_seconds,
        sampled_flops, sampled_bytes) for gauge aggregation across replica
        ledgers."""
        with self._lock:
            g = self._graphs.get(kind)
            if g is None:
                return (0.0,) * 7
            return (
                float(g.dispatches), g.est_flops, g.est_bytes,
                float(g.samples), g.sampled_seconds, g.sampled_flops,
                g.sampled_bytes,
            )

    def device_seconds(self, kind: str) -> float:
        """Estimated total device-busy seconds for ``kind``: the mean
        sampled time extrapolated over every dispatch."""
        with self._lock:
            g = self._graphs.get(kind)
            if g is None or not g.samples:
                return 0.0
            return g.sampled_seconds / g.samples * g.dispatches

    def snapshot(self) -> dict:
        """The ledger as a JSON-shaped dict (/debug/devprof): one entry per
        graph kind that dispatched or was captured, with the roofline
        shares only where the device's peaks are known."""
        with self._lock:
            graphs = {k: g for k, g in self._graphs.items()
                      if g.dispatches or g.compiles}
            out: dict = {
                "model": self.model,
                "device_kind": self.device_kind,
                "sample_every": self.sample_n,
                "graphs": {},
            }
            for kind in GRAPH_KINDS:
                g = graphs.get(kind)
                if g is None:
                    continue
                entry: dict = {
                    "dispatches": g.dispatches,
                    "compiles": g.compiles,
                    "compile_seconds": round(g.compile_seconds, 4),
                    "est_flops": g.est_flops,
                    "est_bytes": g.est_bytes,
                    "samples": g.samples,
                    "sampled_seconds": round(g.sampled_seconds, 6),
                }
                if g.samples:
                    per = g.sampled_seconds / g.samples
                    entry["device_seconds_per_dispatch"] = round(per, 6)
                    entry["device_seconds"] = round(per * g.dispatches, 4)
                if self.peaks is not None and g.sampled_seconds > 0:
                    pf, pb = self.peaks
                    if g.sampled_flops:
                        entry["mfu"] = float(
                            f"{g.sampled_flops / g.sampled_seconds / pf:.4g}"
                        )
                    if g.sampled_bytes:
                        entry["hbm_bw_util"] = float(
                            f"{g.sampled_bytes / g.sampled_seconds / pb:.4g}"
                        )
                out["graphs"][kind] = entry
            return out


class Timing:
    """One sampled dispatch's timing token: CUDA events recorded around
    the dispatch on its stream (``begin`` / ``stop``), or, off CUDA, the
    host clock. ``cost`` is the dispatch's (flops, bytes), which a
    megagraph sets once its k is known."""

    __slots__ = ("kind", "key", "cost", "_start", "_stop", "_t0", "_dt")

    def __init__(self, kind: str, key, cost: Cost, device) -> None:
        self.kind, self.key, self.cost = kind, key, cost
        self._start = self._stop = None
        self._dt: Optional[float] = None
        self._t0: Optional[float] = None
        if getattr(device, "type", "cpu") == "cuda":
            import torch

            self._start = torch.cuda.Event(enable_timing=True)
            self._stop = torch.cuda.Event(enable_timing=True)

    def begin(self) -> None:
        """Mark the start, right before the dispatch's first launch (an
        idle card would otherwise count the host's work in between);
        later calls do nothing."""
        if self._t0 is not None:
            return
        self._t0 = time.perf_counter()
        if self._start is not None:
            self._start.record()

    def stop(self) -> None:
        """Mark the end of the dispatch (right after its replays are
        issued, on the same stream)."""
        if self._stop is not None:
            self._stop.record()
        elif self._dt is None:
            self._dt = time.perf_counter() - self._t0

    def done(self) -> bool:
        """Whether the dispatch's stop mark has completed on the device."""
        if self._stop is None:
            return True
        return bool(self._stop.query())

    def seconds(self) -> float:
        """The dispatch's device seconds. Called after the dispatch's own
        readback, so the stop event has completed; one that has not raises
        rather than wait or read a silent 0."""
        if self._stop is None:
            if self._dt is None:
                self.stop()
            return self._dt
        if not self._stop.query():
            raise RuntimeError(
                f"devprof: the {self.kind} dispatch's stop event has not "
                "completed at its readback")
        return self._start.elapsed_time(self._stop) / 1e3


def snapshot_all(model: str = "") -> dict:
    """Every live ledger's snapshot, grouped per model (the /debug/devprof
    payload; replica ledgers list separately, the gauges do the summing)."""
    with _reg_lock:
        items = {
            m: list(s) for m, s in _LEDGERS.items()
            if (not model or m == model)
        }
    return {
        "capture": capture_status(),
        "models": {
            m: [led.snapshot() for led in leds]
            for m, leds in items.items() if leds
        },
    }


# -- on-demand profiler capture (/debug/profile) ----------------------------

class CaptureBusy(RuntimeError):
    """A capture is already running (HTTP 409)."""


class CaptureDisabled(RuntimeError):
    """AIOS_TPU_DEVPROF_DUMP_DIR is not set (HTTP 403)."""


_capture_lock = make_lock("profile_capture")  # capture start/stop only, never hot-path
_capture = {"busy": False, "path": "", "started": 0.0, "secs": 0.0,
            "error": ""}


def capture_status() -> dict:
    with _capture_lock:
        return dict(_capture)


def prepare_capture() -> None:
    """Initialize the profiler on the calling thread. Kineto initializes
    its client only on the thread that registered it (the one that loaded
    torch), and a capture started first from another thread records no
    device activity; a serving process calls this from its main thread
    before ``/debug/profile`` can start a capture on an HTTP thread."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities):
        pass


def start_capture(secs: float) -> dict:
    """Start a bounded ``torch.profiler`` trace (CPU activity, and CUDA
    activity where a card is present) into ``AIOS_TPU_DEVPROF_DUMP_DIR`` on
    a daemon thread; one at a time. The trace lands as
    ``<path>/trace.json`` (Chrome trace-event JSON) when the capture ends.
    Returns {profiling, path, secs}; raises :class:`CaptureDisabled` /
    :class:`CaptureBusy`. ``secs`` clamps to [0.05, CAPTURE_MAX_SECS]."""
    dump_dir = os.environ.get("AIOS_TPU_DEVPROF_DUMP_DIR", "").strip()
    if not dump_dir:
        raise CaptureDisabled(
            "profiler capture disabled: set AIOS_TPU_DEVPROF_DUMP_DIR"
        )
    secs = min(max(float(secs), 0.05), CAPTURE_MAX_SECS)
    with _capture_lock:
        if _capture["busy"]:
            raise CaptureBusy(
                f"capture already running ({_capture['path']}, "
                f"{_capture['secs']:g}s)"
            )
        path = os.path.join(dump_dir, f"devprof-{int(time.time() * 1e3)}")
        _capture.update(
            busy=True, path=path, started=time.time(), secs=secs, error="",
        )

    def run() -> None:
        err = ""
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            os.makedirs(path, exist_ok=True)
            prof = profile(activities=activities)
            with _engines_quiesced():
                prof.start()
            try:
                time.sleep(secs)
            finally:
                with _engines_quiesced():
                    prof.stop()
            prof.export_chrome_trace(os.path.join(path, "trace.json"))
            log.warning("devprof capture (%.2fs) -> %s", secs, path)
        except Exception as exc:  # noqa: BLE001 - capture must never crash serving
            err = repr(exc)[:200]
            log.exception("devprof capture failed")
        finally:
            with _capture_lock:
                _capture["busy"] = False
                _capture["error"] = err

    threading.Thread(
        target=run, name="devprof-capture", daemon=True
    ).start()
    return {"profiling": True, "path": path, "secs": secs}
