"""SLO engine: windowed TTFT/TPOT/availability objectives per model.

Consumes finished flight-recorder timelines (it registers itself as a
``FlightRecorder`` finish listener) and maintains a sliding window of
per-request samples per (model, tenant). From the window it computes,
per model and objective:

  * **attainment** — the fraction of requests in the window meeting the
    objective's target (TTFT <= ``ttft_ms``, TPOT <= ``tpot_ms``, and
    for availability: retired normally rather than shed/aborted);
  * **burn rate** — error-budget consumption speed,
    ``(1 - attainment) / (1 - target)`` (1.0 = burning exactly at
    budget; >1 = the window is eating future budget);
  * **breach** — attainment below target with at least ``min_samples``
    requests observed (small windows never page anyone).

Exposed as the ``aios_tpu_slo_*`` metric family (attainment + burn-rate
gauges and a breach counter, labeled (model, objective) — the objective
label is the closed ``OBJECTIVES`` enum, and the per-tenant breakdown
stays in ``/debug/slo`` / ``health()`` JSON so no metric carries the
unbounded tenant x model product). A breach flipping ON increments the
counter, freezes a flight-recorder anomaly snapshot, and flips every
service's ``/healthz`` to 503 via :func:`annotate_health`
(obs/http.py calls it on each probe).

Targets come from env (read once at engine construction):
``AIOS_TPU_SLO_TTFT_MS`` / ``AIOS_TPU_SLO_TPOT_MS`` /
``AIOS_TPU_SLO_TARGET`` / ``AIOS_TPU_SLO_WINDOW_SECS`` /
``AIOS_TPU_SLO_MIN_SAMPLES`` — docs/OBSERVABILITY.md has the table.
"""

from __future__ import annotations

import logging
import os
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from . import flightrec
from . import instruments as obs
from ..analysis.locks import make_lock

log = logging.getLogger("aios.obs")

# The closed objective enum — the only values the ``objective`` label of
# the aios_tpu_slo_* family may carry (linted by tests/test_obs_lint.py).
OBJECTIVES = ("ttft", "tpot", "availability")

_MAX_SAMPLES_PER_MODEL = 8192  # hard cap under the time window
_MAX_TENANT_ROWS = 64  # per-tenant breakdown rows in health()/debug JSON
_EVAL_TTL_SECS = 1.0  # evaluation cache: scrapes hit 3 gauges x N models


def _env_float(name: str, default: float, lo: float, hi: float) -> float:
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        v = float(raw)
        if not lo <= v <= hi:
            raise ValueError(f"must be in [{lo}, {hi}]")
        return v
    except ValueError as exc:
        log.warning("%s=%r ignored (%s); using %s", name, raw, exc, default)
        return default


@dataclass(frozen=True)
class SLOConfig:
    """Per-process objective targets (one policy for every model — the
    serving plane's floor; per-model targets can layer on later without
    changing the sample plumbing)."""

    ttft_ms: float = 2000.0  # time to first token
    tpot_ms: float = 250.0  # time per output token after the first
    target: float = 0.99  # attainment target per objective
    window_secs: float = 300.0
    min_samples: int = 20  # below this the window never breaches

    @classmethod
    def from_env(cls) -> "SLOConfig":
        return cls(
            ttft_ms=_env_float("AIOS_TPU_SLO_TTFT_MS", 2000.0, 1.0, 1e7),
            tpot_ms=_env_float("AIOS_TPU_SLO_TPOT_MS", 250.0, 0.1, 1e6),
            target=_env_float("AIOS_TPU_SLO_TARGET", 0.99, 0.5, 1.0),
            window_secs=_env_float(
                "AIOS_TPU_SLO_WINDOW_SECS", 300.0, 1.0, 86400.0
            ),
            min_samples=int(_env_float(
                "AIOS_TPU_SLO_MIN_SAMPLES", 20, 1, 1e6
            )),
        )


# One sample per finished request: (t_monotonic, tenant, ttft_ms|None,
# tpot_ms|None, ok). ttft/tpot are None when the request never produced
# a first token (shed, aborted pre-prefill) — those count against
# availability but not against the latency objectives.
_Sample = Tuple[float, str, Optional[float], Optional[float], bool]


class SLOEngine:
    def __init__(self, cfg: Optional[SLOConfig] = None) -> None:
        self.cfg = cfg or SLOConfig.from_env()
        self._lock = make_lock("slo")
        self._samples: Dict[str, deque] = {}  #: guarded_by _lock
        self._breached: Dict[Tuple[str, str], bool] = {}  #: guarded_by _lock
        self.breaches = 0  # total breach EDGES (monotonic)
        self._eval_cache: Dict[str, Tuple[float, dict]] = {}
        self._registered: set = set()

    # -- ingest --------------------------------------------------------------

    def observe(self, tl) -> None:
        """FlightRecorder finish listener: fold one timeline into the
        window. Cancelled requests are the client's choice, not the
        plane's failure — they don't sample. Neither do QUOTA sheds:
        they are the tenant's own policy violation doing exactly what
        the bucket promised, and counting them would let one abusive
        tenant breach availability and eject healthy replicas from the
        load balancer. Saturation sheds (deadline/queue_full/draining)
        and aborts DO count — those are the plane failing admitted or
        admissible work."""
        if tl.state == "cancelled":
            return
        if tl.state == "shed" and tl.shed_cause == "quota":
            return
        ok = tl.state == "retired"
        ttft = tl.ttft_ms if tl.ttft_ms > 0 else None
        tpot = tl.tpot_ms if tl.tokens_out > 1 and tl.ttft_ms > 0 else None
        self.record(tl.model, tl.tenant, ttft_ms=ttft, tpot_ms=tpot, ok=ok)

    def record(self, model: str, tenant: str = "anonymous", *,
               ttft_ms: Optional[float] = None,
               tpot_ms: Optional[float] = None, ok: bool = True,
               now: Optional[float] = None) -> None:
        """Add one request sample (``now`` injectable for window tests)."""
        t = time.monotonic() if now is None else now
        with self._lock:
            dq = self._samples.get(model)
            if dq is None:
                dq = self._samples.setdefault(
                    model, deque(maxlen=_MAX_SAMPLES_PER_MODEL)
                )
                first = model not in self._registered
                self._registered.add(model)
            else:
                first = False
            dq.append((t, tenant, ttft_ms, tpot_ms, ok))
        if first:
            self._register_gauges(model)
        # breach edges are detected at record time (the natural moment to
        # freeze evidence — the breaching requests are still in the
        # recorder ring), not only lazily at scrape; the 1 s evaluation
        # cache keeps this amortized O(window)/sec, not O(window)/request
        self.evaluate(model, now=now)

    def _register_gauges(self, model: str) -> None:
        for objective in OBJECTIVES:
            obs.SLO_ATTAINMENT.labels(
                model=model, objective=objective
            ).set_function(
                lambda m=model, o=objective:
                    self.evaluate(m)[o]["attainment"]
            )
            obs.SLO_BURN_RATE.labels(
                model=model, objective=objective
            ).set_function(
                lambda m=model, o=objective:
                    self.evaluate(m)[o]["burn_rate"]
            )

    # -- evaluation ----------------------------------------------------------

    def _window(self, model: str, now: float) -> List[_Sample]:
        dq = self._samples.get(model)
        if not dq:
            return []
        horizon = now - self.cfg.window_secs
        while dq and dq[0][0] < horizon:
            dq.popleft()
        return list(dq)

    def evaluate(self, model: str, now: Optional[float] = None) -> dict:
        """Windowed objective evaluation for one model:
        ``{objective: {attainment, burn_rate, breached, samples,
        target_value}}``. Breach EDGES (ok -> breached) increment the
        ``aios_tpu_slo_breaches_total`` counter and freeze a
        flight-recorder snapshot."""
        t = time.monotonic() if now is None else now
        with self._lock:
            cached = self._eval_cache.get(model)
            if now is None and cached is not None \
                    and t - cached[0] < _EVAL_TTL_SECS:
                return cached[1]
            window = self._window(model, t)
        cfg = self.cfg
        out: dict = {}
        for objective in OBJECTIVES:
            if objective == "ttft":
                vals = [s for s in window if s[2] is not None]
                met = sum(1 for s in vals if s[2] <= cfg.ttft_ms)
                target_value: float = cfg.ttft_ms
            elif objective == "tpot":
                vals = [s for s in window if s[3] is not None]
                met = sum(1 for s in vals if s[3] <= cfg.tpot_ms)
                target_value = cfg.tpot_ms
            else:  # availability
                vals = window
                met = sum(1 for s in vals if s[4])
                target_value = cfg.target
            n = len(vals)
            attainment = met / n if n else 1.0
            burn = (1.0 - attainment) / max(1.0 - cfg.target, 1e-9)
            breached = n >= cfg.min_samples and attainment < cfg.target
            out[objective] = {
                "attainment": round(attainment, 6),
                "burn_rate": round(burn, 4),
                "breached": breached,
                "samples": n,
                "target_value": target_value,
                "target": cfg.target,
            }
            self._note_breach(model, objective, breached)
        if now is None:  # injected clocks (tests) must not poison the cache
            with self._lock:
                self._eval_cache[model] = (t, out)
        return out

    def _note_breach(self, model: str, objective: str,
                     breached: bool) -> None:
        key = (model, objective)
        # edge detection under the lock: a scrape-thread evaluate() and a
        # record-path evaluate() crossing the threshold together must
        # count ONE breach, not one each (counter + snapshot follow
        # outside the lock — the recorder takes its own)
        with self._lock:
            was = self._breached.get(key, False)
            self._breached[key] = breached
            edge = breached and not was
            if edge:
                self.breaches += 1
        if edge:
            obs.SLO_BREACHES.labels(model=model, objective=objective).inc()
            log.warning("SLO breach: %s/%s fell below target", model,
                        objective)
            # async: breach edges fire on the request-finish path
            flightrec.RECORDER.snapshot(model, "slo_breach", sync=False)

    # -- surfaces ------------------------------------------------------------

    def tenants(self, model: str, now: Optional[float] = None) -> dict:
        """Per-tenant window breakdown (bounded row count; JSON surfaces
        only — tenant never becomes a metric label next to model)."""
        t = time.monotonic() if now is None else now
        with self._lock:
            window = self._window(model, t)
        by_tenant: Dict[str, List[_Sample]] = {}
        for s in window:
            by_tenant.setdefault(s[1], []).append(s)
        out = {}
        for tenant, rows in sorted(by_tenant.items())[:_MAX_TENANT_ROWS]:
            with_ttft = [s for s in rows if s[2] is not None]
            out[tenant] = {
                "samples": len(rows),
                "ok_ratio": round(
                    sum(1 for s in rows if s[4]) / len(rows), 4
                ),
                "ttft_attainment": round(
                    sum(1 for s in with_ttft if s[2] <= self.cfg.ttft_ms)
                    / len(with_ttft), 4
                ) if with_ttft else 1.0,
            }
        return out

    def models(self) -> List[str]:
        with self._lock:
            return sorted(self._samples)

    def health(self) -> dict:
        """/healthz fragment: evaluation per model + degraded status when
        any objective is in breach."""
        models = self.models()
        if not models:
            return {}
        slo = {m: self.evaluate(m) for m in models}
        breached = [
            m for m, objectives in slo.items()
            if any(o["breached"] for o in objectives.values())
        ]
        out: dict = {"slo": slo}
        if breached:
            out["status"] = "degraded"
            out["slo_breached"] = breached
        return out

    def clear(self) -> None:
        """Test isolation (metric children persist; values re-resolve)."""
        with self._lock:
            self._samples.clear()
            self._breached.clear()
            self._eval_cache.clear()


ENGINE = SLOEngine()
flightrec.RECORDER.add_listener(ENGINE.observe)


def annotate_health(payload: dict) -> dict:
    """Fold the SLO view into a /healthz payload (obs/http.py calls this
    on every probe): adds the ``slo`` section when samples exist and
    downgrades ``status`` to ``degraded`` on any active breach. When the
    fleet telemetry plane is armed (obs/fleet.py), the fleet rollup —
    member counts by state, worst-burn host, per-objective fleet
    attainment — rides the same probe as a ``fleet`` section."""
    from . import fleet

    if fleet.FLEET is not None:
        payload.setdefault("fleet", fleet.FLEET.health_summary())
    h = ENGINE.health()
    if not h:
        return payload
    slo = h.pop("slo")
    payload.setdefault("slo", slo)
    if h.get("status") == "degraded" and payload.get("status") == "ok":
        payload["status"] = "degraded"
        payload["slo_breached"] = h["slo_breached"]
    return payload
