"""Trace-driven storm load generation for the serving plane.

The million-user storm harness (docs/TESTING.md, docs/RUNBOOK.md §8): a
SEEDED, deterministic workload generator that drives the full gRPC
surface (``Infer``/``StreamInfer`` through the real runtime service —
never the batcher directly) with production-shaped traffic:

  * declarative scenarios (TOML/JSON — :mod:`scenario`) composing tenant
    mixes, diurnal/burst/Poisson arrival curves, long-tail prompt/output
    length distributions, shared-prefix fork-shaped agent-loop call
    patterns (the radix cache's workload), abusive-tenant quota storms,
    and deadline-carrying reactive-tier requests;
  * a pure trace builder (:mod:`trace`) — the whole call schedule is a
    deterministic function of (scenario, seed), so two runs submit
    byte-identical work;
  * a wall-clock driver (:mod:`driver`) replaying the trace over gRPC
    and recording per-request outcomes (TTFT/TPOT, shed causes,
    retry-after hints, stream text);
  * a verdict builder (:mod:`report`) separating the DETERMINISTIC
    fingerprint (counts, greedy stream hashes, pass/fail against the
    scenario's declared SLO targets) from timing measurements, plus the
    live ``/debug/slo`` surface readback.

``bench.py --storm`` runs a committed scenario twice and fails on any
fingerprint divergence — the contention-realistic regression gate beside
tier-1 and the chaos storm (it composes with ``--chaos``: same storm,
seeded faults armed).
"""

from .scenario import SLOTargets, StormScenario, TenantSpec, load_scenario
from .trace import Call, build_trace, trace_fingerprint
from .driver import FleetStormDriver, Outcome, StormDriver, target_of
from .report import build_report

__all__ = [
    "Call",
    "FleetStormDriver",
    "Outcome",
    "SLOTargets",
    "StormDriver",
    "StormScenario",
    "TenantSpec",
    "build_report",
    "build_trace",
    "load_scenario",
    "target_of",
    "trace_fingerprint",
]
