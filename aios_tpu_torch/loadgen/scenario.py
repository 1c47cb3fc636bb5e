"""Declarative storm scenarios: tenant mixes, curves, and SLO targets.

A scenario file (TOML or JSON; ``scenarios/storm_*.toml`` are the
committed references) declares WHAT the storm looks like; the trace
builder turns it into a deterministic call schedule. Validation is
strict — a misspelled tenant class or arrival curve fails the load, not
the gate (the chaos lesson: a storm that silently does nothing passes
vacuously).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field, fields
from typing import Tuple

from .._compat import tomllib

TENANT_CLASSES = ("interactive", "agent", "batch", "abusive", "reactive")
ARRIVALS = ("poisson", "uniform", "diurnal", "burst")

# intelligence level per tenant class (the runtime service maps levels
# to admission priority: strategic 3, tactical 2, operational/reactive
# 1, unclassified 0 — so "batch" traffic is the best-effort tier the
# degrade ladder's rung 3 sheds)
CLASS_LEVELS = {
    "interactive": "operational",
    "agent": "tactical",
    "batch": "",
    "abusive": "",
    "reactive": "reactive",
}


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's traffic shape. Lengths are in CHARACTERS of prompt
    text (the storm models serve byte-level tokenizers, so chars ==
    tokens; real-tokenizer scenarios just mean "about this many
    tokens")."""

    name: str
    klass: str = "interactive"
    rps: float = 1.0  # base arrival rate (requests/sec of virtual time)
    arrival: str = "poisson"
    peak_ratio: float = 4.0  # diurnal/burst peak rate multiplier
    period_secs: float = 4.0  # diurnal period / burst cycle length
    burst_secs: float = 1.0  # burst on-window at the start of each cycle
    prompt_p50: int = 48  # lognormal median prompt length
    prompt_sigma: float = 0.5  # lognormal spread (the long tail)
    prompt_max: int = 400  # hard cap (keeps prompts inside the context)
    max_tokens: int = 16
    max_tokens_max: int = 0  # 0 = fixed; else uniform [max_tokens, this]
    temperature: float = 0.0  # greedy by default (the determinism contract)
    streaming: bool = False  # StreamInfer (TTFT measured at first chunk)
    shared_prefix: int = 0  # chars of shared per-tenant preamble
    fork_width: int = 0  # agent loops: children per parent call
    fork_gap_secs: float = 0.15  # child arrival offset after the parent
    deadline_ms: int = 0  # gRPC deadline (reactive tier); 0 = none
    quota_storm: bool = False  # fixed-cost hammering meant to trip quotas

    def __post_init__(self):
        if self.klass not in TENANT_CLASSES:
            raise ValueError(
                f"tenant {self.name!r}: unknown class {self.klass!r} "
                f"(one of {TENANT_CLASSES})"
            )
        if self.arrival not in ARRIVALS:
            raise ValueError(
                f"tenant {self.name!r}: unknown arrival {self.arrival!r} "
                f"(one of {ARRIVALS})"
            )
        if self.rps <= 0:
            raise ValueError(f"tenant {self.name!r}: rps must be > 0")

    @property
    def level(self) -> str:
        return CLASS_LEVELS[self.klass]


@dataclass(frozen=True)
class SLOTargets:
    """The storm's declared pass/fail line, judged from the driver's
    own measurements AND read back from the live /debug/slo surface."""

    ttft_ms: float = 30_000.0
    tpot_ms: float = 5_000.0
    attainment: float = 0.95  # min fraction of requests meeting each
    availability: float = 0.99  # min ok ratio over admitted+admissible work


@dataclass(frozen=True)
class StormScenario:
    name: str
    seed: int
    duration_secs: float
    model: str
    tenants: Tuple[TenantSpec, ...]
    slo: SLOTargets = field(default_factory=SLOTargets)
    # serving-plane env applied for the storm's pool (ReplicaPool knobs)
    replicas: int = 2
    context: int = 512
    num_slots: int = 4
    tenant_tokens_per_sec: float = 0.0  # 0 = quotas off
    tenant_burst_tokens: float = 0.0
    max_queue: int = 64
    # multi-target storms (the fleet driver): explicit runtime endpoints
    # to spread the trace over. Empty = single target supplied by the
    # harness at run time; the VERDICT then aggregates one fingerprint
    # per endpoint (tenant -> target routing is deterministic, so the
    # per-target counts are part of the determinism contract).
    endpoints: Tuple[str, ...] = ()

    def tenant(self, name: str) -> TenantSpec:
        for t in self.tenants:
            if t.name == name:
                return t
        raise KeyError(name)


def _build(data: dict, path: str) -> StormScenario:
    if "scenario" not in data:
        raise ValueError(f"{path}: missing [scenario] section")
    sc = dict(data["scenario"])
    slo = SLOTargets(**data.get("slo", {}))
    raw_tenants = data.get("tenants", [])
    if not raw_tenants:
        raise ValueError(f"{path}: a storm needs at least one [[tenants]]")
    tenants = []
    allowed = {f.name for f in fields(TenantSpec)}
    for row in raw_tenants:
        row = dict(row)
        # TOML has no "class" collision problem, python does
        if "class" in row:
            row["klass"] = row.pop("class")
        unknown = set(row) - allowed
        if unknown:
            raise ValueError(
                f"{path}: tenant {row.get('name', '?')!r} has unknown "
                f"keys {sorted(unknown)}"
            )
        tenants.append(TenantSpec(**row))
    names = [t.name for t in tenants]
    if len(set(names)) != len(names):
        raise ValueError(f"{path}: duplicate tenant names {names}")
    return StormScenario(
        name=str(sc.get("name", os.path.basename(path))),
        seed=int(sc.get("seed", 42)),
        duration_secs=float(sc.get("duration_secs", 5.0)),
        model=str(sc.get("model", "storm-tiny")),
        replicas=int(sc.get("replicas", 2)),
        context=int(sc.get("context", 512)),
        num_slots=int(sc.get("num_slots", 4)),
        tenant_tokens_per_sec=float(sc.get("tenant_tokens_per_sec", 0.0)),
        tenant_burst_tokens=float(sc.get("tenant_burst_tokens", 0.0)),
        max_queue=int(sc.get("max_queue", 64)),
        endpoints=tuple(str(e) for e in sc.get("endpoints", ())),
        tenants=tuple(tenants),
        slo=slo,
    )


def load_scenario(path: str) -> StormScenario:
    """Load + validate a scenario file (.toml or .json)."""
    if path.endswith(".json"):
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
    else:
        with open(path, "rb") as f:
            data = tomllib.load(f)
    return _build(data, path)


def default_scenario_path(repo_root: str, smoke: bool = False) -> str:
    """The scenario ``bench.py --storm`` runs: AIOS_TPU_STORM_SCENARIO
    (CI matrices point at a site scenario without editing the command
    line) or the committed reference/smoke file."""
    override = os.environ.get("AIOS_TPU_STORM_SCENARIO", "").strip()
    if override:
        return override
    return os.path.join(
        repo_root, "scenarios",
        "storm_smoke.toml" if smoke else "storm_reference.toml",
    )


def time_scale_env() -> float:
    """AIOS_TPU_STORM_TIME_SCALE stretches the arrival clock on slow or
    oversubscribed containers (2.0 = half speed; floor 0.1). The trace
    — and so the deterministic verdict — is unchanged; only the
    wall-clock replay slows down."""
    raw = os.environ.get("AIOS_TPU_STORM_TIME_SCALE", "").strip()
    if not raw:
        return 1.0
    try:
        return max(float(raw), 0.1)
    except ValueError:
        return 1.0
