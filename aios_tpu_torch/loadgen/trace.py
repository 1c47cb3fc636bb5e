"""Deterministic trace building: scenario + seed -> the full call list.

Everything random draws from per-tenant ``random.Random`` instances
seeded ``(scenario.seed, tenant.name)``, so tenants are independent (a
new tenant never perturbs another's schedule) and the whole trace is a
pure function of the scenario — the storm gate's determinism contract
rests here. The driver replays arrival TIMES on the wall clock; the
WORK (prompts, budgets, deadlines, task ids) is fixed at build time —
trace-driven, not generated on the fly.

Arrival curves (non-homogeneous Poisson via thinning for the shaped
ones):

  * ``poisson`` — exponential gaps at ``rps``;
  * ``uniform`` — evenly spaced (deadline probes want fixed cadence);
  * ``diurnal`` — rate swings sinusoidally between ``rps`` and
    ``rps * peak_ratio`` over ``period_secs`` (a whole diurnal cycle
    compressed into seconds);
  * ``burst`` — ``rps * peak_ratio`` during the first ``burst_secs`` of
    each ``period_secs`` cycle, ``rps`` otherwise (quota storms, thundering
    herds).

Agent tenants emit fork-shaped call FAMILIES: each parent call spawns
``fork_width`` children at small offsets whose prompts extend the
parent's prompt — the children share the parent's whole text as a
prefix, which is exactly the radix-cache / cache-aware-routing workload
(SGLang's observation that agent traffic is tree-shaped programs,
PAPERS.md).
"""

from __future__ import annotations

import hashlib
import json
import math
import random
from dataclasses import asdict, dataclass
from typing import List

from .scenario import StormScenario, TenantSpec

_WORDS = (
    "plan", "probe", "route", "merge", "audit", "cache", "shard", "drain",
    "batch", "trace", "queue", "grant", "spill", "prune", "fetch", "score",
)


@dataclass(frozen=True)
class Call:
    """One scheduled request. ``t`` is seconds of virtual storm time;
    the driver maps it onto the wall clock."""

    t: float
    tenant: str
    klass: str
    task_id: str
    prompt: str
    max_tokens: int
    temperature: float
    streaming: bool
    deadline_ms: int
    level: str
    parent: str = ""  # parent task id for fork children ("" = root)
    # whether this call's STREAM TEXT joins the verdict fingerprint —
    # set at build time to greedy calls of cache-independent tenants
    # (no shared preamble, no forks). Cache-COUPLED prompts hit the
    # radix index at whatever state the wall clock left it in, and a
    # prefix HIT prefills through different XLA graph shapes than a
    # MISS — bitwise-different KV at near-tie logits can legally flip
    # an argmax, so their contract is counts + completion, not content.
    hash_stream: bool = False

    @property
    def must_complete(self) -> bool:
        """Greedy, non-abusive, deadline-free calls must COMPLETE in
        every run (polite tenants carry margins that make timing sheds
        impossible). Which quota-storm call wins the bucket race is
        timing, so abusive calls pin their admitted/shed COUNTS instead
        — and a deadline verdict is a function of live backlog + the
        observed rate at arrival, so deadline-carrying calls pin
        NOTHING deterministic (their outcomes ride the measured block;
        see report.py)."""
        return (
            self.temperature == 0.0
            and self.klass != "abusive"
            and self.deadline_ms == 0
        )


def _arrivals(t: TenantSpec, duration: float, rng: random.Random) -> List[float]:
    out: List[float] = []
    if t.arrival == "uniform":
        gap = 1.0 / t.rps
        x = gap * 0.5
        while x < duration:
            out.append(x)
            x += gap
        return out
    peak = t.rps * (t.peak_ratio if t.arrival in ("diurnal", "burst") else 1.0)

    def rate_at(x: float) -> float:
        if t.arrival == "poisson":
            return t.rps
        if t.arrival == "diurnal":
            # swing between base and peak over one period
            phase = 0.5 * (1.0 + math.sin(2.0 * math.pi * x / t.period_secs))
            return t.rps + (peak - t.rps) * phase
        # burst: peak inside the on-window at the start of each cycle
        return peak if (x % t.period_secs) < t.burst_secs else t.rps

    # thinning: draw candidate arrivals at the max rate, keep with
    # probability rate(t)/peak — exact for poisson (rate==peak)
    x = 0.0
    while True:
        x += rng.expovariate(peak)
        if x >= duration:
            return out
        if rng.random() * peak <= rate_at(x):
            out.append(x)


def _prompt_len(t: TenantSpec, rng: random.Random) -> int:
    # lognormal long tail around the median, hard-capped
    n = int(rng.lognormvariate(math.log(max(t.prompt_p50, 4)), t.prompt_sigma))
    return max(8, min(n, t.prompt_max))


def _text(rng: random.Random, n_chars: int, head: str) -> str:
    parts = [head]
    size = len(head)
    while size < n_chars:
        w = _WORDS[rng.randrange(len(_WORDS))]
        parts.append(" " + w)
        size += len(w) + 1
    return "".join(parts)[:max(n_chars, len(head))]


def _budget(t: TenantSpec, rng: random.Random) -> int:
    if t.max_tokens_max > t.max_tokens:
        return rng.randint(t.max_tokens, t.max_tokens_max)
    return t.max_tokens


def build_trace(sc: StormScenario) -> List[Call]:
    """The full storm, sorted by arrival time. Deterministic in
    (scenario contents, seed) — build twice, compare, it's ``==``."""
    calls: List[Call] = []
    for t in sc.tenants:
        rng = random.Random(f"{sc.seed}:{t.name}")
        preamble = ""
        if t.shared_prefix > 0:
            # ONE per-tenant preamble every call shares — the agent
            # system-prompt shape the prefix cache exists for
            preamble = _text(
                random.Random(f"{sc.seed}:{t.name}:preamble"),
                t.shared_prefix, f"[{t.name} preamble]",
            )
        for i, at in enumerate(_arrivals(t, sc.duration_secs, rng)):
            task = f"{t.name}-{i}"
            if t.quota_storm:
                # FIXED cost: every storm call is byte-identical in
                # price, so the admitted COUNT is bucket math, not a
                # race over which prompt was dearer (report.py pins it)
                prompt = _text(
                    random.Random(f"{sc.seed}:{t.name}:storm"),
                    t.prompt_p50, f"[{t.name} storm]",
                )
                budget = t.max_tokens
            else:
                head = f"[{t.name} r{i}]"
                prompt = (preamble + " " if preamble else "") + _text(
                    rng, _prompt_len(t, rng), head
                )
                budget = _budget(t, rng)
            cacheless = t.shared_prefix == 0 and t.fork_width == 0
            calls.append(Call(
                t=round(at, 4), tenant=t.name, klass=t.klass,
                task_id=task, prompt=prompt, max_tokens=budget,
                temperature=t.temperature, streaming=t.streaming,
                deadline_ms=t.deadline_ms, level=t.level,
                hash_stream=(
                    t.temperature == 0.0 and not t.quota_storm
                    and cacheless and t.deadline_ms == 0
                ),
            ))
            if t.fork_width > 0:
                # fork-shaped children extending the parent's prompt —
                # each child's prompt CONTAINS the parent's as a prefix
                for k in range(t.fork_width):
                    calls.append(Call(
                        t=round(at + t.fork_gap_secs * (k + 1), 4),
                        tenant=t.name, klass=t.klass,
                        task_id=f"{task}f{k}",
                        prompt=prompt + f" branch {k}: "
                        + _text(rng, 24, ""),
                        max_tokens=budget,
                        temperature=t.temperature,
                        streaming=t.streaming,
                        deadline_ms=t.deadline_ms, level=t.level,
                        parent=task,  # cache-coupled: counts, not content
                    ))
    calls.sort(key=lambda c: (c.t, c.task_id))
    return calls


def trace_fingerprint(calls: List[Call]) -> str:
    """sha256 over the whole schedule — the verdict's proof that two
    runs replayed identical work."""
    h = hashlib.sha256()
    for c in calls:
        h.update(json.dumps(asdict(c), sort_keys=True).encode())
    return h.hexdigest()[:16]
