"""Storm verdicts: a deterministic fingerprint + measured SLO judgment.

The verdict JSON has two parts with different contracts:

  * ``verdict`` — DETERMINISTIC across two seeded runs of the same
    scenario on the same tree: the trace fingerprint, per-tenant
    submitted/completed/shed counts, the sorted (task_id, sha) stream
    hashes of every ``hash_stream`` call, and the PASS/FAIL booleans
    against the scenario's declared targets. ``bench.py --storm`` runs
    twice and compares this dict with ``==``; any divergence fails the
    gate. Three deliberate exclusions keep the contract honest:
    deadline-carrying tenants pin NOTHING (a feasibility verdict is a
    function of live backlog + observed rate at arrival — pure load
    timing; their counts ride ``measured.deadline_tenants``);
    quota-storm tenants pin their admitted/shed COUNTS (every storm
    call costs the same, so bucket math is order-independent) but not
    which task ids won the bucket race; and cache-COUPLED tenants
    (shared preambles, fork families) pin counts + completion but not
    stream CONTENT — whether a fork child's prompt hits the radix index
    depends on when its parent's pages registered, and a prefix HIT
    prefills through different XLA graph shapes than a MISS, whose
    bitwise-different KV can legally flip an argmax at a near-tie
    (the same reason bf16 spec-vs-plain comparisons are confined to
    fp32 in the engine's identity tests).
  * ``measured`` — wall-clock evidence (TTFT/TPOT percentiles per
    class, the live /debug/slo readback, shed-cause tallies) for humans
    and dashboards; never compared across runs.

The PASS line: no errors, no stuck workers, every deterministic call
completed, measured attainment over the declared SLO targets, and
availability (ok / (ok + non-quota sheds + errors)) over its floor.
"""

from __future__ import annotations

import hashlib
from collections import defaultdict
from typing import Dict, List

from .scenario import StormScenario
from .trace import Call, trace_fingerprint
from .driver import Outcome


def _pct(vals: List[float], p: float) -> float:
    if not vals:
        return 0.0
    vals = sorted(vals)
    idx = min(int(p * (len(vals) - 1) + 0.5), len(vals) - 1)
    return round(vals[idx], 3)


def _sha(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()[:12]


def build_report(sc: StormScenario, calls: List[Call],
                 outcomes: List[Outcome], slo_surface: dict) -> dict:
    by_tenant: Dict[str, List[Outcome]] = defaultdict(list)
    for o in outcomes:
        by_tenant[o.call.tenant].append(o)

    tenants_det: dict = {}
    tenants_measured: dict = {}
    stream_hashes: List[tuple] = []
    errors: List[dict] = []
    stuck = 0
    det_missing: List[str] = []
    for name, outs in sorted(by_tenant.items()):
        counts = {
            "submitted": len(outs),
            "completed": sum(1 for o in outs if o.status == "ok"),
            "shed": sum(1 for o in outs if o.status == "shed"),
            "rejected": sum(1 for o in outs if o.status == "rejected"),
        }
        # deadline-carrying tenants' outcomes are load-timing verdicts:
        # real evidence, but not a determinism contract
        if any(o.call.deadline_ms > 0 for o in outs):
            tenants_measured[name] = counts
        else:
            tenants_det[name] = counts
        for o in outs:
            if o.status == "error":
                stuck += int(o.detail == "stuck")
                errors.append({
                    "task": o.call.task_id, "code": o.code,
                    "detail": o.detail,
                })
            if o.call.must_complete and o.status != "ok":
                det_missing.append(o.call.task_id)
            if o.call.hash_stream and o.status == "ok":
                stream_hashes.append((o.call.task_id, _sha(o.text)))

    # driver-side latency evidence per tenant class
    classes: dict = {}
    for klass in sorted({c.klass for c in calls}):
        outs = [o for o in outcomes if o.call.klass == klass]
        oks = [o for o in outs if o.status == "ok"]
        ttfts = [o.ttft_ms for o in oks if o.ttft_ms > 0]
        tpots = [
            (o.wall_ms - o.ttft_ms) / (o.chunks - 1)
            for o in oks if o.ttft_ms > 0 and o.chunks > 1
        ]
        classes[klass] = {
            "requests": len(outs),
            "ok": len(oks),
            "ttft_p50_ms": _pct(ttfts, 0.5),
            "ttft_p99_ms": _pct(ttfts, 0.99),
            "tpot_p50_ms": _pct(tpots, 0.5),
            "tpot_p99_ms": _pct(tpots, 0.99),
            "wall_p50_ms": _pct([o.wall_ms for o in oks], 0.5),
        }

    # SLO judgment from the driver's own measurements (the live surface
    # is recorded beside it; its window also contains warmup traffic)
    lat = [o for o in outcomes if o.status == "ok" and o.ttft_ms > 0]
    ttft_ok = sum(1 for o in lat if o.ttft_ms <= sc.slo.ttft_ms)
    ttft_attain = ttft_ok / len(lat) if lat else 1.0
    tp = [
        (o.wall_ms - o.ttft_ms) / (o.chunks - 1)
        for o in lat if o.chunks > 1
    ]
    tpot_ok = sum(1 for v in tp if v <= sc.slo.tpot_ms)
    tpot_attain = tpot_ok / len(tp) if tp else 1.0
    n_ok = sum(1 for o in outcomes if o.status == "ok")
    # availability over the work the plane OWED: quota sheds/rejections
    # are the tenant's own policy violation (the SLO-engine convention),
    # and a DEADLINE shed is the feasibility gate correctly refusing
    # work that could not finish in time (RTP-LLM's point — shedding it
    # protects the requests that can) — neither is the plane failing
    # admitted or admissible work
    owed = [
        o for o in outcomes
        if not (o.status in ("shed", "rejected")
                and o.shed_cause in ("quota", "deadline"))
    ]
    availability = n_ok / len(owed) if owed else 1.0

    passed = (
        not errors
        and stuck == 0
        and not det_missing
        and ttft_attain >= sc.slo.attainment
        and tpot_attain >= sc.slo.attainment
        and availability >= sc.slo.availability
    )

    verdict = {
        "scenario": sc.name,
        "seed": sc.seed,
        "trace_sha": trace_fingerprint(calls),
        "calls": len(calls),
        "tenants": tenants_det,
        "stream_hashes": sorted(stream_hashes),
        "deterministic_missing": sorted(det_missing),
        "errors": len(errors),
        "stuck": stuck,
        "pass": passed,
    }
    per_target = _per_target(outcomes)
    if per_target:
        # multi-endpoint storms (FleetStormDriver): one fingerprint per
        # target. Routing is a pure function of the tenant name, so
        # submitted counts are deterministic; completion pins only for
        # non-deadline tenants (the same exclusion as the tenant table)
        verdict["per_target"] = per_target
    measured = {
        "classes": classes,
        "deadline_tenants": tenants_measured,
        "ttft_attainment": round(ttft_attain, 4),
        "tpot_attainment": round(tpot_attain, 4),
        "availability": round(availability, 4),
        "targets": {
            "ttft_ms": sc.slo.ttft_ms, "tpot_ms": sc.slo.tpot_ms,
            "attainment": sc.slo.attainment,
            "availability": sc.slo.availability,
        },
        "shed_causes": _cause_tally(outcomes),
        "error_detail": errors[:8],
        "slo_surface": slo_surface,
    }
    return {"verdict": verdict, "measured": measured, "pass": passed}


def _per_target(outcomes: List[Outcome]) -> dict:
    """Per-target deterministic fingerprint for multi-endpoint storms:
    submitted counts per target (pure trace+routing function), plus
    completed/shed/rejected restricted to non-deadline tenants (a
    deadline verdict is load timing — the build_report exclusion).
    Empty when no outcome carries a target (single-endpoint storms keep
    their verdict shape unchanged)."""
    rows: Dict[int, dict] = {}
    for o in outcomes:
        t = o.extras.get("target")
        if t is None:
            return {}
        row = rows.setdefault(int(t), {
            "submitted": 0, "completed": 0, "shed": 0, "rejected": 0,
        })
        row["submitted"] += 1
        if o.call.deadline_ms > 0:
            continue
        if o.status == "ok":
            row["completed"] += 1
        elif o.status == "shed":
            row["shed"] += 1
        elif o.status == "rejected":
            row["rejected"] += 1
    return {str(k): rows[k] for k in sorted(rows)}


def _cause_tally(outcomes: List[Outcome]) -> dict:
    tally: Dict[str, int] = defaultdict(int)
    for o in outcomes:
        if o.status in ("shed", "rejected") and o.shed_cause:
            tally[f"{o.status}:{o.shed_cause}"] += 1
    return dict(sorted(tally.items()))
