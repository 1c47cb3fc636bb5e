"""Deterministic, seeded fault injection for the serving plane.

The reference aiOS survives component failure by design — the spawner
restarts crashed agents and the intelligence hierarchy degrades tier by
tier — but recovery code nobody can *provoke* is recovery code nobody
has tested. This module gives the TPU serving plane named injection
points compiled into its hot paths:

    pool.scheduler_crash    the batcher scheduler thread raises mid-tick
    dispatch.delay          the decode loop sleeps before a dispatch
    host_store.restore_fail the host-tier restore dies mid-scatter
    host_store.corrupt      a spilled page's bytes flip (crc32 catches it)
    rpc.unavailable         a server RPC aborts UNAVAILABLE + retry-after
    allocator.pressure      alloc_pages raises PoolExhausted
    admission.clock_skew    the deadline gate sees a skewed clock

Each point is a **near-zero-cost no-op** unless a schedule is active:
the hot-path call is one module-global ``None`` check. A schedule comes
from ``AIOS_TPU_FAULTS`` (or boot ``[faults]`` -> that env, or
:func:`activate` in tests/bench)::

    AIOS_TPU_FAULTS="seed=42;pool.scheduler_crash=nth:3;\
dispatch.delay=prob:0.25,delay_ms=20;admission.clock_skew=after:5,skew_ms=2000"

Triggers (the fire decision is a pure function of ``(seed, point,
hit-index)`` for ``nth``/``prob`` — the same seed and call pattern
reproduce the same injected-fault sequence, which is what makes a chaos
run a *regression test* instead of a dice roll):

  * ``nth:N``  — fire exactly on the Nth hit of the point (one-shot);
  * ``prob:P`` — fire each hit with probability P, drawn from a
    per-point PRNG seeded with ``(seed, point)`` — one draw per hit;
  * ``after:T`` — fire on every hit once T seconds have elapsed since
    activation (wall-clock; for live chaos drills, not determinism).

Optional ``key=value`` params ride after the trigger: ``delay_ms``
(dispatch.delay, net.delay), ``skew_ms`` (admission.clock_skew),
``retry_after_ms`` (rpc.unavailable), ``after_msgs`` (net.drop_after).
The ``net.*`` points additionally take STRING-valued scoping params —
``src=``/``dst=`` (fleet host ids) and ``surface=`` ("rpc"/"http") —
and count hits per ``(src, dst)`` edge, so the k-th send on one edge
fires deterministically regardless of other edges' traffic; ``until=M``
widens an ``nth:N`` one-shot into the held window ``[N, M]``
(docs/FAULTS.md "Per-edge network faults").

Every fired fault is counted by ``aios_tpu_faults_injected_total{point,
mode}``, recorded on the flight recorder's model lane as a ``fault``
event, and appended to a bounded in-process journal (:func:`fired`) so
a chaos harness can assert the injected sequence was identical across
re-runs. See docs/FAULTS.md.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..analysis.locks import make_lock
from ..obs import instruments as obs

log = logging.getLogger("aios.faults")

__all__ = [
    "POINTS", "MODES", "FaultAction", "InjectedFault", "activate",
    "deactivate", "active", "point", "fired", "install_from_env",
]

# The closed catalog of injection points. A schedule naming anything
# else logs and skips it (the lenient-env pattern) — a typo must not
# silently arm nothing while the operator believes chaos is running.
POINTS = (
    "pool.scheduler_crash",
    "dispatch.delay",
    "host_store.restore_fail",
    "host_store.corrupt",
    "rpc.unavailable",
    "allocator.pressure",
    "admission.clock_skew",
    # decode-host loss mid-handoff (aios_tpu_torch/fleet/disagg.py): the
    # servicer aborts the stream — or, with exit=1, kills the whole
    # process (the disagg smoke's real host kill) — and the prefill
    # host re-hands the stream to a survivor
    "fleet.host_kill",
    # per-EDGE network faults (aios_tpu_torch/faults/net.py): scoped by
    # src=/dst= host-id params (string-valued) and an optional
    # surface= filter ("rpc" | "http"), hit-counted PER EDGE so the
    # k-th send on one edge fires deterministically no matter how
    # other edges interleave. Injected at the shared rpc client
    # interceptor and the obs/fleet.py HTTP helpers — membership,
    # federation, KVX, and Handoff all traverse one fault surface.
    "net.partition",          # both directions refused
    "net.partition_oneway",   # src->dst dropped, reverse clean
    "net.delay",              # per-edge latency (delay_ms)
    "net.drop_after",         # stream severed after after_msgs messages
    # multi-tick decode megagraph (engine.py _mega_dispatch): caps the
    # device while-loop's abort_after operand mid-window (ticks param)
    # so the early-exit path fires with slots still live — the chaos
    # storm's proof that a k<K readback retires/streams correctly
    "pool.megatick_abort",
)

MODES = ("nth", "prob", "after")

# journal bound: a chaos storm fires tens of faults, not thousands; the
# cap only guards against a runaway prob:1.0 schedule on a hot point
_MAX_JOURNAL = 4096

# parameter defaults per point: a schedule that names the point but not
# its magnitude still injects SOMETHING — a fired fault that is secretly
# a no-op would count in the metric/journal while exercising nothing
_PARAM_DEFAULTS: Dict[str, Dict[str, float]] = {
    "dispatch.delay": {"delay_ms": 10.0},
    "admission.clock_skew": {"skew_ms": 1000.0},
    "rpc.unavailable": {"retry_after_ms": 1000.0},
    "net.delay": {"delay_ms": 50.0},
    "net.drop_after": {"after_msgs": 3.0},
    "pool.megatick_abort": {"ticks": 1.0},
}

# param keys whose values are strings, not floats — the per-edge scoping
# of the net.* points. Any OTHER non-float param value still drops the
# whole entry (the lenient-env contract tests pin).
_STR_PARAMS = ("src", "dst", "surface")


class InjectedFault(RuntimeError):
    """The exception a crash-class injection point raises. Distinct type
    so recovery-path tests can assert the abort they observe is the one
    they injected, not an unrelated failure."""


@dataclass(frozen=True)
class FaultAction:
    """What a fired point tells its call site to do. ``hit`` is the
    1-based hit index at fire time (the journal's determinism anchor)."""

    point: str
    mode: str
    hit: int
    delay_s: float = 0.0
    skew_s: float = 0.0
    retry_after_ms: int = 1000
    # fleet.host_kill only: True = the call site should take the whole
    # PROCESS down (os._exit), not just abort the stream — the disagg
    # smoke's real host kill. Default False so in-process tests drive
    # the same recovery path without dying.
    exit: bool = False
    # net.drop_after only: how many stream messages flow before the
    # sever (the mid-transfer cut the resume ladder must survive)
    after_msgs: int = 3
    # pool.megatick_abort only: cap the megagraph's abort_after operand
    # at this many ticks (0 = the call site's half-window default) —
    # the injected "host attention needed" demand that forces the
    # device loop's early-exit branch mid-window
    ticks: int = 0


@dataclass
class _PointSpec:
    mode: str
    arg: float  # N for nth, P for prob, T seconds for after
    params: Dict[str, float] = field(default_factory=dict)
    # string-valued params (src/dst/surface) — the net.* edge scoping
    strs: Dict[str, str] = field(default_factory=dict)


class FaultPlan:
    """One activated schedule: per-point triggers, seeded PRNGs, hit
    counters, and the fired-fault journal."""

    def __init__(self, schedule: Dict[str, _PointSpec], seed: int) -> None:
        self.seed = seed
        self.schedule = schedule
        self.activated_at = time.monotonic()
        self._lock = make_lock("faults")
        #: guarded_by _lock
        self._hits: Dict[str, int] = {}
        #: guarded_by _lock
        self._journal: deque = deque(maxlen=_MAX_JOURNAL)
        # per-point PRNG seeded by (seed, point): the k-th draw decides
        # the k-th hit no matter how points interleave across threads
        self._rngs: Dict[str, random.Random] = {
            name: random.Random(f"{seed}:{name}") for name in schedule
        }

    def check(self, name: str, model: str = "",
              edge: Optional[Tuple[str, str]] = None,
              surface: str = "") -> Optional[FaultAction]:
        spec = self.schedule.get(name)
        if spec is None:
            return None
        # edge/surface scoping (net.* points): a spec scoped to a
        # src/dst/surface it does not match neither fires NOR consumes
        # a hit — unrelated traffic must not shift the hit index the
        # determinism contract anchors on.
        want_src = spec.strs.get("src", "")
        want_dst = spec.strs.get("dst", "")
        if want_src or want_dst:
            if edge is None:
                return None
            if want_src and edge[0] != want_src:
                return None
            if want_dst and edge[1] != want_dst:
                return None
        want_surface = spec.strs.get("surface", "")
        if want_surface and surface != want_surface:
            return None
        # per-edge points count hits PER EDGE: the k-th send on one
        # edge is the same k no matter how other edges interleave
        key = name if edge is None else f"{name}|{edge[0]}->{edge[1]}"
        with self._lock:
            hit = self._hits.get(key, 0) + 1
            self._hits[key] = hit
            if spec.mode == "nth":
                # until=M widens the one-shot to the window [N, M] —
                # a held partition, not a single dropped send
                until = int(spec.params.get("until", 0.0))
                if until > 0:
                    fire = int(spec.arg) <= hit <= until
                else:
                    fire = hit == int(spec.arg)
            elif spec.mode == "prob":
                rng = self._rngs.get(key)
                if rng is None:
                    rng = self._rngs[key] = random.Random(
                        f"{self.seed}:{key}"
                    )
                fire = rng.random() < spec.arg
            else:  # after
                fire = (
                    time.monotonic() - self.activated_at >= spec.arg
                )
            if not fire:
                return None
            act = FaultAction(
                point=name, mode=spec.mode, hit=hit,
                delay_s=spec.params.get("delay_ms", 0.0) / 1e3,
                skew_s=spec.params.get("skew_ms", 0.0) / 1e3,
                retry_after_ms=int(spec.params.get("retry_after_ms", 1000)),
                exit=bool(spec.params.get("exit", 0.0)),
                after_msgs=int(spec.params.get("after_msgs", 3.0)),
                ticks=int(spec.params.get("ticks", 0.0)),
            )
            entry = {"point": name, "mode": spec.mode, "hit": hit,
                     "model": model}
            if edge is not None:
                entry["edge"] = f"{edge[0]}->{edge[1]}"
            self._journal.append(entry)
        self._record(act, model)
        return act

    def _record(self, act: FaultAction, model: str) -> None:
        """Observability for a fired fault — outside the plan lock (the
        recorder and metric children take their own)."""
        obs.FAULTS_INJECTED.labels(point=act.point, mode=act.mode).inc()
        from ..obs import flightrec, incidents  # late: obs import order

        flightrec.RECORDER.model_event(
            model or "faults", "fault",
            point=act.point, mode=act.mode, hit=act.hit,
        )
        # a fired fault is an incident trigger — the bundle freezes the
        # telemetry window around the injection (no-op when unarmed;
        # the per-(model, cause) cooldown keeps fault storms bounded)
        incidents.notify(model or "faults", "fault",
                         point=act.point, mode=act.mode, hit=act.hit)
        log.warning(
            "fault injected: %s (%s, hit %d)%s",
            act.point, act.mode, act.hit,
            f" on {model}" if model else "",
        )

    def journal(self) -> List[dict]:
        with self._lock:
            return list(self._journal)


# The active plan. None = faults disabled; the hot-path cost of a
# disabled point() is one global load + is-None check.
_PLAN: Optional[FaultPlan] = None
_swap = threading.Lock()  # activate/deactivate only — never on hot paths


def point(name: str, model: str = "",
          edge: Optional[Tuple[str, str]] = None,
          surface: str = "") -> Optional[FaultAction]:
    """The hot-path call: None when no schedule is active or the point
    does not fire; a :class:`FaultAction` telling the call site what to
    inject otherwise. ``edge=(src_host, dst_host)`` scopes the per-edge
    net points; ``surface`` ("rpc"/"http") narrows them further."""
    plan = _PLAN
    if plan is None:
        return None
    return plan.check(name, model, edge=edge, surface=surface)


def active() -> bool:
    return _PLAN is not None


def fired() -> List[dict]:
    """The active plan's fired-fault journal (empty when inactive) —
    ordered ``{point, mode, hit, model}`` dicts, the determinism
    fingerprint chaos re-runs compare."""
    plan = _PLAN
    return plan.journal() if plan is not None else []


def activate(spec: str, seed: Optional[int] = None) -> FaultPlan:
    """Arm a schedule programmatically (tests, ``bench.py --chaos``).
    ``spec`` uses the ``AIOS_TPU_FAULTS`` grammar; an explicit ``seed``
    overrides the spec's ``seed=`` entry. Returns the plan (its
    ``journal()`` is the run's injected-fault sequence)."""
    global _PLAN
    schedule, spec_seed = _parse(spec)
    plan = FaultPlan(schedule, seed if seed is not None else spec_seed)
    with _swap:
        _PLAN = plan
    if schedule:
        log.warning(
            "fault injection ACTIVE (seed %d): %s", plan.seed,
            ", ".join(
                f"{n}={s.mode}:{s.arg:g}" for n, s in schedule.items()
            ),
        )
    return plan


def deactivate() -> None:
    global _PLAN
    with _swap:
        _PLAN = None


def install_from_env() -> None:
    """Arm (or disarm) from ``AIOS_TPU_FAULTS`` — called at import so a
    booted process carries its schedule from birth, and callable again
    after an env change (tests)."""
    raw = os.environ.get("AIOS_TPU_FAULTS", "").strip()
    if raw:
        activate(raw)
    else:
        deactivate()


def _parse(spec: str) -> Tuple[Dict[str, _PointSpec], int]:
    """``seed=42;point=mode:arg[,k=v...];...`` -> (schedule, seed).
    Malformed entries log and drop (never take down a boot)."""
    schedule: Dict[str, _PointSpec] = {}
    seed = 0
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        name, _, rest = entry.partition("=")
        name, rest = name.strip(), rest.strip()
        if name == "seed":
            try:
                seed = int(rest)
            except ValueError:
                log.warning("AIOS_TPU_FAULTS: bad seed %r ignored", rest)
            continue
        if name not in POINTS:
            log.warning(
                "AIOS_TPU_FAULTS: unknown point %r ignored (known: %s)",
                name, ", ".join(POINTS),
            )
            continue
        head, *params = rest.split(",")
        mode, _, arg = head.partition(":")
        mode = mode.strip()
        if mode not in MODES:
            log.warning(
                "AIOS_TPU_FAULTS: %s: unknown trigger %r ignored "
                "(known: %s)", name, mode, ", ".join(MODES),
            )
            continue
        try:
            argv = float(arg)
        except ValueError:
            log.warning(
                "AIOS_TPU_FAULTS: %s: bad trigger arg %r ignored",
                name, arg,
            )
            continue
        kv: Dict[str, float] = dict(_PARAM_DEFAULTS.get(name, ()))
        sv: Dict[str, str] = {}
        ok = True
        for p in params:
            k, _, v = p.partition("=")
            k = k.strip()
            if k in _STR_PARAMS:
                sv[k] = v.strip()
                continue
            try:
                kv[k] = float(v)
            except ValueError:
                log.warning(
                    "AIOS_TPU_FAULTS: %s: bad param %r ignored — "
                    "dropping the whole entry", name, p,
                )
                ok = False
        if ok:
            schedule[name] = _PointSpec(mode, argv, kv, sv)
    return schedule, seed


install_from_env()
