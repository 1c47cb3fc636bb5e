"""The declared concurrency model of the port's serving plane.

This file is the single place that states WHICH locks exist,
what each one is allowed to shelter, which fields they guard, and which
functions run with a lock already held by their caller (hooks reached
through dynamic dispatch the AST cannot follow). The rules in
:mod:`aios_tpu_torch.analysis.rules` are generic; everything specific to
the port lives here, so adding a lock to the serving plane is a one-line
registry change, and forgetting to add it means the analyzer simply does
not defend it, which shows at a glance.

The same declarations drive the runtime half: ``locks.make_lock(<name>)``
call sites in the declared modules switch to the order-checking
:class:`~aios_tpu_torch.analysis.locks.DebugLock` under
``AIOS_TPU_LOCK_DEBUG=1`` (the lock NAMES here and there must match;
``tests/test_torch_analysis.py`` checks both directions).

A lock is an attribute of a class (``class_name`` set: instances of that
class and its in-module subclasses hold it as ``self.<attr>``) or a
module-level global (``class_name`` None: ``with <attr>:`` anywhere in its
module).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

# hazard classes rule lock-discipline knows how to spot
HAZARDS = ("dispatch", "readback", "rpc")


@dataclass(frozen=True)
class LockDecl:
    """One declared lock: where it lives and what its body must not do."""

    name: str                  # registry id, also the DebugLock name
    module: str                # dotted module
    class_name: Optional[str]  # owning class; None for a module-level lock
    attr: str                  # attribute (or module global) the lock is stored under
    forbids: Tuple[str, ...] = HAZARDS

    @property
    def module_level(self) -> bool:
        return self.class_name is None


_E = "aios_tpu_torch.engine"
_O = "aios_tpu_torch.obs"
_S = "aios_tpu_torch.serving"

# -- the lock registry -------------------------------------------------------
# The engine lock's JOB is sheltering the dispatch (graph replays and
# captures) and the state it moves, so it forbids only host-blocking work
# (device readback, RPC and waits). Every other serving-plane lock is a
# pure bookkeeping lock: a dispatch or readback under it stalls the
# router/scheduler/scrape threads that share it.

LOCKS: Tuple[LockDecl, ...] = (
    # -- the roles of the JAX package's registry, at their port counterparts
    LockDecl("engine", f"{_E}.engine", "TorchEngine", "_lock",
             forbids=("readback", "rpc")),
    LockDecl("engine_spill", f"{_E}.engine", "TorchEngine", "_spill_lock"),
    LockDecl("prefix_index", f"{_E}.paged", "_PrefixIndexBase", "_lock"),
    LockDecl("host_store", f"{_E}.paged", "HostPageStore", "_lock"),
    LockDecl("batcher", f"{_E}.batching", "ContinuousBatcher", "_lock"),
    LockDecl("batcher_queue", f"{_E}.batching", "ContinuousBatcher", "_qlock"),
    LockDecl("json_masks", f"{_E}.batching", "ContinuousBatcher",
             "_json_masks_lock"),
    LockDecl("pool", f"{_S}.pool", "ReplicaPool", "_lock"),
    LockDecl("router", f"{_S}.router", "Router", "_lock"),
    LockDecl("admission", f"{_S}.admission", "AdmissionController", "_lock"),
    LockDecl("token_bucket", f"{_S}.admission", "TokenBucket", "_lock"),
    LockDecl("recorder", f"{_O}.flightrec", "FlightRecorder", "_lock"),
    LockDecl("slo", f"{_O}.slo", "SLOEngine", "_lock"),
    LockDecl("model_manager", "aios_tpu_torch.runtime.model_manager",
             "ModelManager", "_lock"),
    LockDecl("faults", "aios_tpu_torch.faults.inject", "FaultPlan", "_lock"),
    LockDecl("failover", f"{_S}.failover", "FailoverHandle", "_lock"),
    LockDecl("devprof", f"{_O}.devprof", "DevprofLedger", "_lock"),
    # autoscale: pure bookkeeping (hold counters, action journal, the
    # added-engine list); engine builds and pool mutations run outside
    LockDecl("autoscale", f"{_S}.autoscale", "AutoscaleController", "_lock"),
    # fleet: pure bookkeeping (member table, transition journal, peer
    # set); announces/scrapes (urllib) and metric/recorder emission for
    # state edges always run outside it
    LockDecl("fleet", f"{_O}.fleet", "FleetRegistry", "_lock"),
    # handoff: cancel/terminal flags and the live local-handle ref on a
    # disaggregated stream; the transfer RPCs themselves (push, fetch,
    # the handoff stream) always run outside it
    LockDecl("handoff", "aios_tpu_torch.fleet.disagg", "HandoffHandle", "_lock"),
    # quarantine: per-peer breaker bookkeeping (EWMAs, state, probe
    # budget); the cross-host calls whose outcomes feed it always run
    # outside, and metric/recorder emission for state edges happens
    # after release (no quarantine->recorder lock edge)
    LockDecl("quarantine", "aios_tpu_torch.fleet.breaker", "BreakerBoard", "_lock"),
    # drain: the phase flag and the one-shot worker handle; the drain
    # protocol itself (pool drain, kvx pushes, the leaving announce)
    # runs on its worker thread outside the lock
    LockDecl("drain", "aios_tpu_torch.fleet.drain", "DrainCoordinator", "_lock"),
    # tsdb: the series map and per-series ring/wheel deques; registry
    # reads (which take metric locks) run before it, metric emission
    # after release; queries copy points under it and aggregate outside
    LockDecl("tsdb", f"{_O}.tsdb", "Tsdb", "_lock"),
    # incidents: bundle deque, cooldown stamps, id counter; bundle
    # construction (tsdb/recorder/faults/devprof reads) and metric/
    # recorder emission always run outside it
    LockDecl("incidents", f"{_O}.incidents", "IncidentStore", "_lock"),
    # -- the port's own serving locks
    # engine_dp: the devprof timing tokens of dispatches that read nothing
    # back, handed from the dispatching thread to a later readback; the
    # tokens' events are polled (``done``), never waited on, under it
    LockDecl("engine_dp", f"{_E}.engine", "TorchEngine", "_dp_lock"),
    # graph_capture: one CUDA graph capture at a time in the process (the
    # caching allocator's rule), taken inside the capturing engine's lock;
    # a capture records launches and dispatches nothing
    LockDecl("graph_capture", f"{_E}.graphs", None, "_capture_lock",
             forbids=("readback", "rpc")),
    # profile_capture: the on-demand profiler's status record; the
    # profiler itself (start, sleep, stop, export) runs on its own thread
    # outside it
    LockDecl("profile_capture", f"{_O}.devprof", None, "_capture_lock"),
)


# -- static type hints the AST cannot infer ---------------------------------
# (module, class, field) -> (module, class): lets the one-level call walk
# cross object boundaries (`self.engine.step(...)` under a batcher lock is
# a dispatch; `self.prefix_index.put(...)` under the engine lock acquires
# the index lock; `self.graphs.capture(...)` under it takes the capture
# lock).

FIELD_TYPES: Dict[Tuple[str, str, str], Tuple[str, str]] = {
    (f"{_E}.engine", "TorchEngine", "prefix_index"):
        (f"{_E}.paged", "_PrefixIndexBase"),
    (f"{_E}.engine", "TorchEngine", "host_store"):
        (f"{_E}.paged", "HostPageStore"),
    (f"{_E}.engine", "TorchEngine", "graphs"):
        (f"{_E}.graphs", "GraphSet"),
    (f"{_E}.engine", "TorchEngine", "_devprof"):
        (f"{_O}.devprof", "DevprofLedger"),
    (f"{_E}.engine", "ChunkedPrefill", "engine"):
        (f"{_E}.engine", "TorchEngine"),
    (f"{_E}.batching", "ContinuousBatcher", "engine"):
        (f"{_E}.engine", "TorchEngine"),
    (f"{_S}.pool", "ReplicaPool", "router"):
        (f"{_S}.router", "Router"),
    (f"{_S}.pool", "ReplicaPool", "admission"):
        (f"{_S}.admission", "AdmissionController"),
    (f"{_S}.pool", "Replica", "engine"):
        (f"{_E}.engine", "TorchEngine"),
    (f"{_S}.pool", "Replica", "batcher"):
        (f"{_E}.batching", "ContinuousBatcher"),
    (f"{_S}.autoscale", "AutoscaleController", "pool"):
        (f"{_S}.pool", "ReplicaPool"),
}

# module-level singletons: bare/dotted name -> (module, class)
GLOBAL_TYPES: Dict[str, Tuple[str, str]] = {
    "RECORDER": (f"{_O}.flightrec", "FlightRecorder"),
}

# -- caller-held lock contexts ----------------------------------------------
# (module, qualname) -> lock names already held when the function runs.
# These are the dynamic-dispatch seams the AST cannot see through; each
# entry mirrors a docstring contract in the named function.

CONTEXT_FNS: Dict[Tuple[str, str], Tuple[str, ...]] = {
    # prefix-index eviction runs from engine-lock-holding callers (see
    # _PrefixIndexBase._drop's docstring), and _drop calls the engine's
    # spill hook synchronously ("Caller holds the lock")
    (f"{_E}.paged", "_PrefixIndexBase._drop"): ("engine",),
    (f"{_E}.engine", "TorchEngine._spill_pages"): ("engine",),
    # the engine's helpers whose docstrings say "Caller holds the lock":
    # staging, the readbacks of an admission and a megagraph, the prefix
    # and host-tier bookkeeping, the dispatch and capture helpers
    **{(f"{_E}.engine", f"TorchEngine.{fn}"): ("engine",) for fn in (
        "_stage_admission", "_stage_tables", "_admitted", "_match_prefix",
        "_stage_page_ids", "_restore_from_host", "_scatter_pages",
        "_backfill_history", "_register_prefix", "_maybe_compress",
        "_back_active_slots", "_dispatcher", "_capture", "_write_mask",
        "_stage_ticks", "_capture_ticks", "_replay_ticks",
    )},
    # the batcher's shared token->bytes table: built under the JSON-mask
    # lock ("caller holds the lock")
    (f"{_E}.batching", "ContinuousBatcher._token_bytes"): ("json_masks",),
    # ring accessor contract: only FlightRecorder.finish calls it, under
    # the recorder lock (the lazy setdefault would race otherwise)
    (f"{_O}.flightrec", "FlightRecorder._ring"): ("recorder",),
    # journal appends happen inside the state-transition critical
    # sections of _observe/tick (see _journal_append's comment)
    (f"{_O}.fleet", "FleetRegistry._journal_append"): ("fleet",),
}

# hook attributes whose call target is registered dynamically:
# (module, attr-name called as `self.<attr>(...)`) -> (module, qualname)
HOOK_TARGETS: Dict[Tuple[str, str], Tuple[str, str]] = {
    (f"{_E}.paged", "spill"): (f"{_E}.engine", "TorchEngine._spill_pages"),
    (f"{_E}.paged", "reclaimer"): (f"{_E}.paged", "_PrefixIndexBase.reclaim"),
}

# closure-passed locks: (module, qualname, local name) -> lock name
# (the static spill worker receives the spill lock as a parameter)
LOCAL_LOCKS: Dict[Tuple[str, str, str], str] = {
    (f"{_E}.engine", "TorchEngine._spill_worker", "lock"): "engine_spill",
}

# -- hazard call shapes ------------------------------------------------------
# Device dispatch: a CUDA graph's replay or capture, the engine's dispatch
# helpers, and the engine's dispatching public surface (what a batcher or
# pool calls), eager twins included.

DISPATCH_TERMINALS = frozenset({
    "replay", "capture", "_dispatcher", "_capture",
    "step", "step_async", "step_masked", "prefill", "spec_step", "jump_step",
    "mega_step", "mega_step_async", "spec_step_draft", "start_chunked_prefill",
    "step_eager", "step_masked_eager", "prefill_eager", "jump_step_eager",
    "spec_step_eager", "spec_step_draft_eager", "generate",
})

# Device-to-host readback or a host-blocking device sync: a tensor's
# `.item()` / `.tolist()` / `.cpu()` / `.numpy()` / `.to("cpu")`,
# `torch.cuda.synchronize`, and a CUDA event's or stream's
# `synchronize` / `elapsed_time` / `query`.
READBACK_TERMINALS = frozenset({
    "item", "tolist", "cpu", "numpy", "synchronize", "elapsed_time", "query",
})
READBACK_TO_DEVICE = "cpu"  # `.to("cpu")` / `.to(device="cpu")`

# blocking RPC / host waits: gRPC stubs, channel readiness, future
# results, sleeps, waits, and a thread's (or queue's) join. `.get(` is
# deliberately absent (dict.get); `join` counts only in Thread.join's
# shapes (no argument, a number or `timeout=`), never str.join's.
RPC_TERMINALS = frozenset({
    "sleep", "channel_ready_future", "result", "wait",
})
RPC_JOIN = "join"
RPC_CHAIN_MARKER = "stub"  # any chain segment containing this matches


# -- dispatch hygiene (rule graph-warmup) ------------------------------------
# Serving-path modules where a graph capture (`_capture(...)` or
# `GraphSet.capture(...)`) must be reachable from a warmup root and
# reachable from no serving entry except through a waived call: the
# "graph_captures flat while serving" invariant, statically.

DISPATCH_HYGIENE_MODULES: Tuple[str, ...] = (
    f"{_E}.engine",
    f"{_E}.batching",
    # the draft model's proposer: its rounds are captured from engine.py
    # behind capture_draft, but the module itself is serving-path
    f"{_E}.spec",
)

# a function whose NAME matches counts as a warmup registration root
WARMUP_ROOT_RE = re.compile(r"^(warmup|capture_\w+)$")
# the capture calls the rule polices
CAPTURE_TERMINALS = frozenset({"_capture", "capture"})
# a function whose NAME matches is a serving entry: the engine's public
# dispatching surface
SERVING_ENTRY_RE = re.compile(
    r"^(step|step_async|step_masked|prefill|spec_step|jump_step|mega_step"
    r"|mega_step_async|spec_step_draft|start_chunked_prefill|generate)$"
)


# -- silent-except (rule silent-except) -------------------------------------
# Broad `except Exception` / `except BaseException` / bare `except:`
# handlers in these module prefixes must RECORD the failure (re-raise,
# log it, or land an abort/terminal cause) or carry an
# `# aios: waive(silent-except): <reason>` pragma.

SILENT_EXCEPT_PREFIXES: Tuple[str, ...] = (
    "aios_tpu_torch.serving", "aios_tpu_torch.engine",
)

# terminal callee names that count as recording the failure: logging,
# flight-recorder terminal events, gRPC error surfacing, and the
# batcher/pool abort plumbing (which sets abort_reason downstream)
SILENT_EXCEPT_RECORDERS = frozenset({
    "exception", "error", "warning", "critical",
    "finish", "finish_shed", "model_event", "snapshot",
    "abort", "set_details",
    "_abort_all", "_terminate_outstanding", "_finish", "_rec_close",
    "shed", "note_failed_restore",
})

BROAD_EXCEPTION_NAMES = frozenset({"Exception", "BaseException"})


# -- knob/docs drift (rule knob-docs) ---------------------------------------

KNOB_RE = re.compile(r"AIOS_TPU_[A-Z0-9_]+")
CONFIG_DOC = "docs/CONFIG.md"
# the declared tuples of knobs the port does not read: a name there
# answers for a row of CONFIG_DOC, but is not itself a read
KNOB_DECLARATIONS: Tuple[Tuple[str, str], ...] = (
    ("aios_tpu_torch.runtime.model_manager", "UNPORTED_KNOBS"),
    ("aios_tpu_torch.runtime.model_manager", "NOT_CARRIED_KNOBS"),
)

# metric constructors that must only run inside the instruments catalog
METRIC_CTORS = frozenset({"Counter", "Gauge", "Histogram"})
METRIC_PREFIX = "aios_tpu_"
METRIC_CATALOG_MODULES = frozenset({
    f"{_O}.instruments", f"{_O}.metrics",
})


@dataclass
class Registry:
    """Bundle of the declarations above; tests construct custom ones to
    drive rule fixtures, production uses :data:`DEFAULT`."""

    locks: Tuple[LockDecl, ...] = LOCKS
    field_types: Dict[Tuple[str, str, str], Tuple[str, str]] = field(
        default_factory=lambda: dict(FIELD_TYPES))
    global_types: Dict[str, Tuple[str, str]] = field(
        default_factory=lambda: dict(GLOBAL_TYPES))
    context_fns: Dict[Tuple[str, str], Tuple[str, ...]] = field(
        default_factory=lambda: dict(CONTEXT_FNS))
    hook_targets: Dict[Tuple[str, str], Tuple[str, str]] = field(
        default_factory=lambda: dict(HOOK_TARGETS))
    local_locks: Dict[Tuple[str, str, str], str] = field(
        default_factory=lambda: dict(LOCAL_LOCKS))
    dispatch_hygiene_modules: Tuple[str, ...] = DISPATCH_HYGIENE_MODULES
    silent_except_prefixes: Tuple[str, ...] = SILENT_EXCEPT_PREFIXES
    silent_except_recorders: frozenset = SILENT_EXCEPT_RECORDERS
    knob_declarations: Tuple[Tuple[str, str], ...] = KNOB_DECLARATIONS

    def lock_named(self, name: str) -> Optional[LockDecl]:
        for d in self.locks:
            if d.name == name:
                return d
        return None


DEFAULT = Registry()
