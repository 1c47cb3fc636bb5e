"""The port's metric catalog: the instruments its serving plane registers.

Copied from ``aios_tpu/obs/instruments.py``: the families that the RPC
interceptors, the replica pool, admission, failover, the autoscaler, the
batcher and its pipelined loop, the engine's speculation, megagraph,
window+sink compression, prefix cache's host tier and device ledger
(devprof), the runtime service, the SLO engine, the tsdb, incident bundles
and the fault points touch, the process-identity gauge, and those of the
service plane (orchestrator, agents, gateway, memory tiers, tools), under
the JAX package's names and types. The names do not collide when both
packages run in one process (the parity tests): each package's instruments
register in its own ``metrics.REGISTRY``, so one name lives once in each
registry and never twice in one. The fleet plane's families wait for the
fleet slice. ``obs/http.py`` serves the registry at ``/metrics``.

Hot paths resolve label children once and hold them (``labels()`` is a
dict lookup under a lock, fine per request, too slow per decoded token).
"""

from __future__ import annotations

from .metrics import Counter, Gauge, Histogram

# -- RPC layer (client + server interceptors, aios_tpu_torch/rpc.py) --------

RPC_REQUESTS = Counter(
    "aios_tpu_rpc_requests_total",
    "RPCs started, by side (client|server), service, and method",
    ("side", "service", "method"),
)
RPC_ERRORS = Counter(
    "aios_tpu_rpc_errors_total",
    "RPCs finished non-OK, by side, service, method, and status code",
    ("side", "service", "method", "code"),
)
RPC_LATENCY = Histogram(
    "aios_tpu_rpc_latency_seconds",
    "RPC wall time start->termination (streams: until exhausted)",
    ("side", "service", "method"),
)

# -- engine: the continuous batcher -----------------------------------------

ENGINE_TOKENS = Counter(
    "aios_tpu_engine_generated_tokens_total",
    "Tokens emitted to request streams by the continuous batcher",
    ("model",),
)

ENGINE_TOKENS_PER_SECOND = Gauge(
    "aios_tpu_engine_tokens_per_second",
    "Recent decode throughput per model (tokens/sec/chip, ~1 s window)",
    ("model",),
)

ENGINE_TTFT = Histogram(
    "aios_tpu_engine_ttft_seconds",
    "Submission -> first sampled token through the continuous batcher",
    ("model",),
)

ENGINE_QUEUE_DEPTH = Gauge(
    "aios_tpu_engine_queue_depth_total",
    "Requests waiting for a slot (admission backlog, scrape-time)",
    ("model",),
)

ENGINE_REQUESTS_COMPLETED = Counter(
    "aios_tpu_engine_requests_completed_total",
    "Requests retired normally (EOS / max_tokens / full cache)",
    ("model",),
)

ENGINE_REQUESTS_CANCELLED = Counter(
    "aios_tpu_engine_requests_cancelled_total",
    "Requests cancelled by the caller (gRPC disconnect, unload)",
    ("model",),
)

ENGINE_POOL_EVICTIONS = Counter(
    "aios_tpu_engine_pool_evictions_total",
    "Live requests retired to free KV pages under pool exhaustion",
    ("model",),
)

# -- speculative decoding (engine.spec_step / spec_step_draft) -------------
# Rounds and accepted tokens are engine counters summed over the live
# replica engines of a model; the acceptance ratio is the batchers' EWMA
# that drives the AIOS_TPU_SPEC_MIN_ACCEPT auto-disable, averaged over the
# live replica batchers. The ``proposer`` label is the closed enum
# spec.SPEC_PROPOSERS (ngram | draft).

SPEC_ROUNDS = Gauge(
    "aios_tpu_spec_rounds_total",
    "Speculative verify rounds dispatched by proposer (ngram|draft; "
    "monotonic, summed over replica engines)",
    ("model", "proposer"),
)
SPEC_ACCEPTED = Gauge(
    "aios_tpu_spec_accepted_total",
    "Draft tokens accepted by speculative verify (emitted tokens minus "
    "the one guaranteed token per slot-round; by proposer, monotonic, "
    "summed over replica engines)",
    ("model", "proposer"),
)
SPEC_ACCEPTANCE = Gauge(
    "aios_tpu_spec_acceptance_ratio",
    "EWMA draft-acceptance ratio (accepted / proposed) per model and "
    "proposer, averaged over replica batchers; drives the per-proposer "
    "AIOS_TPU_SPEC_MIN_ACCEPT auto-disable ladder",
    ("model", "proposer"),
)

# -- the decode dispatch loop (the pipelined batcher, AIOS_TPU_DECODE_PIPELINE)
# The host side of the decode loop: the host's time between consecutive
# decode dispatches (the card idles through it in the sync loop; the
# pipeline exists to hide it), whether a pipelined dispatch is in flight, and
# how often the pipeline drained early.

ENGINE_DISPATCH_HOST_GAP = Histogram(
    "aios_tpu_engine_dispatch_host_gap_seconds",
    "Host wall time between consecutive decode dispatches (emit/detok/"
    "retire/bookkeeping; the device idles through this unless pipelined)",
    ("model",),
    buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
             0.05, 0.1, 0.25, 1.0),
)
ENGINE_DISPATCH_INFLIGHT = Gauge(
    "aios_tpu_engine_dispatch_inflight_total",
    "Pipelined decode dispatches enqueued but not yet consumed, summed "
    "over the model's replica batchers (0..replicas; scrape-time)",
    ("model",),
)
ENGINE_DISPATCH_FLUSHES = Counter(
    "aios_tpu_engine_dispatch_flushes_total",
    "Pipelined decode flushes by cause "
    "(constrained|spec|evict|idle)",
    ("model", "cause"),
)

# -- the multi-tick decode megagraph (engine.mega_step): monotonic engine
# counters read at scrape time, summed over the model's live replica engines.
# dispatches * K - ticks is what the early exits saved.

ENGINE_MEGA_DISPATCHES = Gauge(
    "aios_tpu_engine_mega_dispatches_total",
    "Multi-tick decode megagraph dispatches (each replaced up to K "
    "single-tick dispatches; monotonic, summed over replica engines)",
    ("model",),
)
ENGINE_MEGA_TICKS = Gauge(
    "aios_tpu_engine_mega_ticks_total",
    "REAL decode ticks run inside megagraph dispatches (k per dispatch, "
    "k <= K on early exit; monotonic, summed over replica engines)",
    ("model",),
)

# -- window+sink KV compression: monotonic engine counters and the live
# residency of compressed slots, summed over the model's replica engines.

KV_COMPRESS_SLOTS = Gauge(
    "aios_tpu_kv_compress_slots_total",
    "Slots whose KV crossed the compression threshold and pruned to "
    "sink + window pages (monotonic, summed over replica engines)",
    ("model",),
)
KV_COMPRESS_PAGES_PRUNED = Gauge(
    "aios_tpu_kv_compress_pages_pruned_total",
    "KV pages released back to the pool by window+sink pruning "
    "(monotonic, summed over replica engines)",
    ("model",),
)
KV_COMPRESS_RESIDENT = Gauge(
    "aios_tpu_kv_compress_resident_pages",
    "Pages currently resident for compressed slots (sink + trailing "
    "window + partial block; scrape-time, summed over replica engines)",
    ("model",),
)

# -- the prefix cache's host tier (engine/paged.py HostPageStore) -------------
# Monotonic store counters surface as count-valued gauges read at scrape time,
# each the sum over the live stores of a model's replicas; only the restore
# latency is a histogram observed on the restore path.

PREFIX_HOST_BYTES = Gauge(
    "aios_tpu_prefix_host_resident_bytes",
    "Host-RAM bytes holding spilled prefix-page KV (scrape-time)",
    ("model",),
)
PREFIX_HOST_SPILLS = Gauge(
    "aios_tpu_prefix_host_spills_total",
    "Prefix pages spilled device->host on HBM eviction (monotonic)",
    ("model",),
)
PREFIX_HOST_RESTORES = Gauge(
    "aios_tpu_prefix_host_restores_total",
    "Prefix pages restored host->device into fresh pool pages (monotonic)",
    ("model",),
)
PREFIX_HOST_HITS = Gauge(
    "aios_tpu_prefix_host_hits_total",
    "Host-tier chain probes that found at least one spilled page "
    "(monotonic)",
    ("model",),
)
PREFIX_HOST_MISSES = Gauge(
    "aios_tpu_prefix_host_misses_total",
    "Host-tier chain probes that found nothing (monotonic)",
    ("model",),
)
PREFIX_HOST_MISSES_CORRUPT = Gauge(
    "aios_tpu_prefix_host_corrupt_total",
    "Spilled pages whose crc32 failed verification at restore probe "
    "time — dropped and recomputed instead of restored (monotonic)",
    ("model",),
)
PREFIX_HOST_RESTORE_SECONDS = Histogram(
    "aios_tpu_prefix_host_restore_seconds",
    "Host-side wall time to stage + dispatch one host->device prefix "
    "restore (the scatter itself is async and overlaps tail prefill)",
    ("model",),
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
             0.5, 1.0),
)

# -- runtime service -------------------------------------------------------

RUNTIME_INFER_LATENCY = Histogram(
    "aios_tpu_runtime_infer_latency_seconds",
    "Per-model inference RPC wall time (rpc = Infer|StreamInfer)",
    ("model", "rpc"),
)

RUNTIME_STREAM_CHUNKS = Counter(
    "aios_tpu_runtime_stream_chunks_total",
    "Text chunks emitted by StreamInfer",
    ("model",),
)

# -- serving layer (replica pool, router, admission, failover) --------------
# Labeled by the MANAGED model name (pool name), not the config name;
# ``replica`` is the replica index (bounded by the replica count).

SERVING_REPLICAS = Gauge(
    "aios_tpu_serving_replicas_total",
    "Live replicas in the pool (scrape-time)",
    ("model",),
)

SERVING_REPLICA_OCCUPANCY = Gauge(
    "aios_tpu_serving_replica_occupancy_ratio",
    "Per-replica active decode slots / total slots (scrape-time)",
    ("model", "replica"),
)

SERVING_ROUTING_DECISIONS = Counter(
    "aios_tpu_serving_routing_decisions_total",
    "Replica selections by reason (prefix|sticky|least_loaded|spill|single)",
    ("model", "reason"),
)

SERVING_SHED = Counter(
    "aios_tpu_serving_shed_total",
    "Requests shed at the front door, by cause "
    "(quota|deadline|queue_full|draining)",
    ("model", "cause"),
)

SERVING_QUOTA_REJECTIONS = Counter(
    "aios_tpu_serving_quota_rejections_total",
    "Token-bucket quota rejections per tenant",
    ("tenant",),
)

SERVING_QUEUE_WAIT = Histogram(
    "aios_tpu_serving_queue_wait_seconds",
    "Submission -> batcher admission (slot assignment) wall time",
    ("model",),
)

SERVING_REPLICA_RESTARTS = Counter(
    "aios_tpu_serving_replica_restarts_total",
    "Replica batchers respawned after a scheduler crash "
    "(the spawner-style restart counter, serving-side)",
    ("model",),
)

SERVING_FAILOVERS = Counter(
    "aios_tpu_serving_failover_total",
    "In-flight requests re-routed after a replica failure, by outcome "
    "(resumed = resubmitted to a surviving replica; exhausted = retry "
    "budget spent, surfaced as UNAVAILABLE + retry-after)",
    ("model", "outcome"),
)

# -- fault injection (faults/) ---------------------------------------------

FAULTS_INJECTED = Counter(
    "aios_tpu_faults_injected_total",
    "Faults fired by the seeded injection layer (point = injection-point "
    "name from faults.POINTS, mode = nth|prob|after)",
    ("point", "mode"),
)

# -- SLO engine (obs/slo.py, fed by the obs/flightrec.py recorder) ---------
# Labeled (model, objective) with ``objective`` drawn from the closed
# slo.OBJECTIVES enum (ttft|tpot|availability); the per-tenant breakdown
# stays in /debug/slo JSON (a tenant x model label product is unbounded).

SLO_ATTAINMENT = Gauge(
    "aios_tpu_slo_attainment_ratio",
    "Fraction of windowed requests meeting the objective's target "
    "(objective=ttft|tpot|availability; scrape-time, sliding window)",
    ("model", "objective"),
)
SLO_BURN_RATE = Gauge(
    "aios_tpu_slo_burn_rate_ratio",
    "Error-budget burn rate: (1 - attainment) / (1 - target); 1.0 burns "
    "exactly at budget, >1 eats future budget (scrape-time)",
    ("model", "objective"),
)
SLO_BREACHES = Counter(
    "aios_tpu_slo_breaches_total",
    "Windowed attainment fell below target (edge-triggered per "
    "(model, objective); each breach freezes a flight-recorder snapshot)",
    ("model", "objective"),
)

# -- SLO autoscaler (serving/autoscale.py) ----------------------------------
# ``action`` and ``cause`` are the closed autoscale.ACTIONS / CAUSES enums,
# every child pre-registered at controller construction.

AUTOSCALE_ACTIONS = Counter(
    "aios_tpu_autoscale_actions_total",
    "SLO-burn autoscaler actions (action=scale_up|scale_down|degrade|"
    "restore off the windowed burn rate; cause=burn|ceiling|recovery|"
    "kill_switch). Every action also lands on the flight recorder's "
    "model lane with level/replica evidence",
    ("model", "action", "cause"),
)

# -- device-time attribution (obs/devprof.py) --------------------------------
# Armed by AIOS_TPU_DEVPROF; every series' ``graph`` label is drawn from the
# closed devprof.GRAPH_KINDS enum (the engine registers the children by
# iterating it), and the per-graph series are monotonic ledger counters read
# at scrape time, summed over the model's live replica ledgers. Only the
# tenant counter is a true Counter, labeled by tenant alone.

DEVPROF_DISPATCHES = Gauge(
    "aios_tpu_devprof_dispatches_total",
    "Device dispatches per serving-graph kind (graph in the closed "
    "devprof.GRAPH_KINDS enum; monotonic, summed over replica ledgers)",
    ("model", "graph"),
)
DEVPROF_DEVICE_SECONDS = Gauge(
    "aios_tpu_devprof_device_seconds_total",
    "Estimated device-busy seconds per graph kind: mean sampled "
    "CUDA-event time extrapolated over all dispatches (summed over "
    "replica ledgers; raw even when the roofline is unknown)",
    ("model", "graph"),
)
DEVPROF_MFU = Gauge(
    "aios_tpu_devprof_mfu_ratio",
    "Model FLOPs utilization per graph kind: the analytic FLOPs of "
    "sampled dispatches / their CUDA-event seconds / the device's peak "
    "dense bf16 FLOP/s (devprof.DEVICE_PEAKS; omitted on unknown devices)",
    ("model", "graph"),
)
DEVPROF_HBM_UTIL = Gauge(
    "aios_tpu_devprof_hbm_bandwidth_utilization_ratio",
    "HBM bandwidth utilization per graph kind: the analytic bytes of "
    "sampled dispatches / their CUDA-event seconds / the device's peak "
    "HBM bytes/s (devprof.DEVICE_PEAKS; omitted on unknown devices)",
    ("model", "graph"),
)
DEVPROF_TENANT_SECONDS = Counter(
    "aios_tpu_devprof_tenant_device_seconds_total",
    "Estimated device-seconds billed per tenant at request retirement "
    "(timeline attribution: per-dispatch ledger means split by batch "
    "occupancy + measured prefill time; per-model detail in "
    "/debug/devprof)",
    ("tenant",),
)

# -- black-box time series (obs/tsdb.py) ------------------------------------
# Armed by AIOS_TPU_TSDB; the queries counter's ``verb`` label is the closed
# tsdb.QUERY_VERBS enum, pre-registered at ring construction.

TSDB_SAMPLES = Counter(
    "aios_tpu_tsdb_sample_passes_total",
    "Sampler passes completed (one pass reads the whole registry and "
    "appends one point per live series)",
)
TSDB_SERIES = Gauge(
    "aios_tpu_tsdb_series_total",
    "Series currently tracked by the ring (scrape-time; bounded by "
    "AIOS_TPU_TSDB_MAX_SERIES)",
)
TSDB_DROPPED = Gauge(
    "aios_tpu_tsdb_dropped_series_total",
    "Distinct series refused by the cardinality cap (monotonic, "
    "scrape-time) — the no-silent-truncation contract: a non-zero value "
    "means the ring is blind to that many series",
)
TSDB_QUERIES = Counter(
    "aios_tpu_tsdb_queries_total",
    "/debug/tsdb expressions evaluated, by verb (the closed "
    "tsdb.QUERY_VERBS enum: raw|rate|avg|min|max|p50|p90|p95|p99)",
    ("verb",),
)

# -- incident bundles (obs/incidents.py) ------------------------------------
# ``cause`` is the closed incidents.TRIGGER_CAUSES enum, pre-registered at
# store construction; fired + suppressed is the true trigger rate.

INCIDENTS = Counter(
    "aios_tpu_incidents_total",
    "Incident bundles frozen, by trigger cause (closed "
    "incidents.TRIGGER_CAUSES enum; each bundle = tsdb window + "
    "flightrec snapshot + fault journal + devprof + lock-watchdog "
    "state, served at /debug/incidents)",
    ("cause",),
)
INCIDENTS_SUPPRESSED = Counter(
    "aios_tpu_incidents_suppressed_total",
    "Triggers swallowed by the per-(model, cause) cooldown — a burst "
    "freezes exactly one bundle; this counter keeps the rest visible",
    ("cause",),
)

# -- fleet telemetry plane (obs/fleet.py, docs/OBSERVABILITY.md) -----------
# Every series is labeled (host, role) — host ids are one-per-process
# (bounded by fleet size, never per-request), and the transitions
# counter's ``state`` label is the CLOSED fleet.MEMBER_STATES enum
# (up|suspect|dead); the registry pre-registers every (host, role,
# state) child by iterating the tuple when a member is first seen (the
# autoscale/SLO registration pattern).

FLEET_MEMBER_UP = Gauge(
    "aios_tpu_fleet_member_up_total",
    "1 while the member's heartbeat is fresh, 0 once the failure "
    "detector marks it suspect/dead (the fleet 'up' boolean, per host "
    "and role)",
    ("host", "role"),
)
FLEET_TRANSITIONS = Counter(
    "aios_tpu_fleet_member_transitions_total",
    "Membership state-machine edges by destination state (state in the "
    "closed fleet.MEMBER_STATES enum: up|suspect|dead; every edge also "
    "lands in the transition journal and on the fleet recorder lane)",
    ("host", "role", "state"),
)
FLEET_SCRAPE_FAILURES = Counter(
    "aios_tpu_fleet_scrape_failures_total",
    "Federation/stitch fetches of a live member's endpoint that failed "
    "(the host drops out of that /metrics/fleet response — absence plus "
    "this counter is the signal)",
    ("host", "role"),
)
FLEET_KVX_PAGES = Counter(
    "aios_tpu_fleet_kvx_pages_total",
    "HostPageStore entries shipped over the fleet transfer plane, by "
    "direction (closed kvx.KVX_DIRECTIONS enum: push = prefill host "
    "streaming pages out, pull = decode host fetching on miss)",
    ("model", "direction"),
)
FLEET_KVX_BYTES = Counter(
    "aios_tpu_fleet_kvx_bytes_total",
    "Payload bytes shipped over the fleet transfer plane, by direction "
    "(same closed direction enum as the pages counter; packed wire "
    "bytes, crc envelopes excluded)",
    ("model", "direction"),
)
FLEET_KVX_FAILURES = Counter(
    "aios_tpu_fleet_kvx_failures_total",
    "Transfers that failed and fell back to local prefill, by cause "
    "(closed kvx.KVX_FAIL_CAUSES enum — crc_mismatch is the receiving "
    "end of the verified-at-both-ends contract rejecting a payload)",
    ("model", "cause"),
)
FLEET_ROUTE = Counter(
    "aios_tpu_fleet_route_total",
    "Fleet-level routing decisions by reason (closed "
    "router.FLEET_ROUTE_REASONS enum: the sticky -> overlap -> "
    "least-loaded ladder extended fleet-wide, plus the disagg handoff "
    "outcomes)",
    ("model", "reason"),
)
FLEET_PEER_BREAKER = Gauge(
    "aios_tpu_fleet_peer_breaker_state_total",
    "Per-peer circuit-breaker state as an index into the closed "
    "breaker.BREAKER_STATES enum (0=closed, 1=open, 2=half_open; "
    "anything non-zero means the peer is quarantined — routed around "
    "until consecutive successful probes clear it). host is the "
    "OBSERVING side of the edge",
    ("host", "peer"),
)
FLEET_ANNOUNCE_FAILURES = Counter(
    "aios_tpu_fleet_announce_failures_total",
    "Heartbeat announces that never got a reply, per peer address — "
    "a climbing single-peer count with members still up is the "
    "asymmetric-partition signature (RUNBOOK §11)",
    ("peer",),
)

# -- process identity (obs/fleet.py stamp, every metrics endpoint) ---------

PROCESS_INFO = Gauge(
    "aios_tpu_process_info",
    "Process identity info-gauge (constant 1): host id, rank, service "
    "role, package version — joins scrapes to the process that produced "
    "them",
    ("host", "rank", "role", "version"),
)

# -- orchestrator ----------------------------------------------------------

GOAL_TASKS = Counter(
    "aios_tpu_goal_tasks_total",
    "Task outcomes recorded by the result aggregator (outcome=success|failure)",
    ("outcome",),
)
GOAL_TASK_TOKENS = Counter(
    "aios_tpu_goal_task_tokens_total",
    "Model tokens consumed by recorded task outcomes",
)
GOAL_TASK_DURATION = Histogram(
    "aios_tpu_goal_task_duration_seconds",
    "Wall time of recorded task outcomes",
)
DECISIONS = Counter(
    "aios_tpu_decisions_total",
    "Decisions logged, by intelligence level",
    ("level",),
)
SCHEDULER_FIRED = Counter(
    "aios_tpu_scheduler_fired_total",
    "Cron schedules fired into goal submission",
)
ROUTER_TASKS = Counter(
    "aios_tpu_router_tasks_total",
    "Task routing outcomes (outcome=routed|ai_path|no_capable_agent)",
    ("outcome",),
)

# -- agents ----------------------------------------------------------------

AGENT_RESTARTS = Counter(
    "aios_tpu_agent_restarts_total",
    "Agent child-process restarts by the spawner",
    ("agent",),
)

# -- api gateway -----------------------------------------------------------

GATEWAY_SPEND = Counter(
    "aios_tpu_gateway_spend_usd_total",
    "Cloud spend recorded against provider budgets (USD)",
    ("provider",),
)
GATEWAY_TOKENS = Counter(
    "aios_tpu_gateway_tokens_total",
    "Cloud tokens by provider and direction (input|output)",
    ("provider", "direction"),
)

# -- memory tiers ----------------------------------------------------------

MEMORY_TIER_LOOKUPS = Counter(
    "aios_tpu_memory_tier_lookups_total",
    "Tier lookups (tier=operational|working|longterm|knowledge, "
    "result=hit|miss)",
    ("tier", "result"),
)

# -- tools -----------------------------------------------------------------

TOOL_INVOCATIONS = Counter(
    "aios_tpu_tool_invocations_total",
    "Tool executions recorded in the audit ledger (outcome=success|failure)",
    ("tool", "outcome"),
)
