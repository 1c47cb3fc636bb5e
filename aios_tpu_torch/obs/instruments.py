"""The port's metric catalog: the instruments its serving plane registers.

Copied from ``aios_tpu/obs/instruments.py``: the families that the replica
pool, admission, failover, the batcher and its pipelined loop, the engine's
speculation, megagraph, window+sink compression and prefix cache's host
tier, the runtime service and the fault points touch,
under the JAX package's names. The names do not collide when both packages
run in one process (the parity tests): each package's
instruments register in its own ``metrics.REGISTRY``, so one name lives
once in each registry and never twice in one. The other JAX families (RPC
interceptors, devprof, SLOs, the autoscaler, the fleet plane, the tsdb)
wait for the modules that emit them. An HTTP ``/metrics`` endpoint is not
ported yet: ``metrics.REGISTRY.render()`` gives the exposition text.

Hot paths resolve label children once and hold them (``labels()`` is a
dict lookup under a lock, fine per request, too slow per decoded token).
"""

from __future__ import annotations

from .metrics import Counter, Gauge, Histogram

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
