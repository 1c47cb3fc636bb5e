"""Continuous batching: many concurrent requests over one decode loop.

The port of the main-path behaviour of ``aios_tpu/engine/batching.py``. A
single scheduler thread assigns each waiting request a slot (highest
effective priority first, with queue age as a tie-breaking boost), prefills
its prompt, and advances every active slot together in dispatches of
``CHUNK_STEPS`` tokens — ``ADMIT_CHUNK_STEPS`` while others wait, so
admission latency stays low. A prompt longer than ``prefill_chunk`` (the
engine's 512 by default) is admitted one chunk per scheduler pass, one such
admission at a time on a reserved slot, with decode dispatches of the live
slots between its chunks, so a long prompt never stalls the other streams
for its whole prefill. Requests retire on a stop token, on
``max_tokens`` or at the cache end; cancelled ones free their slot at the
next scheduler boundary. When the page pool cannot back a dispatch or an
admission, the lowest-priority longest request is evicted (its stream ends
as an abort) and the work retries.

With ``speculative=True`` every decode tick is a speculative dispatch over
either cache: greedy requests emit the same tokens in fewer dispatches,
sampling requests one token per round. The proposer ladder is the JAX
batcher's: the engine's draft model (``TorchEngine.spec_step_draft``) when
it carries one and a greedy request is live, then prompt lookup
(``spec_step``, the n-gram proposer). Each proposer keeps its own
acceptance EWMA (accepted over proposed tokens for the draft), suspension
and probe budget, so a collapsed draft falls back to n-gram and a
collapsed n-gram to plain ticks, each re-probed later; ``degrade_spec``
switches speculation off from outside. On a CUDA engine every dispatch
replays a graph; attaching captures those this batcher dispatches (its
``spec_draft_len`` and ``spec_ngram``, and the draft's round and ingest
widths) if the engine's warmup did not.

A request with ``json_mode`` (one JSON object) or ``json_schema`` (that
schema's shape, ``jsonschema.py``) is grammar-constrained; the batcher
needs the model's ``tokenizer`` for it. Its first token is the grammar's
opener (``engine.force_pending_token``), and while any constrained request
is live every tick is one dispatch: a jump (``engine.jump_step``) when some
constrained slot's automaton forces a run of two or more tokens
(jump-ahead, on unless ``jump_ahead`` is False, ``AIOS_TPU_JUMP_AHEAD`` or
the config say otherwise; setting the ``jump_ahead`` attribute sheds it
from outside), else
one masked step (``engine.step_masked``) with the constrained slots' mask
rows, cached on the device per automaton state; unconstrained slots decode
in the same step with zero rows. Attaching captures every jump bucket when
the engine holds the masked graph.

For the serving plane (``serving/``) the batcher carries what the JAX
batcher gives its replica pool: each request's flight-recorder timeline
(``Request.rec``: queue wait, one event per prefill, chunk and dispatch, the
terminal event) and its failover controller (``Request.failover``: an
abort the controller claims leaves the terminal event to it), the live
numbers the router and admission read (``outstanding_tokens``,
``tokens_per_second``, ``active_count``, ``queue_wait_obs``), the degrade
switches (``degrade_spec``, ``degrade_jump``), the metric families of
``obs/instruments.py`` and two fault points: ``dispatch.delay`` before a
decode dispatch and ``pool.scheduler_crash`` on a tick with live slots.
A scheduler failure aborts every outstanding request (slots and their
page references released) and is kept in ``last_error``; the pool then
respawns the batcher over the same engine. A CUDA error is not such a
failure: it poisons the context every replica shares, so the scheduler
aborts its requests with ``device fault`` (no cause failover retries),
keeps the error in ``device_fault``, calls ``on_device_fault`` and stops;
nothing respawns it.

The decode loop's modes (the JAX batcher's): with ``pipeline``
(``AIOS_TPU_DECODE_PIPELINE``) a plain decode tick hands dispatch N+1 to
the engine's dispatch worker (``engine.step_async``) before it emits
dispatch N's tokens, a depth-2 double buffer; each in-flight dispatch
carries the live map it was issued for and the lengths after it, so
retirement reads what the sync loop would read and the streams are the
same. The pipeline drains first (``_flush_pending``) at a constrained or
speculative tick, an eviction and an idle tick, and a scheduler failure
drops it. With the engine's ``mega_ticks`` a plain tick is one megagraph
dispatch of up to ``min(n, mega_ticks)`` ticks (``engine.mega_step``, or
``mega_step_async`` pipelined) with each slot's first stop ids and its
remaining budget on the device (``_mega_operands``); its tokens retire
against the per-tick lengths. Speculative ticks never pipeline.
"""

from __future__ import annotations

import itertools
import logging
import os
import queue
import threading
import time
import weakref
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import faults
from ..device import DEVICE_FAULT_REASON, is_device_fault
from ..obs import flightrec
from ..obs import instruments as obs
from . import jsonmode, jsonschema
from .engine import (JUMP_BUCKETS, MEGA_STOP_SLOTS, SPEC_DRAFT_LEN, SPEC_NGRAM,
                     ChunkedPrefill, PendingDecode, TorchEngine, _env_flag,
                     jump_ahead_enabled)
from .paged import PoolExhausted
from .sampling import GREEDY_EPS
from .spec import SPEC_PROPOSERS

log = logging.getLogger("aios.torch.batcher")

_END = object()

# Queued requests gain +1 effective priority per this many seconds waiting,
# bounding starvation under sustained higher-priority traffic.
PRIORITY_AGING_SECS = 5.0

# Decode steps per dispatch, and while requests wait for admission (the JAX
# batcher's chunk_steps / admit_chunk_steps defaults).
CHUNK_STEPS = 16
ADMIT_CHUNK_STEPS = 2

# Speculation auto-disable (the JAX batcher's constants): how long a collapsed
# proposer stays suspended, the weight of a dispatch in its acceptance EWMA,
# and how many probe dispatches re-measure before the floor judges again.
SPEC_REPROBE_SECS = 10.0
SPEC_EWMA_ALPHA = 0.3
SPEC_PROBE_DISPATCHES = 3

# Backoff hint of a retryable abort (the JAX batcher's default).
DEFAULT_RETRY_AFTER_MS = 1000

# Live batchers by model name: the acceptance gauge averages their EWMAs.
_BATCHERS_BY_MODEL: Dict[str, "weakref.WeakSet"] = {}


def _env_float(name: str, ok, why: str) -> Optional[float]:
    """A float from the environment, or None when unset or refused."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    try:
        value = float(raw)
        if not ok(value):
            raise ValueError(why)
    except ValueError as exc:
        log.warning("%s=%r ignored (%s)", name, raw, exc)
        return None
    return value


@dataclass
class Request:
    prompt_ids: List[int]
    max_tokens: int = 256
    temperature: float = 0.7
    top_p: float = 0.95
    stop_ids: Tuple[int, ...] = ()
    request_id: str = ""
    # grammar-constrained decoding: output restricted to one JSON object
    # (the reference's non-streaming response_format=json_object)
    json_mode: bool = False
    # structured outputs: output restricted to the exact SHAPE of this
    # schema (the jsonschema.py subset); wins over json_mode when both are
    # set (the stricter guarantee)
    json_schema: Optional[dict] = None
    # admission priority: higher admits first when slots are contended
    priority: int = 0
    # flight-recorder timeline riding the request through admission ->
    # routing -> scheduling; opened by the runtime service, the pool or the
    # batcher, whoever sees the request first. None when recording is off.
    rec: object = field(default=None, repr=False, compare=False)
    # transparent-failover controller (serving/failover.py), set by the
    # pool: it claims a retryable abort's terminal event and resumes the
    # stream on a surviving replica. None = no failover.
    failover: object = field(default=None, repr=False, compare=False)


@dataclass
class _Live:
    req: Request
    slot: int
    produced: int = 0
    out_q: "queue.Queue" = field(default_factory=queue.Queue)
    first_token_at: float = 0.0
    submitted_at: float = 0.0
    admitted_at: float = 0.0  # first slot assignment (queue-wait boundary)
    done: bool = False
    cancelled: bool = False
    # non-empty when the request was ABORTED (eviction, scheduler failure,
    # unload) rather than finished or cancelled
    abort_reason: str = ""
    constraint: Optional[jsonmode.JsonConstraint] = None  # json_mode / json_schema


@dataclass
class _PendingTick:
    """One pipelined decode dispatch in flight: the engine's handle, the
    live map as it was when the dispatch was issued (its tokens belong to
    those requests; one retired since has ``done`` set and its column is
    dropped at consume) and the flight-recorder events recorded at issue,
    which a megagraph's real tick count joins at consume."""

    pending: PendingDecode
    lives: Dict[int, "_Live"]
    evs: tuple = ()
    graph: str = "step"


class RequestHandle:
    """Caller-side view of an in-flight request (blocking token iterator)."""

    def __init__(self, live: _Live, batcher: "ContinuousBatcher"):
        self._live = live
        self._batcher = batcher

    def __iter__(self):
        while True:
            item = self._live.out_q.get()
            if item is _END:
                return
            yield item

    def tokens(self) -> List[int]:
        return list(self)

    def cancel(self) -> None:
        """Abort this request: its slot and pages free at the scheduler's
        next boundary and the iterator ends. Idempotent."""
        self._live.cancelled = True
        self._batcher._wake.set()

    @property
    def aborted(self) -> bool:
        """True when the stream ended by abort: the tokens are a truncation."""
        return bool(self._live.abort_reason)

    @property
    def abort_reason(self) -> str:
        return self._live.abort_reason

    @property
    def retry_after_ms(self) -> int:
        """Backoff hint of a RETRYABLE abort (0 when not aborted, or when a
        retry cannot help); the runtime service returns it as
        ``retry-after-ms`` trailing metadata."""
        reason = self._live.abort_reason
        if not reason:
            return 0
        if flightrec.abort_cause(reason) in flightrec.RETRYABLE_ABORT_CAUSES:
            return DEFAULT_RETRY_AFTER_MS
        return 0

    @property
    def ttft_ms(self) -> float:
        if not self._live.first_token_at:
            return 0.0
        return (self._live.first_token_at - self._live.submitted_at) * 1000.0


class ContinuousBatcher:
    """Background scheduler marrying a request queue to engine slots."""

    def __init__(
        self,
        engine: TorchEngine,
        speculative: bool = False,
        spec_draft_len: int = SPEC_DRAFT_LEN,
        spec_ngram: int = SPEC_NGRAM,
        spec_min_accept: Optional[float] = None,  # auto-disable floor
        spec_reprobe_secs: Optional[float] = None,  # suspension length
        prefill_chunk: Optional[int] = None,  # None: the engine's default; 0: off
        tokenizer=None,  # enables json_mode / json_schema requests
        jump_ahead: Optional[bool] = None,  # None: jump_ahead_enabled(cfg)
        pipeline: Optional[bool] = None,  # depth-2 pipelined decode loop
        chunk_steps: int = CHUNK_STEPS,
        admit_chunk_steps: int = ADMIT_CHUNK_STEPS,
    ) -> None:
        self.engine = engine
        self.chunk_steps = chunk_steps
        self.admit_chunk_steps = admit_chunk_steps
        # the pipelined decode loop (AIOS_TPU_DECODE_PIPELINE, else the
        # config's decode_pipeline): dispatch N+1 is issued before dispatch
        # N's tokens are emitted, so the host's emit and retire overlap the
        # card; it drains at constrained and speculative ticks, evictions
        # and idle ticks (_flush_pending)
        if pipeline is None:
            pipeline = _env_flag("AIOS_TPU_DECODE_PIPELINE")
        if pipeline is None:
            pipeline = bool(engine.cfg.decode_pipeline)
        self.pipeline = bool(pipeline)
        self._pending: Optional[_PendingTick] = None
        self.flushes = 0
        # the host's time between decode dispatches, less the time a
        # pipelined tick waited on the card for the previous tokens
        self.decode_dispatches = 0
        # the decode dispatches this batcher's engine ran, by devprof graph
        # kind (step, masked, mega, spec, draft_spec, jump): a pipelined one
        # counts once its tokens are collected
        self.dispatches_by_graph: Dict[str, int] = {}
        self.host_gap_seconds = 0.0
        self._gap_wait = 0.0
        # prompts longer than this admit incrementally, one chunk per
        # scheduler pass; off (whole-prompt prefill) when the engine's
        # buckets cannot honour it
        if prefill_chunk is None:
            prefill_chunk = engine.prefill_chunk_default
        self.prefill_chunk: Optional[int] = prefill_chunk or None
        if self.prefill_chunk is not None and (
                self.prefill_chunk not in engine.buckets
                or engine.max_context % self.prefill_chunk):
            self.prefill_chunk = None
        self.speculative = speculative
        self.spec_draft_len = spec_draft_len
        self.spec_ngram = spec_ngram
        # When the EWMA draft-acceptance ratio of the speculative dispatches
        # falls below this floor, speculation suspends for spec_reprobe_secs
        # and decode takes plain ticks, whose cost the failed drafts were
        # inflating. 0 never suspends. Unset, both come from the JAX stack's
        # variables.
        if spec_min_accept is None:
            spec_min_accept = _env_float(
                "AIOS_TPU_SPEC_MIN_ACCEPT", lambda v: 0.0 <= v <= 1.0, "must be in [0, 1]")
        self.spec_min_accept = 0.0 if spec_min_accept is None else spec_min_accept
        if spec_reprobe_secs is None:
            spec_reprobe_secs = _env_float(
                "AIOS_TPU_SPEC_REPROBE_SECS", lambda v: v > 0, "must be > 0")
        self.spec_reprobe_secs = (SPEC_REPROBE_SECS if spec_reprobe_secs is None
                                  else spec_reprobe_secs)
        # the proposer ladder: the draft model when the engine carries one,
        # prompt lookup always (its floor); the constrained tick's jump-ahead
        # outranks both. Per proposer: acceptance EWMA, suspension end,
        # probe budget, so an auto-disable falls one rung (draft -> ngram ->
        # off)
        self.spec_proposers: Tuple[str, ...] = (
            ("draft", "ngram") if engine.draft is not None else ("ngram",))
        self.spec_ewma: Dict[str, Optional[float]] = {p: None for p in self.spec_proposers}
        self._spec_off_until = {p: 0.0 for p in self.spec_proposers}
        self._spec_probe_left = {p: 0 for p in self.spec_proposers}
        self._spec_probe_seen = {p: 0 for p in self.spec_proposers}
        self.spec_autodisables = 0
        # the degrade ladder's switches (ReplicaPool.set_degrade_level):
        # speculation first, then grammar jump-ahead; greedy streams are the
        # same either way, so a flip mid-stream perturbs nothing (plain bool
        # stores, flipped cross-thread)
        self.degrade_spec = False
        self.degrade_jump = False
        # grammar jump-ahead: chains of grammar-FORCED tokens emit host-side
        # and append their K/V in one multi-token dispatch (over the pool
        # too: the jump's verify forward is verify_step_paged); the
        # degrade ladder sheds it through degrade_jump
        if jump_ahead is None:
            jump_ahead = jump_ahead_enabled(engine.cfg)
        self.jump_ahead = bool(jump_ahead)
        self.jump_max = JUMP_BUCKETS[-1]
        # constrained decoding: the token->bytes table, the shared json_mode
        # mask cache and the per-schema caches (LRU, 16; the schema is
        # client input), all built on first use
        self.tokenizer = tokenizer
        self._json_masks: Optional[jsonmode.JsonMaskCache] = None
        self._json_masks_lock = threading.Lock()
        self._token_table = None
        self._byte_matrix = None  # (mat, lens) shared across mask caches
        self._schema_caches: "OrderedDict[str, jsonschema.SchemaMaskCache]" = OrderedDict()
        self.pool_evictions = 0
        self.cancellations = 0
        self.completed = 0
        self.tokens_emitted = 0
        self.last_error: Optional[BaseException] = None
        # a CUDA error that stopped the scheduler for good, and the hook the
        # pool sets to hear of it (called once, on the scheduler thread)
        self.device_fault: Optional[BaseException] = None
        self.on_device_fault = None
        self._closed = False
        self._waiting: "deque[_Live]" = deque()  # guarded by _qlock
        self._qlock = threading.Lock()
        self._live: Dict[int, _Live] = {}  # guarded by _lock
        self._lock = threading.Lock()
        # the admission in flight, chunk by chunk, and its reserved slot
        # (inactive on the engine until the final chunk)
        self._prefilling: Optional[Tuple[_Live, ChunkedPrefill]] = None
        self._reserved_slot = -1
        self._wake = threading.Event()
        self._stop = False
        self._ids = itertools.count()
        # metric children resolved once (labels() is a locked dict lookup);
        # the queue-depth gauge reads live state through a weakref
        model_name = engine.cfg.name
        self._obs_tokens = obs.ENGINE_TOKENS.labels(model=model_name)
        self._obs_ttft = obs.ENGINE_TTFT.labels(model=model_name)
        self._obs_completed = obs.ENGINE_REQUESTS_COMPLETED.labels(model=model_name)
        self._obs_cancelled = obs.ENGINE_REQUESTS_CANCELLED.labels(model=model_name)
        self._obs_evictions = obs.ENGINE_POOL_EVICTIONS.labels(model=model_name)
        self._obs_tps = obs.ENGINE_TOKENS_PER_SECOND.labels(model=model_name)
        self._obs_gap = obs.ENGINE_DISPATCH_HOST_GAP.labels(model=model_name)
        ref = weakref.ref(self)
        obs.ENGINE_QUEUE_DEPTH.labels(model=model_name).set_function(
            lambda: float(ref().queue_depth()) if ref() is not None else 0.0)
        peers = _BATCHERS_BY_MODEL.setdefault(model_name, weakref.WeakSet())
        peers.add(self)
        obs.ENGINE_DISPATCH_INFLIGHT.labels(model=model_name).set_function(
            lambda: float(sum(1 for b in list(peers) if b._pending is not None)))

        def acceptance(proposer: str):
            def read() -> float:
                vals = [v for v in (b.spec_ewma.get(proposer) for b in list(peers))
                        if v is not None]
                return float(sum(vals) / len(vals)) if vals else 0.0
            return read

        for p in SPEC_PROPOSERS:
            obs.SPEC_ACCEPTANCE.labels(model=model_name, proposer=p).set_function(
                acceptance(p))
        # tokens/sec over a ~1 s window, refreshed by the scheduler; last_tps
        # keeps the last non-zero rate, so that the deadline gate's estimate
        # survives idle gaps
        self._rate_tokens = 0
        self._rate_t0 = time.monotonic()
        self.last_tps = 0.0
        # the host gap between decode dispatches (None after an idle tick)
        self._gap_mark: Optional[float] = None
        self._prefill_chunks = 0  # chunks run, for the timelines
        # serving-layer hook: a Histogram child observed with each admitted
        # request's submit -> slot wait (the pool sets it)
        self.queue_wait_obs = None
        # the graphs of this batcher's dispatches, before any dispatch (the
        # JAX batcher's attach compiles its missing sizes); a failed capture
        # raises here
        engine.capture_step()
        if engine.mega_ticks:
            # the megagraph windows this batcher dispatches, each size
            # capped at K and bucketed (warmup covers them already unless
            # the batcher's sizes differ)
            for n in {self.admit_chunk_steps, self.chunk_steps}:
                engine.capture_mega(engine.mega_bucket(min(n, engine.mega_ticks)))
        if self.speculative:
            engine.capture_spec(self.spec_draft_len, self.spec_ngram)
            engine.capture_draft(self.spec_draft_len)
        if self.jump_ahead and "masked" in engine.graphs:
            # constrained serving was declared at warmup: every run-length
            # bucket the constrained tick can dispatch is captured too; an
            # engine never warmed for it captures both at first use
            for k in JUMP_BUCKETS:
                engine.capture_jump(k)
        self._thread = threading.Thread(
            target=self._run, name="continuous-batcher", daemon=True
        )
        self._thread.start()

    # -- public API -------------------------------------------------------------

    def queue_depth(self) -> int:
        """Requests waiting for a slot, the admission in flight included."""
        with self._qlock:
            return len(self._waiting) + (self._prefilling is not None)

    def outstanding_tokens(self) -> int:
        """Work queued on this batcher, in tokens: a waiting request counts
        prompt + budget, a live one its remaining budget, each capped at
        what the cache can hold (a prompt keeps its last max_context - 1
        ids, and decode retires at the cache end). The router's
        least-loaded score and the deadline gate read it."""
        cap = self.engine.max_context
        with self._qlock:
            waiting = list(self._waiting)
            if self._prefilling is not None:
                waiting.append(self._prefilling[0])
        total = 0
        for l in waiting:
            p = min(len(l.req.prompt_ids), cap - 1)
            total += p + max(min(l.req.max_tokens, cap - p), 0)
        with self._lock:
            total += sum(
                max(min(l.req.max_tokens - l.produced,
                        cap - self.engine.slot_length(l.slot)), 0)
                for l in self._live.values())
        return total

    def tokens_per_second(self) -> float:
        """The last non-zero observed decode rate (tokens/sec across all
        slots); 0.0 until the first measured window."""
        return self.last_tps

    @property
    def active_count(self) -> int:
        with self._lock:
            return len(self._live)

    def _token_bytes(self):
        """The shared token->bytes table (built once; caller holds the
        lock)."""
        if self._token_table is None:
            if self.tokenizer is None:
                raise ValueError("json_mode/json_schema requires the batcher to know "
                                 "the tokenizer")
            self._token_table = jsonmode.token_bytes_table(
                self.tokenizer, self.engine.cfg.vocab_size)
        return self._token_table

    def _json_mask_cache(self) -> jsonmode.JsonMaskCache:
        """The per-model json_mode mask cache, built once under the lock so
        that concurrent first requests share one vocab walk. compact=True:
        generation emits no structural whitespace, so grammar-forced
        positions are SINGLETON states that jump-ahead collapses."""
        with self._json_masks_lock:
            if self._json_masks is None:
                self._json_masks = jsonmode.JsonMaskCache(
                    self._token_bytes(), getattr(self.tokenizer, "eos_id", None),
                    compact=True, device=self.engine.device)
            return self._json_masks

    def _schema_mask_cache(self, schema: dict) -> jsonschema.SchemaMaskCache:
        """The mask cache of ``schema``, compiled once and shared by every
        request carrying it; LRU-bounded, with the vocab byte matrix built
        once and shared. Raises ValueError on a schema outside the
        supported subset or with a scalar root."""
        key = jsonschema.schema_cache_key(schema)
        with self._json_masks_lock:
            cache = self._schema_caches.get(key)
            if cache is not None:
                self._schema_caches.move_to_end(key)
                return cache
            table = self._token_bytes()
            if self._byte_matrix is None and self._json_masks is not None:
                base = self._json_masks
                self._byte_matrix = (base._byte_mat, base._byte_lens)
            cache = jsonschema.SchemaMaskCache(
                table, getattr(self.tokenizer, "eos_id", None), schema,
                byte_matrix=self._byte_matrix, compact=True, device=self.engine.device)
            if self._byte_matrix is None:
                self._byte_matrix = (cache._byte_mat, cache._byte_lens)
            if cache.start_token_id is None:
                raise ValueError("json_schema root must be an object, array, or any "
                                 "(scalar roots have no forced opener; wrap them in "
                                 "an object)")
            while len(self._schema_caches) >= 16:
                self._schema_caches.popitem(last=False)
            self._schema_caches[key] = cache
            return cache

    def submit(self, req: Request) -> RequestHandle:
        if not req.prompt_ids:
            # fail on the caller's thread: a scheduler-thread exception would
            # strand every waiter
            raise ValueError("empty prompt")
        if not req.request_id:
            req.request_id = f"req-{next(self._ids)}"
        if req.rec is None:
            # direct batcher callers still get a timeline; served requests
            # arrive with one already open
            req.rec = flightrec.RECORDER.begin(
                self.engine.cfg.name, req.request_id,
                prompt_tokens=len(req.prompt_ids), priority=req.priority)
        elif not req.rec.request_id:
            req.rec.request_id = req.request_id  # the id assigned above
        live = _Live(req=req, slot=-1, submitted_at=time.monotonic())
        if req.json_schema is not None:
            # built on the caller's thread: fail fast, and keep the vocab
            # walk and the schema compile off the scheduler thread
            cache = self._schema_mask_cache(req.json_schema)
            min_bytes = cache._distance(cache.start())
            if req.max_tokens * cache._byte_mat.shape[1] < min_bytes:
                # even all-longest tokens cannot carry the schema's minimal
                # completion: the output could only truncate
                raise ValueError(f"max_tokens={req.max_tokens} cannot fit the schema's "
                                 f"minimal completion ({min_bytes} bytes)")
            live.constraint = jsonmode.JsonConstraint(cache)
        elif req.json_mode:
            live.constraint = jsonmode.JsonConstraint(self._json_mask_cache())
        with self._qlock:
            if self._closed:
                raise RuntimeError("batcher is shut down")
            if self.device_fault is not None:
                raise RuntimeError(f"{DEVICE_FAULT_REASON}: {self.device_fault!r}")
            self._waiting.append(live)
        self._wake.set()
        return RequestHandle(live, self)

    def generate(self, prompt_ids: Sequence[int], **kw) -> List[int]:
        return self.submit(Request(prompt_ids=list(prompt_ids), **kw)).tokens()

    def shutdown(self) -> None:
        with self._qlock:
            self._closed = True
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=70)
        if self._thread.is_alive():
            log.error("batcher scheduler did not stop after 70s; outstanding "
                      "requests are NOT terminated (wedged dispatch?)")
            return
        # zeroed after the join, so that a last tick cannot set it again
        self._obs_tps.set(0.0)
        self._terminate_outstanding("model unloading")

    # -- scheduler loop -------------------------------------------------------

    def _advance_prefill(self) -> None:
        """Run one chunk of the admission in flight, if any. When the pool
        cannot back the chunk, evict and retry the same chunk now (the next
        pass would hand the freed pages to a new admission); when only
        higher-priority streams hold the pool, keep the partial admission
        for the next pass; with nobody to evict, the admission itself fails
        and its pages return."""
        if self._prefilling is None:
            return
        live, pc = self._prefilling
        t0, pos0 = time.monotonic(), pc.pos
        reused0, restored0 = self.engine.prefix_rows_reused, self.engine.prefix_rows_restored
        while True:
            try:
                first = pc.step()
                break
            except PoolExhausted:
                outcome = self._evict_longest(requester_priority=live.req.priority)
                if outcome == "blocked":
                    return
                if outcome == "empty":
                    self._prefilling = None
                    self._reserved_slot = -1
                    live.done = True
                    live.abort_reason = "evicted: KV pool exhausted"
                    self.engine.release(live.slot)
                    self._rec_close(live)
                    live.out_q.put(_END)
                    return
        # tokens = rows consumed by this chunk (the final one is partial)
        self._prefill_chunks += 1
        self._rec_prefill(live, pc.pos - pos0, t0, reused0, restored0,
                          chunk=self._prefill_chunks)
        if first is not None:
            self._prefilling = None
            self._reserved_slot = -1
            if live.constraint is not None:
                first = self._constrained_first(live, first)
            live.first_token_at = time.monotonic()
            self._obs_ttft.observe(live.first_token_at - live.submitted_at)
            with self._lock:
                self._live[live.slot] = live
            self._emit(live, first)

    def _admit(self) -> None:
        alloc = self.engine.allocator  # None over the dense cache
        while True:
            free = [s for s in self.engine.free_slots() if s != self._reserved_slot]
            if not free:
                return
            with self._qlock:
                if not self._waiting:
                    return
                now = time.monotonic()
                live = max(
                    self._waiting,
                    key=lambda l: l.req.priority
                    + (now - l.submitted_at) / PRIORITY_AGING_SECS,
                )
                self._waiting.remove(live)
            if not live.admitted_at:
                # the first slot assignment ends the queue wait (requeues
                # keep their original boundary)
                live.admitted_at = time.monotonic()
                wait = live.admitted_at - live.submitted_at
                if self.queue_wait_obs is not None:
                    self.queue_wait_obs.observe(wait)
                rec = live.req.rec
                if rec is not None:
                    rec.queue_wait_ms = wait * 1000.0
                    rec.event("queue", wait_ms=round(wait * 1000.0, 3))
            slot = free[0]
            live.slot = slot
            ids = live.req.prompt_ids
            need_rows = min(len(ids), self.engine.max_context - 1)
            window = self.engine.cfg.sliding_window
            if alloc is not None and window is not None and self.prefill_chunk is not None:
                # a windowed chunked admission trims as it goes: its peak is
                # the window, one chunk in flight and a page of straddle
                need_rows = min(need_rows, window + self.prefill_chunk + alloc.page_size)
            if alloc is not None and alloc.blocks_for(need_rows) > alloc.capacity_blocks():
                # can NEVER fit: fail it now instead of evicting every
                # co-resident stream on the way to the same conclusion
                log.warning("request %s prompt (%d tokens) exceeds the whole "
                            "KV page pool; failing it", live.req.request_id, len(ids))
                live.done = True
                live.abort_reason = "prompt exceeds the KV page pool"
                self._rec_close(live)
                live.out_q.put(_END)
                continue
            if self.prefill_chunk is not None and len(ids) > self.prefill_chunk:
                if self._prefilling is not None:
                    # one incremental admission at a time; FIFO order holds
                    with self._qlock:
                        self._waiting.appendleft(live)
                    return
                self._prefilling = (live, self.engine.start_chunked_prefill(
                    slot, ids, temperature=live.req.temperature, top_p=live.req.top_p,
                    chunk=self.prefill_chunk))
                self._reserved_slot = slot
                continue
            t0 = time.monotonic()
            reused0, restored0 = self.engine.prefix_rows_reused, self.engine.prefix_rows_restored
            try:
                first = self.engine.prefill(
                    slot, ids, temperature=live.req.temperature, top_p=live.req.top_p
                )
            except PoolExhausted:
                with self._qlock:
                    self._waiting.appendleft(live)  # keep FIFO order
                outcome = self._evict_longest(requester_priority=live.req.priority)
                if outcome == "empty":
                    with self._qlock:
                        self._waiting.popleft()
                    live.done = True
                    live.abort_reason = "prompt exceeds the KV page pool"
                    self._rec_close(live)
                    live.out_q.put(_END)
                # "blocked": only higher-priority streams hold the pool, the
                # admission waits for them; "evicted": retry next pass
                return
            self._rec_prefill(live, min(len(ids), self.engine.max_context - 1), t0, reused0,
                              restored0)
            if live.constraint is not None:
                first = self._constrained_first(live, first)
            live.first_token_at = time.monotonic()
            self._obs_ttft.observe(live.first_token_at - live.submitted_at)
            with self._lock:
                self._live[slot] = live
            self._emit(live, first)

    def _constrained_first(self, live: _Live, first: int) -> int:
        """A constrained request's admission sampled its first token
        unmasked: overwrite it with the grammar's forced opener ("{")."""
        forced = live.constraint.cache.start_token_id
        if forced is None:  # no "{" token in the vocab: fail open
            log.warning("json_mode: vocab has no '{' token; unconstrained")
            live.constraint = None
            return first
        self.engine.force_pending_token(live.slot, forced)
        live.constraint.advance(forced)
        return forced

    def _emit(self, live: _Live, token: int, slot_len: Optional[int] = None) -> None:
        if live.cancelled:
            return  # reaped (slot freed) at the next tick boundary
        live.produced += 1
        self.tokens_emitted += 1
        self._obs_tokens.inc()
        self._rate_tokens += 1
        live.out_q.put(token)
        hit_stop = token in live.req.stop_ids
        out_of_budget = live.produced >= live.req.max_tokens
        # a pipelined or megagraph consume passes the slot's length as of
        # the dispatch (tick) that produced the token: the engine's live
        # length already counts the dispatch in flight, and reading it would
        # retire a request a dispatch early
        if slot_len is None:
            slot_len = self.engine.slot_length(live.slot)
        out_of_cache = slot_len >= self.engine.max_context - 1
        if hit_stop or out_of_budget or out_of_cache:
            self._finish(live)

    def _finish(self, live: _Live, *, was_cancelled: bool = False,
                abort_reason: str = "") -> None:
        live.done = True
        if abort_reason:
            live.abort_reason = abort_reason
        with self._lock:
            self._live.pop(live.slot, None)
        self.engine.release(live.slot)
        if was_cancelled:
            self.cancellations += 1
            self._obs_cancelled.inc()
        else:
            self.completed += 1
            self._obs_completed.inc()
        self._rec_close(live)
        # _END goes last: when a consumer unblocks, the slot is already free
        live.out_q.put(_END)

    def _reap_cancelled(self) -> None:
        with self._qlock:
            still: "deque[_Live]" = deque()
            dropped: List[_Live] = []
            for live in self._waiting:
                (dropped if live.cancelled else still).append(live)
            if dropped:
                self._waiting = still
        for live in dropped:
            live.done = True
            self.cancellations += 1
            self._obs_cancelled.inc()
            self._rec_close(live)
            live.out_q.put(_END)
        if self._prefilling is not None and self._prefilling[0].cancelled:
            # a cancelled admission releases its reserved slot mid-prefill
            live = self._prefilling[0]
            self._prefilling = None
            self._reserved_slot = -1
            self._finish(live, was_cancelled=True)
        with self._lock:
            cancelled = [l for l in self._live.values() if l.cancelled]
        for live in cancelled:
            self._finish(live, was_cancelled=True)

    def _evict_longest(self, requester_priority: Optional[int] = None) -> str:
        """Retire the lowest-priority live request, longest first within a
        level (it frees the most pages). An admission (``requester_priority``
        set) never evicts a victim that strictly outranks it. Returns
        "evicted", "empty" or "blocked"."""
        # land the pipelined dispatch first: the victim keeps what it
        # produced (as in the sync loop), and a retirement in the flush may
        # free the pages this hunt is after
        self._flush_pending("evict")
        with self._lock:
            if not self._live:
                return "empty"
            victim = min(
                self._live.values(),
                key=lambda l: (l.req.priority, -self.engine.slot_length(l.slot)),
            )
        if requester_priority is not None and victim.req.priority > requester_priority:
            return "blocked"
        log.warning("KV page pool exhausted; retiring request %s (priority %d, "
                    "%d rows) to free pages", victim.req.request_id,
                    victim.req.priority, self.engine.slot_length(victim.slot))
        self.pool_evictions += 1
        self._obs_evictions.inc()
        self._finish(victim, abort_reason="evicted: KV pool exhausted")
        return "evicted"

    def _terminate_outstanding(self, reason: str) -> None:
        """End every live and queued request with ``reason`` as its abort,
        releasing its slot and the slot's page references; called on a
        scheduler failure and at shutdown."""
        victims: List[_Live] = []
        # an in-flight pipelined dispatch dies with the scheduler: its tokens
        # would extend streams that end as truncations anyway, so they are
        # dropped; the releases below wait until it no longer runs
        pending, self._pending = self._pending, None
        if pending is not None:
            try:
                pending.pending.wait()
            except Exception:  # noqa: BLE001 - its outcome is being dropped
                log.warning("dropped pipelined dispatch failed", exc_info=True)
        if self._prefilling is not None:
            victims.append(self._prefilling[0])
            self._prefilling = None
            self._reserved_slot = -1
        with self._lock:
            victims.extend(self._live.values())
            self._live.clear()
        with self._qlock:
            victims.extend(self._waiting)
            self._waiting.clear()
        for live in victims:
            live.done = True
            live.abort_reason = reason
            if live.slot >= 0:
                self.engine.release(live.slot)
            self._rec_close(live)
            live.out_q.put(_END)

    def _run(self) -> None:
        while not self._stop:
            try:
                self._tick()
            except Exception as exc:  # noqa: BLE001 - the loop must survive
                self.last_error = exc
                if is_device_fault(exc):
                    # sticky: no later launch in this process can succeed, so
                    # the requests end with a cause nothing retries, and the
                    # scheduler stops rather than loop on a dead context
                    # (the owner hears first, so a client that sees its
                    # abort finds the model already out of service)
                    self.device_fault = exc
                    log.exception("CUDA error in the scheduler; the device is lost")
                    try:
                        if self.on_device_fault is not None:
                            self.on_device_fault(exc)
                    finally:
                        self._terminate_outstanding(f"{DEVICE_FAULT_REASON}: {exc!r}"[:200])
                    return
                # a scheduler failure must surface, not strand callers: every
                # outstanding request aborts and the pool respawns the batcher
                log.exception("continuous batcher scheduler failed; aborting requests")
                self._terminate_outstanding(f"scheduler failed: {exc!r}"[:200])

    def _note_dispatch(self) -> Optional[float]:
        """Call just before a decode dispatch: returns the host gap since the
        previous one ends (None after an idle tick), less the time a
        pipelined tick waited on the card for the previous tokens (device
        time, not host work), records it, and runs the ``dispatch.delay``
        fault point, whose sleep lands in that gap."""
        act = faults.point("dispatch.delay", self.engine.cfg.name)
        if act is not None and act.delay_s > 0:
            time.sleep(act.delay_s)
        gap = None
        if self._gap_mark is not None:
            gap = max(time.monotonic() - self._gap_mark - self._gap_wait, 0.0)
            self.host_gap_seconds += gap
            self.decode_dispatches += 1
            self._obs_gap.observe(gap)
        self._gap_wait = 0.0
        return gap

    # -- the pipelined decode loop (depth-2 double buffer) ----------------------

    def _consume(self, tick: _PendingTick) -> None:
        """Emit a finished dispatch's tokens to whoever is still live, each
        retiring against the lengths as of its own dispatch, or for a
        megagraph its own tick. A PoolExhausted from the dispatch (its
        backing failed; the state is untouched) retires a victim here
        instead, after collecting the next dispatch, which was issued
        against the same exhausted pool: its failure is the same event."""
        t0 = time.monotonic()
        try:
            tokens = tick.pending.wait()
        except PoolExhausted:
            self._gap_wait += time.monotonic() - t0
            nxt, self._pending = self._pending, None
            if nxt is not None:
                try:
                    nxt.pending.wait()
                except PoolExhausted:
                    pass  # state untouched; the tick after the eviction retries
                else:
                    self._pending = nxt  # it ran after all: deliver it
            self._evict_longest()
            return
        self._gap_wait += time.monotonic() - t0
        self._count_dispatch(tick.graph)
        dev = tick.pending.device_s
        if dev is not None:
            # the late devprof join: the worker's sample of this dispatch
            # onto the events recorded at its issue (scheduler thread only)
            for ev in tick.evs:
                ev["dev_us"] = round(dev * 1e6, 1)
        lengths = tick.pending.lengths
        if lengths.ndim == 2:
            # a megagraph: its events recorded at issue learn the real k
            for ev in tick.evs:
                ev["n"] = tick.pending.ticks
        self._emit_rows(tick.lives, tokens, lengths)

    def _emit_rows(self, lives: Dict[int, _Live], tokens, lengths) -> None:
        """Emit a dispatch's token rows [n, S] to the requests of ``lives``
        still live, each retiring against the slot lengths after its
        dispatch (``lengths`` [S]) or, for a megagraph, after its own tick
        (``lengths`` [k, S])."""
        for i, row in enumerate(tokens):
            lrow = lengths[i] if lengths.ndim == 2 else lengths
            for slot, live in lives.items():
                if not live.done:
                    self._emit(live, int(row[slot]), slot_len=int(lrow[slot]))

    def _flush_pending(self, cause: str) -> None:
        """Consume the pipelined dispatch in flight now: before a tick that
        cannot be issued ahead of the tokens (a constrained tick, whose mask
        depends on every token; a speculative one), an eviction (the
        victim's tokens land before its stream aborts) and an idle tick. No
        dispatch in flight, nothing to do."""
        tick = self._pending
        if tick is None:
            return
        self._pending = None
        self.flushes += 1
        obs.ENGINE_DISPATCH_FLUSHES.labels(model=self.engine.cfg.name, cause=cause).inc()
        self._consume(tick)

    def _mega_operands(self, slots: Dict[int, _Live]) -> Tuple[np.ndarray, np.ndarray]:
        """A megagraph window's device operands: each slot's first
        MEGA_STOP_SLOTS stop ids [S, MEGA_STOP_SLOTS] (pad -1; best effort,
        ``_emit`` checks the whole set) and its remaining budget [S] (0 for
        a slot with no live request, so an empty column never holds the
        loop open)."""
        eng = self.engine
        stops = np.full((eng.num_slots, MEGA_STOP_SLOTS), -1, np.int32)
        budgets = np.zeros((eng.num_slots,), np.int32)
        for slot, live in slots.items():
            if live.done:
                continue
            ids = tuple(live.req.stop_ids)[:MEGA_STOP_SLOTS]
            if ids:
                stops[slot, :len(ids)] = ids
            budgets[slot] = max(live.req.max_tokens - live.produced, 0)
        return stops, budgets

    def _mega_tick(self, n: int, slots: Dict[int, _Live]) -> None:
        """One megagraph dispatch of up to ``min(n, mega_ticks)`` ticks
        (pipelined: issued before the previous dispatch is consumed). A
        slot already at the context cap can run no tick (the device's live
        predicate excludes it): it finishes here, or a dispatch of no ticks
        would emit nothing and the scheduler would spin on it."""
        eng = self.engine
        window = min(n, eng.mega_ticks)
        cap = eng.max_context - 1
        for slot, live in list(slots.items()):
            if not live.done and eng.slot_length(slot) >= cap:
                self._finish(live)
        slots = {s_: l for s_, l in slots.items() if not l.done}
        if not slots:
            return
        stops, budgets = self._mega_operands(slots)
        if self.pipeline:
            prev = self._pending
            gap = self._note_dispatch()
            handle = eng.mega_step_async(window, stops, budgets)
            self._gap_mark = time.monotonic()
            # recorded with the window asked; the real k joins at consume
            evs = self._rec_dispatch(slots.values(), "decode", window, gap, None,
                                     graph="mega", join_sample=False, pipelined=True)
            self._pending = _PendingTick(handle, slots, tuple(evs), "mega")
            if prev is not None:
                self._consume(prev)
            return
        try:
            gap = self._note_dispatch()
            t0 = time.monotonic()
            tokens, lengths, k = eng.mega_step(window, stops, budgets)
            self._gap_mark = time.monotonic()
        except PoolExhausted:
            self._evict_longest()
            return
        self._count_dispatch("mega")
        self._rec_dispatch(slots.values(), "decode", k, gap, self._gap_mark - t0,
                           graph="mega")
        self._emit_rows(slots, tokens, lengths)

    # -- flight-recorder hooks (obs/flightrec.py) ---------------------------------
    # One event per DISPATCH per live request, never per token; a request
    # without a timeline costs nothing.

    def _count_dispatch(self, graph: str) -> None:
        self.dispatches_by_graph[graph] = self.dispatches_by_graph.get(graph, 0) + 1

    def _rec_dispatch(self, lives, kind: str, n: int, gap: Optional[float],
                      dur_s: Optional[float], graph: str = "step",
                      join_sample: bool = True, **extra) -> list:
        """Record one dispatch on every live timeline; returns the events
        (a pipelined dispatch's real tick count and devprof sample join
        them at consume). ``dur_s`` None for a pipelined issue, whose
        duration the host does not see. ``graph`` names the devprof
        GRAPH_KINDS entry the dispatch ran as: with devprof armed, a fresh
        sample of that kind joins the event as ``dev_us``
        (``join_sample=False`` for a pipelined issue, whose sample lands at
        consume) and the ledger's mean device time, split by occupancy,
        accrues on each timeline's ``device_us``."""
        occ = len(lives)
        fields = dict(n=n, occ=occ, **extra)
        if gap is not None:
            fields["gap_ms"] = round(gap * 1e3, 3)
        if dur_s is not None:
            fields["dur_ms"] = round(dur_s * 1e3, 3)
        est = None
        if self.engine._devprof is not None:
            if join_sample:
                s = self.engine.devprof_take_sample()
                if s is not None and s[0] == graph:
                    fields["dev_us"] = round(s[1] * 1e6, 1)
            est = self.engine.devprof_est_s(graph)
        evs = []
        for live in lives:
            rec = live.req.rec
            if rec is not None and not live.done:
                ev = rec.event(kind, **fields)
                if ev is not None:
                    evs.append(ev)
                if est:
                    rec.device_us += est * 1e6 / max(occ, 1)
        return evs

    def _rec_prefill(self, live: _Live, tokens: int, t0: float, reused0: int,
                     restored0: int, chunk: Optional[int] = None) -> None:
        # pop the engine's sample first (even for a request with no
        # timeline), so that a prefill's sample never joins a later event
        sample = None
        if self.engine._devprof is not None:
            sample = self.engine.devprof_take_sample()
        rec = live.req.rec
        if rec is None:
            return
        dur_s = time.monotonic() - t0
        fields = dict(tokens=tokens, dur_ms=round(dur_s * 1e3, 3))
        if sample is not None and sample[0] in ("prefill", "chunk", "seq_prefill"):
            fields["dev_us"] = round(sample[1] * 1e6, 1)
        if self.engine._devprof is not None:
            # an admission is the request's alone and the engine call blocked
            # through it: bill the measured wall (an upper bound on device
            # time)
            rec.device_us += dur_s * 1e6
        cached = self.engine.prefix_rows_reused - reused0
        restored = self.engine.prefix_rows_restored - restored0
        if cached:
            fields["cached_rows"] = int(cached)
        if restored:
            fields["restored_rows"] = int(restored)
        if chunk is not None:
            fields["chunk"] = chunk
        rec.event("prefill", **fields)

    def _rec_close(self, live: _Live) -> None:
        """Finalize the request's timeline, on every end-of-life path, just
        before its end of stream. Accounting is cumulative over the timeline
        (under failover one request spans several attempts): tokens add up,
        TTFT anchors to the timeline's origin, TPOT spreads the rest of the
        wall over every token the client received. An abort that the
        request's failover controller claims leaves the terminal event to
        the controller."""
        rec = live.req.rec
        if rec is None:
            return
        rec.tokens_out += live.produced
        if live.first_token_at and not rec.ttft_ms:
            rec.ttft_ms = (live.first_token_at - rec.t0) * 1000.0
        if rec.ttft_ms and rec.tokens_out > 1:
            rec.tpot_ms = (((time.monotonic() - rec.t0) * 1000.0 - rec.ttft_ms)
                           / (rec.tokens_out - 1))
        if live.abort_reason:
            fo = live.req.failover
            if fo is not None and fo.claims(live.abort_reason):
                return
        # terminal from here on: bill the tenant's estimated device seconds
        # once (a failover-resumed request reaches this on its last attempt,
        # device_us summed over every attempt)
        if self.engine._devprof is not None and rec.device_us and not rec.finished_at:
            obs.DEVPROF_TENANT_SECONDS.labels(tenant=rec.tenant).inc(rec.device_us / 1e6)
        if live.abort_reason:
            flightrec.RECORDER.finish(rec, "aborted", abort_reason=live.abort_reason)
        elif live.cancelled:
            flightrec.RECORDER.finish(rec, "cancelled")
        else:
            flightrec.RECORDER.finish(rec, "retired")

    # -- speculation auto-disable (per-proposer EWMA acceptance floor) ---------

    def _spec_proposer(self, greedy_live: bool = True) -> Optional[str]:
        """The proposer the next decode tick dispatches with, or None while
        every one is suspended. An expired suspension grants the proposer
        SPEC_PROBE_DISPATCHES probe dispatches on a fresh cumulative average
        before the floor judges again. ``greedy_live=False`` skips the draft
        rung: with no greedy slot live its K draft steps buy nothing and
        measure no acceptance, so the tick falls through to n-gram, whose
        zero-acceptance EWMA suspends speculation properly."""
        now = time.monotonic()
        for p in self.spec_proposers:
            if p == "draft" and not greedy_live:
                continue
            off = self._spec_off_until[p]
            if off:
                if now < off:
                    continue
                self._spec_off_until[p] = 0.0
                self.spec_ewma[p] = None
                self._spec_probe_left[p] = SPEC_PROBE_DISPATCHES
                self._spec_probe_seen[p] = 0
            return p
        return None

    def _spec_active(self) -> bool:
        """Whether the next decode tick may dispatch speculatively."""
        if self.degrade_spec:
            return False
        return self._spec_proposer() is not None

    def _spec_measure(self, proposer: str, counts, consumed: Dict[int, int],
                      proposed=None) -> None:
        """Fold one speculative dispatch's acceptance into ``proposer``'s
        EWMA and suspend it when that falls below the floor. ``counts`` is
        the dispatch's [rounds, num_slots] emitted-token matrix; ``consumed``
        maps slot -> rounds whose tokens were actually emitted (each emits
        1 + accepted drafts). Rounds past a request's retirement inside the
        dispatch are excluded: their drafts score a continuation that is
        never served. ``proposed`` (the draft proposer's [rounds,
        num_slots] offered tokens) is the denominator where given, so
        rounds with nothing proposed do not read as rejection; n-gram keeps
        its every-round denominator."""
        if proposed is None:
            possible = sum(consumed.values()) * self.spec_draft_len
        else:
            possible = sum(float(proposed[:r, s].sum()) for s, r in consumed.items())
        if not possible:
            return
        accepted = sum(float(counts[:r, s].sum()) - r for s, r in consumed.items())
        ratio = max(accepted, 0.0) / possible
        prev = self.spec_ewma[proposer]
        if prev is None:
            self.spec_ewma[proposer] = ratio
            self._spec_probe_seen[proposer] = 1
        elif self._spec_probe_left[proposer] > 0:
            # probe phase: a cumulative average over the probe budget (an
            # EWMA seeded from one sample would weigh it like a whole
            # collapsed history)
            n = self._spec_probe_seen[proposer]
            self.spec_ewma[proposer] = (prev * n + ratio) / (n + 1)
            self._spec_probe_seen[proposer] = n + 1
        else:
            self.spec_ewma[proposer] = (
                (1 - SPEC_EWMA_ALPHA) * prev + SPEC_EWMA_ALPHA * ratio)
        if self._spec_probe_left[proposer] > 0:
            self._spec_probe_left[proposer] -= 1
            if self._spec_probe_left[proposer] > 0:
                return  # the verdict waits until the probe budget drains
        if self.spec_min_accept > 0 and self.spec_ewma[proposer] < self.spec_min_accept:
            self._spec_off_until[proposer] = time.monotonic() + self.spec_reprobe_secs
            self.spec_autodisables += 1
            log.info("%s: %s speculation suspended (EWMA acceptance %.3f < floor "
                     "%.3f); re-probing in %.0fs", self.engine.cfg.name, proposer,
                     self.spec_ewma[proposer], self.spec_min_accept,
                     self.spec_reprobe_secs)

    def _spec_tick(self, proposer: str, n: int, slots: Dict[int, _Live]) -> None:
        """One speculative dispatch of ``n`` rounds: emit each round's
        accepted run in order; ``_emit`` retires requests inside the dispatch
        as usual."""
        proposed = None
        try:
            gap = self._note_dispatch()
            t0 = time.monotonic()
            if proposer == "draft":
                tokens, counts, proposed = self.engine.spec_step_draft(
                    n, draft_len=self.spec_draft_len)
            else:
                tokens, counts = self.engine.spec_step(
                    n, draft_len=self.spec_draft_len, ngram=self.spec_ngram)
            self._gap_mark = time.monotonic()
        except PoolExhausted:
            # the failed backing left the engine's state untouched: retire
            # a victim and retry on the next tick
            self._evict_longest()
            return
        dur_ms = round((self._gap_mark - t0) * 1e3, 3)
        graph = "draft_spec" if proposer == "draft" else "spec"
        self._count_dispatch(graph)
        dev_us = None
        est_us = 0.0
        if self.engine._devprof is not None:
            s_ = self.engine.devprof_take_sample()
            if s_ is not None and s_[0] == graph:
                dev_us = round(s_[1] * 1e6, 1)
            est = self.engine.devprof_est_s(graph)
            if est:
                est_us = est * 1e6 / max(len(slots), 1)
        consumed: Dict[int, int] = {}
        for r in range(tokens.shape[0]):
            for slot, live in slots.items():
                if live.done:
                    continue
                consumed[slot] = r + 1  # this round's tokens are served
                for j in range(int(counts[r, slot])):
                    self._emit(live, int(tokens[r, slot, j]))
                    if live.done:
                        break
        for slot, live in slots.items():
            rounds = consumed.get(slot)
            if live.req.rec is not None and rounds:
                # emitted = rounds + accepted drafts of the slot's served rounds
                live.req.rec.event(
                    "spec", rounds=rounds, proposer=proposer,
                    emitted=int(counts[:rounds, slot].sum()),
                    draft_len=self.spec_draft_len, dur_ms=dur_ms,
                    **({"gap_ms": round(gap * 1e3, 3)} if gap is not None else {}),
                    **({"dev_us": dev_us} if dev_us is not None else {}))
                live.req.rec.device_us += est_us
        self._spec_measure(proposer, counts, consumed, proposed)

    # -- grammar jump-ahead (compressed-FSM run collapse) ----------------------

    def _grammar_budget(self, slot: int, live: _Live) -> int:
        """Tokens a constrained request may still emit: what its max_tokens
        leaves, and no more than its cache rows hold (``_emit`` retires it
        at row C - 1), so the grammar's closing walk ends the structure
        before either runs out. (The JAX batcher bounds it by max_tokens
        alone, so a budget past the cache end truncates the structure.)"""
        room = self.engine.max_context - 1 - self.engine.slot_length(slot)
        return max(min(live.req.max_tokens - live.produced, room), 1)

    def _jump_tick(self, constrained: List[Tuple[int, _Live]]) -> bool:
        """Collapse chains of grammar-FORCED tokens into one multi-token
        dispatch (``engine.jump_step``) instead of one masked dispatch each.
        Each constrained slot's automaton is probed for a forced run
        (``JsonConstraint.forced_run``: states whose effective mask admits
        exactly one token); runs of >= 2 tokens pay for a jump, and the
        tokens emit host-side (they are the only tokens any sampler could
        produce, so streams are those of the per-step path). Slots without
        a run, and unconstrained co-residents, do not advance this
        dispatch; the next tick serves them with a masked step. Returns
        True when a jump was issued (the tick is done)."""
        runs: Dict[int, List[int]] = {}
        for s, live in constrained:
            c = live.constraint
            if c is None or c.failed:
                continue
            rem = self._grammar_budget(s, live)
            # the verify-write contract: post-run length <= C-2
            room = self.engine.max_context - 2 - self.engine.slot_length(s)
            cap = min(self.jump_max, rem, room)
            if cap < 2:
                continue
            run = c.forced_run(cap, remaining=rem, stop_ids=live.req.stop_ids)
            if len(run) >= 2:
                runs[s] = run
        if not runs:
            return False
        k = max(len(r) for r in runs.values())
        forced = np.zeros((self.engine.num_slots, k), np.int64)
        counts = np.zeros((self.engine.num_slots,), np.int64)
        for s, run in runs.items():
            forced[s, : len(run)] = run
            counts[s] = len(run)
        try:
            gap = self._note_dispatch()
            t0 = time.monotonic()
            self.engine.jump_step(forced, counts)
            self._gap_mark = time.monotonic()
        except PoolExhausted:
            self._evict_longest()  # retry next tick
            return True
        self._count_dispatch("jump")
        by_slot = dict(constrained)
        dur_ms = round((self._gap_mark - t0) * 1e3, 3)
        dev_us = None
        est_us = 0.0
        if self.engine._devprof is not None:
            # a jump reads nothing back: its sample lands at a later
            # readback, so only an earlier jump's can be here to pop
            s_ = self.engine.devprof_take_sample()
            if s_ is not None and s_[0] == "jump":
                dev_us = round(s_[1] * 1e6, 1)
            est = self.engine.devprof_est_s("jump")
            if est:
                est_us = est * 1e6 / max(len(runs), 1)
        for s in sorted(runs):
            live = by_slot[s]
            if live.req.rec is not None and not live.done:
                live.req.rec.event(
                    "jump", k=len(runs[s]), occ=len(runs), dur_ms=dur_ms,
                    **({"gap_ms": round(gap * 1e3, 3)} if gap is not None else {}),
                    **({"dev_us": dev_us} if dev_us is not None else {}))
                live.req.rec.device_us += est_us
            for tok in runs[s]:
                if live.done:
                    break
                live.constraint.advance(tok)
                self._emit(live, tok)
        return True

    def _constrained_tick(self, slots: Dict[int, _Live],
                          constrained: List[Tuple[int, _Live]]) -> None:
        """One tick while constrained requests are live: a jump when one
        pays, else one masked step, the constrained slots' rows (cached on
        the device per automaton state) copied into the engine's mask, the
        other slots' rows zero."""
        if self.jump_ahead and not self.degrade_jump and self._jump_tick(constrained):
            return
        rows = {s: live.constraint.device_mask(remaining=self._grammar_budget(s, live))
                for s, live in constrained}
        try:
            gap = self._note_dispatch()
            t0 = time.monotonic()
            tokens = self.engine.step_masked(rows)
            self._gap_mark = time.monotonic()
        except PoolExhausted:
            self._evict_longest()
            return
        self._count_dispatch("masked")
        self._rec_dispatch(slots.values(), "decode", 1, gap, self._gap_mark - t0,
                           graph="masked", constrained=True)
        for slot, live in slots.items():
            if live.done:
                continue
            tok = int(tokens[0, slot])
            if live.constraint is not None:
                live.constraint.advance(tok)
            self._emit(live, tok)

    def _tick(self) -> None:
        now = time.monotonic()
        if now - self._rate_t0 >= 1.0:
            rate = self._rate_tokens / (now - self._rate_t0)
            self._obs_tps.set(rate)
            if rate > 0:
                self.last_tps = rate
            self._rate_tokens = 0
            self._rate_t0 = now
        if self._pending is not None:
            # ordering fence: the dispatch handed to the worker last tick
            # holds the engine lock before this tick's engine calls
            # (releases, admissions, chunks), which must land after it
            self._pending.pending.wait_started()
        self._reap_cancelled()
        self._advance_prefill()
        self._admit()
        with self._lock:
            slots = dict(self._live)
        if slots:
            # chaos: a scheduler crash mid-decode, gated on live slots so
            # that idle ticks consume no hits (nth:N counts decode ticks)
            act = faults.point("pool.scheduler_crash", self.engine.cfg.name)
            if act is not None:
                raise faults.InjectedFault(
                    f"injected scheduler crash ({act.mode}, hit {act.hit})")
        if not slots:
            # nothing live now: land what the last pipelined dispatch made
            # (its requests retired, so this drops their columns) first
            self._flush_pending("idle")
            self._gap_mark = None
            if self._prefilling is not None:
                return  # nothing to decode; keep chunking
            self._wake.wait(timeout=0.05)
            self._wake.clear()
            return
        constrained = [(s, l) for s, l in slots.items() if l.constraint is not None]
        if constrained:
            # grammar masks change with every emitted token: constrained
            # slots ride one-dispatch ticks, and the next mask depends on
            # every token so far, so the pipeline drains first
            self._flush_pending("constrained")
            self._constrained_tick(slots, constrained)
            return
        # two dispatch sizes only; overshooting a request's budget costs a
        # few ignored tokens
        with self._qlock:
            anyone_waiting = bool(self._waiting) or self._prefilling is not None
        n = self.admit_chunk_steps if anyone_waiting else self.chunk_steps
        proposer = None
        if self.speculative and not self.degrade_spec:
            # the draft rung needs a greedy slot to propose for
            greedy_live = any(l.req.temperature < GREEDY_EPS for l in slots.values())
            proposer = self._spec_proposer(greedy_live)
        if proposer is not None:
            # a speculative dispatch consumes its own output (acceptance
            # gates the emit), so it never pipelines
            self._flush_pending("spec")
            self._spec_tick(proposer, n, slots)
            return
        if self.engine.mega_ticks:
            self._mega_tick(n, slots)
            return
        if self.pipeline:
            # depth 2: hand dispatch N+1 to the dispatch worker, then
            # consume dispatch N while it runs; each carries its live map
            # and lengths, so the streams are the sync loop's
            prev = self._pending
            gap = self._note_dispatch()
            handle = self.engine.step_async(n)
            self._gap_mark = time.monotonic()
            evs = self._rec_dispatch(slots.values(), "decode", n, gap, None,
                                     join_sample=False, pipelined=True)
            self._pending = _PendingTick(handle, slots, tuple(evs))
            if prev is not None:
                self._consume(prev)
            return
        try:
            gap = self._note_dispatch()
            t0 = time.monotonic()
            tokens = self.engine.step(n)  # [n, num_slots]
            self._gap_mark = time.monotonic()
        except PoolExhausted:
            # the failed ensure() left engine state untouched: retire a
            # victim and retry on the next tick
            self._evict_longest()
            return
        self._count_dispatch("step")
        self._rec_dispatch(slots.values(), "decode", n, gap, self._gap_mark - t0)
        for step_row in tokens:
            for slot, live in slots.items():
                if not live.done:
                    self._emit(live, int(step_row[slot]))
