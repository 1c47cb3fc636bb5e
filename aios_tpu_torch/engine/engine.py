"""The decode engine: paged KV pool or dense slot cache, bucketed whole-prompt
prefill, chunked admission, the prompt-prefix cache, batched decode with
on-device sampling, n-gram speculation.

``TorchEngine`` is the counterpart of ``aios_tpu``'s ``TPUEngine``. Weights,
the KV cache and all per-slot decode state (lengths, last tokens,
temperatures, top_p, active mask, token history, the device page table, the
sampling generator) live on the device in buffers that keep their storage
for the engine's life; a decode dispatch moves only the page table in
(paged) and the sampled tokens out.

On a CUDA engine every decode and admission dispatch replays a CUDA graph
(``graphs.py``), as the JAX engine dispatches compiled executables:
``warmup`` captures the decode step of the engine's cache and, where it
speculates, the round of ``spec_step``'s defaults, then the admission
graphs (``capture_admission``): a whole-prompt prefill per bucket the pool
can back, the mid chunk and every final bucket up to the batcher's chunk,
and the same at the prefix hit's chunk, all in one shared memory pool. A
size not warmed is captured at first use, and counted. ``step(n)`` and
``spec_step(n)`` replay the one-step or one-round graph n times and read
back once; ``prefill`` and each ``ChunkedPrefill.step`` replay one graph on
operands staged into static device buffers (the slot, the start, the
valid rows, the prompt's length, the temperature and top_p, the tokens),
and only a final chunk or a prefill reads back, its first token. On the
CPU they run the same bodies eagerly; on the card ``step_eager``,
``spec_step_eager``, ``prefill_eager`` and ``ChunkedPrefill(eager=True)``
do, like a kernel's plain twin, by name only.

The cache is a shared page pool of ``paged_pool_rows`` rows, or, with
``paged_pool_rows=None``, a dense slot cache [L, S, C, KH, D] in which slot s
owns rows [0, C) of its own. A slot's life: ``prefill(slot, prompt)`` writes
K/V rows [0, len) and samples the first token, ``step(n)`` extends every
active slot by n tokens, ``release(slot)`` frees it (and returns its pages).
Inactive slots decode garbage against the sacrificial page, or the dense
cache's last row; their outputs are ignored. Over the pool a sliding-window
model returns each slot's pages below the window before a dispatch.

A long prompt is admitted a chunk at a time (``start_chunked_prefill``, the
``ChunkedPrefill`` driver): each ``step()`` writes one chunk's K/V rows and
attends them over everything written so far (``model.prefill_chunk`` or
``prefill_chunk_paged``, K6 or K7 with the chunk as T queries of one slot),
and the caller runs decode dispatches of the other slots in between; the
slot stays inactive, so those write only the sacrificial page or row, until
the final chunk samples its first token and activates it. Over the pool,
prompts' full leading blocks are published to a prefix index
(``paged.RadixPrefixIndex`` by default, ``paged.PrefixIndex`` with
``prefix_radix=False``): a later prompt whose leading blocks hash-match maps
those pages shared, read-only, and admits only its tail through the chunked
path.

``spec_step(n_rounds, draft_len, ngram)`` runs speculative rounds over
either cache: propose drafts from the device token history (``spec.py``),
verify them in one multi-token forward (``verify_step_paged`` over the pool,
after backing ``n_rounds * (draft_len + 1)`` rows of every active slot and
returning a windowed model's pages below the window), accept the longest
matching prefix. With a draft model (``draft=spec.DraftModel``),
``spec_step_draft(n_rounds, draft_len)`` runs the fused draft round instead:
teacher-forced catch-up of the draft's own dense cache, ``draft_len`` greedy
draft steps, the serving verify, acceptance, and the draft lengths clamped to
the verified length; a freshly admitted slot's draft cache first catches up
through bulk ingest dispatches at ``DRAFT_INGEST_BUCKETS`` widths. The round
and each ingest width are CUDA graphs on the card.

Grammar-constrained decoding (``jsonmode.py``, ``jsonschema.py``, driven by
the batcher) dispatches two more graphs over either cache: ``step_masked``,
one decode step whose logits get the additive [S, V] f32 mask
``step_mask`` before sampling (a static buffer of the "masked" graph, into
which the caller's rows are copied on the device; unconstrained slots keep
zero rows), and ``jump_step``, which appends a grammar-forced token run of
up to ``JUMP_BUCKETS[-1]`` tokens per slot in one verify forward
(``model.verify_step_paged`` over the pool, ``model.verify_step`` over the
dense cache), bucketed to ``JUMP_BUCKETS``. ``warmup(masked_step=True)``
captures both kinds; a constrained request on an engine not warmed for it
captures them at first use.

Weights serve as int8 (``quantize="int8"``) or group-wise int4
(``quantize="int4"``); the cache is bf16, or int8 (``cache_dtype=torch.int8``)
with f32 scales beside it ([L, N, P, KH] or [L, S, C, KH]), rows quantizing
on write.

With ``prefix_host_bytes`` (``AIOS_TPU_PREFIX_HOST_BYTES``) the prefix
index gets a host-RAM tier (``paged.HostPageStore``): an evicted prefix
page's K/V is gathered on the dispatch stream, copied to pinned memory on a
side stream and landed in the store by a worker thread; an admission whose
chain goes on there allocates pages and copies the K/V back (one
``index_copy_`` a pool tensor) before its tail chunk, instead of prefilling
those rows. ``export_prefix`` hands a cached chain to another engine's store
(the KVX1 wire format is ``paged.pack_entry``), ``prefix_digest`` summarizes
the cached chains for a fleet.

The decode loop's other modes (the JAX engine's): ``step_async`` and
``mega_step_async`` run a dispatch on the engine's dispatch worker thread
and return a ``PendingDecode`` (the pipelined batcher emits dispatch N's
tokens while N+1 runs); ``mega_step`` runs up to ``mega_ticks`` decode
ticks in one dispatch with sampling, stop, budget and context-cap checks on
the device and an early exit once no slot needs another tick (on CUDA one
replay of a graph whose ticks are conditional nodes, ``ops/mega_graph.py``,
one graph per power-of-two bucket, captured at warmup). The JAX
``unified_step`` (one graph for every decode chunk size) is the port's
shape already: ``step(n)`` replays the one-step graph n times for every n,
so the knob is resolved and reported and changes no dispatch. Window+sink KV
compression (``kv_compress_after``) prunes a long slot's pool pages to its
sink pages and a trailing window (``PageAllocator.prune_range``); the
slot's live-window start rides beside the page tables as a staged device
operand every paged graph reads, and K3/K4 and K6/K7 mask the pruned
middle with their sink predicate.

Not here yet (later slices of the port): sharding and the
sequence-sharded prefill.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import logging
import os
import queue
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import faults, ops
from ..analysis.locks import make_lock
from ..device import resolve_device
from ..obs import devprof, flightrec
from ..obs import instruments as obs
from ..ops import build, mega_graph, split
from ..ops.quantized_matmul import counters_for, sm_count
from . import model, paged, sampling, spec
from .config import ModelConfig
from .graphs import GraphSet

log = logging.getLogger("aios.torch.engine")

DEFAULT_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)
# spec_step's defaults, and the round graph warmup captures
SPEC_DRAFT_LEN = 7
SPEC_NGRAM = 3
# Run-length buckets of the grammar jump-ahead graphs (jump_step): a forced
# run of k tokens dispatches through the smallest bucket >= k, so warmup
# captures len(JUMP_BUCKETS) graphs (the JAX engine's buckets). Bounded by
# spec.HISTORY_PAD - 2: the history scatter stays inside the pad margin.
JUMP_BUCKETS = (4, 16)
assert JUMP_BUCKETS[-1] <= spec.HISTORY_PAD - 2
# Widths of the draft's bulk ingest graphs (the JAX engine's buckets): a
# freshly admitted slot's draft cache trails the serving state by its whole
# prompt, and spec_step_draft catches it up in these teacher-forced chunks
# before the fused rounds take over (whose own catch-up is draft_len + 1
# wide; the steady gap is 0 or 1). One graph per width up to the context.
DRAFT_INGEST_BUCKETS = (32, 64, 128, 256, 512)
# Stop ids per slot that the megagraph checks on the device ([S,
# MEGA_STOP_SLOTS], pad -1): best effort, as in the JAX engine; the
# batcher's emit stays the authority over the full stop set.
MEGA_STOP_SLOTS = 4

# Live engines by model name: replica engines share the (model,) label of the
# speculative families, so the gauges read the SUM over this set.
_ENGINES_BY_MODEL: Dict[str, "weakref.WeakSet"] = {}
# Live host stores by model name, for the aios_tpu_prefix_host_* families
# (the JAX engine's _HOST_STORES_BY_MODEL): the gauges read their sum.
_HOST_STORES_BY_MODEL: Dict[str, "weakref.WeakSet"] = {}
# The keys of a host-tier entry, in the order of ``_pool_tensors``.
HOST_ENTRY_KEYS = ("k", "v", "k_s", "v_s")
# Most device bytes of spilled pages that may wait for the spill worker by
# default (at least 16 pages, at most the pool's worth).
SPILL_STAGING_BYTES = 1 << 30


def _env_int(name: str) -> Optional[int]:
    """The JAX stack's lenient integer variables: None when unset, blank or
    malformed (a bad knob logs and falls back rather than failing a load)."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    try:
        value = int(float(raw))
        if value < 0:
            raise ValueError("must be >= 0")
        return value
    except ValueError:
        log.warning("%s=%r ignored (expected a non-negative integer)", name, raw)
        return None


def _env_flag(name: str) -> Optional[bool]:
    """The JAX stack's tri-state boolean variables: None when unset."""
    raw = os.environ.get(name, "").strip().lower()
    if not raw:
        return None
    return raw in ("1", "true", "on", "yes")


def jump_ahead_enabled(cfg: ModelConfig) -> bool:
    """Whether grammar jump-ahead serves: ``AIOS_TPU_JUMP_AHEAD`` when set,
    else ``cfg.jump_ahead`` (the JAX stack's rule)."""
    enabled = _env_flag("AIOS_TPU_JUMP_AHEAD")
    return bool(cfg.jump_ahead) if enabled is None else enabled


def workspace_launches(cfg: ModelConfig, num_slots: int, max_context: int, *,
                       chunk: Optional[int], speculative: bool,
                       sms: int) -> List[Tuple[int, int, int]]:
    """(groups, splits, partial rows) of each split-attention launch shape
    an engine makes: the single-query decode attention of every slot (K3,
    K4, K8, K9), the verify attention of every slot (K6, K7) at its most
    rows, the longest draft with speculation, else the largest jump-ahead
    run (``JUMP_BUCKETS[-1] + 1`` tokens), and with ``chunk`` a chunk's
    attention, B = 1 and T = chunk over the whole context (K6, K7).
    ``split.workspace`` sizes for them."""
    KH, G = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
    splits = split.split_plan(max_context, num_slots, KH, sms)
    out = [(*split.launch_groups(num_slots, KH), splits)]
    verify_rows = spec.HISTORY_PAD - 1 if speculative else JUMP_BUCKETS[-1] + 1
    out.append((*split.launch_groups(num_slots, KH, verify_rows * G), splits))
    if chunk:
        out.append((*split.launch_groups(1, KH, chunk * G),
                    split.split_plan(max_context, 1, KH, sms)))
    return [(groups, s, rows) for groups, rows, s in out]


def draft_workspace_launches(dcfg: ModelConfig, num_slots: int, max_context: int, *,
                             sms: int) -> List[Tuple[int, int, int]]:
    """(groups, splits, partial rows) of the split launches of a draft model
    ``dcfg`` over its dense cache of ``max_context`` rows a slot: its decode
    steps (K8), the fused round's catch-up (K6 at T up to ``HISTORY_PAD -
    1``) and the widest bulk ingest (K6 at T = ``DRAFT_INGEST_BUCKETS[-1]``),
    every slot at once; partials at the draft's head dim."""
    KH, G = dcfg.num_kv_heads, dcfg.num_heads // dcfg.num_kv_heads
    splits = split.split_plan(max_context, num_slots, KH, sms)
    out = [split.launch_groups(num_slots, KH)]
    for T in (spec.HISTORY_PAD - 1, min(DRAFT_INGEST_BUCKETS[-1], max_context)):
        out.append(split.launch_groups(num_slots, KH, T * G))
    return [(groups, splits, rows) for groups, rows in out]


def workspace_floats(launches, head_dim: int) -> int:
    """The fp32 partials of the workspace that holds every launch of
    ``workspace_launches``: the largest one's."""
    return max(groups * s * split.partial_floats(head_dim, rows)
               for groups, s, rows in launches)


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class Staged:
    """A device buffer that the host fills without waiting for the stream.

    On CUDA the host writes a pinned twin (``host``, a numpy view of it)
    and ``push`` copies it in asynchronously, in stream order, so a
    dispatch's operands never put the host in lockstep with the card the
    way a copy from pageable memory does. A pinned buffer must not change
    before its queued copy has run, so ``host`` first waits for the event of
    the twin's previous copy; where the stream has drained since (the
    previous dispatch's readback) that wait is free. On the CPU the twin is
    the buffer itself."""

    def __init__(self, dev: torch.Tensor) -> None:
        self.dev = dev
        cuda = dev.device.type == "cuda"
        self._twin = (torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
                      if cuda else dev)
        self._np = self._twin.numpy()
        self._copied = torch.cuda.Event() if cuda else None

    @property
    def host(self) -> np.ndarray:
        if self._copied is not None:
            self._copied.synchronize()
        return self._np

    def push(self, n: Optional[int] = None) -> None:
        """Queue the copy of the twin's first ``n`` elements (all by
        default) into the device buffer."""
        if self._copied is None:
            return
        self.dev.view(-1)[:n].copy_(self._twin.view(-1)[:n], non_blocking=True)
        self._copied.record()


def _numpy_bits(t: torch.Tensor) -> np.ndarray:
    """A numpy view of host tensor ``t``; a bf16 tensor as its uint16 bits
    (numpy has no bfloat16: the host tier's and KVX1's convention)."""
    if t.dtype == torch.bfloat16:
        # aios: waive(lock-readback): t is host memory (the restore's pinned staging, a spill's landed copy): .numpy() is a view, no device sync
        return t.view(torch.int16).numpy().view(np.uint16)
    # aios: waive(lock-readback): t is host memory, as above: a view, no device sync
    return t.numpy()


class _PageCopy:
    """The copy of some pool pages to the host, as a spill or an export
    takes it.

    Under the engine lock only the gather is enqueued (one ``index_select``
    of each pool tensor over the page axis) on the current stream, the
    stream the engine's dispatches and graph replays run on: it reads the
    pages before any later dispatch can rewrite them, and the host waits for
    nothing. ``wait``, off the lock (the spill worker, or an export's
    caller), then copies the gathered pages to pinned host memory on a side
    stream that waits for the gather's event, so neither the pinned
    allocation nor the transfer holds up the dispatch stream or the lock,
    and waits on that copy's event alone. Off CUDA the gather is the copy."""

    def __init__(self, tensors: List[torch.Tensor], ids: torch.Tensor, side) -> None:
        self.side = side
        cuda = ids.device.type == "cuda"
        ev = functools.partial(torch.cuda.Event, enable_timing=True)
        self.events = (ev(), ev(), ev(), ev()) if cuda else None
        if cuda:
            self.events[0].record()
        self.gathered = [t.index_select(1, ids) for t in tensors]
        if cuda:
            self.events[1].record()

    def wait(self) -> List[np.ndarray]:
        """The pages on the host, [L, n, ...] per pool tensor; the device
        staging is released."""
        if self.events is None:
            host = self.gathered
        else:
            host = [torch.empty(g.shape, dtype=g.dtype, pin_memory=True)
                    for g in self.gathered]
            self.side.wait_event(self.events[1])
            with torch.cuda.stream(self.side):
                self.events[2].record(self.side)
                for h, g in zip(host, self.gathered):
                    h.copy_(g, non_blocking=True)
                    g.record_stream(self.side)
                self.events[3].record(self.side)
            self.events[3].synchronize()
        self.gathered = None
        return [_numpy_bits(h) for h in host]

    def device_ms(self) -> Tuple[float, float]:
        """(gather, device-to-host copy) ms by CUDA events, after ``wait``;
        (0, 0) off CUDA."""
        if self.events is None:
            return 0.0, 0.0
        e = self.events
        return e[0].elapsed_time(e[1]), e[2].elapsed_time(e[3])


def _page_entries(host: List[np.ndarray], n: int) -> List[Dict[str, np.ndarray]]:
    """The ``n`` pages of a ``_PageCopy`` as host-tier entries (owned
    arrays). One thread: the spill worker runs beside the dispatches, and
    more threads copying there slowed an admission's restore on the card."""
    return [{k: np.ascontiguousarray(a[:, i]) for k, a in zip(HOST_ENTRY_KEYS, host)}
            for i in range(n)]


class PendingDecode:
    """A decode dispatch running on the engine's dispatch worker
    (``step_async``, ``mega_step_async``): the twin of the JAX
    ``PendingDecode``. The worker runs the whole dispatch, lock, replay
    and token readback, so the caller's thread overlaps its own host work
    with it.

    ``wait()`` returns the host tokens [ticks, S]. ``lengths`` (after
    ``wait()``) snapshots the host slot lengths after THIS dispatch: [S]
    for a step, or for a megagraph the per-tick [k, S]; the batcher's
    out-of-cache retirement reads them, never the engine's live lengths,
    which later dispatches have moved. ``ticks`` is the real tick count
    (a megagraph's k), ``device_s`` the dispatch's devprof sample in
    device seconds when it took one. ``wait_started()`` blocks until the dispatch holds
    the engine lock: the fence for engine calls that must land after it.
    """

    __slots__ = ("_fut", "_started", "n_steps", "tokens", "lengths", "ticks", "device_s")

    def __init__(self, fut, n_steps: int, started: threading.Event) -> None:
        self._fut = fut
        self._started = started
        self.n_steps = int(n_steps)
        self.tokens: Optional[np.ndarray] = None
        self.lengths: Optional[np.ndarray] = None
        self.ticks = int(n_steps)
        # the dispatch's devprof sample (device seconds), when it took one
        self.device_s: Optional[float] = None

    def wait_started(self) -> None:
        if self.tokens is not None or self._fut.done():
            return
        self._started.wait()

    def wait(self) -> np.ndarray:
        if self.tokens is None:
            self.tokens, self.lengths, self.ticks, self.device_s = self._fut.result()
        return self.tokens


class _TickGraph:
    """The static buffers of one megagraph bucket: the tokens of its ``m``
    ticks [m, S], each tick's gate [m], and the kernel launches of one
    tick's body, which a replay adds once per tick that ran."""

    def __init__(self, m: int, num_slots: int, device: torch.device) -> None:
        self.m = m
        self.tokens = torch.zeros((m, num_slots), dtype=torch.int64, device=device)
        self.go = torch.zeros(m, dtype=torch.int32, device=device)
        self.tick_launches: Dict[object, int] = {}


class TorchEngine:
    """Single-model decode engine over a fixed set of batch slots and a
    paged KV pool of ``paged_pool_rows`` rows in pages of ``page_size``, or
    (``paged_pool_rows=None``) a dense cache of ``max_context`` rows per
    slot. ``track_history`` keeps the device token history that the n-gram
    proposer of ``spec_step`` reads. Over the pool ``prefix_cache`` (None:
    on) keeps the prompt-prefix index, a radix tree unless ``prefix_radix``
    is False (None reads the JAX stack's ``AIOS_TPU_PREFIX_RADIX``), with
    a host tier of ``prefix_host_bytes`` behind it (None: the config's
    ``prefix_host_bytes``; 0: none) whose chains restore from
    ``host_restore_min_pages`` blocks on. ``draft`` (a ``spec.DraftModel``
    of the same vocabulary, shared read-only between engines) enables
    ``spec_step_draft``. ``unified_step``, ``mega_ticks``,
    ``kv_compress_after``, ``kv_sink_pages`` and ``kv_window_pages`` are
    the decode loop's knobs (None: the JAX stack's variable, else the
    config's value)."""

    # admission granularity of long prompts: the batcher's default chunk and
    # the chunk a prefix hit's tail admits at (the JAX engine's default)
    prefill_chunk_default = 512

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        paged_pool_rows: Optional[int] = None,
        page_size: int = 128,
        num_slots: int = 8,
        max_context: Optional[int] = None,
        cache_dtype: torch.dtype = torch.bfloat16,
        quantize: Optional[str] = None,
        track_history: bool = True,
        device: Optional[Union[str, torch.device]] = None,
        prefix_cache: Optional[bool] = None,
        prefix_radix: Optional[bool] = None,
        draft: Optional[spec.DraftModel] = None,
        prefix_host_bytes: Optional[int] = None,
        host_restore_min_pages: Optional[int] = None,
        unified_step: Optional[bool] = None,
        mega_ticks: Optional[int] = None,
        kv_compress_after: Optional[int] = None,
        kv_sink_pages: Optional[int] = None,
        kv_window_pages: Optional[int] = None,
    ) -> None:
        self.device = resolve_device(device)
        self.cfg = cfg
        # the sampler's candidate pool (AIOS_TPU_SAMPLE_POOL), read once: the
        # graphs bake it in, so an eager body and its graph never disagree
        self.sample_pool = sampling.topk_cap()
        self.num_slots = num_slots
        self.track_history = bool(track_history)
        self.max_context = int(max_context or cfg.max_context)
        if self.device.type == "cuda":
            # refuse at load what no kernel of the path would take at the
            # first request; the plain paths on the CPU take any geometry
            faults = model.kernel_contract_faults(
                cfg, paged=paged_pool_rows is not None,
                quant_cache=cache_dtype == torch.int8,
                quantize=quantize or None,
                pages_per_slot=self.max_context // page_size)
            if faults:
                raise ValueError(
                    f"{cfg.name} (head_dim {cfg.head_dim}, H/KH {cfg.num_heads}/"
                    f"{cfg.num_kv_heads}) cannot be served on {self.device}: "
                    + "; ".join(faults))
        self.buckets = tuple(
            b for b in DEFAULT_BUCKETS if b <= self.max_context
        ) or (self.max_context,)
        self._lock = make_lock("engine")
        if quantize not in (None, False, "int8", "int4"):
            raise ValueError(f"unsupported quantize mode {quantize!r}")
        params = _to_device(params, self.device)
        self.quantize_seconds = 0.0  # making the serving leaves, device time included
        if model.is_quantized(params):
            self.quantized = True
            if self.device.type == "cuda":
                params = model.pad_serving_head(params)
        elif quantize:
            t0 = time.perf_counter()
            params = model.quantize_params(params, mode=quantize)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.quantize_seconds = time.perf_counter() - t0
            self.quantized = True
        else:
            self.quantized = False
        self.params = params
        # MoE decode (the JAX engine's static choice): the gathered path
        # streams only the routed experts' blocks when every slot's picks
        # together touch fewer experts than exist, opted into with
        # AIOS_TPU_MOE_GATHER (dense is the default); decode and
        # verify-shaped dispatches only, and AIOS_TPU_MOE_IMPL overrides it
        # when a graph is captured (moe.resolve_impl)
        self._moe_impl: Optional[str] = None
        if (cfg.moe and num_slots * cfg.num_experts_per_tok < cfg.num_experts
                and os.environ.get("AIOS_TPU_MOE_GATHER", "").lower() in ("1", "true", "on")):
            self._moe_impl = "gather"

        self.paged = paged_pool_rows is not None
        self.allocator: Optional[paged.PageAllocator] = None
        if self.paged:
            if page_size < 1 or page_size & (page_size - 1):
                raise ValueError(f"page_size {page_size} must be a power of 2")
            if self.max_context % page_size:
                raise ValueError(
                    f"max_context {self.max_context} must be a multiple of "
                    f"page_size {page_size}"
                )
            num_pages = 1 + max(1, -(-int(paged_pool_rows) // page_size))
            self.allocator = paged.PageAllocator(
                num_pages, page_size, num_slots, self.max_context // page_size
            )
            shape = (num_pages, page_size)
        else:
            shape = (num_slots, self.max_context)
        self._init_decode_knobs(unified_step, mega_ticks, kv_compress_after,
                                kv_sink_pages, kv_window_pages)
        # prefix caching rides on the pool: prompts whose leading full blocks
        # hash-match an earlier prompt's map those pages, and their tail
        # admits through the chunked path at the largest bucket up to the
        # default chunk that divides the context
        self._prefix_chunk = max(
            (b for b in self.buckets
             if b <= self.prefill_chunk_default and self.max_context % b == 0),
            default=None)
        self.prefix_index = None
        if prefix_cache is None:
            prefix_cache = True
        if self.paged and prefix_cache and self._prefix_chunk is not None:
            if prefix_radix is None:
                prefix_radix = _env_flag("AIOS_TPU_PREFIX_RADIX")
            index_cls = (paged.PrefixIndex if prefix_radix is False
                         else paged.RadixPrefixIndex)
            self.prefix_index = index_cls(self.allocator, max_pages=num_pages)
        # the page pool [L, N, P, KH, D] or the dense cache [L, S, C, KH, D]
        self.k_pool, self.v_pool = model.init_kv_cache(
            cfg, *shape, cache_dtype, self.device
        )
        self.quant_cache = cache_dtype == torch.int8
        self.k_scales = self.v_scales = None
        if self.quant_cache:
            self.k_scales, self.v_scales = model.init_kv_scales(cfg, *shape, self.device)
        dev = self.device
        self.lengths = torch.zeros(num_slots, dtype=torch.int32, device=dev)
        self.last_tokens = torch.zeros(num_slots, dtype=torch.int64, device=dev)
        self.temps = torch.zeros(num_slots, dtype=torch.float32, device=dev)
        self.top_ps = torch.ones(num_slots, dtype=torch.float32, device=dev)
        self.active_dev = torch.zeros(num_slots, dtype=torch.bool, device=dev)
        self.history = (spec.init_history(num_slots, self.max_context, dev)
                        if self.track_history else None)
        # the device page table and, beside it, each slot's live-window
        # start (window+sink compression; 0 = uncompressed): the
        # allocator's host tables and ``_win_starts``, copied in before each
        # dispatch as one staged buffer
        self.tables_dev = self.win_starts_dev = self._tables = None
        if self.paged:
            n_tab = self.allocator.tables.size
            self._tables = Staged(torch.zeros(n_tab + num_slots, dtype=torch.int32,
                                              device=dev))
            self.tables_dev = self._tables.dev[:n_tab].view(self.allocator.tables.shape)
            self.win_starts_dev = self._tables.dev[n_tab:]
        self._slot_ids = torch.arange(num_slots, device=dev)
        self._columns = torch.arange(max(spec.HISTORY_PAD, DRAFT_INGEST_BUCKETS[-1]),
                                     device=dev)
        # the admission operands, the twins of the JAX admission
        # executables' operands: [slot, start, n_valid, true_len, tokens of
        # the bucket (zero-padded) ...] and [temperature, top_p]; and the
        # admission's outputs, the first token and the logits row it was
        # sampled from. Static for the engine's life (graphs hold them).
        self._adm_ints = Staged(torch.zeros(4 + self.max_context, dtype=torch.int64,
                                            device=dev))
        self._adm_f32 = Staged(torch.zeros(2, dtype=torch.float32, device=dev))
        ints = self._adm_ints.dev
        self._adm_slot, self._adm_start, self._adm_n_valid, self._adm_true_len = (
            ints[i:i + 1] for i in range(4))
        self._adm_tokens = ints[4:].view(1, self.max_context)
        self._adm_temp, self._adm_top_p = self._adm_f32.dev[0:1], self._adm_f32.dev[1:2]
        self._adm_first = torch.zeros(1, dtype=torch.int64, device=dev)
        self._adm_logits = torch.zeros(cfg.vocab_size, dtype=torch.float32, device=dev)
        # the masked step's additive logits mask (0 = allowed), the slots
        # whose rows are set, and a jump's operands: [counts S][forced
        # S x kb] for its bucket kb, staged from pinned memory
        self.step_mask = torch.zeros((num_slots, cfg.vocab_size), dtype=torch.float32,
                                     device=dev)
        self._mask_rows: set = set()
        self._jump_ops = Staged(torch.zeros(num_slots * (1 + JUMP_BUCKETS[-1]),
                                            dtype=torch.int64, device=dev))
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(0)
        self.graphs = GraphSet(dev, self.generator)
        # one memory pool for every admission graph (graphs.py's ownership
        # rule), the bytes it took at warmup, and the chunk the split
        # workspace is reserved for
        self._admission_pool = self.graphs.new_pool()
        self.admission_pool_bytes = 0
        self._workspace_chunk = self._prefix_chunk
        # logits of the last step or round dispatched (on CUDA a graph's
        # static output, overwritten by its next replay)
        self.last_logits: Optional[torch.Tensor] = None
        # host mirrors for the scheduler
        self.active = np.zeros(num_slots, dtype=bool)
        self._host_lengths = np.zeros(num_slots, dtype=np.int64)
        self.decode_steps = 0
        self.prefills = 0  # whole-prompt prefill forwards
        self.prefill_chunks = 0  # chunk forwards of chunked admissions
        self.prefix_rows_reused = 0
        self.prefix_rows_restored = 0
        self.kv_pages_trimmed = 0
        self.spec_rounds = 0
        self.spec_tokens = 0
        self.spec_slot_rounds = 0  # (round, active slot) pairs
        self.spec_proposer_rounds = {p: 0 for p in spec.SPEC_PROPOSERS}
        self.spec_proposer_accepted = {p: 0 for p in spec.SPEC_PROPOSERS}
        self.jump_dispatches = 0
        self.jump_tokens = 0
        self._init_ticks()
        self._init_draft(draft, cache_dtype)
        self._spill_lock = make_lock("engine_spill")
        self._spill_pending = 0  #: guarded_by _spill_lock; bytes staged for the worker
        self._init_host_tier(cfg.prefix_host_bytes if prefix_host_bytes is None
                             else prefix_host_bytes, host_restore_min_pages)
        self._init_devprof()
        self._register_obs()

    def _init_decode_knobs(self, unified_step, mega_ticks, kv_compress_after,
                           kv_sink_pages, kv_window_pages) -> None:
        """The decode loop's knobs as the JAX engine resolves them (an
        explicit argument, else its variable, else the config): the
        unified step (served by the one-step graph as it stands), the
        megagraph's tick cap and window+sink compression,
        which arms only over the pool of a model without a sliding window,
        its threshold raised to the sink + window floor."""
        cfg = self.cfg

        def knob(explicit, env: str, default) -> int:
            if explicit is not None:
                return int(explicit)
            value = _env_int(env)
            return int(default) if value is None else value

        if unified_step is None:
            unified_step = _env_flag("AIOS_TPU_UNIFIED_STEP")
        self.unified_step = bool(cfg.unified_step if unified_step is None else unified_step)
        self.mega_ticks = max(knob(mega_ticks, "AIOS_TPU_MEGA_TICKS", cfg.mega_ticks), 0)
        self.mega_dispatches = 0
        self.mega_tick_total = 0
        self.kv_compress_after = knob(kv_compress_after, "AIOS_TPU_KV_COMPRESS_AFTER",
                                      cfg.kv_compress_after)
        self.kv_sink_pages = max(knob(kv_sink_pages, "AIOS_TPU_KV_SINK_PAGES",
                                      cfg.kv_sink_pages), 1)
        self.kv_window_pages = max(knob(kv_window_pages, "AIOS_TPU_KV_WINDOW_PAGES",
                                        cfg.kv_window_pages), 1)
        self.kv_compress_armed = False
        self._sink_rows = 0
        if self.kv_compress_after > 0:
            if not self.paged:
                log.warning("%s: kv_compress_after needs a paged, unreplicated KV pool; "
                            "compression disabled", cfg.name)
            elif cfg.sliding_window is not None:
                log.warning("%s: kv_compress_after is redundant under a model sliding "
                            "window (residency is already bounded); compression disabled",
                            cfg.name)
            else:
                P = self.allocator.page_size
                # sink + window must fit under the threshold, or an armed slot
                # could prune rows it is still exact below the threshold for
                floor = (self.kv_sink_pages + self.kv_window_pages) * P
                if self.kv_compress_after < floor:
                    log.info("%s: kv_compress_after %d raised to sink+window floor %d",
                             cfg.name, self.kv_compress_after, floor)
                    self.kv_compress_after = floor
                if self.device.type == "cuda" and P % split.SPLIT_ALIGN:
                    # K6/K7 skip a pruned warp slice whole (ops/verify_attention)
                    raise ValueError(f"{cfg.name}: window+sink compression on {self.device} "
                                     f"needs pages of a multiple of {split.SPLIT_ALIGN} "
                                     f"rows, got {P}")
                self.kv_compress_armed = True
                self._sink_rows = self.kv_sink_pages * P
        # each slot's live-window start in rows (0 = uncompressed), staged
        # beside the page tables
        self._win_starts = np.zeros(self.num_slots, dtype=np.int32)
        self.kv_compress_slots = 0  # slots that crossed the threshold
        self.kv_pages_pruned = 0  # pages released by pruning

    def _init_ticks(self) -> None:
        """The multi-tick graphs' operands (staged [cap, budgets S, stops S
        x MEGA_STOP_SLOTS] int32), the per-slot stop flags their ticks set,
        the side stream and memory pool their tick bodies are captured on,
        and the dispatch worker behind ``step_async`` (made at first use)."""
        S = self.num_slots
        self._tick_ops = Staged(torch.zeros(1 + S + S * MEGA_STOP_SLOTS, dtype=torch.int32,
                                            device=self.device))
        t = self._tick_ops.dev
        self._tick_cap, self._tick_rem = t[:1], t[1:1 + S]
        self._tick_stops = t[1 + S:].view(S, MEGA_STOP_SLOTS)
        self._tick_done = torch.zeros(S, dtype=torch.bool, device=self.device)
        self._tick_graphs: Dict[Tuple[str, int], _TickGraph] = {}
        self._tick_stream = None
        self._tick_pool = None
        self._tick_pool_refs = 0
        self._dispatch_pool: Optional[ThreadPoolExecutor] = None

    def _init_draft(self, draft: Optional[spec.DraftModel], cache_dtype: torch.dtype) -> None:
        """Attach ``draft`` (the JAX engine's draft set-up): its dense
        cache and lengths as static device buffers, which the draft graphs
        read in place, and the host mirrors of the draft lengths and of
        which slots decode greedily (set at admission: only greedy slots
        propose, so bulk ingest skips sampling ones). A vocabulary other
        than the serving model's raises, as does on CUDA a draft geometry
        no kernel of its path takes; without the token history the draft is
        ignored, with a warning."""
        S = self.num_slots
        self.draft: Optional[spec.DraftModel] = None
        self.draft_state: Optional[Dict[str, torch.Tensor]] = None
        self._draft_params = None
        self._draft_host_lengths = np.zeros(S, dtype=np.int64)
        self._host_greedy = np.zeros(S, dtype=bool)
        self.draft_ingest_dispatches = 0
        self.draft_proposed_tokens = 0
        # the ingest graphs' memory pool (they return nothing: any replay
        # order is safe, as for the admission graphs) and its bytes
        self._draft_pool = None
        self.draft_pool_bytes = 0
        if draft is None:
            return
        if draft.cfg.vocab_size != self.cfg.vocab_size:
            raise ValueError(
                f"draft model vocab ({draft.cfg.vocab_size}) must match the serving "
                f"model's ({self.cfg.vocab_size}): they must share one tokenizer")
        if self.device.type == "cuda":
            faults = model.kernel_contract_faults(draft.cfg, paged=False, quant_cache=False,
                                                  quantize=draft.quant_mode)
            if faults:
                raise ValueError(f"draft {draft.cfg.name} cannot be served on "
                                 f"{self.device}: " + "; ".join(faults))
        if not self.track_history:
            log.warning("%s: draft-model speculation needs the token history "
                        "(track_history=True); draft model ignored", self.cfg.name)
            return
        self.draft = draft
        self._draft_params = _to_device(draft.params, self.device)
        self.draft_state = draft.init_state(S, self.max_context, cache_dtype, self.device)
        self._draft_pool = self.graphs.new_pool()

    def _init_host_tier(self, max_bytes: int, restore_min_pages: Optional[int]) -> None:
        """The host tier behind the prefix index (the JAX engine's set-up):
        with an index and ``max_bytes`` > 0, a ``paged.HostPageStore`` of
        that budget, the spill queue and its worker thread, and the index's
        ``spill`` hook; else nothing, and an eviction frees its pages.

        A spill's pages wait for the worker in a device staging copy, so
        what may wait is capped (``spill_cap_bytes``): the pool's worth, as
        the JAX engine caps the same backlog, but at most
        ``SPILL_STAGING_BYTES``, and at least 16 pages; past it a spill
        becomes a plain eviction with a warning."""
        self.host_store: Optional[paged.HostPageStore] = None
        self.host_restore_min_pages = max(int(restore_min_pages or 1), 1)
        self.host_restore_seconds = 0.0
        self._obs_restore_hist = None
        self._spill_q: Optional[queue.Queue] = None
        self._spill_thread: Optional[threading.Thread] = None
        self.spill_cap_bytes = 0
        # device and host time of the spills the worker has landed (CUDA
        # events; the host copies on the worker's clock), and the most bytes
        # that ever waited in staging
        self.spill_timing = dict(pages=0, bytes=0, gather_ms=0.0, d2h_ms=0.0, copy_s=0.0)
        self.spill_staging_peak = 0
        self.spill_drops = 0  # pages a full backlog turned into plain evictions
        # (copy to the card, scatter) CUDA events of the last restore, and
        # the host seconds of the probes (the crc checks) and of the staging
        # into pinned memory
        self.last_restore_events: Optional[Tuple[torch.cuda.Event, ...]] = None
        self.host_probe_seconds = 0.0
        self.host_staging_seconds = 0.0
        # the restore's pinned staging, reused; its last copy's event
        self._restore_pinned: Optional[torch.Tensor] = None
        self._restore_copied: Optional[torch.cuda.Event] = None
        self._copy_stream = None  # the side stream of device-to-host copies
        if self.prefix_index is None or int(max_bytes) <= 0:
            return
        self.host_store = paged.HostPageStore(int(max_bytes))
        page = self.page_bytes()
        self.spill_cap_bytes = max(16 * page, min(self.allocator.capacity_blocks() * page,
                                                  SPILL_STAGING_BYTES))
        self._spill_q = queue.Queue()
        # the worker must not hold the engine (a bound method would pin the
        # weights and the pool for good when an engine is dropped without
        # close()): it takes the queue, the store and the lock, and reaches
        # the engine's counters through a weak reference
        self._spill_thread = threading.Thread(
            target=TorchEngine._spill_worker,
            args=(self._spill_q, self.host_store, self._spill_lock, weakref.ref(self)),
            name=f"prefix-host-spill-{self.cfg.name}", daemon=True)
        self._spill_thread.start()
        self.prefix_index.spill = self._spill_pages

    def _pool_tensors(self) -> List[torch.Tensor]:
        """The pool's tensors in ``HOST_ENTRY_KEYS`` order: k and v, and over
        an int8 pool their scales."""
        out = [self.k_pool, self.v_pool]
        if self.quant_cache:
            out += [self.k_scales, self.v_scales]
        return out

    def page_bytes(self) -> int:
        """Bytes one page holds across every layer (K, V and their scales):
        one host-tier entry."""
        return sum(t[:, 0].numel() * t.element_size() for t in self._pool_tensors())

    def host_staging_bytes(self) -> int:
        """Device bytes the host tier may hold beyond the pool: the spill
        backlog's cap and one restore of a whole slot's pages (its copy on
        the card before the scatter). 0 without the tier."""
        if self.host_store is None:
            return 0
        return self.spill_cap_bytes + self.allocator.max_blocks * self.page_bytes()

    def _register_obs(self) -> None:
        """The speculative families of ``obs/instruments.py``, one series a
        proposer, each the sum of its engine counter over the live engines
        of this model (the JAX engine's WeakSet pattern)."""
        name = self.cfg.name
        engines = _ENGINES_BY_MODEL.setdefault(name, weakref.WeakSet())
        engines.add(self)

        def proposer_sum(attr: str, proposer: str):
            def read() -> float:
                return float(sum(getattr(e, attr).get(proposer, 0) for e in list(engines)))
            return read

        for p in spec.SPEC_PROPOSERS:
            obs.SPEC_ROUNDS.labels(model=name, proposer=p).set_function(
                proposer_sum("spec_proposer_rounds", p))
            obs.SPEC_ACCEPTED.labels(model=name, proposer=p).set_function(
                proposer_sum("spec_proposer_accepted", p))

        def engines_sum(read):
            def total() -> float:
                return float(sum(read(e) for e in list(engines)))
            return total

        # the megagraph's and compression's families (the JAX engine's)
        for family, read in ((obs.ENGINE_MEGA_DISPATCHES, lambda e: e.mega_dispatches),
                             (obs.ENGINE_MEGA_TICKS, lambda e: e.mega_tick_total),
                             (obs.KV_COMPRESS_SLOTS, lambda e: e.kv_compress_slots),
                             (obs.KV_COMPRESS_PAGES_PRUNED, lambda e: e.kv_pages_pruned),
                             (obs.KV_COMPRESS_RESIDENT,
                              lambda e: e.compressed_resident_pages())):
            family.labels(model=name).set_function(engines_sum(read))
        if self._devprof is not None:
            self._register_devprof_gauges()
        if self.host_store is None:
            return
        # the host-tier families, each the sum over the live stores of this
        # model's replicas (they share the model label)
        stores = _HOST_STORES_BY_MODEL.setdefault(name, weakref.WeakSet())
        stores.add(self.host_store)

        def store_sum(attr: str):
            def read() -> float:
                return float(sum(getattr(s, attr) for s in list(stores)))
            return read

        for family, attr in ((obs.PREFIX_HOST_BYTES, "bytes_resident"),
                             (obs.PREFIX_HOST_SPILLS, "spills"),
                             (obs.PREFIX_HOST_RESTORES, "restores"),
                             (obs.PREFIX_HOST_HITS, "hits"),
                             (obs.PREFIX_HOST_MISSES, "misses"),
                             (obs.PREFIX_HOST_MISSES_CORRUPT, "corruptions")):
            family.labels(model=name).set_function(store_sum(attr))
        self._obs_restore_hist = obs.PREFIX_HOST_RESTORE_SECONDS.labels(model=name)

    # -- device-time attribution (obs/devprof.py) -------------------------------
    # Off by default: the hot paths pay one attribute None check. Armed
    # (AIOS_TPU_DEVPROF, read here), every dispatch is counted by graph kind
    # with its analytic cost, and every Nth is timed by CUDA events recorded
    # around its replays on the dispatching stream (``devprof.Timing``); the
    # elapsed time is read where the dispatch reads its result back. A
    # dispatch that reads nothing back (a mid chunk, a jump, a restore) is
    # read at the next dispatch's readback, which ordered it. Kind arguments
    # are devprof.GRAPH_KINDS literals.

    def _init_devprof(self) -> None:
        devprof.track_engine(self)
        self._devprof: Optional[devprof.DevprofLedger] = None
        self._devprof_deferred: List[devprof.Timing] = []
        self._dp_lock = make_lock("engine_dp")  # the deferred tokens only
        if not devprof.enabled():
            return
        self._devprof = devprof.DevprofLedger(
            self.cfg.name, device_kind=devprof.local_device_kind(self.device))
        # the bytes a forward streams: the layer leaves and the lm_head (the
        # embedding table when the head is tied), and one position's K and V
        # over every layer, scales included
        wb = model.serving_weight_bytes(self.params)
        if "lm_head" not in self.params:
            embed = self.params["embed"]
            wb += embed.numel() * embed.element_size()
        self._dp_weight_bytes = float(wb)
        cfg = self.cfg
        row = cfg.num_kv_heads * cfg.head_dim * self.k_pool.element_size()
        if self.quant_cache:
            row += cfg.num_kv_heads * self.k_scales.element_size()
        self._dp_kv_row_bytes = float(2 * cfg.num_layers * row)

    def _register_devprof_gauges(self) -> None:
        """The devprof families: per-graph children over the closed
        GRAPH_KINDS enum, each the sum over the model's live replica
        ledgers; the MFU and HBM-utilization gauges only where the card's
        peaks are known (the JAX engine's registration)."""
        name = self.cfg.name
        ledgers = devprof.ledgers_for(name)

        def ledger_sum(kind, idx):
            def read() -> float:
                return float(sum(led.totals(kind)[idx] for led in list(ledgers)))
            return read

        def ledger_device_s(kind):
            def read() -> float:
                return float(sum(led.device_seconds(kind) for led in list(ledgers)))
            return read

        def ledger_util(kind, idx, peak_idx):
            # weighted across replicas: summed sampled flops or bytes over
            # summed sampled seconds
            def read() -> float:
                leds = list(ledgers)
                num = sum(led.totals(kind)[idx] for led in leds)
                den = sum(led.totals(kind)[4] for led in leds)
                peaks = next((led.peaks for led in leds if led.peaks is not None), None)
                if not den or peaks is None:
                    return 0.0
                return float(num / den / peaks[peak_idx])
            return read

        roofline = self._devprof.peaks is not None
        for g in devprof.GRAPH_KINDS:
            obs.DEVPROF_DISPATCHES.labels(model=name, graph=g).set_function(
                ledger_sum(g, 0))
            obs.DEVPROF_DEVICE_SECONDS.labels(model=name, graph=g).set_function(
                ledger_device_s(g))
            if roofline:
                obs.DEVPROF_MFU.labels(model=name, graph=g).set_function(
                    ledger_util(g, 5, 0))
                obs.DEVPROF_HBM_UTIL.labels(model=name, graph=g).set_function(
                    ledger_util(g, 6, 1))

    def devprof_cost(self, kind: str, key=None, lens=None, start: int = 0,
                     n: int = 1) -> Optional[Tuple[float, float]]:
        """(FLOPs, bytes) of one dispatch of graph ``key`` of ``kind``
        (``devprof.forward_cost`` over the rows it runs): ``n`` passes of a
        decode-shaped graph (a step, a masked step, a megagraph tick, a
        jump of ``key[1]`` tokens or a speculative round of ``key[1]``
        drafts, T rows a slot a pass) whose slots attend from ``lens`` on
        (the active slots' lengths; None: every slot at the full context,
        the graph's own shape), a whole-prompt prefill at bucket ``key[1]``
        (causal over the bucket), or a chunk of ``key[1]`` rows from row
        ``start``. None for a kind with no forward (a copy)."""
        cfg, S, C = self.cfg, self.num_slots, self.max_context
        if kind in ("prefill", "chunk"):
            b = key[1]
            attended = b * start + b * (b + 1) / 2
            kv_read = start + b if kind == "chunk" else 0
            return devprof.forward_cost(cfg, b, attended, b, self._dp_weight_bytes,
                                        kv_read, self._dp_kv_row_bytes)
        if kind in ("step", "masked", "mega"):
            T = 1
        elif kind in ("jump", "spec", "draft_spec"):
            T = key[1] + 1
        else:
            return None
        lens = (np.full(S, C - T, dtype=np.float64) if lens is None
                else np.asarray(lens, dtype=np.float64))
        A = lens.size
        base = float(lens.sum())
        # pass p: each slot's T query rows attend len + p*T + t + 1 rows and
        # read len + (p + 1) * T rows
        attended = n * T * base + A * (T * T * n * (n - 1) / 2 + n * T * (T + 1) / 2)
        kv_read = n * base + A * T * n * (n + 1) / 2
        return devprof.forward_cost(cfg, n * S * T, attended, n * S * T,
                                    n * self._dp_weight_bytes, kv_read,
                                    self._dp_kv_row_bytes)

    def _active_lens(self) -> np.ndarray:
        return self._host_lengths[self.active]

    def _devprof_note(self, kind: str, key=None, cost=None, need_slack: bool = False):
        """Count one dispatch of ``kind`` (charging ``cost``); when it is due
        a sample, its timing token (started right before the dispatch's first
        launch, ``_timed``), else None. Caller checked ``self._devprof is not
        None``."""
        dp = self._devprof
        due = dp.note(kind, key, cost)
        if due and need_slack and dp.queue_depth() > 1:
            # a dispatch is queued behind this one on the worker: skip the
            # sample rather than ever delay it
            due = False
        return devprof.Timing(kind, key, cost, self.device) if due else None

    @staticmethod
    def _timed(run, tok):
        """``run``, whose first call marks ``tok``'s start just before it
        launches (``run`` itself when nothing is timed)."""
        if tok is None:
            return run

        def timed():
            tok.begin()
            return run()
        return timed

    def _devprof_sample(self, tok) -> Optional[float]:
        """Land ``tok``'s sample (after the dispatch's readback), and those
        of earlier dispatches that read nothing back; returns ``tok``'s
        device seconds."""
        if self._devprof_deferred:
            # those this readback ordered; one issued since (on another
            # thread) waits for a later readback
            with self._dp_lock:
                ready = [t for t in self._devprof_deferred if t.done()]
                self._devprof_deferred = [t for t in self._devprof_deferred
                                          if not t.done()]
            for t in ready:
                self._devprof.sample(t.kind, t.key, t.seconds(), t.cost)
        if tok is None:
            return None
        secs = tok.seconds()
        self._devprof.sample(tok.kind, tok.key, secs, tok.cost)
        return secs

    def _devprof_defer(self, tok) -> None:
        """Hold the token of a dispatch that reads nothing back until a
        later dispatch's readback."""
        if tok is not None:
            with self._dp_lock:
                self._devprof_deferred.append(tok)

    def devprof_est_s(self, kind: str) -> Optional[float]:
        """Mean sampled device-seconds per ``kind`` dispatch (None when
        devprof is off or unsampled): the batcher's per-request rate."""
        dp = self._devprof
        return dp.mean_s(kind) if dp is not None else None

    def devprof_take_sample(self):
        """Pop the ledger's most recent (kind, seconds) sample."""
        dp = self._devprof
        return dp.take_last_sample() if dp is not None else None

    def devprof_snapshot(self) -> Optional[dict]:
        """The per-graph ledger as a JSON-shaped dict."""
        dp = self._devprof
        return dp.snapshot() if dp is not None else None

    # -- admission ------------------------------------------------------------

    def bucket_for(self, length: int) -> int:
        for b in self.buckets:
            if length <= b:
                return b
        return self.buckets[-1]

    def free_slots(self) -> List[int]:
        return [i for i in range(self.num_slots) if not self.active[i]]

    def prefill(self, slot: int, token_ids: List[int], temperature: float = 0.0,
                top_p: float = 1.0) -> int:
        """Fill ``slot`` with a prompt and return the first generated token.
        A prompt whose leading full blocks hit the prefix index maps those
        pages and admits only its tail, through the chunked path at the
        prefix chunk (the slot is released if that fails). Any other prompt
        runs one whole-prompt pass at its bucket (``_prefill_body``; on
        CUDA one replay of the bucket's graph): the K/V rows are written
        straight into the page pool, or into rows [0, bucket) of the slot's
        dense cache, in place; rows of the bucket's padding land on the
        sacrificial page or past the prompt and are never read. Raises
        PoolExhausted before touching any state when the pool cannot back
        the prompt."""
        return self._prefill(slot, token_ids, temperature, top_p, eager=False)

    def prefill_eager(self, slot: int, token_ids: List[int], temperature: float = 0.0,
                      top_p: float = 1.0) -> int:
        """``prefill`` through the eager bodies (a hit's tail too), the plain
        twin of the replayed graphs on the card: how a caller holds a replay
        against the same kernels issued one by one. The serving path never
        calls it."""
        return self._prefill(slot, token_ids, temperature, top_p, eager=True)

    def _prefill(self, slot: int, token_ids: List[int], temperature: float,
                 top_p: float, eager: bool) -> int:
        if not 0 <= slot < self.num_slots:
            raise ValueError(f"slot {slot} out of range")
        token_ids = list(token_ids)[-(self.max_context - 1):]
        true_len = len(token_ids)
        if true_len == 0:
            raise ValueError("empty prompt")
        matched, hashes = 0, []
        if self.prefix_index is not None:
            with self._lock:
                matched, hashes = self._match_prefix(slot, token_ids)
        if matched:
            pc = ChunkedPrefill(self, slot, token_ids, temperature, top_p,
                                self._prefix_chunk, start_pos=matched, hashes=hashes,
                                eager=eager)
            try:
                first = pc.step()
                while first is None:
                    first = pc.step()
            except BaseException:
                # the shared pages must not leak into the batcher's retry
                self.release(slot)
                raise
            return first
        bucket = self.bucket_for(true_len)
        dtok = None
        with self._lock:
            if self.paged:
                self.allocator.ensure(slot, true_len)
            self._stage_admission(slot, token_ids, 0, true_len, true_len, temperature,
                                  top_p, bucket)
            key = ("prefill", bucket)
            run = self._dispatcher(key, functools.partial(self._prefill_body, bucket),
                                   eager, admission=True)
            if self._devprof is not None:
                dtok = self._devprof_note("prefill", key,
                                          self.devprof_cost("prefill", key))
            self._timed(run, dtok)()
            if dtok is not None:
                dtok.stop()
            first_token = self._admitted(slot, true_len, temperature)
            self.prefills += 1
            self._register_prefix(slot, token_ids, hashes)
        if self._devprof is not None:
            # the first token's readback above ordered the dispatch
            self._devprof_sample(dtok)
        return first_token

    def _stage_admission(self, slot: int, ids: List[int], start: int, n_valid: int,
                         true_len: int, temperature: float, top_p: float,
                         bucket: int) -> None:
        """Stage one admission dispatch's operands into the static buffers
        its body reads: the slot, the start row, the valid rows of the
        bucket, the prompt's length, the tokens ``ids`` zero-padded to
        ``bucket``, the temperature and top_p, and over the pool the page
        tables. Caller holds the lock."""
        host = self._adm_ints.host
        host[:4] = (slot, start, n_valid, true_len)
        host[4:4 + bucket] = 0
        host[4:4 + len(ids)] = ids
        self._adm_ints.push(4 + bucket)
        self._adm_f32.host[:] = (temperature, top_p)
        self._adm_f32.push()
        if self.paged:
            self._stage_tables()

    def _stage_tables(self) -> None:
        """Copy the allocator's page tables into ``tables_dev`` and, where
        compression is armed, the live-window starts into
        ``win_starts_dev``. Caller holds the lock."""
        host = self._tables.host
        n_tab = self.allocator.tables.size
        host[:n_tab] = self.allocator.tables.reshape(-1)
        if self.kv_compress_armed:
            host[n_tab:] = self._win_starts
            self._tables.push()
        else:
            self._tables.push(n_tab)

    def _prefill_body(self, bucket: int) -> None:
        """Whole-prompt prefill at ``bucket`` on the staged operands (the
        twin of the JAX ``_prefill_impl_paged`` and ``_prefill_impl``): the
        forward over the tokens [1, bucket], their K/V rows into the pool
        through the slot's row of ``tables_dev`` (a static repeat of its
        first blocks, as the JAX function takes them), or into rows
        [0, bucket) of the slot's dense cache, the padded bucket into the
        history, then ``_activate_body`` on the logits row of the prompt's
        last token. Reads only static storage, reads nothing back, branches
        on no tensor and returns nothing: what the eager path runs and a
        CUDA graph captures."""
        tokens, slot = self._adm_tokens[:, :bucket], self._adm_slot
        logits, ks, vs = model.prefill(self.params, self.cfg, tokens)
        offs = torch.arange(bucket, device=self.device)
        if self.paged:
            P = self.allocator.page_size
            row = self.tables_dev.index_select(0, slot)[0, : -(-bucket // P)].long()
            pages, offs = model.page_rows(row, P, bucket), offs % P
        else:  # (slot, rows [0, bucket)) of the dense cache
            pages = slot.expand(bucket)
        k, v = ks[:, 0], vs[:, 0]  # [L, T, KH, D]
        if self.quant_cache:
            (k, k_s), (v, v_s) = model.quantize_kv(k), model.quantize_kv(v)
            self.k_scales[:, pages, offs] = k_s
            self.v_scales[:, pages, offs] = v_s
        self.k_pool[:, pages, offs] = k.to(self.k_pool.dtype)
        self.v_pool[:, pages, offs] = v.to(self.v_pool.dtype)
        if self.track_history:
            # the whole padded bucket; the first token then goes over the
            # padding's first column
            self.history[slot, :bucket] = tokens
        self._activate_body(logits[0].index_select(0, self._adm_n_valid - 1))

    def _chunk_body(self, bucket: int, final: bool) -> None:
        """One chunk of an admission on the staged operands (the twin of the
        JAX ``_prefill_chunk_impl`` and, ``final``, ``_final_chunk_impl``):
        tokens [1, bucket] at rows [start, start+bucket) of the slot, their
        K/V rows into the cache and the tokens into the history (columns
        past its end collapse onto the sacrificial last column: a prefix
        match de-aligns chunk starts, so a final bucket's padding may
        overrun), attended over everything the slot holds
        (``model.prefill_chunk_paged`` through the slot's row of
        ``tables_dev``, or ``model.prefill_chunk`` at the device slot); the
        final chunk then runs ``_activate_body`` on the logits row of
        valid row ``n_valid - 1``. The contract of ``_prefill_body``."""
        tokens, slot, start = self._adm_tokens[:, :bucket], self._adm_slot, self._adm_start
        if self.paged:
            sink = {}
            if self.kv_compress_armed:
                # a prompt can cross the threshold mid-admission
                sink = dict(win_start=self.win_starts_dev.index_select(0, slot),
                            sink_rows=self._sink_rows)
            logits = model.prefill_chunk_paged(
                self.params, self.cfg, tokens, start, self.k_pool, self.v_pool,
                self.tables_dev.index_select(0, slot)[0], cache_scales=self._cache_scales(),
                **sink)
        else:
            logits = model.prefill_chunk(
                self.params, self.cfg, tokens, slot, start, self.k_pool, self.v_pool,
                cache_scales=self._cache_scales())
        if self.track_history:
            cols = start + torch.arange(bucket, device=self.device)
            self.history[slot, cols.clamp(max=self.history.shape[1] - 1)] = tokens[0]
        if final:
            self._activate_body(logits[0].index_select(0, self._adm_n_valid - 1))

    def _chunk_forward(self, pc: "ChunkedPrefill", n: int, bucket: int, final: bool) -> None:
        """Dispatch one chunk of ``pc``'s admission: its ``n`` tokens from
        row ``pc.pos``, padded to ``bucket``, staged and run through
        ``_chunk_body`` (on CUDA one replay, unless ``pc.eager``). Caller
        holds the lock and has backed the rows."""
        self._stage_admission(pc.slot, pc.ids[pc.pos:pc.pos + n], pc.pos, n, len(pc.ids),
                              pc.temperature, pc.top_p, bucket)
        key = ("chunk", bucket, final)
        run = self._dispatcher(key, functools.partial(self._chunk_body, bucket, final),
                               pc.eager, admission=True)
        dtok = None
        if self._devprof is not None:
            dtok = self._devprof_note("chunk", key,
                                      self.devprof_cost("chunk", key, start=pc.pos))
        self._timed(run, dtok)()
        self.prefill_chunks += 1
        if dtok is not None:
            dtok.stop()
            if final:
                pc.dtok = dtok  # read once the first token is back
            else:
                self._devprof_defer(dtok)  # a mid chunk reads nothing back

    def _activate_body(self, row: torch.Tensor) -> None:
        """The device half of the end of an admission, inside the bodies:
        keep ``row`` [1, V] (the logits of the prompt's last token), sample
        the first token from it, put it in the history at column
        ``true_len`` and make the slot live at the device slot: its length,
        last token, temperature, top_p and active flag. ``_admitted`` is
        the host half."""
        self._adm_logits.copy_(row[0])
        sampling.sample(self._adm_logits[None], self.generator, self._adm_temp,
                        self._adm_top_p, out=self._adm_first, pool=self.sample_pool)
        slot = self._adm_slot
        if self.track_history:
            self.history.index_put_((slot, self._adm_true_len), self._adm_first)
        self.lengths.index_copy_(0, slot, self._adm_true_len.to(torch.int32))
        self.last_tokens.index_copy_(0, slot, self._adm_first)
        self.temps.index_copy_(0, slot, self._adm_temp)
        self.top_ps.index_copy_(0, slot, self._adm_top_p)
        self.active_dev.index_fill_(0, slot, True)

    def _admitted(self, slot: int, true_len: int, temperature: float) -> int:
        """The host half of the end of an admission, after its dispatch:
        the host mirrors, and the admission's one readback, its first
        token. Caller holds the lock."""
        self.active[slot] = True
        self._host_greedy[slot] = temperature < sampling.GREEDY_EPS
        self._host_lengths[slot] = true_len
        # aios: waive(lock-readback): the admission's one readback stays under the engine lock, as the JAX prefill's int(first) does: _adm_first is a static buffer that the next admission rewrites
        return int(self._adm_first.item())

    def start_chunked_prefill(self, slot: int, token_ids: List[int],
                              temperature: float = 0.0, top_p: float = 1.0,
                              chunk: int = 512, eager: bool = False) -> "ChunkedPrefill":
        """Begin an incremental prefill of ``slot``: the caller calls
        ``.step()`` once per chunk and may run decode dispatches of the
        other slots in between (the continuous batcher does). ``chunk`` must
        be a prefill bucket that divides max_context, so that chunk writes
        never run past the cache end. A prompt whose leading blocks hit the
        prefix index starts after its matched rows. ``eager`` runs the
        chunks through the eager body (``ChunkedPrefill``)."""
        if not 0 <= slot < self.num_slots:
            raise ValueError(f"slot {slot} out of range")
        if chunk not in self.buckets or self.max_context % chunk:
            raise ValueError(f"chunk {chunk} must be a prefill bucket dividing "
                             f"max_context={self.max_context}")
        ids = list(token_ids)[-(self.max_context - 1):]
        matched, hashes = 0, []
        if self.prefix_index is not None:
            with self._lock:
                matched, hashes = self._match_prefix(slot, ids)
        return ChunkedPrefill(self, slot, ids, temperature, top_p, chunk,
                              start_pos=matched, hashes=hashes, eager=eager)

    def _match_prefix(self, slot: int, ids: List[int]) -> Tuple[int, List[bytes]]:
        """Map the longest hash-matched prefix of ``ids`` into ``slot``'s page
        table and backfill its history. Blocks in the pool map as shared
        read-only pages; where the chain goes on in the host tier, for at
        least ``host_restore_min_pages`` blocks, fresh pages are allocated
        and the stored K/V is copied back into them (``_restore_from_host``).
        The match is capped at the prompt's last full block minus one row,
        so every write of the slot lands past the matched rows, restored ones
        too. Returns (matched rows, the prompt's block hashes), the hashes
        even on a miss (registration publishes them after the admission).
        Caller holds the lock.

        The matched rows are page-aligned but not chunk-aligned: the tail's
        chunk starts inherit the misalignment, which ``chunk_write_rows``
        and the history's clamped write are built for."""
        P = self.allocator.page_size
        full = (len(ids) - 1) // P
        if full <= 0:
            return 0, []
        hashes = paged.chain_hashes(ids, P, full)
        pages = self.prefix_index.match(hashes)
        entries = []
        if self.host_store is not None and len(pages) < full:
            t0 = time.perf_counter()
            entries = self.host_store.match_chain(hashes[len(pages):])
            self.host_probe_seconds += time.perf_counter() - t0
            if len(entries) < self.host_restore_min_pages:
                entries = []  # below the floor a prefill beats the copy
        if not pages and not entries:
            return 0, hashes
        if pages:
            # map the pool's hits first: the slot's reference keeps the
            # restore's allocation from reclaiming the pages just matched
            self.allocator.map_shared(slot, pages)
            self.prefix_rows_reused += len(pages) * P
        restored = (self._restore_from_host(slot, entries, hashes[:len(pages)], pages)
                    if entries else [])
        matched = (len(pages) + len(restored)) * P
        if not matched:
            return 0, hashes
        if self.track_history:
            self._backfill_history(slot, ids[:matched])
        return matched, hashes

    # -- the prefix cache's host tier ------------------------------------------

    def _stage_page_ids(self, pages: List[int]) -> torch.Tensor:
        """``pages`` as an int64 device tensor, copied from fresh pinned
        memory: no host sync, not even on the previous copy (PyTorch's host
        allocator reuses the pinned block only once its copy has run).
        Caller holds the lock."""
        ids = torch.tensor(pages, dtype=torch.int64)
        if self.device.type != "cuda":
            return ids
        return ids.pin_memory().to(self.device, non_blocking=True)

    def _copy_pages(self, pages: List[int]) -> _PageCopy:
        """Enqueue the copy of ``pages`` to the host (``_PageCopy``). Caller
        holds the lock."""
        if self._copy_stream is None and self.device.type == "cuda":
            self._copy_stream = torch.cuda.Stream(self.device)
        return _PageCopy(self._pool_tensors(), self._stage_page_ids(pages), self._copy_stream)

    def _spill_pages(self, evicted: List[Tuple[bytes, int]]) -> None:
        """The index's eviction hook: enqueue the gather of the evicted pages
        (``_PageCopy``) and hand it to the spill worker, which copies it to
        the host and lands it in the store off the lock. The pages are free, and may be
        rewritten by the next dispatch, once this returns: the gather is
        enqueued before any such dispatch, on the same stream. A backlog
        past ``spill_cap_bytes`` drops the spill (a plain eviction), as a
        failed gather does. Caller holds the lock."""
        nbytes = len(evicted) * self.page_bytes()
        with self._spill_lock:
            pending = self._spill_pending
            if pending + nbytes <= self.spill_cap_bytes:
                self._spill_pending += nbytes
                self.spill_staging_peak = max(self.spill_staging_peak, self._spill_pending)
                pending = -1
        if pending >= 0:
            self.spill_drops += len(evicted)
            log.warning("%s: host-tier spill backlog at %d B; dropping %d page(s)",
                        self.cfg.name, pending, len(evicted))
            return
        try:
            copy = self._copy_pages([p for _, p in evicted])
        except BaseException:
            # give the reservation back, or the backlog gate would shut for
            # good; the index turns this into a plain eviction
            with self._spill_lock:
                self._spill_pending -= nbytes
            raise
        self._spill_q.put(([h for h, _ in evicted], nbytes, copy))
        flightrec.RECORDER.model_event(self.cfg.name, "spill", pages=len(evicted))

    @staticmethod
    def _spill_worker(q: queue.Queue, store: paged.HostPageStore, lock, eng_ref) -> None:
        """Land spilled pages in the store: copy each gather to the host
        (``_PageCopy.wait``), cut it into one owned entry a page and
        ``put`` them. Best effort: a
        failure loses those pages (a later hit recomputes them), never
        corrupts. Static, so that it does not hold the engine: the pending
        counter and the timings go through ``eng_ref``, and a worker whose
        engine was collected without ``close()`` winds down at its next
        idle minute."""
        while True:
            try:
                item = q.get(timeout=60)
            except queue.Empty:
                if eng_ref() is None:
                    return
                continue
            if item is None:
                return
            hashes, nbytes, copy = item
            gather_ms = d2h_ms = copy_s = 0.0
            try:
                host = copy.wait()
                gather_ms, d2h_ms = copy.device_ms()
                t0 = time.perf_counter()
                entries = _page_entries(host, len(hashes))
                copy_s = time.perf_counter() - t0
                copy.host = host = None  # the pinned staging goes back now
                for h, e in zip(hashes, entries):
                    store.put(h, e)
            except Exception:  # noqa: BLE001 - a spill is best effort
                log.exception("host-tier spill worker failed")
            finally:
                eng = eng_ref()
                if eng is not None:
                    with lock:
                        eng._spill_pending -= nbytes
                        t = eng.spill_timing
                        t["pages"] += len(hashes)
                        t["bytes"] += nbytes
                        t["gather_ms"] += gather_ms
                        t["d2h_ms"] += d2h_ms
                        t["copy_s"] += copy_s

    def spill_backlog(self) -> int:
        """Bytes of spills the worker has not landed yet."""
        with self._spill_lock:
            return self._spill_pending

    def _restore_from_host(self, slot: int, entries, lead_hashes=(), lead_pages=()
                           ) -> List[int]:
        """Allocate pages for a host-tier chain hit, copy the stored K/V back
        into them, map them as ``slot``'s next blocks and publish their
        hashes in the index again (with the pool's matched ``lead`` of the
        chain, so that the radix tree grafts them in place). Returns the new
        pages; empty when the pool cannot back them or the restore fails, in
        which case every page allocated here is given back and the caller
        prefills instead. Caller holds the lock."""
        # clamp to what the pool can back before allocating: an allocation
        # bound to fail would first evict (and spill) cold entries for nothing
        avail = self.allocator.free_pages + self.prefix_index.reclaimable()
        if len(entries) > avail:
            entries = entries[:avail]
            if len(entries) < self.host_restore_min_pages:
                return []
        try:
            pages = self.allocator.alloc_pages(len(entries))
        except paged.PoolExhausted:
            return []
        t0 = time.perf_counter()
        n = len(pages)
        ok = False
        try:
            act = faults.point("host_store.restore_fail", self.cfg.name)
            if act is not None:
                # chaos: the restore dies mid-flight; recovery is the real
                # fallback below (pages given back, a prefill)
                raise faults.InjectedFault(f"injected restore failure (hit {act.hit})")
            dtok = None
            if self._devprof is not None:
                dtok = self._devprof_note("restore", n)
                if dtok is not None:
                    dtok.begin()
            self._scatter_pages(pages, [e for _, e in entries])
            if dtok is not None:
                dtok.stop()
                self._devprof_defer(dtok)  # the copies read nothing back
            ok = True
        except Exception:  # noqa: BLE001 - a failed restore recomputes
            log.exception("%s: host-tier restore failed; recomputing %d page(s)",
                          self.cfg.name, n)
        finally:
            if not ok:
                for p in pages:
                    self.allocator.decref(p)
                self.host_store.note_failed_restore()
        if not ok:
            return []
        dt = time.perf_counter() - t0
        self.host_restore_seconds += dt
        if self._obs_restore_hist is not None:
            self._obs_restore_hist.observe(dt)
        self.allocator.append_owned(slot, pages)
        hashes = [h for h, _ in entries]
        self.prefix_index.put(list(lead_hashes) + hashes, list(lead_pages) + pages)
        self.host_store.discard(hashes, restored=True)
        self.prefix_rows_restored += n * self.allocator.page_size
        flightrec.RECORDER.model_event(self.cfg.name, "restore", pages=n,
                                       rows=n * self.allocator.page_size)
        return pages

    def _scatter_pages(self, pages: List[int], entries: List[Dict[str, np.ndarray]]) -> None:
        """Copy host-tier ``entries`` into pool ``pages``: each pool tensor's
        pages are stacked into pinned memory ([L, n, ...], on the host-copy
        threads), copied to the card without a host sync and written with
        one ``index_copy_`` over every layer, all on the current stream,
        ahead of the tail chunk's replay. The pinned staging is the
        engine's, reused: it first waits for the event of its previous copy.
        Raises ValueError on an entry whose shape or dtype is not the pool's.
        Eager, as ``_backfill_history`` is. Caller holds the lock."""
        cuda = self.device.type == "cuda"
        pools = self._pool_tensors()
        n = len(pages)
        shapes = [(p.shape[0], n) + tuple(p.shape[2:]) for p in pools]
        for key, pool, shape in zip(HOST_ENTRY_KEYS, pools, shapes):
            want = (shape[:1] + shape[2:], _numpy_bits(torch.empty(0, dtype=pool.dtype)).dtype)
            for e in entries:
                if (e[key].shape, e[key].dtype) != want:
                    raise ValueError(f"host-tier entry {key!r} is {e[key].dtype} "
                                     f"{e[key].shape}, the pool's pages {want[1]} {want[0]}")
        t0 = time.perf_counter()
        if cuda:
            sizes = [int(np.prod(sh)) * p.element_size() for sh, p in zip(shapes, pools)]
            offs = np.cumsum([0] + [-(-b // 256) * 256 for b in sizes])
            raw = self._restore_buffer(int(offs[-1]))
            bufs = [raw[o:o + b].view(p.dtype).view(sh)
                    for o, b, p, sh in zip(offs, sizes, pools, shapes)]
        else:
            bufs = [torch.empty(sh, dtype=p.dtype) for sh, p in zip(shapes, pools)]
        outs = [_numpy_bits(b) for b in bufs]

        def fill(i: int) -> None:
            for out, key in zip(outs, HOST_ENTRY_KEYS):
                out[:, i] = entries[i][key]

        paged.host_map(fill, range(n), sum(b.numel() * b.element_size() for b in bufs))
        self.host_staging_seconds += time.perf_counter() - t0
        ids = self._stage_page_ids(pages)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)] if cuda else None
        if cuda:
            ev[0].record()
            srcs = [b.to(self.device, non_blocking=True) for b in bufs]
            ev[1].record()
            self._restore_copied = ev[1]
        else:
            srcs = bufs
        for pool, src in zip(pools, srcs):
            pool.index_copy_(1, ids, src)
        if cuda:
            ev[2].record()
            self.last_restore_events = tuple(ev)

    def _restore_buffer(self, nbytes: int) -> torch.Tensor:
        """The restore's pinned staging of at least ``nbytes``, once its
        previous copy to the card has run (a larger one replaces it)."""
        if self._restore_copied is not None:
            # aios: waive(lock-readback): waits only for the previous restore's copy to the card, which that admission's first-token readback already ordered (the batcher keeps one admission in flight), so it returns at once while serving; the pinned staging is the engine's and is rewritten under its lock
            self._restore_copied.synchronize()
        if self._restore_pinned is None or self._restore_pinned.numel() < nbytes:
            self._restore_pinned = None
            self._restore_pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        return self._restore_pinned

    def export_prefix(self, token_ids: List[int], max_pages: int = 0):
        """A copy of the longest pool-resident chain prefix of the prompt, as
        [(hash, entry)] in the host tier's layout: what another engine
        ``put``s into its store to restore it (the fleet's push-on-prefill
        source). Empty without an index or when no full block is cached."""
        return self.export_hashes(self.prefix_hashes(token_ids), max_pages)

    def export_hashes(self, hashes: List[bytes], max_pages: int = 0):
        """``export_prefix`` by chain hashes (a peer's pull). The gather is
        enqueued under the lock, like a spill's, and the copy is waited for
        outside it."""
        if self.prefix_index is None or not hashes:
            return []
        with self._lock:
            snap = self.prefix_index.snapshot()
            chain = []
            for h in hashes:
                page = snap.get(h)
                if page is None:
                    break
                chain.append((h, page))
            if max_pages:
                chain = chain[:max_pages]
            if not chain:
                return []
            copy = self._copy_pages([p for _, p in chain])
        host = copy.wait()
        return list(zip([h for h, _ in chain], _page_entries(host, len(chain))))

    def prefix_digest(self, max_tails: int = 256) -> Dict[str, int]:
        """A bounded digest of the cached chains for the fleet's prefix
        index: the chain hash's first 16 hex digits -> depth in blocks (0 =
        unknown); the pool's entries first, then the host tier's in what the
        cap leaves."""
        if self.prefix_index is None:
            return {}
        out: Dict[str, int] = {}
        for h, blocks in self.prefix_index.digest(max_tails):
            out[h.hex()[:16]] = blocks
        if self.host_store is not None and len(out) < max_tails:
            for h in self.host_store.stored_hashes(max_tails - len(out)):
                out.setdefault(h.hex()[:16], 0)
        return out

    def prefix_hashes(self, token_ids: List[int]) -> List[bytes]:
        """Chain hashes of the prompt's full blocks, truncated as admission
        truncates: computed once per request by the serving pool and shared
        by its replicas' overlap probes (replicas of one model share page
        size and truncation)."""
        if self.prefix_index is None:
            return []
        ids = list(token_ids)[-(self.max_context - 1):]
        P = self.allocator.page_size
        full = (len(ids) - 1) // P
        if full <= 0:
            return []
        return paged.chain_hashes(ids, P, full)

    def prefix_overlap_rows(self, token_ids: List[int],
                            hashes: Optional[List[bytes]] = None) -> int:
        """How many leading prompt rows this engine's prefix cache holds: the
        router's cache-aware score. Read-only: no hit or miss counted, no
        LRU refresh, no page mapped, and only the index's and the host
        store's own locks taken, never the engine's, so a replica
        mid-dispatch cannot stall routing. Rows only the host tier holds
        count at ``paged.HOST_OVERLAP_DISCOUNT`` (where they clear the
        restore floor). 0 without an index or when no full block matches."""
        if self.prefix_index is None:
            return 0
        if hashes is None:
            hashes = self.prefix_hashes(token_ids)
        if not hashes:
            return 0
        P = self.allocator.page_size
        n_pool = self.prefix_index.peek(hashes)
        rows = n_pool * P
        if self.host_store is not None and n_pool < len(hashes):
            n_host = self.host_store.peek_chain(hashes[n_pool:])
            if n_host >= self.host_restore_min_pages:
                rows += int(n_host * P * paged.HOST_OVERLAP_DISCOUNT)
        return rows

    def _backfill_history(self, slot: int, ids: List[int]) -> None:
        """Write a prefix hit's matched tokens into the history of ``slot``:
        the twin of the JAX ``compile_hist_fn``, which compiles this write
        per bucket because an XLA program is the only way to change a
        device buffer there. Here it is one copy of the staged tokens into
        the history, a single device-to-device copy that a graph would
        issue no cheaper. Caller holds the lock."""
        n = len(ids)
        if self._devprof is not None:
            self._devprof.note("hist", ("hist", n))  # counted, never timed
        self._adm_ints.host[4:4 + n] = ids
        self._adm_ints.push(4 + n)
        self.history[slot, :n].copy_(self._adm_tokens[0, :n])

    def _register_prefix(self, slot: int, ids: List[int], hashes: List[bytes]) -> None:
        """After an admission, publish the slot's fully covered prompt
        blocks to the index so that the next prompt with this prefix skips
        their prefill. A slot that window trimming released leading blocks
        of has nothing registrable (a chain starts at block 0); one whose
        middle window+sink pruning released during the admission registers
        only its sink blocks, a valid chain prefix (the rest map the
        sacrificial page). Caller holds the lock."""
        if self.prefix_index is None or not hashes:
            return
        if self.allocator.trimmed_blocks(slot):
            return
        lo, hi = self.allocator.pruned_range(slot)
        if hi:
            hashes = hashes[:lo]
            if not hashes:
                return
        pages = [int(self.allocator.tables[slot, b]) for b in range(len(hashes))]
        self.prefix_index.put(hashes, pages)

    # -- decode -----------------------------------------------------------------

    def _maybe_compress(self, slot: int, length: Optional[int] = None) -> None:
        """Window+sink KV compression (the JAX ``_maybe_compress``): once
        ``slot``'s length passes the threshold, release its blocks between
        the sink blocks and the trailing window back to the pool and move
        its live-window start, the mask operand every later dispatch reads.
        A page shared with the prefix index keeps the index's reference
        (and spills through the host tier like any cold prefix page); only
        the slot's reference drops. Monotone: the start never rewinds.
        ``length`` is given by a mid-admission caller (the slot is not
        active yet and its host length is 0). Caller holds the lock."""
        if not self.kv_compress_armed:
            return
        if length is None:
            if not self.active[slot]:
                return
            length = int(self._host_lengths[slot])
        if length <= self.kv_compress_after:
            return
        P = self.allocator.page_size
        # the last block wholly below the trailing window [L - window rows, L]
        wb = (length - self.kv_window_pages * P) // P
        if wb <= self.kv_sink_pages:
            return
        if self._win_starts[slot] == 0:
            self.kv_compress_slots += 1
            flightrec.RECORDER.model_event(self.cfg.name, "kv_compress", slot=slot,
                                           length=length)
        self.kv_pages_pruned += self.allocator.prune_range(slot, self.kv_sink_pages, wb)
        self._win_starts[slot] = wb * P

    def compressed_resident_pages(self) -> int:
        """Pages resident for the slots window+sink compression has pruned
        (sink, trailing window and the partial block): the
        ``aios_tpu_kv_compress_resident_pages`` gauge."""
        if not self.kv_compress_armed:
            return 0
        return sum(self.allocator.slot_pages_resident(s) for s in range(self.num_slots)
                   if self._win_starts[s] > 0)

    def win_starts(self) -> np.ndarray:
        """A copy of each slot's live-window start in rows (0 =
        uncompressed)."""
        return self._win_starts.copy()

    def _back_active_slots(self, grow_rows: int) -> None:
        """Back every active slot's next ``grow_rows`` rows BEFORE a
        dispatch, so PoolExhausted surfaces with state untouched and the
        batcher can retire a victim and retry; a windowed model first
        returns the pages attention can no longer reach, and an engine with
        compression armed prunes each slot past the threshold to its sink
        and window (``_maybe_compress``). Caller holds the lock."""
        window = self.cfg.sliding_window
        for s in range(self.num_slots):
            if self.active[s]:
                if window is not None:
                    self.kv_pages_trimmed += self.allocator.trim_below_window(
                        s, int(self._host_lengths[s]), window
                    )
                self._maybe_compress(s)
                self.allocator.ensure(
                    s, min(int(self._host_lengths[s]) + grow_rows, self.max_context)
                )

    def _cache_scales(self):
        return (self.k_scales, self.v_scales) if self.quant_cache else None

    def _sink_operands(self) -> Dict[str, object]:
        """The paged forwards' compression operands: the staged live-window
        starts and the sink rows where compression is armed, else none (the
        graphs of an unarmed engine are those of the exact path)."""
        if not self.kv_compress_armed:
            return {}
        return dict(win_starts=self.win_starts_dev, sink_rows=self._sink_rows)

    def _step_body(self, masked: bool = False) -> torch.Tensor:
        """One decode step of every slot on the static state, in place:
        each slot's new K/V row, the sampled token into ``last_tokens`` and
        the history, ``lengths`` + 1 (clamped at the cache end, inactive
        slots too); ``masked`` adds ``step_mask`` to the logits before
        sampling (the JAX ``_decode_body``'s mask). Returns the logits [S,
        V] sampled from. What the eager loop runs and a CUDA graph
        captures: it reads nothing back and branches on no tensor."""
        if self.paged:
            logits = model.decode_step_paged(
                self.params, self.cfg, self.last_tokens, self.lengths,
                self.k_pool, self.v_pool, self.tables_dev, active=self.active_dev,
                cache_scales=self._cache_scales(), moe_impl=self._moe_impl,
                **self._sink_operands(),
            )
        else:
            logits = model.decode_step(
                self.params, self.cfg, self.last_tokens, self.lengths,
                self.k_pool, self.v_pool, active=self.active_dev,
                cache_scales=self._cache_scales(), moe_impl=self._moe_impl,
            )
        if masked:
            logits = logits + self.step_mask
        sampling.sample(logits, self.generator, self.temps, self.top_ps,
                        out=self.last_tokens, pool=self.sample_pool)
        if self.track_history:
            # the new token's column is lengths+1 (<= C, inside the pad);
            # inactive slots write the sacrificial last column
            hcol = torch.where(
                self.active_dev, self.lengths.long() + 1,
                torch.full_like(self._slot_ids, self.history.shape[1] - 1))
            self.history[self._slot_ids, hcol] = self.last_tokens
        torch.clamp(self.lengths + 1, max=self.max_context - 1, out=self.lengths)
        return logits

    def _round_body(self, draft_len: int, ngram: int):
        """One speculative round of every slot on the static state, in
        place: propose, verify, accept, update ``last_tokens``, ``lengths``
        and the history. Returns (tokens [S, K+1], counts [S], logits
        [S, K+1, V]). Eager on the CPU, captured on CUDA, like
        ``_step_body``."""
        K, C = draft_len, self.max_context
        # a pruned slot proposes only from matches inside its live window,
        # never from context its verify can no longer read
        drafts, _ = spec.propose_ngram(self.history, self.lengths, K, ngram, C,
                                       min_pos=self.win_starts_dev
                                       if self.kv_compress_armed else None)
        # only greedy, active slots speculate; everyone else verifies a row
        # of -1 drafts (accept count 0: a plain decode step)
        ok = (self.temps < sampling.GREEDY_EPS) & self.active_dev
        drafts = torch.where(ok[:, None], drafts, torch.full_like(drafts, -1))
        feed = torch.cat([self.last_tokens[:, None], drafts], dim=1)
        logits = self._verify_forward(feed)
        g, counts = self._accept_body(drafts, logits)
        return g, counts, logits

    def _accept_body(self, drafts: torch.Tensor, logits: torch.Tensor):
        """The end of a speculative round, shared by the n-gram and the
        draft rounds: accept the longest prefix of ``drafts`` [S, K] that
        matches the verify ``logits`` [S, K+1, V] argmax, sample row 0 (one
        draw from the generator), write the emitted tokens into the history
        and advance ``last_tokens`` and ``lengths``. Returns (tokens [S,
        K+1], counts [S])."""
        K, C = drafts.shape[1], self.max_context
        g = logits.argmax(dim=-1)  # [S, K+1]
        a = spec.accept_counts(drafts, g)  # [S] in [0, K]
        # row 0 is a plain decode step's logits; sample() takes the argmax
        # for greedy rows, so this covers both kinds of slot
        g[:, 0] = sampling.sample(logits[:, 0], self.generator, self.temps, self.top_ps,
                                  pool=self.sample_pool)
        counts = a + 1  # tokens emitted this round per slot
        # accepted tokens land at history columns lengths+1 .. lengths+1+K,
        # inside the HISTORY_PAD margin: no clamp and no colliding writes
        # for active slots
        steps = self._columns[None, : K + 1]
        hidx = torch.where(self.active_dev[:, None], self.lengths.long()[:, None] + 1 + steps,
                           torch.full_like(steps, self.history.shape[1] - 1))
        self.history[self._slot_ids[:, None], hidx] = g
        torch.gather(g, 1, a[:, None], out=self.last_tokens[:, None])
        self.lengths.copy_(torch.clamp(self.lengths + counts, max=C - 1))
        return g, counts

    # -- draft-model speculation (spec.DraftModel) ------------------------------
    # The draft's dense cache rows [0, d_len) mirror history[:, 0:d_len), the
    # contract the serving cache keeps with its lengths: accept, reject and
    # release move d_len and never rewrite rows. Accepted rows were written
    # by the draft itself while proposing; rejected ones lie past the clamped
    # d_len and are overwritten before they can be read.

    def _draft_ingest_body(self, width: int) -> None:
        """Teacher-forced catch-up of the draft cache (the JAX
        ``_draft_ingest_body`` on greedy slots, as ``_draft_ingest_impl``
        gates it): up to ``width`` history tokens a slot from column d_len
        go through the draft's ``verify_step``, which writes their K/V rows
        at [d_len, d_len + width) and stops before the lm_head (the JAX
        function discards the logits); d_len advances by min(gap, width)
        toward the serving length. Slots caught up, sampling or inactive
        write the sacrificial row. Reads only static storage and returns
        nothing: the bulk ingest graph of width ``width``, and the first
        step of the fused draft round."""
        d = self.draft_state
        d_len = d["lengths"]
        gap = torch.clamp(self.lengths - d_len, min=0)
        ing = self.active_dev & (self.temps < sampling.GREEDY_EPS) & (gap > 0)
        idx = (d_len.long()[:, None] + self._columns[None, :width]).clamp(
            max=self.history.shape[1] - 1)
        feed = self.history.gather(1, idx)
        model.verify_step(self._draft_params, self.draft.cfg, feed, d_len, d["k"], d["v"],
                          active=ing, logits=False)
        d_len.add_(torch.where(ing, torch.clamp(gap, max=width), torch.zeros_like(gap)))

    def _draft_propose_body(self, ok: torch.Tensor, draft_len: int) -> torch.Tensor:
        """``draft_len`` greedy draft steps through the draft's
        ``decode_step`` (the JAX ``_draft_propose_body``): the first takes
        the serving model's pending token and writes its draft row at d_len,
        the later ones take the draft's own argmax. A slot not ``ok`` still
        runs (fixed shapes), writes the sacrificial row and keeps its
        length. Returns the drafts [S, K], -1 rows where not ``ok``."""
        d = self.draft_state
        C = d["k"].shape[2]
        tok, length = self.last_tokens, d["lengths"]
        out = []
        for _ in range(draft_len):
            logits = model.decode_step(self._draft_params, self.draft.cfg, tok, length,
                                       d["k"], d["v"], active=ok)
            tok = logits.argmax(dim=-1)
            length = torch.where(ok, torch.clamp(length + 1, max=C - 1), length)
            out.append(tok)
        d["lengths"].copy_(length)
        drafts = torch.stack(out, dim=1)
        return torch.where(ok[:, None], drafts, torch.full_like(drafts, -1))

    def _draft_round_body(self, draft_len: int):
        """One draft-model round of every slot on the static state, in place
        (the JAX ``_draft_spec_impl``'s round): catch-up of width
        ``draft_len + 1``, the draft's K greedy steps where a slot is greedy,
        active, its draft length equal to its serving length and
        ``lengths + K <= C - 2``, the serving verify (``_verify_forward``),
        ``_accept_body``, and the draft lengths clamped to the verified
        length (rows of rejected drafts, or the bonus token's unwritten row,
        become unreadable). Sampling and inactive slots take one plain step,
        as in ``_round_body``. Returns (tokens [S, K+1], counts [S],
        proposed [S], logits [S, K+1, V]); the contract of ``_step_body``."""
        K, C = draft_len, self.max_context
        d_len = self.draft_state["lengths"]
        self._draft_ingest_body(K + 1)
        ok = ((self.temps < sampling.GREEDY_EPS) & self.active_dev
              & (d_len == self.lengths) & (self.lengths + K <= C - 2))
        if self.kv_compress_armed:
            # the draft's dense cache mirrors the whole history, which a
            # pruned slot's verify no longer sees: it takes the plain step
            ok = ok & (self.win_starts_dev == 0)
        drafts = self._draft_propose_body(ok, K)
        proposed = torch.where(ok, torch.full_like(self._slot_ids, K),
                               torch.zeros_like(self._slot_ids))
        feed = torch.cat([self.last_tokens[:, None], drafts], dim=1)
        logits = self._verify_forward(feed)
        g, counts = self._accept_body(drafts, logits)
        torch.minimum(d_len, self.lengths, out=d_len)
        return g, counts, proposed, logits

    def _verify_moe_impl(self, feed_width: int) -> Optional[str]:
        """The MoE path of a verify-shaped dispatch (n-gram and draft rounds,
        jumps): feeding W tokens a slot gathers S*W*k expert blocks, so the
        gather the engine chose falls back to dense once that reaches the
        expert count (the JAX ``_verify_moe_impl``)."""
        if (self._moe_impl == "gather"
                and self.num_slots * feed_width * self.cfg.num_experts_per_tok
                >= self.cfg.num_experts):
            return None
        return self._moe_impl

    def _verify_forward(self, feed: torch.Tensor) -> torch.Tensor:
        """The multi-token forward of ``feed`` [S, W] ([last token, W-1
        drafted or forced tokens]) over the engine's cache, its rows
        written in place (the JAX ``_verify_feed``): ``verify_step_paged``
        through ``tables_dev`` or ``verify_step``, on the MoE path of
        ``_verify_moe_impl``. Returns logits [S, W, V]."""
        impl = self._verify_moe_impl(feed.shape[1])
        if self.paged:
            return model.verify_step_paged(
                self.params, self.cfg, feed, self.lengths, self.k_pool, self.v_pool,
                self.tables_dev, active=self.active_dev, cache_scales=self._cache_scales(),
                moe_impl=impl, **self._sink_operands())
        return model.verify_step(
            self.params, self.cfg, feed, self.lengths, self.k_pool, self.v_pool,
            active=self.active_dev, cache_scales=self._cache_scales(), moe_impl=impl)

    def _jump_body(self, kb: int) -> torch.Tensor:
        """One jump-ahead dispatch at bucket ``kb`` on the staged operands
        (the twin of the JAX ``_jump_impl``): a slot with ``counts[s] = c >
        0`` feeds [last token, forced[s, :c-1]] (and the padding after it)
        through the verify forward, acceptance pinned to all: its K/V rows
        land as c masked steps would leave them, ``last_tokens`` becomes
        ``forced[s, c-1]`` (the pending token, written by the next
        dispatch), ``lengths`` advances by c, clamped at C-1, and the run
        goes into the history at columns lengths+1 .. lengths+kb. A slot
        with ``counts == 0`` keeps its length, last token and history (its
        row writes land at or past its length, where the next dispatch
        rewrites them); nothing is sampled, so the generator is untouched.
        Returns the verify logits [S, kb+1, V], which serve nothing. The
        contract of ``_step_body``."""
        S, C = self.num_slots, self.max_context
        ops_ = self._jump_ops.dev
        counts, forced = ops_[:S], ops_[S:S + S * kb].view(S, kb)
        feed = torch.cat([self.last_tokens[:, None], forced], dim=1)
        logits = self._verify_forward(feed)
        jumped = counts > 0
        new_last = torch.where(jumped, feed.gather(1, counts[:, None])[:, 0],
                               self.last_tokens)
        if self.track_history:
            # inactive and non-jumping slots write the sacrificial last column
            steps = self._columns[None, :kb]
            hidx = torch.where((self.active_dev & jumped)[:, None],
                               self.lengths.long()[:, None] + 1 + steps,
                               torch.full_like(steps, self.history.shape[1] - 1))
            self.history[self._slot_ids[:, None], hidx] = forced
        self.last_tokens.copy_(new_last)
        self.lengths.copy_(torch.clamp(self.lengths + counts, max=C - 1))
        return logits

    def _dispatcher(self, key, body, eager: bool, admission: bool = False, pool=None):
        """What runs one dispatch: ``body`` itself on the CPU or when
        ``eager``, else the replay of its graph, captured now (and counted)
        if warmup did not. Caller holds the lock."""
        if eager or not self.graphs.enabled:
            return body
        if key not in self.graphs:
            # aios: waive(graph-warmup): a key warmup did not capture (a spec round, jump bucket or admission shape first asked for later) is captured once here and counted in GraphSet.captures, HealthCheck's <model>.serving.graph_captures, which stays flat while serving after LoadModel
            self._capture(key, body, admission, pool)
        return lambda: self.graphs.replay(key)

    def _capture(self, key, body, admission: bool = False, pool=None) -> None:
        """Capture ``body`` as graph ``key``. The capture runs nothing. The
        eager pass before it must leave the engine's state as the dispatch
        would: a step or round body runs with every slot inactive (writing
        only the sacrificial page or each dense slot's last row, and the
        history's sacrificial column), then puts back the lengths, last
        tokens and active mask it moved. An admission body is idempotent
        given its staged operands, so it runs on them as it is: it writes
        what the replay then rewrites, and draws once more from the
        generator. Admission graphs share one memory pool; a body that
        returns nothing may share ``pool`` (the draft's ingest graphs).
        Caller holds the lock."""
        def prepare() -> None:
            self._reserve_workspaces()
            if admission:
                body()
                return
            state = (self.lengths, self.last_tokens, self.active_dev)
            if self.draft is not None:
                state += (self.draft_state["lengths"],)
            saved = [t.clone() for t in state]
            self.active_dev.zero_()
            body()
            for t, was in zip(state, saved):
                t.copy_(was)

        t0 = time.perf_counter()
        graph = self.graphs.capture(key, body, prepare,
                                    pool=self._admission_pool if admission else pool)
        dt = time.perf_counter() - t0
        log.info("%s: captured the %s graph (%d kernel launches) in %.2fs", self.cfg.name,
                 key, sum(graph.launches.values()), dt)
        self._devprof_register(key, dt)

    def _devprof_register(self, key, capture_s: float, n: int = 1) -> None:
        """Register a captured graph with the ledger: its capture seconds and
        the analytic cost of one replay at the graph's own shapes (every
        slot at the full context; ``n`` ticks for a megagraph bucket)."""
        if self._devprof is None:
            return
        kind = key if isinstance(key, str) else key[0]
        start = self.max_context - key[1] if kind == "chunk" else 0
        self._devprof.register(kind, key, self.devprof_cost(kind, key, start=start, n=n),
                               capture_s)

    def _workspace_launches(self) -> List[Tuple[int, int, int, int]]:
        """The split launches of this engine as (groups, splits, partial
        rows, head dim): ``workspace_launches`` (the decode attention, the
        verify attention of a speculative round or a jump, and a chunk of
        the prefix hit's rows (``prefill_chunk_default``, the batcher's
        default chunk), or of the larger chunk ``warmup`` was given), and
        with a draft model ``draft_workspace_launches`` at its head dim."""
        sms = sm_count(self.device.index)
        out = [(*launch, self.cfg.head_dim) for launch in workspace_launches(
            self.cfg, self.num_slots, self.max_context, chunk=self._workspace_chunk,
            speculative=self.track_history, sms=sms)]
        if self.draft is not None:
            out += [(*launch, self.draft.cfg.head_dim) for launch in draft_workspace_launches(
                self.draft.cfg, self.num_slots, self.max_context, sms=sms)]
        return out

    def workspace_bytes(self) -> int:
        """Bytes of the split workspace the engine reserves on a stream (fp32
        partials and int32 tickets), 0 off CUDA."""
        if self.device.type != "cuda":
            return 0
        launches = self._workspace_launches()
        floats = max(g * s * split.partial_floats(d, rows) for g, s, rows, d in launches)
        return 4 * (floats + max(g for g, _, _, _ in launches))

    def _reserve_workspaces(self) -> None:
        """Make the current stream's split workspace at the largest launch
        this engine makes (single-query attention over the whole context;
        the verify attention of the longest draft spec_step takes, or of
        the largest jump; a chunk of the admission, B = 1 and T = its rows;
        a draft's steps, catch-up and widest ingest) and its split-K ticket
        counters, before a capture holds their addresses."""
        dev = self.device
        stream = torch.cuda.current_stream(dev).cuda_stream
        for groups, splits, rows, head_dim in self._workspace_launches():
            split.workspace(dev, stream, groups, splits, head_dim, rows)
        counters_for(dev, stream)

    def admission_plan(self, prefill_chunk: Optional[int] = None
                       ) -> Tuple[List[int], List[Tuple[int, bool]]]:
        """(prefill buckets, chunk keys (bucket, final)) of the admission
        graphs ``capture_admission`` captures: the keys of the JAX warmup's
        ``_prefill_fns`` (less its history backfills, one copy here:
        ``_backfill_history``) and ``_chunk_fns`` on the same geometry. Every
        bucket the pool can back (``blocks_for(bucket // 2 + 1)`` within
        ``capacity_blocks()``); for the batcher's chunk (None:
        ``prefill_chunk_default``, 0: none), where it is a bucket dividing
        the context, the mid chunk (chunk, False) and a final (b, True) for
        each bucket b up to it; with the prefix index, the same at
        ``_prefix_chunk``."""
        alloc = self.allocator
        buckets = [b for b in self.buckets
                   if alloc is None or alloc.blocks_for(b // 2 + 1) <= alloc.capacity_blocks()]
        ck = self.prefill_chunk_default if prefill_chunk is None else prefill_chunk
        chunks: List[Tuple[int, bool]] = []
        for c in (ck, self._prefix_chunk if self.prefix_index is not None else None):
            if c and c in self.buckets and self.max_context % c == 0:
                for key in [(c, False)] + [(b, True) for b in self.buckets if b <= c]:
                    if key not in chunks:
                        chunks.append(key)
        return buckets, chunks

    def capture_admission(self, prefill_chunk: Optional[int] = None) -> int:
        """Capture every graph of ``admission_plan(prefill_chunk)`` not
        captured yet, largest prefill bucket first (so the shared memory
        pool reaches its peak once), then the chunks: the twin of the JAX
        warmup's ``compile_prefill_fn`` and ``compile_chunk_fn`` loops.
        Returns how many it captured and adds the reserved bytes they took
        to ``admission_pool_bytes``. The eager pass before each capture
        runs on parked operands (slot 0, start 0, one token, page 0 of an
        empty table), whose state it puts back; a dense cache keeps no
        sacrificial slot, so this runs before the first admission, as
        ``warmup`` does, and raises after one. Nothing to do off CUDA."""
        if not self.graphs.enabled:
            return 0
        buckets, chunks = self.admission_plan(prefill_chunk)
        todo = [(("prefill", b), functools.partial(self._prefill_body, b))
                for b in sorted(buckets, reverse=True)]
        todo += [(("chunk", b, final), functools.partial(self._chunk_body, b, final))
                 for b, final in chunks]
        todo = [(key, body) for key, body in todo if key not in self.graphs]
        if not todo:
            return 0
        with self._lock:
            if self.prefills or self.prefill_chunks:
                raise RuntimeError("capture_admission captures on parked operands, which "
                                   "would overwrite an admitted slot: call it before the "
                                   "first admission (warmup does)")
            moved = [self.lengths, self.last_tokens, self.temps, self.top_ps,
                     self.active_dev] + ([self.history] if self.track_history else [])
            saved = [t.clone() for t in moved]
            before = self.graphs.reserved_bytes()
            self._stage_admission(0, [0], 0, 1, 1, 0.0, 1.0, self.buckets[-1])
            for key, body in todo:
                self._capture(key, body, admission=True)
            for t, was in zip(moved, saved):
                t.copy_(was)
            self.admission_pool_bytes += self.graphs.reserved_bytes() - before
        return len(todo)

    def admission_graphs(self) -> int:
        """How many admission graphs the engine holds."""
        return sum(isinstance(k, tuple) and k[0] in ("prefill", "chunk")
                   for k in self.graphs.graphs)

    def capture_step(self) -> None:
        """Ensure the decode step's graph exists without dispatching (the
        twin of the JAX ``compile_step_fn``); nothing to do off CUDA."""
        if self.graphs.enabled:
            with self._lock:
                self._dispatcher("step", self._step_body, eager=False)

    def capture_masked(self) -> None:
        """Ensure the masked step's graph exists without dispatching (the
        twin of the JAX ``compile_masked_fn``); nothing to do off CUDA."""
        if self.graphs.enabled:
            with self._lock:
                self._dispatcher("masked", functools.partial(self._step_body, True),
                                 eager=False)

    def capture_jump(self, k_bucket: int) -> None:
        """Ensure the jump graph of bucket ``k_bucket`` exists without
        dispatching (the twin of the JAX ``compile_jump_fn``); nothing to do
        off CUDA."""
        if k_bucket not in JUMP_BUCKETS:
            raise ValueError(f"jump bucket {k_bucket} not in {JUMP_BUCKETS}")
        if self.graphs.enabled:
            with self._lock:
                self._dispatcher(("jump", k_bucket),
                                 functools.partial(self._jump_body, k_bucket), eager=False)

    def capture_spec(self, draft_len: int = SPEC_DRAFT_LEN, ngram: int = SPEC_NGRAM) -> None:
        """Ensure the round graph for (draft_len, ngram) exists without
        dispatching (the twin of the JAX ``compile_spec_fn``); nothing to do
        off CUDA or without the token history."""
        if not (self.graphs.enabled and self.track_history):
            return
        self._check_spec(draft_len, ngram)
        with self._lock:
            self._dispatcher(("spec", draft_len, ngram),
                             functools.partial(self._round_body, draft_len, ngram),
                             eager=False)

    def capture_draft(self, draft_len: int = SPEC_DRAFT_LEN) -> None:
        """Ensure the fused draft round of ``draft_len`` and every bulk
        ingest width exist without dispatching (the twins of the JAX
        ``compile_draft_spec_fn`` and ``compile_draft_ingest_fns``), the
        ingest graphs, widest first, in their own shared pool, whose bytes
        go to ``draft_pool_bytes``; nothing to do off CUDA or without a
        draft model."""
        if not (self.graphs.enabled and self.draft is not None):
            return
        self._check_spec(draft_len, SPEC_NGRAM)
        with self._lock:
            self._dispatcher(("draft_spec", draft_len),
                             functools.partial(self._draft_round_body, draft_len), eager=False)
            todo = [w for w in sorted(self._draft_ingest_buckets(), reverse=True)
                    if ("draft_ingest", w) not in self.graphs]
            if todo:
                before = self.graphs.reserved_bytes()
                for w in todo:
                    self._dispatcher(("draft_ingest", w),
                                     functools.partial(self._draft_ingest_body, w),
                                     eager=False, pool=self._draft_pool)
                self.draft_pool_bytes += self.graphs.reserved_bytes() - before

    def draft_graphs(self) -> int:
        """How many draft graphs (fused rounds and ingest widths) the engine
        holds."""
        return sum(isinstance(k, tuple) and k[0] in ("draft_spec", "draft_ingest")
                   for k in self.graphs.graphs)

    def step(self, n_steps: int = 1) -> np.ndarray:
        """Run ``n_steps`` batched decode steps; returns tokens
        [n_steps, num_slots] (only active columns mean anything). Lengths
        advance for every slot, clamped at the cache end. One host readback
        per call; on CUDA each step is one replay of the step graph."""
        return self._steps(n_steps, eager=False)

    def step_eager(self, n_steps: int = 1) -> np.ndarray:
        """``step`` through the eager body, the plain twin of the replayed
        graph on the card: how a caller holds a replay against the same
        kernels issued one by one. The serving path never calls it."""
        return self._steps(n_steps, eager=True)

    def step_masked(self, rows) -> np.ndarray:
        """One batched decode step whose logits get an ADDITIVE mask before
        sampling (grammar-constrained decoding, ``jsonmode.py``): ``rows``
        maps slot -> [vocab] f32 row (0 = allowed, ``jsonmode.NEG_INF`` =
        forbidden; a device tensor, a host tensor or a numpy array), copied
        into ``step_mask`` on the device; every other slot decodes with a
        zero row. Returns tokens [1, num_slots]. On CUDA one replay of the
        "masked" graph."""
        return self._steps(1, eager=False, rows=rows)

    def step_masked_eager(self, rows) -> np.ndarray:
        """``step_masked`` through the eager body (see ``step_eager``)."""
        return self._steps(1, eager=True, rows=rows)

    def _write_mask(self, rows) -> None:
        """Copy ``rows`` into ``step_mask`` and zero the rows set before
        that ``rows`` leaves out. Caller holds the lock."""
        for s in self._mask_rows - set(rows):
            self.step_mask[s].zero_()
        for s, row in rows.items():
            self.step_mask[s].copy_(torch.as_tensor(row))
        self._mask_rows = set(rows)

    def _steps(self, n_steps: int, eager: bool, rows=None) -> np.ndarray:
        return self._step_dispatch(n_steps, eager=eager, rows=rows)[0]

    def _step_dispatch(self, n_steps: int, started: Optional[threading.Event] = None,
                       eager: bool = False, rows=None) -> Tuple[np.ndarray, np.ndarray, int]:
        """The decode dispatch (the JAX ``_step_dispatch``): under the lock,
        back and stage, run ``n_steps`` steps (n replays of the one-step
        graph, which serves every n, with ``unified_step`` or without),
        advance the host lengths; then read the tokens back outside the
        lock. Returns (tokens [n, S], the host lengths after this
        dispatch, n, the devprof sample's device seconds or None).
        ``started`` (the dispatch worker's) is set once the lock is held."""
        try:
            return self._step_dispatch_locked(n_steps, started, eager, rows)
        finally:
            if started is not None and self._devprof is not None:
                self._devprof.dequeue()

    def _step_dispatch_locked(self, n_steps: int, started, eager: bool, rows):
        with self._lock:
            if started is not None:
                started.set()
            if self.paged:
                self._back_active_slots(n_steps)
                self._stage_tables()
            if rows is not None:
                self._write_mask(rows)
                kind = "masked"
                run = self._dispatcher(kind, functools.partial(self._step_body, True), eager)
            else:
                kind = "step"
                run = self._dispatcher(kind, self._step_body, eager)
            dtok = None
            if self._devprof is not None:
                # the worker samples only with nothing queued behind it
                dtok = self._devprof_note(
                    kind, kind, self.devprof_cost(kind, lens=self._active_lens(), n=n_steps),
                    need_slack=started is not None)
            out = torch.empty((n_steps, self.num_slots), dtype=torch.int64,
                              device=self.device)
            run = self._timed(run, dtok)
            for i in range(n_steps):
                self.last_logits = run()
                out[i] = self.last_tokens
            if dtok is not None:
                dtok.stop()
            self.decode_steps += n_steps
            self._host_lengths = np.minimum(
                self._host_lengths + n_steps, self.max_context - 1
            )
            lengths = self._host_lengths.copy()
        tokens = out.cpu().numpy()
        # the readback just ordered the dispatch: its sample costs no sync
        sample_s = self._devprof_sample(dtok) if self._devprof is not None else None
        return tokens, lengths, n_steps, sample_s

    def _dispatch_worker(self) -> ThreadPoolExecutor:
        """The single dispatch worker of ``step_async`` and
        ``mega_step_async`` (made at first use): FIFO, so dispatches run in
        the order they were issued."""
        if self._dispatch_pool is None:
            self._dispatch_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix=f"decode-dispatch-{self.cfg.name}")
        return self._dispatch_pool

    def step_async(self, n_steps: int = 1) -> PendingDecode:
        """``step(n_steps)`` on the engine's dispatch worker; returns at once
        (the JAX ``step_async``). The worker runs the whole dispatch,
        replays and readback, so the pipelined batcher emits dispatch N's
        tokens while N+1 runs. A PoolExhausted from backing the slots
        surfaces at ``wait()`` with the state untouched. Dispatches are FIFO
        and take the engine lock like every other engine call;
        ``wait_started()`` orders later calls after this one."""
        started = threading.Event()
        if self._devprof is not None:
            self._devprof.enqueue()  # the worker's sampling slack
        fut = self._dispatch_worker().submit(self._step_dispatch, n_steps, started)
        return PendingDecode(fut, n_steps, started)

    # -- the megagraph ---------------------------------------------------------

    def mega_bucket(self, n: int) -> int:
        """The power-of-two megagraph bucket serving an ``n``-tick window
        (the smallest captured K >= n; the dispatch stages the true n)."""
        m = 1
        while m < n:
            m *= 2
        return m

    def _stage_ticks(self, cap: int, stops: np.ndarray, budgets: np.ndarray) -> None:
        """Stage a megagraph dispatch's operands: the tick cap, each slot's
        remaining budget and stop ids (pad -1). Caller holds the lock."""
        S = self.num_slots
        host = self._tick_ops.host
        host[0] = cap
        host[1:1 + S] = budgets
        host[1 + S:] = np.asarray(stops, dtype=np.int32).reshape(-1)
        self._tick_ops.push()

    def _tick_body(self, i: int, tg: _TickGraph) -> None:
        """Tick ``i`` of a megagraph dispatch on the static state: one
        decode step (``_step_body``), its tokens into row i of ``tg``'s
        tokens, each slot's stop flag (the sampled token is one of its stop
        ids) and budget. What the eager loop runs and what a graph captures
        into tick i's conditional node."""
        self._step_body()
        tg.tokens[i].copy_(self.last_tokens)
        hit = (self.last_tokens[:, None] == self._tick_stops).any(dim=1)
        torch.logical_or(self._tick_done, hit, out=self._tick_done)
        self._tick_rem.sub_(1)

    def _ticks_eager(self, tg: _TickGraph) -> int:
        """The ticks of ``tg`` one by one, each after its gate
        (``ops.mega_gate``, read back): the CPU's path and the card's eager
        twin of the replayed graph. Returns the ticks that ran."""
        self._tick_done.zero_()
        tg.go.zero_()
        for i in range(tg.m):
            ops.mega_gate(i, self._tick_cap, self.active_dev, self._tick_done, self._tick_rem,
                          self.lengths, self.max_context - 1, tg.go)
            if not int(tg.go[i]):
                return i
            self._tick_body(i, tg)
        return tg.m

    def _capture_ticks(self, m: int) -> None:
        """Capture the megagraph bucket ``("mega", m)``: a
        prologue, then for each of the m ticks the gate and a conditional
        node whose body is ``_tick_body`` (``ops.mega_graph.mega_tick``),
        then the readback, the m token rows and the tick count in one
        tensor. The bodies are captured on the engine's tick stream into
        one memory pool every tick graph shares (they run one at a time on
        the engine's stream and return nothing); the eager pass before the
        capture runs one tick with every slot inactive and puts the state
        back, as ``_capture`` does. Caller holds the lock."""
        key = ("mega", m)
        tg = _TickGraph(m, self.num_slots, self.device)
        if self._tick_pool is None:
            self._tick_pool = self.graphs.new_pool()
            if self.device.type == "cuda":
                self._tick_stream = torch.cuda.Stream(self.device)
        ctx = self.max_context - 1

        def prepare() -> None:
            self._reserve_workspaces()
            state = (self.lengths, self.last_tokens, self.active_dev, self._tick_done,
                     self._tick_ops.dev)
            saved = [t.clone() for t in state]
            self.active_dev.zero_()
            self._tick_body(0, tg)
            ops.mega_gate(0, self._tick_cap, self.active_dev, self._tick_done, self._tick_rem,
                          self.lengths, ctx, tg.go)
            for t, was in zip(state, saved):
                t.copy_(was)

        def body() -> torch.Tensor:
            tg.go.zero_()
            self._tick_done.zero_()
            for i in range(m):
                with mega_graph.mega_tick(self._tick_stream, self._tick_pool, i,
                                          self._tick_cap, self.active_dev, self._tick_done,
                                          self._tick_rem, self.lengths, ctx, tg.go):
                    self._tick_pool_refs += 1
                    with build.recording_launches() as launches:
                        self._tick_body(i, tg)
                if i == 0:
                    tg.tick_launches = launches
            return torch.cat([tg.tokens.view(-1), tg.go.sum().view(1).to(torch.int64)])

        t0 = time.perf_counter()
        self._tick_graphs[key] = tg
        self.graphs.capture(key, body, prepare)
        dt = time.perf_counter() - t0
        log.info("%s: captured the %s graph (%d ticks, %d kernel launches a tick) in %.2fs",
                 self.cfg.name, key, m, sum(tg.tick_launches.values()), dt)
        self._devprof_register(key, dt, n=m)

    def _replay_ticks(self, m: int, dtok=None) -> Tuple[torch.Tensor, int]:
        """Replay the megagraph bucket ``m`` (captured now if need be) on
        the staged operands; read back its tokens and tick count k (the
        one readback) and count the launches of the k ticks that ran.
        ``dtok`` (a devprof timing) is stopped right after the replay.
        Returns (tokens [k, S] on the host, k). Caller holds the lock."""
        key = ("mega", m)
        if key not in self.graphs:
            # aios: waive(graph-warmup): a bucket warmup did not capture (mega_ticks raised after LoadModel) is captured once here and counted in GraphSet.captures, HealthCheck's <model>.serving.graph_captures
            self._capture_ticks(m)
        tg = self._tick_graphs[key]
        if dtok is not None:
            dtok.begin()
        out = self.graphs.replay(key)
        if dtok is not None:
            dtok.stop()
        # aios: waive(lock-readback): the tick count k is read back under the engine lock, as the JAX _mega_dispatch does: the host lengths advance by k before the next dispatch stages, and out is the graph's static output, which the next replay rewrites
        host = out.cpu()
        k = int(host[-1])
        build.add_launches(tg.tick_launches, k)
        return host[:-1].view(tg.m, self.num_slots)[:k], k

    def capture_mega(self, k_bucket: int) -> None:
        """Ensure the ``k_bucket``-tick megagraph exists without
        dispatching (the twin of the JAX ``compile_mega_fn``); nothing to do
        off CUDA or with the megagraph off."""
        if not (self.graphs.enabled and self.mega_ticks):
            return
        with self._lock:
            if ("mega", k_bucket) not in self.graphs:
                self._capture_ticks(k_bucket)

    def capture_decode_loop(self) -> None:
        """Capture the megagraph buckets that ``warmup`` covers: with
        ``mega_ticks`` every power-of-two bucket up to
        ``mega_bucket(mega_ticks)`` (the batcher's window is min(chunk,
        mega_ticks), and shorter windows bucket down). Nothing to do off
        CUDA or with the megagraph off."""
        if self.mega_ticks:
            m = 1
            while m <= self.mega_bucket(self.mega_ticks):
                self.capture_mega(m)
                m *= 2

    def mega_graphs(self) -> int:
        """How many megagraph buckets the engine holds."""
        return sum(isinstance(k, tuple) and k[0] == "mega" for k in self.graphs.graphs)

    def _mega_dispatch(self, n_ticks: int, stops: np.ndarray, budgets: np.ndarray,
                       started: Optional[threading.Event] = None, eager: bool = False
                       ) -> Tuple[np.ndarray, np.ndarray, int]:
        """The megagraph dispatch (the JAX ``_mega_dispatch``): under the
        lock, back and stage, take the ``pool.megatick_abort`` fault into
        the cap, run up to ``n_ticks`` ticks (one replay of the bucket's
        graph, or the eager loop), read back the tokens and the real tick
        count k (under the lock: the host lengths advance by k), and
        advance by k. Returns (tokens [k, S], per-tick host length snapshots
        [k, S], k, the devprof sample's device seconds or None)."""
        try:
            return self._mega_dispatch_locked(n_ticks, stops, budgets, started, eager)
        finally:
            if started is not None and self._devprof is not None:
                self._devprof.dequeue()

    def _mega_dispatch_locked(self, n_ticks, stops, budgets, started, eager):
        S = self.num_slots
        stops = np.asarray(stops, dtype=np.int32).reshape(S, MEGA_STOP_SLOTS)
        budgets = np.asarray(budgets, dtype=np.int32).reshape(S)
        with self._lock:
            if started is not None:
                started.set()
            if self.paged:
                self._back_active_slots(n_ticks)
                self._stage_tables()
            abort_after = n_ticks
            act = faults.point("pool.megatick_abort", self.cfg.name)
            if act is not None and n_ticks > 1:
                # injected host-attention demand: the device loop stops
                # mid-window with slots still live
                abort_after = min(max(act.ticks or n_ticks // 2, 1), n_ticks - 1)
            m = self.mega_bucket(n_ticks)
            self._stage_ticks(min(n_ticks, abort_after, m), stops, budgets)
            dtok = lens = None
            if self._devprof is not None:
                # the cost joins once k is read back: k ticks of a step;
                # the whole replay is timed, never tick by tick
                lens = self._active_lens()
                dtok = self._devprof_note("mega", ("mega", m), (0.0, 0.0),
                                          need_slack=started is not None)
            if eager or not self.graphs.enabled:
                tg = self._tick_graphs.get(("eager", m))
                if tg is None:
                    tg = self._tick_graphs[("eager", m)] = _TickGraph(m, S, self.device)
                if dtok is not None:
                    dtok.begin()
                k = self._ticks_eager(tg)
                if dtok is not None:
                    dtok.stop()
                # a copy: the buffer is the next dispatch's, which a
                # pipelined caller issues before it reads these
                # aios: waive(lock-readback): the eager twin of _replay_ticks' readback: k and the tokens are read under the engine lock, as the JAX _mega_dispatch does
                tokens = tg.tokens[:k].to("cpu", copy=True)
            else:
                tokens, k = self._replay_ticks(m, dtok)
            if self._devprof is not None:
                cost = self.devprof_cost("mega", lens=lens, n=k)
                self._devprof.charge("mega", cost)
                if dtok is not None:
                    dtok.cost = cost
            self.last_logits = None
            self.mega_dispatches += 1
            self.mega_tick_total += k
            self.decode_steps += k
            base = self._host_lengths.copy()
            self._host_lengths = np.minimum(base + k, self.max_context - 1)
        # row j: every slot's length as of tick j, the anchor of the
        # batcher's out-of-cache retirement for that tick's tokens
        lengths = np.minimum(base[None, :] + np.arange(1, k + 1, dtype=np.int64)[:, None],
                             self.max_context - 1)
        sample_s = self._devprof_sample(dtok) if self._devprof is not None else None
        return tokens.numpy(), lengths, k, sample_s

    def mega_step(self, n_ticks: int, stops: np.ndarray, budgets: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray, int]:
        """Run up to ``n_ticks`` decode ticks in ONE dispatch (the JAX
        ``mega_step``), with an early exit the moment no slot needs another
        tick: a slot is live while it is active, has not sampled one of its
        ``stops`` ids ([S, MEGA_STOP_SLOTS] int32, pad -1), has ``budgets``
        left ([S] int32, tokens still to produce) and is below the context
        cap. Returns (tokens [k, S], per-tick length snapshots [k, S], k), k
        <= n_ticks the ticks that ran. On CUDA one replay of the bucket's
        graph (``mega_bucket``), whose ticks are conditional nodes."""
        return self._mega_dispatch(n_ticks, stops, budgets)[:3]

    def mega_step_async(self, n_ticks: int, stops: np.ndarray, budgets: np.ndarray
                        ) -> PendingDecode:
        """``mega_step`` on the dispatch worker (the JAX
        ``mega_step_async``): ``step_async``'s contract; after ``wait()``
        the handle's ``ticks`` is k and its ``lengths`` the [k, S]
        snapshots."""
        started = threading.Event()
        if self._devprof is not None:
            self._devprof.enqueue()
        fut = self._dispatch_worker().submit(self._mega_dispatch, n_ticks, stops, budgets,
                                             started)
        return PendingDecode(fut, n_ticks, started)

    def jump_step(self, forced: np.ndarray, counts: np.ndarray) -> None:
        """Append grammar-FORCED token runs in ONE multi-token dispatch
        (compressed-FSM jump-ahead; the batcher's constrained tick).

        ``forced`` [num_slots, k] holds each jumping slot's run (padded
        past its count); ``counts`` [num_slots] in [0, k], 0 marking a slot
        this dispatch must not advance. k buckets up to the smallest
        ``JUMP_BUCKETS`` size; a longer run raises. The caller clamps each
        run so ``slot_length + counts[s] <= max_context - 2`` and emits the
        run tokens itself: they ARE the dispatch's output. Over the pool
        ``kb + 1`` rows of every active slot are backed first, so
        PoolExhausted leaves the state untouched. On CUDA one replay of
        the bucket's graph (``_jump_body``)."""
        self._jump(forced, counts, eager=False)

    def jump_step_eager(self, forced: np.ndarray, counts: np.ndarray) -> None:
        """``jump_step`` through the eager body (see ``step_eager``)."""
        self._jump(forced, counts, eager=True)

    def _jump(self, forced: np.ndarray, counts: np.ndarray, eager: bool) -> None:
        forced = np.asarray(forced)
        k = int(forced.shape[1])
        kb = next((b for b in JUMP_BUCKETS if b >= k), None)
        if kb is None:
            raise ValueError(f"jump run of {k} tokens exceeds the largest bucket "
                             f"({JUMP_BUCKETS[-1]}); clamp runs to jump_max")
        S = self.num_slots
        counts = np.asarray(counts, dtype=np.int64)
        with self._lock:
            if self.paged:
                self._back_active_slots(kb + 1)
                self._stage_tables()
            host = self._jump_ops.host
            host[:S] = counts
            block = host[S:S + S * kb].reshape(S, kb)
            block[:] = 0
            block[:, :k] = forced
            self._jump_ops.push(S + S * kb)
            key = ("jump", kb)
            run = self._dispatcher(key, functools.partial(self._jump_body, kb), eager)
            dtok = None
            if self._devprof is not None:
                dtok = self._devprof_note("jump", key, self.devprof_cost(
                    "jump", key, lens=self._active_lens()))
            self.last_logits = self._timed(run, dtok)()
            if dtok is not None:
                dtok.stop()
                self._devprof_defer(dtok)  # a jump reads nothing back
            self.decode_steps += 1
            self.jump_dispatches += 1
            self.jump_tokens += int(counts.sum())
            self._host_lengths = np.minimum(self._host_lengths + counts,
                                            self.max_context - 1)

    def force_pending_token(self, slot: int, token_id: int) -> None:
        """Replace ``slot``'s pending (sampled, not yet consumed) token.
        Grammar-constrained requests use it right after their admission:
        the first token is sampled unmasked, so the batcher overwrites it
        with the grammar's forced opener ("{") before any decode dispatch
        consumes it, in ``last_tokens`` and at the history's column of the
        slot's length."""
        with self._lock:
            self.last_tokens[slot] = token_id
            if self.track_history:
                self.history[slot, int(self._host_lengths[slot])] = token_id

    def _check_spec(self, draft_len: int, ngram: int) -> None:
        # the upper bound keeps active slots' history writes strictly below
        # the sacrificial last pad column reserved for inactive slots
        if not 1 <= draft_len <= spec.HISTORY_PAD - 2:
            raise ValueError(f"draft_len must be in [1, {spec.HISTORY_PAD - 2}]")
        if ngram < 1:
            raise ValueError("ngram must be >= 1")
        if not self.track_history:
            raise ValueError(
                "speculative decoding needs the token history "
                "(track_history=True; the n-gram proposer reads it)"
            )

    def spec_step(self, n_rounds: int = 8, draft_len: int = SPEC_DRAFT_LEN,
                  ngram: int = SPEC_NGRAM) -> Tuple[np.ndarray, np.ndarray]:
        """Run ``n_rounds`` speculative decode rounds over the engine's cache.

        Returns (tokens [n_rounds, num_slots, draft_len+1], counts
        [n_rounds, num_slots]): in round r, slot s emitted the first
        ``counts[r, s]`` entries of ``tokens[r, s]`` — at least 1 (a plain
        decode step's token), up to ``draft_len+1`` when the whole n-gram
        draft was accepted. Greedy slots emit exactly the plain-greedy
        sequence; temp > 0 slots never speculate and emit one sampled token
        per round. Only columns where ``self.active`` are meaningful. Each
        round draws from the generator once, like a decode step; one host
        readback per call. Over the pool ``n_rounds * (draft_len + 1)`` rows
        of every active slot are backed first (full acceptance every round;
        unused pages recycle at release), so PoolExhausted leaves the state
        untouched. On CUDA each round is one replay of the round graph of
        (draft_len, ngram)."""
        return self._rounds(n_rounds, draft_len, ngram, eager=False)

    def spec_step_eager(self, n_rounds: int = 8, draft_len: int = SPEC_DRAFT_LEN,
                        ngram: int = SPEC_NGRAM) -> Tuple[np.ndarray, np.ndarray]:
        """``spec_step`` through the eager body, the plain twin of the
        replayed graph on the card (see ``step_eager``)."""
        return self._rounds(n_rounds, draft_len, ngram, eager=True)

    def _rounds(self, n_rounds: int, draft_len: int, ngram: int,
                eager: bool) -> Tuple[np.ndarray, np.ndarray]:
        self._check_spec(draft_len, ngram)
        S, K = self.num_slots, draft_len
        with self._lock:
            if self.paged:
                self._back_active_slots(n_rounds * (K + 1))
                self._stage_tables()
            key = ("spec", draft_len, ngram)
            run = self._dispatcher(key, functools.partial(self._round_body, draft_len, ngram),
                                   eager)
            dtok = None
            if self._devprof is not None:
                dtok = self._devprof_note("spec", key, self.devprof_cost(
                    "spec", key, lens=self._active_lens(), n=n_rounds))
            # tokens [R, S, K+1] and, in the last column, counts: one readback
            out = torch.empty((n_rounds, S, K + 2), dtype=torch.int64, device=self.device)
            run = self._timed(run, dtok)
            for r in range(n_rounds):
                g, counts, self.last_logits = run()
                out[r, :, : K + 1] = g
                out[r, :, K + 1] = counts
            if dtok is not None:
                dtok.stop()
            self.decode_steps += n_rounds
            self.spec_rounds += n_rounds
            self.spec_proposer_rounds["ngram"] += n_rounds
            # acceptance denominator: (round, active slot) pairs, a per-slot
            # rate that does not scale with batch occupancy
            active_rounds = n_rounds * int(self.active.sum())
            self.spec_slot_rounds += active_rounds
        host = out.cpu().numpy()
        if self._devprof is not None:
            self._devprof_sample(dtok)
        tokens, counts = host[:, :, : K + 1], host[:, :, K + 1]
        with self._lock:
            emitted = int(counts[:, self.active].sum())
            self.spec_tokens += emitted
            self.spec_proposer_accepted["ngram"] += max(emitted - active_rounds, 0)
            self._host_lengths = np.minimum(
                self._host_lengths + counts.sum(axis=0), self.max_context - 1
            )
        return tokens, counts

    def spec_step_draft(self, n_rounds: int = 8, draft_len: int = SPEC_DRAFT_LEN
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Run ``n_rounds`` draft-model speculative rounds: the attached
        draft proposes ``draft_len`` tokens a greedy slot and the serving
        model verifies them, catch-up, proposal, verify, acceptance and the
        draft's sync in one fused round (bulk ingest for freshly admitted
        slots first, ``_draft_catchup``). Returns (tokens [n_rounds,
        num_slots, draft_len+1], counts [n_rounds, num_slots], proposed
        [n_rounds, num_slots]): tokens and counts as ``spec_step``'s,
        ``proposed`` the draft tokens offered a (round, slot), 0 or
        draft_len, the acceptance denominator. Greedy slots emit the
        plain-greedy sequence; temp > 0 slots never propose. Over the pool
        ``n_rounds * (draft_len + 1)`` rows of every active slot are backed
        first. One host readback per call (and one per ingest dispatch); on
        CUDA each round is one replay of the fused round's graph, each
        ingest one replay of its width's graph."""
        return self._draft_rounds(n_rounds, draft_len, eager=False)

    def spec_step_draft_eager(self, n_rounds: int = 8, draft_len: int = SPEC_DRAFT_LEN
                              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``spec_step_draft`` through the eager bodies, ingest included
        (see ``step_eager``)."""
        return self._draft_rounds(n_rounds, draft_len, eager=True)

    def _draft_rounds(self, n_rounds: int, draft_len: int, eager: bool):
        if self.draft is None:
            raise ValueError("no draft model attached (TorchEngine(draft=...) / "
                             "AIOS_TPU_DRAFT_MODEL)")
        self._check_spec(draft_len, SPEC_NGRAM)
        self._draft_catchup(draft_len + 1, eager)
        S, K = self.num_slots, draft_len
        with self._lock:
            if self.paged:
                self._back_active_slots(n_rounds * (K + 1))
                self._stage_tables()
            key = ("draft_spec", K)
            run = self._dispatcher(key, functools.partial(self._draft_round_body, K), eager)
            dtok = None
            if self._devprof is not None:
                # the serving model's verify rows (the draft's steps are not
                # charged)
                dtok = self._devprof_note("draft_spec", key, self.devprof_cost(
                    "draft_spec", key, lens=self._active_lens(), n=n_rounds))
            # tokens, counts and proposed [R, S, K+3], then the draft lengths
            # after the last round: one readback
            out = torch.empty((n_rounds, S, K + 3), dtype=torch.int64, device=self.device)
            run = self._timed(run, dtok)
            for r in range(n_rounds):
                g, counts, proposed, self.last_logits = run()
                out[r, :, : K + 1] = g
                out[r, :, K + 1] = counts
                out[r, :, K + 2] = proposed
            flat = torch.cat([out.view(-1), self.draft_state["lengths"].long()])
            if dtok is not None:
                dtok.stop()
            self.decode_steps += n_rounds
            self.spec_rounds += n_rounds
            self.spec_proposer_rounds["draft"] += n_rounds
            active_rounds = n_rounds * int(self.active.sum())
            self.spec_slot_rounds += active_rounds
        flat = flat.cpu().numpy()
        if self._devprof is not None:
            self._devprof_sample(dtok)
        host = flat[: -S].reshape(n_rounds, S, K + 3)
        tokens, counts, proposed = host[:, :, : K + 1], host[:, :, K + 1], host[:, :, K + 2]
        with self._lock:
            emitted = int(counts[:, self.active].sum())
            self.spec_tokens += emitted
            self.spec_proposer_accepted["draft"] += max(emitted - active_rounds, 0)
            self.draft_proposed_tokens += int(proposed[:, self.active].sum())
            self._host_lengths = np.minimum(
                self._host_lengths + counts.sum(axis=0), self.max_context - 1)
            self._draft_host_lengths = flat[-S:].copy()
        return tokens, counts, proposed

    def _draft_ingest_buckets(self) -> Tuple[int, ...]:
        return tuple(b for b in DRAFT_INGEST_BUCKETS if b <= self.max_context) or \
            DRAFT_INGEST_BUCKETS[:1]

    def _draft_catchup(self, headroom: int, eager: bool) -> None:
        """Bulk-ingest history into the draft cache until every active
        greedy slot's draft gap fits the fused round's catch-up width
        (``headroom``): each dispatch advances every lagging slot by up to
        the smallest ``DRAFT_INGEST_BUCKETS`` width that covers the largest
        gap (the widest if none does), then reads the draft lengths back
        (the JAX ``_draft_catchup``). Dispatches all come from one thread,
        so the host mirrors cannot race the device state."""
        buckets = self._draft_ingest_buckets()
        while True:
            gaps = (self._host_lengths - self._draft_host_lengths)[
                self.active & self._host_greedy]
            gap_max = int(gaps.max()) if gaps.size else 0
            if gap_max <= headroom:
                return
            w = next((b for b in buckets if b >= gap_max), buckets[-1])
            with self._lock:
                key = ("draft_ingest", w)
                run = self._dispatcher(key, functools.partial(self._draft_ingest_body, w),
                                       eager, pool=self._draft_pool)
                dtok = None
                if self._devprof is not None:
                    dtok = self._devprof_note("draft_ingest", key)
                self._timed(run, dtok)()
                if dtok is not None:
                    dtok.stop()
                self.draft_ingest_dispatches += 1
                d_len = self.draft_state["lengths"].long()
            self._draft_host_lengths = d_len.cpu().numpy()
            if self._devprof is not None:
                self._devprof_sample(dtok)

    def release(self, slot: int) -> None:
        # the host mirrors change under the lock: a dispatch on the dispatch
        # worker advances the host lengths under it meanwhile
        with self._lock:
            self.active[slot] = False
            self._host_lengths[slot] = 0
            self._win_starts[slot] = 0  # the next occupant starts uncompressed
            self._draft_host_lengths[slot] = 0
            self._host_greedy[slot] = False
            if self.paged:
                self.allocator.free_slot(slot)
            self.lengths[slot] = 0
            self.active_dev[slot] = False
            if self.draft_state is not None:
                # the next occupant's draft rows rebuild from the history by
                # ingest: zeroing the length is the whole reset
                self.draft_state["lengths"][slot] = 0

    def slot_length(self, slot: int) -> int:
        return int(self._host_lengths[slot])

    @contextlib.contextmanager
    def quiesced(self):
        """Hold off this engine's dispatches for the block (its lock): the
        on-demand profiler starts and stops under it (``devprof``)."""
        with self._lock:
            yield

    def stats(self) -> Dict[str, float]:
        active = int(self.active.sum())
        out = {
            "decode_steps": self.decode_steps,
            "prefills": self.prefills,
            "prefill_chunks": self.prefill_chunks,
            "active_slots": active,
            "batch_occupancy": round(active / self.num_slots, 3) if self.num_slots else 0.0,
        }
        if self.paged:
            out.update(
                kv_pages_in_use=self.allocator.pages_in_use(),
                kv_pages_free=self.allocator.free_pages,
                kv_pages_trimmed=self.kv_pages_trimmed,
            )
        if self.kv_compress_armed:
            out["kv_compress_slots"] = self.kv_compress_slots
            out["kv_compress_pages_pruned"] = self.kv_pages_pruned
            out["kv_compress_resident_pages"] = self.compressed_resident_pages()
        if self.mega_dispatches:
            out["mega_dispatches"] = self.mega_dispatches
            # the ticks that ran (k a dispatch, <= K on an early exit)
            out["mega_ticks"] = self.mega_tick_total
        if self.prefix_index is not None:
            out.update(prefix_hits=self.prefix_index.hits,
                       prefix_misses=self.prefix_index.misses,
                       prefix_rows_reused=self.prefix_rows_reused)
        if self.host_store is not None:
            st = self.host_store
            out.update(prefix_rows_restored=self.prefix_rows_restored,
                       host_tier_bytes=st.bytes_resident,
                       host_tier_capacity_bytes=st.max_bytes,
                       host_tier_spills=st.spills,
                       host_tier_restores=st.restores,
                       host_tier_hits=st.hits,
                       host_tier_misses=st.misses,
                       host_tier_corrupt=st.corruptions,
                       host_tier_restore_s=round(self.host_restore_seconds, 3))
        # the JAX engine's compile accounting (xla_compiles), for graphs
        out.update(graph_captures=self.graphs.captures,
                   graph_capture_seconds=round(self.graphs.capture_seconds, 3),
                   graph_replays=self.graphs.replays)
        if self.spec_rounds:
            out["spec_rounds"] = self.spec_rounds
            # mean tokens emitted per slot per verify round (1.0 = nothing
            # accepted; draft_len+1 = every draft accepted)
            out["spec_tokens_per_round"] = round(
                self.spec_tokens / max(self.spec_slot_rounds, 1), 2)
            out["spec_accepted"] = max(self.spec_tokens - self.spec_slot_rounds, 0)
            for p in spec.SPEC_PROPOSERS:
                if self.spec_proposer_rounds[p]:
                    out[f"spec_{p}_rounds"] = self.spec_proposer_rounds[p]
                    out[f"spec_{p}_accepted"] = self.spec_proposer_accepted[p]
        if self.draft is not None:
            out["draft_ingest_dispatches"] = self.draft_ingest_dispatches
            out["draft_proposed_tokens"] = self.draft_proposed_tokens
            if self.draft_proposed_tokens:
                out["draft_acceptance"] = round(
                    self.spec_proposer_accepted["draft"] / self.draft_proposed_tokens, 3)
        if self.jump_dispatches:
            out["jump_dispatches"] = self.jump_dispatches
            out["jump_tokens"] = self.jump_tokens
        return out

    def warmup(self, prefill_chunk: Optional[int] = None, masked_step: bool = False) -> None:
        """On a CUDA engine, build and load the kernel library, then capture
        the decode step's graph (with ``mega_ticks`` also every power-of-two
        megagraph bucket up to ``mega_bucket(mega_ticks)``, as the JAX
        warmup compiles them) and, where the engine speculates, the round
        graph of spec_step's defaults (with a draft model also its fused
        round and every ingest width, ``capture_draft``), with ``masked_step`` the masked
        step's graph and, where ``jump_ahead_enabled``, the jump graph of
        each of ``JUMP_BUCKETS``, then the admission graphs at the
        batcher's ``prefill_chunk`` (None: ``prefill_chunk_default``, 0: no
        chunk graphs; ``capture_admission``): the twin of the JAX
        ``warmup``, which compiles every serving graph behind the readiness
        gate, so the first request waits for neither nvcc nor a capture
        (with the host tier, nor for the restore's pinned staging). A
        failed capture raises. The split workspace of the current stream,
        where the eager twins run, is reserved here as well, for the
        largest chunk planned. The CPU runs the bodies eagerly and captures
        nothing."""
        if self.device.type != "cuda":
            return
        t0 = time.perf_counter()
        ops.build_all()
        chunks = self.admission_plan(prefill_chunk)[1]
        with self._lock:
            self._workspace_chunk = max([self._workspace_chunk or 0]
                                        + [b for b, _ in chunks]) or None
            self._reserve_workspaces()
        self.capture_step()
        self.capture_decode_loop()
        self.capture_spec()
        self.capture_draft()
        if masked_step:  # json-mode deployments dispatch step_masked
            self.capture_masked()
            if jump_ahead_enabled(self.cfg):
                for k in JUMP_BUCKETS:
                    self.capture_jump(k)
        self.capture_admission(prefill_chunk)
        if self.host_store is not None:
            # the restore's pinned staging at a whole slot's pages, so that
            # no restore pays for pinning host memory
            self._restore_buffer(self.allocator.max_blocks * self.page_bytes()
                                 + 256 * len(self._pool_tensors()))
        log.info("%s: kernels and %d graphs (%d of admission, %d B of shared pool; %d of "
                 "the draft, %d B of ingest pool; %d megagraph buckets) ready in %.1fs",
                 self.cfg.name, self.graphs.captures, self.admission_graphs(),
                 self.admission_pool_bytes, self.draft_graphs(), self.draft_pool_bytes,
                 self.mega_graphs(), time.perf_counter() - t0)

    def close(self) -> None:
        """Drop graphs, weights and the cache now rather than at the next
        gc pass; first stop taking spills and let the spill worker drain
        (its queued copies hold device staging of their own, not the pool)
        and stop, then empty the host store. The dispatch worker finishes
        what it was given and stops."""
        if self._dispatch_pool is not None:
            self._dispatch_pool.shutdown(wait=True)
            self._dispatch_pool = None
        if self._spill_q is not None:
            self.prefix_index.spill = None
            self._spill_q.put(None)
            if self._spill_thread is not None:
                self._spill_thread.join(timeout=5)
            self._spill_thread = None
        if self.host_store is not None:
            self.host_store.clear()
        with self._lock:
            self.graphs.close()
            self._tick_graphs.clear()
            if self._tick_pool_refs:
                # the tick bodies' pool, now that no graph replays them
                mega_graph.release_pool(self.device, self._tick_pool, self._tick_pool_refs)
                self._tick_pool_refs = 0
            self.last_logits = None
            self.params = None
            self.k_pool = self.v_pool = None
            self.k_scales = self.v_scales = None
            self.history = None
            # the DraftModel's leaves may be shared with other replicas
            self.draft = None
            self.draft_state = None
            self._draft_params = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- convenience (tests, single-shot callers) ----------------------------

    def generate(
        self,
        token_ids: List[int],
        max_new_tokens: int = 32,
        temperature: float = 0.0,
        top_p: float = 1.0,
        stop_tokens: Tuple[int, ...] = (),
        slot: int = 0,
        chunk: int = 8,
        speculative: Union[bool, str] = False,
        draft_len: int = SPEC_DRAFT_LEN,
        ngram: int = SPEC_NGRAM,
    ) -> List[int]:
        """Single-request generation loop (the continuous batcher in
        ``batching.py`` is the serving path). ``speculative=True`` decodes
        through n-gram speculative rounds, ``speculative="draft"`` through
        the attached draft model's: identical greedy output in fewer
        dispatches; a sampling request takes one token per round."""
        first = self.prefill(slot, token_ids, temperature, top_p)
        out = [first]
        while len(out) < max_new_tokens and out[-1] not in stop_tokens:
            budget = min(chunk, max_new_tokens - len(out))
            room = self.max_context - 1 - self.slot_length(slot)
            if room <= 0:
                break
            if speculative:
                pre = self.slot_length(slot)  # before the dispatch moves it
                if speculative == "draft":
                    toks, counts, _ = self.spec_step_draft(min(budget, room),
                                                           draft_len=draft_len)
                else:
                    toks, counts = self.spec_step(min(budget, room), draft_len=draft_len,
                                                  ngram=ngram)
                new: List[int] = []
                for r in range(toks.shape[0]):
                    if pre >= self.max_context - 1:
                        # the slot saturated mid-dispatch: later rounds'
                        # cache writes collapse onto the last row, their
                        # tokens are indeterminate and must not be consumed
                        break
                    new.extend(int(t) for t in toks[r, slot, : counts[r, slot]])
                    pre += int(counts[r, slot])
            else:
                new = self.step(min(budget, room))[:, slot].tolist()
            for t in new:
                out.append(int(t))
                if t in stop_tokens:
                    break
            del out[max_new_tokens:]  # speculative overshoot
        self.release(slot)
        if stop_tokens:
            for i, t in enumerate(out):
                if t in stop_tokens:
                    return out[: i + 1]
        return out


class ChunkedPrefill:
    """Driver of one slot's incremental prefill (the JAX engine's
    ``ChunkedPrefill``). Each ``step()`` runs one chunk under the engine
    lock (on CUDA one replay of the chunk's graph, or the eager body when
    ``eager``, the plain twin the serving path never takes); between calls
    the owner may run ``engine.step`` for the other slots. A mid chunk
    reads nothing back: the host returns once its dispatch is queued. While
    chunks are in flight the slot stays inactive, so the decode dispatches
    in between write its (ignored) K/V to the sacrificial page or the dense
    cache's last row and never touch the rows already admitted. The final
    chunk, at ``bucket_for`` of the rows left, samples the first token,
    activates the slot and publishes its prefix blocks."""

    def __init__(self, engine: TorchEngine, slot: int, token_ids: List[int],
                 temperature: float, top_p: float, chunk: int, start_pos: int = 0,
                 hashes=(), eager: bool = False) -> None:
        ids = list(token_ids)[-(engine.max_context - 1):]
        if not ids:
            raise ValueError("empty prompt")
        self.engine = engine
        self.slot = slot
        self.ids = ids
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self.chunk = int(chunk)
        self.pos = int(start_pos)  # rows already in the cache (a matched prefix)
        self.hashes = list(hashes)  # block hashes to publish when done
        self.eager = eager
        self.first_token: Optional[int] = None
        # a copy of the final chunk's logits row the first token was sampled
        # from (the engine's static row is the next admission's)
        self.first_logits: Optional[torch.Tensor] = None
        self.dtok = None  # the final chunk's devprof timing, if sampled

    @property
    def done(self) -> bool:
        return self.first_token is not None

    def step(self) -> Optional[int]:
        """Run the next chunk; returns the first sampled token once the
        prompt is admitted, else None. Over the pool the chunk's rows are
        backed first (a sliding-window model first returns the blocks no
        later chunk can see), so PoolExhausted leaves the admission as it
        was."""
        if self.done:
            return self.first_token
        eng = self.engine
        remaining = len(self.ids) - self.pos
        final = remaining <= self.chunk
        n = min(self.chunk, remaining)
        bucket = eng.bucket_for(n) if final else self.chunk
        with eng._lock:
            if eng.paged:
                window = eng.cfg.sliding_window
                if window is not None:
                    eng.kv_pages_trimmed += eng.allocator.trim_below_window(
                        self.slot, self.pos, window)
                # an armed engine prunes the same way once the admitted rows
                # pass the threshold: the peak is sink + window + a chunk
                eng._maybe_compress(self.slot, length=self.pos)
                eng.allocator.ensure(self.slot, self.pos + n)
            eng._chunk_forward(self, n, bucket, final)
            if final:
                self.first_token = eng._admitted(self.slot, len(self.ids), self.temperature)
                self.first_logits = eng._adm_logits.clone()
                eng._register_prefix(self.slot, self.ids, self.hashes)
        self.pos += n
        if final and eng._devprof is not None:
            eng._devprof_sample(self.dtok)
        return self.first_token
