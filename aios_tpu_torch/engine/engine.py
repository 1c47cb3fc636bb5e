"""The decode engine: paged KV pool or dense slot cache, bucketed whole-prompt
prefill, batched decode with on-device sampling, n-gram speculation.

``TorchEngine`` is the counterpart of ``aios_tpu``'s ``TPUEngine``. Weights,
the KV cache and all per-slot decode state (lengths, last tokens,
temperatures, top_p, active mask, token history, the device page table, the
sampling generator) live on the device in buffers that keep their storage
for the engine's life; a decode dispatch moves only the page table in
(paged) and the sampled tokens out.

On a CUDA engine every decode dispatch replays a CUDA graph (``graphs.py``),
as the JAX engine dispatches compiled executables: ``warmup`` captures the
decode step of the engine's cache and, where it speculates, the round of
``spec_step``'s defaults; a (draft_len, ngram) not warmed is captured at
first use, and counted. ``step(n)`` and ``spec_step(n)`` replay the one-step
or one-round graph n times and read back once. On the CPU they run the same
bodies eagerly; on the card ``step_eager`` and ``spec_step_eager`` do, like
a kernel's plain twin, by name only.

The cache is a shared page pool of ``paged_pool_rows`` rows, or, with
``paged_pool_rows=None``, a dense slot cache [L, S, C, KH, D] in which slot s
owns rows [0, C) of its own. A slot's life: ``prefill(slot, prompt)`` writes
K/V rows [0, len) and samples the first token, ``step(n)`` extends every
active slot by n tokens, ``release(slot)`` frees it (and returns its pages).
Inactive slots decode garbage against the sacrificial page, or the dense
cache's last row; their outputs are ignored. Over the pool a sliding-window
model returns each slot's pages below the window before a dispatch.

``spec_step(n_rounds, draft_len, ngram)`` runs speculative rounds over the
dense cache: propose drafts from the device token history (``spec.py``),
verify them in one multi-token forward, accept the longest matching prefix.

Weights serve as int8 (``quantize="int8"``) or group-wise int4
(``quantize="int4"``); the cache is bf16, or int8 (``cache_dtype=torch.int8``)
with f32 scales beside it ([L, N, P, KH] or [L, S, C, KH]), rows quantizing
on write.

Not here yet (later slices of the port): the prefix cache and host tier,
chunked admission, speculation over the page pool (``verify_step_paged``),
the draft-model proposer, jump-ahead and masked steps, the multi-tick
megagraph, window+sink KV compression, sharding and the pipelined
``step_async``.
"""

from __future__ import annotations

import functools
import gc
import logging
import threading
import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import ops
from ..device import resolve_device
from ..ops import split
from ..ops.quantized_matmul import counters_for, sm_count
from . import model, paged, sampling, spec
from .config import ModelConfig
from .graphs import GraphSet

log = logging.getLogger("aios.torch.engine")

DEFAULT_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)
# spec_step's defaults, and the round graph warmup captures
SPEC_DRAFT_LEN = 7
SPEC_NGRAM = 3


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class TorchEngine:
    """Single-model decode engine over a fixed set of batch slots and a
    paged KV pool of ``paged_pool_rows`` rows in pages of ``page_size``, or
    (``paged_pool_rows=None``) a dense cache of ``max_context`` rows per
    slot. ``track_history`` keeps the device token history that the n-gram
    proposer of ``spec_step`` reads."""

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
    ) -> None:
        self.device = resolve_device(device)
        self.cfg = cfg
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
        self._lock = threading.Lock()
        if quantize not in (None, False, "int8", "int4"):
            raise ValueError(f"unsupported quantize mode {quantize!r}")
        params = _to_device(params, self.device)
        if model.is_quantized(params):
            self.quantized = True
        elif quantize:
            params = model.quantize_params(params, mode=quantize)
            self.quantized = True
        else:
            self.quantized = False
        self.params = params

        self.paged = paged_pool_rows is not None
        # speculation verifies over the dense cache only: the paged verify
        # forward (verify_step_paged) is not ported
        self.spec_supported = not self.paged
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
        # the device page table: the allocator's host tables, copied in
        # before each dispatch
        self.tables_dev = (torch.zeros(self.allocator.tables.shape, dtype=torch.int32,
                                       device=dev) if self.paged else None)
        self._slot_ids = torch.arange(num_slots, device=dev)
        self._columns = torch.arange(spec.HISTORY_PAD, device=dev)
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(0)
        self.graphs = GraphSet(dev, self.generator)
        # logits of the last step or round dispatched (on CUDA a graph's
        # static output, overwritten by its next replay)
        self.last_logits: Optional[torch.Tensor] = None
        # host mirrors for the scheduler
        self.active = np.zeros(num_slots, dtype=bool)
        self._host_lengths = np.zeros(num_slots, dtype=np.int64)
        self.decode_steps = 0
        self.prefills = 0
        self.kv_pages_trimmed = 0
        self.spec_rounds = 0
        self.spec_tokens = 0
        self.spec_slot_rounds = 0  # (round, active slot) pairs

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
        """Fill ``slot`` with a prompt in one whole-prompt pass at its bucket
        and return the first generated token. The K/V rows are written
        straight into the page pool, or into rows [0, bucket) of the slot's
        dense cache, in place; rows of the bucket's padding land on the
        sacrificial page or past the prompt and are never read. Raises
        PoolExhausted before touching any state when the pool cannot back
        the prompt."""
        if not 0 <= slot < self.num_slots:
            raise ValueError(f"slot {slot} out of range")
        token_ids = list(token_ids)[-(self.max_context - 1):]
        true_len = len(token_ids)
        if true_len == 0:
            raise ValueError("empty prompt")
        bucket = self.bucket_for(true_len)
        padded = torch.zeros((1, bucket), dtype=torch.int64)
        padded[0, :true_len] = torch.tensor(token_ids, dtype=torch.int64)
        with self._lock:
            dev = self.device
            if self.paged:
                self.allocator.ensure(slot, true_len)
                P = self.allocator.page_size
                nb = -(-bucket // P)
                pages = np.repeat(self.allocator.tables[slot, :nb], P)[:bucket]
                pages = torch.from_numpy(pages.astype(np.int64)).to(dev)
                offs = torch.arange(bucket, device=dev) % P
            else:  # (slot, rows [0, bucket)) of the dense cache
                pages, offs = slot, slice(0, bucket)
            padded = padded.to(dev)
            logits, ks, vs = model.prefill(self.params, self.cfg, padded)
            if self.quant_cache:
                kq, k_s = model.quantize_kv(ks[:, 0])  # [L, T, KH, D], [L, T, KH]
                vq, v_s = model.quantize_kv(vs[:, 0])
                self.k_pool[:, pages, offs] = kq
                self.v_pool[:, pages, offs] = vq
                self.k_scales[:, pages, offs] = k_s
                self.v_scales[:, pages, offs] = v_s
            else:
                self.k_pool[:, pages, offs] = ks[:, 0].to(self.k_pool.dtype)
                self.v_pool[:, pages, offs] = vs[:, 0].to(self.v_pool.dtype)
            temp = torch.tensor([temperature], dtype=torch.float32, device=dev)
            tp = torch.tensor([top_p], dtype=torch.float32, device=dev)
            first = sampling.sample(logits[0, true_len - 1][None], self.generator, temp, tp)
            if self.track_history:
                # the whole padded bucket, then the first token over the
                # padding's first column
                self.history[slot, :bucket] = padded[0]
                self.history[slot, true_len] = first[0]
            self.lengths[slot] = true_len
            self.last_tokens[slot] = first[0]
            self.temps[slot] = temp[0]
            self.top_ps[slot] = tp[0]
            self.active_dev[slot] = True
            self.active[slot] = True
            self._host_lengths[slot] = true_len
            self.prefills += 1
            first_token = int(first[0])
        return first_token

    # -- decode -----------------------------------------------------------------

    def _back_active_slots(self, grow_rows: int) -> None:
        """Back every active slot's next ``grow_rows`` rows BEFORE a
        dispatch, so PoolExhausted surfaces with state untouched and the
        batcher can retire a victim and retry; a windowed model first
        returns the pages attention can no longer reach. Caller holds the
        lock."""
        window = self.cfg.sliding_window
        for s in range(self.num_slots):
            if self.active[s]:
                if window is not None:
                    self.kv_pages_trimmed += self.allocator.trim_below_window(
                        s, int(self._host_lengths[s]), window
                    )
                self.allocator.ensure(
                    s, min(int(self._host_lengths[s]) + grow_rows, self.max_context)
                )

    def _cache_scales(self):
        return (self.k_scales, self.v_scales) if self.quant_cache else None

    def _step_body(self) -> torch.Tensor:
        """One decode step of every slot on the static state, in place:
        each slot's new K/V row, the sampled token into ``last_tokens`` and
        the history, ``lengths`` + 1 (clamped at the cache end, inactive
        slots too). Returns the step's logits [S, V]. What the eager loop
        runs and a CUDA graph captures: it reads nothing back and branches
        on no tensor."""
        if self.paged:
            logits = model.decode_step_paged(
                self.params, self.cfg, self.last_tokens, self.lengths,
                self.k_pool, self.v_pool, self.tables_dev, active=self.active_dev,
                cache_scales=self._cache_scales(),
            )
        else:
            logits = model.decode_step(
                self.params, self.cfg, self.last_tokens, self.lengths,
                self.k_pool, self.v_pool, active=self.active_dev,
                cache_scales=self._cache_scales(),
            )
        sampling.sample(logits, self.generator, self.temps, self.top_ps,
                        out=self.last_tokens)
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
        drafts, _ = spec.propose_ngram(self.history, self.lengths, K, ngram, C)
        # only greedy, active slots speculate; everyone else verifies a row
        # of -1 drafts (accept count 0: a plain decode step)
        ok = (self.temps < sampling.GREEDY_EPS) & self.active_dev
        drafts = torch.where(ok[:, None], drafts, torch.full_like(drafts, -1))
        feed = torch.cat([self.last_tokens[:, None], drafts], dim=1)
        logits = model.verify_step(
            self.params, self.cfg, feed, self.lengths, self.k_pool, self.v_pool,
            active=self.active_dev, cache_scales=self._cache_scales(),
        )
        g = logits.argmax(dim=-1)  # [S, K+1]
        a = spec.accept_counts(drafts, g)  # [S] in [0, K]
        # row 0 is a plain decode step's logits; sample() takes the argmax
        # for greedy rows, so this covers both kinds of slot
        g[:, 0] = sampling.sample(logits[:, 0], self.generator, self.temps, self.top_ps)
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
        return g, counts, logits

    def _dispatcher(self, key, body, eager: bool):
        """What runs one step or round: ``body`` itself on the CPU or when
        ``eager``, else the replay of its graph, captured now (and counted)
        if warmup did not. Caller holds the lock."""
        if eager or not self.graphs.enabled:
            return body
        if key not in self.graphs:
            self._capture(key, body)
        return lambda: self.graphs.replay(key)

    def _capture(self, key, body) -> None:
        """Capture ``body`` as graph ``key`` and leave the engine's state as
        it was: the capture runs nothing, and the eager pass before it runs
        with every slot inactive (writing only the sacrificial page or each
        dense slot's last row, and the history's sacrificial column), then
        puts back the lengths, last tokens and active mask it moved.
        Caller holds the lock."""
        def prepare() -> None:
            self._reserve_workspaces()
            state = (self.lengths, self.last_tokens, self.active_dev)
            saved = [t.clone() for t in state]
            self.active_dev.zero_()
            body()
            for t, was in zip(state, saved):
                t.copy_(was)

        t0 = time.perf_counter()
        graph = self.graphs.capture(key, body, prepare)
        log.info("%s: captured the %s graph (%d kernel launches) in %.2fs", self.cfg.name,
                 key, sum(graph.launches.values()), time.perf_counter() - t0)

    def _reserve_workspaces(self) -> None:
        """Make the current stream's split workspace at the largest launch
        any graph of this engine can make (single-query attention over the
        whole context; with speculation, the verify attention of the
        longest draft spec_step takes) and its split-K ticket counters,
        before a capture holds their addresses."""
        dev, cfg = self.device, self.cfg
        stream = torch.cuda.current_stream(dev).cuda_stream
        B, KH, D = self.num_slots, cfg.num_kv_heads, cfg.head_dim
        splits = split.split_plan(self.max_context, B, KH, sm_count(dev.index))
        query_rows = [0]
        if self.spec_supported and self.track_history:
            query_rows.append((spec.HISTORY_PAD - 1) * (cfg.num_heads // KH))
        for rows in query_rows:
            groups, partial_rows = split.launch_groups(B, KH, rows)
            split.workspace(dev, stream, groups, splits, D, partial_rows)
        counters_for(dev, stream)

    def capture_step(self) -> None:
        """Ensure the decode step's graph exists without dispatching (the
        twin of the JAX ``compile_step_fn``); nothing to do off CUDA."""
        if self.graphs.enabled:
            with self._lock:
                self._dispatcher("step", self._step_body, eager=False)

    def capture_spec(self, draft_len: int = SPEC_DRAFT_LEN, ngram: int = SPEC_NGRAM) -> None:
        """Ensure the round graph for (draft_len, ngram) exists without
        dispatching (the twin of the JAX ``compile_spec_fn``); nothing to do
        off CUDA or on an engine that cannot speculate."""
        if not (self.graphs.enabled and self.spec_supported and self.track_history):
            return
        self._check_spec(draft_len, ngram)
        with self._lock:
            self._dispatcher(("spec", draft_len, ngram),
                             functools.partial(self._round_body, draft_len, ngram),
                             eager=False)

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

    def _steps(self, n_steps: int, eager: bool) -> np.ndarray:
        with self._lock:
            if self.paged:
                self._back_active_slots(n_steps)
                self.tables_dev.copy_(torch.from_numpy(self.allocator.tables))
            run = self._dispatcher("step", self._step_body, eager)
            out = torch.empty((n_steps, self.num_slots), dtype=torch.int64,
                              device=self.device)
            for i in range(n_steps):
                self.last_logits = run()
                out[i] = self.last_tokens
            self.decode_steps += n_steps
            self._host_lengths = np.minimum(
                self._host_lengths + n_steps, self.max_context - 1
            )
        return out.cpu().numpy()

    def _check_spec(self, draft_len: int, ngram: int) -> None:
        # the upper bound keeps active slots' history writes strictly below
        # the sacrificial last pad column reserved for inactive slots
        if not 1 <= draft_len <= spec.HISTORY_PAD - 2:
            raise ValueError(f"draft_len must be in [1, {spec.HISTORY_PAD - 2}]")
        if ngram < 1:
            raise ValueError("ngram must be >= 1")
        if not self.spec_supported:
            raise ValueError(
                "speculative decoding is unsupported over the paged pool "
                "(verify_step_paged is not ported); serve the dense cache, "
                "paged_pool_rows=None"
            )
        if not self.track_history:
            raise ValueError(
                "speculative decoding needs the token history "
                "(track_history=True; the n-gram proposer reads it)"
            )

    def spec_step(self, n_rounds: int = 8, draft_len: int = SPEC_DRAFT_LEN,
                  ngram: int = SPEC_NGRAM) -> Tuple[np.ndarray, np.ndarray]:
        """Run ``n_rounds`` speculative decode rounds over the dense cache.

        Returns (tokens [n_rounds, num_slots, draft_len+1], counts
        [n_rounds, num_slots]): in round r, slot s emitted the first
        ``counts[r, s]`` entries of ``tokens[r, s]`` — at least 1 (a plain
        decode step's token), up to ``draft_len+1`` when the whole n-gram
        draft was accepted. Greedy slots emit exactly the plain-greedy
        sequence; temp > 0 slots never speculate and emit one sampled token
        per round. Only columns where ``self.active`` are meaningful. Each
        round draws from the generator once, like a decode step; one host
        readback per call. On CUDA each round is one replay of the round
        graph of (draft_len, ngram)."""
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
            run = self._dispatcher(("spec", draft_len, ngram),
                                   functools.partial(self._round_body, draft_len, ngram),
                                   eager)
            # tokens [R, S, K+1] and, in the last column, counts: one readback
            out = torch.empty((n_rounds, S, K + 2), dtype=torch.int64, device=self.device)
            for r in range(n_rounds):
                g, counts, self.last_logits = run()
                out[r, :, : K + 1] = g
                out[r, :, K + 1] = counts
            self.decode_steps += n_rounds
            self.spec_rounds += n_rounds
            # acceptance denominator: (round, active slot) pairs, a per-slot
            # rate that does not scale with batch occupancy
            self.spec_slot_rounds += n_rounds * int(self.active.sum())
        host = out.cpu().numpy()
        tokens, counts = host[:, :, : K + 1], host[:, :, K + 1]
        with self._lock:
            self.spec_tokens += int(counts[:, self.active].sum())
            self._host_lengths = np.minimum(
                self._host_lengths + counts.sum(axis=0), self.max_context - 1
            )
        return tokens, counts

    def release(self, slot: int) -> None:
        self.active[slot] = False
        self._host_lengths[slot] = 0
        with self._lock:
            if self.paged:
                self.allocator.free_slot(slot)
            self.lengths[slot] = 0
            self.active_dev[slot] = False

    def slot_length(self, slot: int) -> int:
        return int(self._host_lengths[slot])

    def stats(self) -> Dict[str, float]:
        active = int(self.active.sum())
        out = {
            "decode_steps": self.decode_steps,
            "prefills": self.prefills,
            "active_slots": active,
            "batch_occupancy": round(active / self.num_slots, 3) if self.num_slots else 0.0,
        }
        if self.paged:
            out.update(
                kv_pages_in_use=self.allocator.pages_in_use(),
                kv_pages_free=self.allocator.free_pages,
                kv_pages_trimmed=self.kv_pages_trimmed,
            )
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
        return out

    def warmup(self) -> None:
        """On a CUDA engine, build and load the kernel library, then capture
        the decode step's graph and, where the engine speculates, the round
        graph of spec_step's defaults: the twin of the JAX ``warmup``, which
        compiles every serving graph behind the readiness gate, so the first
        request waits for neither nvcc nor a capture. A failed capture
        raises. The CPU runs the bodies eagerly and captures nothing."""
        if self.device.type != "cuda":
            return
        t0 = time.perf_counter()
        ops.build_all()
        self.capture_step()
        self.capture_spec()
        log.info("%s: kernels and %d graphs ready in %.1fs", self.cfg.name,
                 self.graphs.captures, time.perf_counter() - t0)

    def close(self) -> None:
        """Drop graphs, weights and the cache now rather than at the next
        gc pass."""
        with self._lock:
            self.graphs.close()
            self.last_logits = None
            self.params = None
            self.k_pool = self.v_pool = None
            self.k_scales = self.v_scales = None
            self.history = None
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
        speculative: bool = False,
        draft_len: int = SPEC_DRAFT_LEN,
        ngram: int = SPEC_NGRAM,
    ) -> List[int]:
        """Single-request generation loop (the continuous batcher in
        ``batching.py`` is the serving path). ``speculative=True`` decodes
        through n-gram speculative rounds: identical greedy output in fewer
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
