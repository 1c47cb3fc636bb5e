"""The decode engine: paged KV pool or dense slot cache, bucketed whole-prompt
prefill, batched decode with on-device sampling, n-gram speculation.

``TorchEngine`` is the counterpart of ``aios_tpu``'s ``TPUEngine``. Weights,
the KV cache and all per-slot decode state (lengths, last tokens,
temperatures, top_p, active mask, token history, the sampling generator) live
on the device; a decode dispatch moves only the page table in (paged) and the
sampled tokens out.

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

import gc
import logging
import threading
import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import ops
from ..device import resolve_device
from . import model, paged, sampling, spec
from .config import ModelConfig

log = logging.getLogger("aios.torch.engine")

DEFAULT_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)


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
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(0)
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

    def step(self, n_steps: int = 1) -> np.ndarray:
        """Run ``n_steps`` batched decode steps; returns tokens
        [n_steps, num_slots] (only active columns mean anything). Lengths
        advance for every slot, clamped at the cache end. One host readback
        per call."""
        with self._lock:
            if self.paged:
                self._back_active_slots(n_steps)
                tables = torch.from_numpy(self.allocator.tables).to(self.device)
            out = torch.empty((n_steps, self.num_slots), dtype=torch.int64,
                              device=self.device)
            slots = torch.arange(self.num_slots, device=self.device)
            for i in range(n_steps):
                if self.paged:
                    logits = model.decode_step_paged(
                        self.params, self.cfg, self.last_tokens, self.lengths,
                        self.k_pool, self.v_pool, tables, active=self.active_dev,
                        cache_scales=self._cache_scales(),
                    )
                else:
                    logits = model.decode_step(
                        self.params, self.cfg, self.last_tokens, self.lengths,
                        self.k_pool, self.v_pool, active=self.active_dev,
                        cache_scales=self._cache_scales(),
                    )
                nxt = sampling.sample(logits, self.generator, self.temps, self.top_ps)
                out[i] = nxt
                if self.track_history:
                    # the new token's column is lengths+1 (<= C, inside the
                    # pad); inactive slots write the sacrificial last column
                    hcol = torch.where(
                        self.active_dev, self.lengths.long() + 1,
                        torch.full_like(slots, self.history.shape[1] - 1))
                    self.history[slots, hcol] = nxt
                self.last_tokens = nxt
                self.lengths = torch.clamp(self.lengths + 1, max=self.max_context - 1)
            self.decode_steps += n_steps
            self._host_lengths = np.minimum(
                self._host_lengths + n_steps, self.max_context - 1
            )
        return out.cpu().numpy()

    def spec_step(self, n_rounds: int = 8, draft_len: int = 7,
                  ngram: int = 3) -> Tuple[np.ndarray, np.ndarray]:
        """Run ``n_rounds`` speculative decode rounds over the dense cache.

        Returns (tokens [n_rounds, num_slots, draft_len+1], counts
        [n_rounds, num_slots]): in round r, slot s emitted the first
        ``counts[r, s]`` entries of ``tokens[r, s]`` — at least 1 (a plain
        decode step's token), up to ``draft_len+1`` when the whole n-gram
        draft was accepted. Greedy slots emit exactly the plain-greedy
        sequence; temp > 0 slots never speculate and emit one sampled token
        per round. Only columns where ``self.active`` are meaningful. Each
        round draws from the generator once, like a decode step; one host
        readback per call."""
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
        S, C, K = self.num_slots, self.max_context, draft_len
        dev = self.device
        with self._lock:
            # tokens [R, S, K+1] and, in the last column, counts: one readback
            out = torch.empty((n_rounds, S, K + 2), dtype=torch.int64, device=dev)
            slots = torch.arange(S, device=dev)[:, None]
            steps = torch.arange(K + 1, device=dev)[None, :]
            pad_col = self.history.shape[1] - 1
            for r in range(n_rounds):
                drafts, _ = spec.propose_ngram(self.history, self.lengths, K, ngram, C)
                # only greedy, active slots speculate; everyone else verifies
                # a row of -1 drafts (accept count 0: a plain decode step)
                ok = (self.temps < sampling.GREEDY_EPS) & self.active_dev
                drafts = torch.where(ok[:, None], drafts, torch.full_like(drafts, -1))
                feed = torch.cat([self.last_tokens[:, None], drafts], dim=1)
                logits = model.verify_step(
                    self.params, self.cfg, feed, self.lengths, self.k_pool,
                    self.v_pool, active=self.active_dev,
                    cache_scales=self._cache_scales(),
                )
                g = logits.argmax(dim=-1)  # [S, K+1]
                a = spec.accept_counts(drafts, g)  # [S] in [0, K]
                # row 0 is a plain decode step's logits; sample() takes the
                # argmax for greedy rows, so this covers both kinds of slot
                g[:, 0] = sampling.sample(logits[:, 0], self.generator, self.temps,
                                          self.top_ps)
                counts = a + 1  # tokens emitted this round per slot
                # accepted tokens land at history columns lengths+1 ..
                # lengths+1+K, inside the HISTORY_PAD margin: no clamp and no
                # colliding writes for active slots
                hidx = torch.where(self.active_dev[:, None],
                                   self.lengths.long()[:, None] + 1 + steps,
                                   torch.full_like(steps, pad_col))
                self.history[slots, hidx] = g
                self.last_tokens = g.gather(1, a[:, None])[:, 0]
                self.lengths = torch.clamp(self.lengths + counts, max=C - 1).to(torch.int32)
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
        if self.spec_rounds:
            out["spec_rounds"] = self.spec_rounds
            # mean tokens emitted per slot per verify round (1.0 = nothing
            # accepted; draft_len+1 = every draft accepted)
            out["spec_tokens_per_round"] = round(
                self.spec_tokens / max(self.spec_slot_rounds, 1), 2)
            out["spec_accepted"] = max(self.spec_tokens - self.spec_slot_rounds, 0)
        return out

    def warmup(self) -> None:
        """Build and load the kernel library on CUDA engines, so the first
        request never waits for nvcc."""
        if self.device.type == "cuda":
            t0 = time.perf_counter()
            ops.build_all()
            log.info("%s: kernels ready in %.1fs", self.cfg.name, time.perf_counter() - t0)

    def close(self) -> None:
        """Drop weights and the cache now rather than at the next gc pass."""
        with self._lock:
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
        draft_len: int = 7,
        ngram: int = 3,
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
