"""The decode engine: paged KV pool, bucketed whole-prompt prefill, batched
decode with on-device sampling.

``TorchEngine`` is the counterpart of ``aios_tpu``'s ``TPUEngine`` on its
paged path. Weights, the page pool and all per-slot decode state (lengths,
last tokens, temperatures, top_p, active mask, the sampling generator) live
on the device; a decode dispatch moves only the page table in and the sampled
tokens out.

A slot's life: ``prefill(slot, prompt)`` writes K/V rows [0, len) and samples
the first token, ``step(n)`` extends every active slot by n tokens,
``release(slot)`` returns its pages. Inactive slots decode garbage against
the sacrificial page; their outputs are ignored. A sliding-window model
returns each slot's pages below the window to the pool before a dispatch.

Weights serve as int8 (``quantize="int8"``) or group-wise int4
(``quantize="int4"``); the pool is bf16, or int8 (``cache_dtype=torch.int8``)
with [L, N, P, KH] f32 scale pools beside it, rows quantizing on write.

Not here yet (later slices of the port): the prefix cache and host tier,
chunked admission, speculation and jump-ahead, the multi-tick megagraph,
window+sink KV compression, sharding and the pipelined ``step_async``.
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
from . import model, paged, sampling
from .config import ModelConfig

log = logging.getLogger("aios.torch.engine")

DEFAULT_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class TorchEngine:
    """Single-model decode engine over a fixed set of batch slots and a
    paged KV pool of ``paged_pool_rows`` rows in pages of ``page_size``."""

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        paged_pool_rows: int,
        page_size: int = 128,
        num_slots: int = 8,
        max_context: Optional[int] = None,
        cache_dtype: torch.dtype = torch.bfloat16,
        quantize: Optional[str] = None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        self.device = resolve_device(device)
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_context = int(max_context or cfg.max_context)
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
        self.k_pool, self.v_pool = model.init_kv_cache(
            cfg, num_pages, page_size, cache_dtype, self.device
        )
        self.quant_cache = cache_dtype == torch.int8
        self.k_scales = self.v_scales = None
        if self.quant_cache:
            self.k_scales, self.v_scales = model.init_kv_scales(
                cfg, num_pages, page_size, self.device
            )
        dev = self.device
        self.lengths = torch.zeros(num_slots, dtype=torch.int32, device=dev)
        self.last_tokens = torch.zeros(num_slots, dtype=torch.int64, device=dev)
        self.temps = torch.zeros(num_slots, dtype=torch.float32, device=dev)
        self.top_ps = torch.ones(num_slots, dtype=torch.float32, device=dev)
        self.active_dev = torch.zeros(num_slots, dtype=torch.bool, device=dev)
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(0)
        # host mirrors for the scheduler
        self.active = np.zeros(num_slots, dtype=bool)
        self._host_lengths = np.zeros(num_slots, dtype=np.int64)
        self.decode_steps = 0
        self.prefills = 0
        self.kv_pages_trimmed = 0

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
        straight into the page pool in place; rows of the bucket's padding
        land on the sacrificial page or past the prompt and are never read.
        Raises PoolExhausted before touching any state when the pool cannot
        back the prompt."""
        if not 0 <= slot < self.num_slots:
            raise ValueError(f"slot {slot} out of range")
        token_ids = list(token_ids)[-(self.max_context - 1):]
        true_len = len(token_ids)
        if true_len == 0:
            raise ValueError("empty prompt")
        bucket = self.bucket_for(true_len)
        padded = torch.zeros((1, bucket), dtype=torch.int64)
        padded[0, :true_len] = torch.tensor(token_ids, dtype=torch.int64)
        P = self.allocator.page_size
        with self._lock:
            self.allocator.ensure(slot, true_len)
            dev = self.device
            logits, ks, vs = model.prefill(self.params, self.cfg, padded.to(dev))
            nb = -(-bucket // P)
            pages = np.repeat(self.allocator.tables[slot, :nb], P)[:bucket]
            pages = torch.from_numpy(pages.astype(np.int64)).to(dev)
            offs = torch.arange(bucket, device=dev) % P
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

    def step(self, n_steps: int = 1) -> np.ndarray:
        """Run ``n_steps`` batched decode steps; returns tokens
        [n_steps, num_slots] (only active columns mean anything). Lengths
        advance for every slot, clamped at the cache end. One host readback
        per call."""
        with self._lock:
            self._back_active_slots(n_steps)
            tables = torch.from_numpy(self.allocator.tables).to(self.device)
            out = torch.empty((n_steps, self.num_slots), dtype=torch.int64,
                              device=self.device)
            for i in range(n_steps):
                logits = model.decode_step_paged(
                    self.params, self.cfg, self.last_tokens, self.lengths,
                    self.k_pool, self.v_pool, tables, active=self.active_dev,
                    cache_scales=(
                        (self.k_scales, self.v_scales) if self.quant_cache else None
                    ),
                )
                nxt = sampling.sample(logits, self.generator, self.temps, self.top_ps)
                out[i] = nxt
                self.last_tokens = nxt
                self.lengths = torch.clamp(self.lengths + 1, max=self.max_context - 1)
            self.decode_steps += n_steps
            self._host_lengths = np.minimum(
                self._host_lengths + n_steps, self.max_context - 1
            )
        return out.cpu().numpy()

    def release(self, slot: int) -> None:
        self.active[slot] = False
        self._host_lengths[slot] = 0
        with self._lock:
            self.allocator.free_slot(slot)
            self.lengths[slot] = 0
            self.active_dev[slot] = False

    def slot_length(self, slot: int) -> int:
        return int(self._host_lengths[slot])

    def stats(self) -> Dict[str, float]:
        active = int(self.active.sum())
        return {
            "decode_steps": self.decode_steps,
            "prefills": self.prefills,
            "active_slots": active,
            "batch_occupancy": round(active / self.num_slots, 3) if self.num_slots else 0.0,
            "kv_pages_in_use": self.allocator.pages_in_use(),
            "kv_pages_free": self.allocator.free_pages,
            "kv_pages_trimmed": self.kv_pages_trimmed,
        }

    def warmup(self) -> None:
        """Build and load the kernel library on CUDA engines, so the first
        request never waits for nvcc."""
        if self.device.type == "cuda":
            t0 = time.perf_counter()
            ops.build_all()
            log.info("%s: kernels ready in %.1fs", self.cfg.name, time.perf_counter() - t0)

    def close(self) -> None:
        """Drop weights and the pool now rather than at the next gc pass."""
        with self._lock:
            self.params = None
            self.k_pool = self.v_pool = None
            self.k_scales = self.v_scales = None
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
    ) -> List[int]:
        """Single-request generation loop (the continuous batcher in
        ``batching.py`` is the serving path)."""
        first = self.prefill(slot, token_ids, temperature, top_p)
        out = [first]
        while len(out) < max_new_tokens and out[-1] not in stop_tokens:
            budget = min(chunk, max_new_tokens - len(out))
            room = self.max_context - 1 - self.slot_length(slot)
            if room <= 0:
                break
            for t in self.step(min(budget, room))[:, slot].tolist():
                out.append(int(t))
                if t in stop_tokens:
                    break
        self.release(slot)
        if stop_tokens:
            for i, t in enumerate(out):
                if t in stop_tokens:
                    return out[: i + 1]
        return out
