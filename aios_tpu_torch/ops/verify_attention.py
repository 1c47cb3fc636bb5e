"""Ragged multi-query decode attention: T in-flight queries per slot.

The speculative verify step scores a slot's pending token plus its draft
tokens in one forward (``model.verify_step``). Its attention is T queries per
slot over that slot's dense cache with a causal staircase: query t of slot b
sits at row ``lengths[b] + t * strides[b]`` and sees the columns up to and
including its own row, inside the sliding window. ``strides`` is 1 for active
slots and 0 for inactive ones, which expose only column 0 to every query. On
CUDA tensors ``multiquery_decode_attention`` (bf16 cache, K6) and
``multiquery_decode_attention_int8`` (int8 cache with [B, C, KH] f32
scales, K7) run one hand-written tensor-core kernel of
``csrc/dense_attention.cu`` (``mq_attention_kernel``, templated on the cache
element): the T * H / KH query rows of a (slot, kv head) in 16-row tiles,
up to 64 rows a block, scored and summed with ``mma.sync`` over K/V chunks
copied asynchronously into shared memory, each slot's visible rows split by
``split_plan`` and merged in the same launch (``ops/split.py``). On CPU
tensors they run their ``*_reference``. With ``win_starts`` [B] int32 and
``sink`` (window+sink KV compression, the predicate K3 and K4 take) slot b
sees only the rows below ``sink`` or from ``win_starts[b]`` on: the
kernel's ``_sink`` entry points, whose pruned middle is never scored
(both bounds multiples of 32 rows, no window: the kernel skips a pruned
warp slice whole); without them the entries and launches are those of the
plain kernels. A
slot whose staircase runs past
the cache end (``lengths[b] + T - 1 >= C``) is saturated: the kernel clamps
its reads to the cache and its outputs are unconsumed by contract.

Arithmetic. Both enter q unscaled (it is bf16, so the product's operands
are exact) and take 1/sqrt(D) on the scores in f32 after the product; the
row sums take p unrounded. K6 rounds p to the cache dtype for P V, as the
TPU kernel does. K7 follows the TPU kernel's f32 int8 path: the int8 K and
V bytes are exact in bf16, the score is (q . k) * sm_scale * k_scale[row],
and the P V weight w = p * v_scale[row] enters as three bf16 terms (each
the bf16 of what the earlier ones left), which sum to w within f32's
rounding; its split holds a D = 128 share to at least
``split.MIN_SHARE_ROWS_D128`` rows, as K9's does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import build
from .decode_attention import NEG_INF, dequantize_cache, launch
from .split import SPLIT_ALIGN


def multiquery_decode_attention_reference(
    q: torch.Tensor,  # [B, T, H, D]
    k_cache: torch.Tensor,  # [B, C, KH, D]
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # [B] int32: query 0's own (just-written) row
    strides: torch.Tensor,  # [B] int32: 1 active, 0 inactive
    *,
    window: Optional[int] = None,
    win_starts: Optional[torch.Tensor] = None,  # [B] int32
    sink: Optional[int] = None,
) -> torch.Tensor:
    """Mask the whole cache per query and attend: the plain version of the
    kernel (the JAX package's ``multiquery_decode_attention_reference``,
    with the sink predicate of its ``verify_step_paged`` mask)."""
    B, T, H, D = q.shape
    C, KH = k_cache.shape[1], k_cache.shape[2]
    steps = torch.arange(T, device=q.device)[None, :]
    qpos = lengths.to(torch.int64)[:, None] + steps * strides.to(torch.int64)[:, None]
    cols = torch.arange(C, device=q.device)[None, None, :]
    mask = cols <= qpos[..., None]  # [B, T, C]
    if window is not None:
        mask = mask & (cols > qpos[..., None] - window)
    if win_starts is not None:
        mask = mask & ((cols < int(sink)) | (cols >= win_starts.to(torch.int64)[:, None, None]))
    qg = q.reshape(B, T, KH, H // KH, D)
    s = torch.einsum("btkgd,bckd->bkgtc", qg, k_cache).to(torch.float32)
    s = s / math.sqrt(D)
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgtc,bckd->btkgd", p, v_cache)
    return out.reshape(B, T, H, D)


def multiquery_decode_attention_int8_reference(
    q: torch.Tensor,  # [B, T, H, D]
    k_cache: torch.Tensor,  # [B, C, KH, D] int8
    v_cache: torch.Tensor,
    k_scales: torch.Tensor,  # [B, C, KH] f32
    v_scales: torch.Tensor,
    lengths: torch.Tensor,
    strides: torch.Tensor,
    *,
    window: Optional[int] = None,
    win_starts: Optional[torch.Tensor] = None,
    sink: Optional[int] = None,
) -> torch.Tensor:
    """Dequantize-then-attend in f32, the plain version of the int8 kernel
    (the JAX package's ``multiquery_decode_attention_int8_reference``); the
    output lands in ``q.dtype``."""
    out = multiquery_decode_attention_reference(
        q.to(torch.float32), dequantize_cache(k_cache, k_scales),
        dequantize_cache(v_cache, v_scales), lengths, strides, window=window,
        win_starts=win_starts, sink=sink,
    )
    return out.to(q.dtype)


def _sink_operands(win_starts: Optional[torch.Tensor], sink: Optional[int]) -> tuple:
    """(win_starts,) when the sink predicate applies, else ()."""
    if win_starts is None:
        return ()
    if sink is None:
        raise ValueError("win_starts needs a sink row count")
    return (win_starts,)


def _check_sink(extra: tuple, sink: Optional[int], window: Optional[int]) -> None:
    """The kernels' sink contract: the sink and every live-window start a
    multiple of SPLIT_ALIGN rows (whole pages of at least 32 rows; the
    starts, on the device, are the caller's to keep so) and no sliding
    window, so that each warp's slice is pruned whole or not at all."""
    if extra and (sink % SPLIT_ALIGN or window is not None):
        raise ValueError(f"the sink predicate takes a sink of a multiple of {SPLIT_ALIGN} "
                         f"rows and no window, got sink={sink} window={window}")


def multiquery_decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    strides: torch.Tensor,
    *,
    window: Optional[int] = None,
    win_starts: Optional[torch.Tensor] = None,
    sink: Optional[int] = None,
) -> torch.Tensor:
    """Ragged multi-query decode attention -> [B, T, H, D]; with
    ``win_starts`` and ``sink`` slot b sees only rows < sink or >=
    win_starts[b]. CPU operands take the reference; CUDA operands launch the
    kernel (bf16 q and caches, int32 lengths, strides and win_starts, D in
    {64, 128}, H/KH <= 8, any T and any cache length C), each slot's rows
    split by ``split_plan``, or raise."""
    extra = _sink_operands(win_starts, sink)
    dev = build.device_of(q, k_cache, v_cache, lengths, strides, *extra)
    if dev.type == "cpu":
        return multiquery_decode_attention_reference(
            q, k_cache, v_cache, lengths, strides, window=window,
            win_starts=win_starts, sink=sink)
    _check_sink(extra, sink, window)
    return launch(multiquery_decode_attention, "aios_multiquery_decode_attention"
                  + ("_sink" if extra else ""), q, k_cache, v_cache, (),
                  (lengths, strides, *extra), window, split=True,
                  sink=sink if extra else None)


multiquery_decode_attention.launches = 0


def multiquery_decode_attention_int8(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_scales: torch.Tensor,
    v_scales: torch.Tensor,
    lengths: torch.Tensor,
    strides: torch.Tensor,
    *,
    window: Optional[int] = None,
    win_starts: Optional[torch.Tensor] = None,
    sink: Optional[int] = None,
) -> torch.Tensor:
    """Ragged multi-query decode attention over an int8 cache with
    [B, C, KH] f32 scales folded into both products -> [B, T, H, D] in
    q.dtype; the sink predicate as ``multiquery_decode_attention``'s. CPU
    operands take the reference; CUDA operands launch the kernel (bf16 q,
    int8 caches, contiguous f32 scales, int32 lengths, strides and
    win_starts, D in {64, 128}, H/KH <= 8, any T and any cache length C),
    each slot's rows split by ``split_plan``, or raise."""
    extra = _sink_operands(win_starts, sink)
    dev = build.device_of(q, k_cache, v_cache, k_scales, v_scales, lengths, strides, *extra)
    if dev.type == "cpu":
        return multiquery_decode_attention_int8_reference(
            q, k_cache, v_cache, k_scales, v_scales, lengths, strides, window=window,
            win_starts=win_starts, sink=sink)
    _check_sink(extra, sink, window)
    return launch(multiquery_decode_attention_int8, "aios_multiquery_decode_attention_int8"
                  + ("_sink" if extra else ""), q, k_cache, v_cache, (k_scales, v_scales),
                  (lengths, strides, *extra), window, split=True,
                  sink=sink if extra else None)


multiquery_decode_attention_int8.launches = 0
