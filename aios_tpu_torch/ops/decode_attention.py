"""Ragged decode attention over the dense slot cache: one query per slot.

The decode step attends one new query per slot against rows [0, lengths[b]]
of that slot's [C, KH, D] cache (row ``lengths[b]`` is the token just
written), inside the sliding window when the model has one. On CUDA tensors
this runs the hand-written kernel ``csrc/dense_attention.cu``, which reads
only the rows the mask exposes and splits each slot's visible rows over
several blocks (``ops/split.py``), merged in the same launch; on CPU tensors
``decode_attention_reference``, which masks the whole cache.
``decode_attention_int8`` is the same over an int8 cache with one f32 scale
per (row, kv head) for K and for V, stored [B, C, KH] as the engine keeps
them; its arithmetic is f32 throughout, and its split holds a D = 128 share
to at least ``split.MIN_SHARE_ROWS_D128`` rows, as K4's does.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from . import build
from .quantized_matmul import sm_count
from .split import MAX_GROUP, launch_groups, split_plan, workspace

NEG_INF = -1e30
HEAD_DIMS = (64, 128)  # the kernels' builds


def dequantize_cache(cache: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """An int8 cache [..., KH, D] and its [..., KH] scales as f32."""
    return cache.to(torch.float32) * scales[..., None]


def decode_attention_reference(
    q: torch.Tensor,  # [B, H, D]
    k_cache: torch.Tensor,  # [B, C, KH, D]
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # [B] int32; row lengths[b] is the newest token
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Mask the whole cache and attend: the plain version of the kernel (the
    JAX package's ``decode_attention_reference``)."""
    B, H, D = q.shape
    C, KH = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, KH, H // KH, D)
    s = torch.einsum("bkgd,bckd->bkgc", qg, k_cache).to(torch.float32)
    s = s / math.sqrt(D)
    cols = torch.arange(C, device=q.device)[None, :]
    lens = lengths.to(torch.int64)[:, None]
    mask = cols <= lens
    if window is not None:
        mask = mask & (cols > lens - window)
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgc,bckd->bkgd", p, v_cache)
    return out.reshape(B, H, D)


def decode_attention_int8_reference(
    q: torch.Tensor,  # [B, H, D]
    k_cache: torch.Tensor,  # [B, C, KH, D] int8
    v_cache: torch.Tensor,
    k_scales: torch.Tensor,  # [B, C, KH] f32
    v_scales: torch.Tensor,
    lengths: torch.Tensor,
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Dequantize-then-attend in f32, the plain version of the int8 kernel
    (the JAX package's ``decode_attention_int8_reference``); the output lands
    in ``q.dtype``."""
    out = decode_attention_reference(
        q.to(torch.float32), dequantize_cache(k_cache, k_scales),
        dequantize_cache(v_cache, v_scales), lengths, window=window,
    )
    return out.to(q.dtype)


def check_launch(q, k_cache, v_cache, scales, index, window, cache_dtype) -> None:
    """The launch contract of every dense-cache attention kernel: q
    [B, (T,) H, D] bf16, caches [B, C, KH, D] of ``cache_dtype``, ``scales``
    () or two contiguous f32 [B, C, KH], ``index`` the [B] int32 operands
    (lengths, strides); raises on anything else."""
    B, H, D = q.shape[0], q.shape[-2], q.shape[-1]
    C, KH = k_cache.shape[1], k_cache.shape[2]
    build.require(q.dtype == torch.bfloat16, f"q must be bfloat16, got {q.dtype}")
    build.require(k_cache.dtype == v_cache.dtype == cache_dtype,
                  f"caches must be {cache_dtype}, got {k_cache.dtype}/{v_cache.dtype}")
    build.require(k_cache.shape == v_cache.shape == (B, C, KH, D),
                  f"cache shapes {tuple(k_cache.shape)}/{tuple(v_cache.shape)} "
                  f"for q {tuple(q.shape)}")
    build.require(D in HEAD_DIMS, f"head_dim {D} not in {HEAD_DIMS}")
    build.require(H % KH == 0 and H // KH <= MAX_GROUP,
                  f"H={H}, KH={KH}: need H % KH == 0 and H / KH <= {MAX_GROUP}")
    build.require(B <= 65535 and KH <= 65535, f"B={B}, KH={KH}: at most 65535 each")
    build.require(window is None or window > 0, f"window must be positive, got {window}")
    for t in index:
        build.require(t.shape == (B,) and t.dtype == torch.int32 and t.is_contiguous(),
                      f"lengths and strides must be contiguous int32 [{B}]")
    for t in scales:
        build.require(t.dtype == torch.float32 and t.is_contiguous()
                      and t.shape == (B, C, KH),
                      f"scales must be contiguous float32 {(B, C, KH)}")
    for t in (q, k_cache, v_cache):
        build.require(t.is_contiguous() and t.data_ptr() % 16 == 0,
                      "dense decode attention needs contiguous 16-byte-aligned q and caches")


_argtypes: Dict[Tuple[int, int], list] = {}


def launch(wrapper, entry: str, q, k_cache, v_cache, scales, index, window,
           split: bool = False, sink: Optional[int] = None) -> torch.Tensor:
    """Check the operands, launch the entry point ``entry`` of
    ``csrc/dense_attention.cu`` and count the launch
    (``build.count_launch``). ``q`` is
    [B, H, D] with ``index = (lengths,)`` or [B, T, H, D] with
    ``index = (lengths, strides)``; ``scales`` is () for a bf16 cache or
    (k_scales, v_scales) for an int8 one. The entry takes the pointers (q,
    caches, scales, index, out and, with ``split``, the split workspace),
    then B, (T,) H, KH, D, C, the window (0 for none) and, with ``split``,
    the ``split_plan`` splits, then 1/sqrt(D) and the stream. A split
    single-query launch has a group per (slot, kv head), partials of
    MAX_GROUP rows; a split multi-query one (K6, K7) a group per (tile of
    up to MQ_BLOCK_ROWS query rows, kv head, slot), partials of
    MQ_BLOCK_ROWS rows."""
    check_launch(q, k_cache, v_cache, scales, index, window,
                 torch.int8 if scales else torch.bfloat16)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    dev = q.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = tuple(t.data_ptr() for t in (q, k_cache, v_cache, *scales, *index, out))
    B, C, KH, D = q.shape[0], k_cache.shape[1], k_cache.shape[2], q.shape[-1]
    dims = (*q.shape[:-1], KH, D, C, window or 0) + ((int(sink),) if sink is not None else ())
    if split:
        splits = split_plan(C, B, KH, sm_count(dev.index))
        query_rows = q.shape[1] * (q.shape[2] // KH) if q.dim() == 4 else 0
        groups, rows = launch_groups(B, KH, query_rows)
        ptrs += workspace(dev, build.scratch_stream(stream), groups, splits, D, rows)
        dims += (splits,)
    argtypes = _argtypes.get((len(ptrs), len(dims)))
    if argtypes is None:
        argtypes = _argtypes[(len(ptrs), len(dims))] = (
            [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * len(dims)
            + [ctypes.c_float, ctypes.c_void_p])
    fn = build.kernel("dense_attention", entry, argtypes)
    rc = fn(*ptrs, *dims, 1.0 / math.sqrt(D), stream)
    build.check("dense_attention", rc)
    build.count_launch(wrapper)
    return out


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Ragged decode attention -> [B, H, D]. CPU operands take the reference;
    CUDA operands launch the kernel (bf16 q and caches, int32 lengths, D in
    {64, 128}, H/KH <= 8, any cache length C), each slot's rows split by
    ``split_plan``, or raise."""
    dev = build.device_of(q, k_cache, v_cache, lengths)
    if dev.type == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, lengths, window=window)
    return launch(decode_attention, "aios_decode_attention", q, k_cache, v_cache, (),
                  (lengths,), window, split=True)


decode_attention.launches = 0


def decode_attention_int8(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_scales: torch.Tensor,
    v_scales: torch.Tensor,
    lengths: torch.Tensor,
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Ragged decode attention over an int8 cache with [B, C, KH] f32 scales
    folded into both products -> [B, H, D] in q.dtype. CPU operands take the
    reference; CUDA operands launch the kernel (bf16 q, int8 caches,
    contiguous f32 scales, int32 lengths, D in {64, 128}, H/KH <= 8, any
    cache length C), each slot's rows split by ``split_plan``, or raise."""
    dev = build.device_of(q, k_cache, v_cache, k_scales, v_scales, lengths)
    if dev.type == "cpu":
        return decode_attention_int8_reference(
            q, k_cache, v_cache, k_scales, v_scales, lengths, window=window)
    return launch(decode_attention_int8, "aios_decode_attention_int8", q, k_cache, v_cache,
                  (k_scales, v_scales), (lengths,), window, split=True)


decode_attention_int8.launches = 0
