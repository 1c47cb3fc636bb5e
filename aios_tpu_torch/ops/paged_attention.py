"""Paged decode attention: one query per slot over a shared page pool.

Logical block i of slot b lives in physical page ``tables[b, i]`` of the pool
[N, P, KH, D]; row ``lengths[b]`` is the slot's newest token, so the slot has
``lengths[b] + 1`` valid rows. Only pages holding valid rows are read. On
CUDA tensors this runs the hand-written kernel ``csrc/paged_attention.cu``;
on CPU tensors ``paged_decode_attention_reference``, which gathers each
slot's pages into a contiguous view first. ``paged_decode_attention_int8``
is the same over an int8 pool with one f32 scale per (page row, kv head)
for K and for V; its arithmetic is f32 throughout.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import build

NEG_INF = -1e30
MAX_GROUP = 8  # query heads per kv head the kernel takes

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
_ARGTYPES_INT8 = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]


def gather_pages(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Logical cache views [..., MB*P, KH, D] of the slots whose page tables
    are ``tables`` [..., MB], gathered from the pool (a copy)."""
    MB = tables.shape[-1]
    P, KH, D = pool.shape[1], pool.shape[2], pool.shape[3]
    return pool[tables.long()].reshape(*tables.shape[:-1], MB * P, KH, D)


def _attend(q, k, v, lengths, window, win_starts, sink):
    """Masked GQA attention of one query per slot over gathered views
    k/v [B, C, KH, D]."""
    B, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    C = k.shape[1]
    qg = q.reshape(B, KH, G, D)
    s = torch.einsum("bkgd,bckd->bkgc", qg, k).to(torch.float32)
    s = s / math.sqrt(D)
    cols = torch.arange(C, device=q.device)[None, :]
    lens = lengths.to(torch.int64)[:, None]
    mask = cols <= lens
    if window is not None:
        mask = mask & (cols > lens - window)
    if win_starts is not None:
        mask = mask & ((cols < int(sink)) | (cols >= win_starts.to(torch.int64)[:, None]))
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bkgc,bckd->bkgd", p, v)
    return out.reshape(B, H, D)


def paged_decode_attention_reference(
    q: torch.Tensor,  # [B, H, D]
    k_pool: torch.Tensor,  # [N, P, KH, D]
    v_pool: torch.Tensor,
    tables: torch.Tensor,  # [B, MB] int32
    lengths: torch.Tensor,  # [B] int32
    *,
    window: Optional[int] = None,
    win_starts: Optional[torch.Tensor] = None,  # [B] int32
    sink: Optional[int] = None,
) -> torch.Tensor:
    """Gather-then-attend: the plain version of the kernel (the JAX package's
    ``paged_decode_attention_reference``)."""
    return _attend(q, gather_pages(k_pool, tables), gather_pages(v_pool, tables),
                   lengths, window, win_starts, sink)


def paged_decode_attention_int8_reference(
    q: torch.Tensor,  # [B, H, D]
    k_pool: torch.Tensor,  # [N, P, KH, D] int8
    v_pool: torch.Tensor,
    k_scales: torch.Tensor,  # [N, P, KH] f32
    v_scales: torch.Tensor,
    tables: torch.Tensor,
    lengths: torch.Tensor,
    *,
    window: Optional[int] = None,
    win_starts: Optional[torch.Tensor] = None,
    sink: Optional[int] = None,
) -> torch.Tensor:
    """Dequantize-then-attend in f32, the plain version of the int8 kernel
    (the JAX package's ``paged_decode_attention_int8_reference``); the
    output lands in ``q.dtype``. Gathers each slot's pages before
    dequantizing, which gives the same values as dequantizing the pool."""
    def view(pool, scales):
        return (gather_pages(pool, tables).to(torch.float32)
                * gather_pages(scales[..., None], tables))

    out = _attend(q.to(torch.float32), view(k_pool, k_scales), view(v_pool, v_scales),
                  lengths, window, win_starts, sink)
    return out.to(q.dtype)


def _check(q, k_pool, v_pool, tables, lengths, window, extra, pool_dtype):
    """The launch contract both kernels share; raises on anything else."""
    B, H, D = q.shape
    N, P, KH = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    build.require(q.dtype == torch.bfloat16, f"q must be bfloat16, got {q.dtype}")
    build.require(k_pool.dtype == v_pool.dtype == pool_dtype,
                  f"pools must be {pool_dtype}, got {k_pool.dtype}/{v_pool.dtype}")
    build.require(k_pool.shape == v_pool.shape == (N, P, KH, D),
                  f"pool shapes {tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    build.require(D in (64, 128), f"head_dim {D} not in (64, 128)")
    build.require(H % KH == 0 and H // KH <= MAX_GROUP,
                  f"H={H}, KH={KH}: need H % KH == 0 and H / KH <= {MAX_GROUP}")
    build.require(tables.shape[0] == B and lengths.shape == (B,),
                  f"tables {tuple(tables.shape)} / lengths {tuple(lengths.shape)} for B={B}")
    build.require(window is None or window > 0, f"window must be positive, got {window}")
    for t in (tables, lengths, *extra):
        build.require(t.dtype == torch.int32 and t.is_contiguous(),
                      "tables, lengths and win_starts must be contiguous int32")
    for t in (q, k_pool, v_pool):
        build.require(t.is_contiguous() and t.data_ptr() % 16 == 0,
                      "paged decode attention needs contiguous 16-byte-aligned q and pools")


def paged_decode_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    tables: torch.Tensor,
    lengths: torch.Tensor,
    *,
    window: Optional[int] = None,
    win_starts: Optional[torch.Tensor] = None,
    sink: Optional[int] = None,
) -> torch.Tensor:
    """Paged ragged decode attention -> [B, H, D]. With ``win_starts`` and
    ``sink`` slot b attends only rows < sink or >= win_starts[b]. CPU
    operands take the reference; CUDA operands launch the kernel (bf16 q and
    pools, int32 tables/lengths, D in {64, 128}, H/KH <= 8) or raise."""
    if win_starts is not None and sink is None:
        raise ValueError("win_starts needs a sink row count")
    extra = (win_starts,) if win_starts is not None else ()
    dev = build.device_of(q, k_pool, v_pool, tables, lengths, *extra)
    if dev.type == "cpu":
        return paged_decode_attention_reference(
            q, k_pool, v_pool, tables, lengths, window=window,
            win_starts=win_starts, sink=sink,
        )
    _check(q, k_pool, v_pool, tables, lengths, window, extra, torch.bfloat16)
    B, H, D = q.shape
    P, KH, MB = k_pool.shape[1], k_pool.shape[2], tables.shape[1]
    out = torch.empty_like(q)
    if B == 0:
        return out
    fn = build.kernel("paged_attention", "aios_paged_decode_attention", _ARGTYPES)
    rc = fn(
        build.ptr(q), build.ptr(k_pool), build.ptr(v_pool), build.ptr(tables),
        build.ptr(lengths),
        build.ptr(win_starts) if win_starts is not None else None,
        build.ptr(out), B, H, KH, D, P, MB, window or 0,
        int(sink) if win_starts is not None else 0, 1.0 / math.sqrt(D),
        build.stream(dev),
    )
    build.check("paged_attention", rc)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_decode_attention_int8(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    k_scales: torch.Tensor,
    v_scales: torch.Tensor,
    tables: torch.Tensor,
    lengths: torch.Tensor,
    *,
    window: Optional[int] = None,
    win_starts: Optional[torch.Tensor] = None,
    sink: Optional[int] = None,
) -> torch.Tensor:
    """Paged ragged decode attention over an int8 pool with [N, P, KH] f32
    scales folded into both products -> [B, H, D] in q.dtype; the masks are
    ``paged_decode_attention``'s. CPU operands take the reference; CUDA
    operands launch the kernel (bf16 q, int8 pools, contiguous f32 scales,
    int32 tables/lengths, D in {64, 128}, H/KH <= 8) or raise."""
    if win_starts is not None and sink is None:
        raise ValueError("win_starts needs a sink row count")
    extra = (win_starts,) if win_starts is not None else ()
    dev = build.device_of(q, k_pool, v_pool, k_scales, v_scales, tables, lengths, *extra)
    if dev.type == "cpu":
        return paged_decode_attention_int8_reference(
            q, k_pool, v_pool, k_scales, v_scales, tables, lengths, window=window,
            win_starts=win_starts, sink=sink,
        )
    _check(q, k_pool, v_pool, tables, lengths, window, extra, torch.int8)
    B, H, D = q.shape
    P, KH, MB = k_pool.shape[1], k_pool.shape[2], tables.shape[1]
    for t in (k_scales, v_scales):
        build.require(t.dtype == torch.float32 and t.is_contiguous()
                      and t.shape == k_pool.shape[:3],
                      f"scales must be contiguous float32 {tuple(k_pool.shape[:3])}")
    out = torch.empty_like(q)
    if B == 0:
        return out
    fn = build.kernel("paged_attention", "aios_paged_decode_attention_int8", _ARGTYPES_INT8)
    rc = fn(
        build.ptr(q), build.ptr(k_pool), build.ptr(v_pool), build.ptr(k_scales),
        build.ptr(v_scales), build.ptr(tables), build.ptr(lengths),
        build.ptr(win_starts) if win_starts is not None else None,
        build.ptr(out), B, H, KH, D, P, MB, window or 0,
        int(sink) if win_starts is not None else 0, 1.0 / math.sqrt(D),
        build.stream(dev),
    )
    build.check("paged_attention", rc)
    paged_decode_attention_int8.launches += 1
    return out


paged_decode_attention_int8.launches = 0
