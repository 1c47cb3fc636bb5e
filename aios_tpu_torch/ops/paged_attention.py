"""Paged decode attention: one query per slot over a shared page pool.

Logical block i of slot b lives in physical page ``tables[b, i]`` of the pool
[N, P, KH, D]; row ``lengths[b]`` is the slot's newest token, so the slot has
``lengths[b] + 1`` valid rows. Only pages holding valid rows are read. On
CUDA tensors this runs the hand-written kernel ``csrc/paged_attention.cu``,
which splits each slot's visible rows over several blocks
(``ops/split.py``, shared with K8) and merges them in the same launch; on
CPU tensors
``paged_decode_attention_reference``, which gathers each slot's pages into
a contiguous view first. ``paged_decode_attention_int8``
is the same over an int8 pool with one f32 scale per (page row, kv head)
for K and for V; its arithmetic is f32 throughout.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import build
from .quantized_matmul import sm_count
from .split import MAX_GROUP, split_plan, workspace

NEG_INF = -1e30
HEAD_DIMS = (64, 128)  # the kernel's builds
MAX_STAGED_PAGES = 2048  # kMaxStagedPages: page-table entries a block stages

# pointers (q, pools, [scales,] tables, lengths, win_starts, out, partial,
# tickets), B H KH D P MB window sink splits, sm_scale, the stream
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
_ARGTYPES_INT8 = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]


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


def _check(q, pools, scales, tables, lengths, window, extra) -> None:
    """The launch contract both kernels share: bf16 q [B, H, D], pools
    [N, P, KH, D] of the kernel's type (bf16, or int8 with contiguous f32
    [N, P, KH] ``scales``), int32 tables [B, MB] and lengths [B], D in
    {64, 128}, H/KH <= MAX_GROUP, MB <= MAX_STAGED_PAGES; raises on anything
    else, before any launch. Messages are formatted only on a refusal: the
    step issues this check 22-32 times and is bound by the host."""
    k_pool, v_pool = pools
    B, H, D = q.shape
    N, P, KH = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    pool_dtype = torch.int8 if scales else torch.bfloat16
    if q.dtype != torch.bfloat16:
        raise ValueError(f"q must be bfloat16, got {q.dtype}")
    if not k_pool.dtype == v_pool.dtype == pool_dtype:
        raise ValueError(f"pools must be {pool_dtype}, got {k_pool.dtype}/{v_pool.dtype}")
    if not k_pool.shape == v_pool.shape == (N, P, KH, D):
        raise ValueError(f"pool shapes {tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if H % KH or H // KH > MAX_GROUP:
        raise ValueError(f"H={H}, KH={KH}: need H % KH == 0 and H / KH <= {MAX_GROUP}")
    if B > 65535 or KH > 65535:
        raise ValueError(f"B={B}, KH={KH}: at most 65535 each")
    if tables.dim() != 2 or tables.shape[0] != B or lengths.shape != (B,):
        raise ValueError(f"tables {tuple(tables.shape)} / lengths {tuple(lengths.shape)} "
                         f"for B={B}")
    if tables.shape[1] > MAX_STAGED_PAGES:
        raise ValueError(f"tables [B, {tables.shape[1]}]: at most {MAX_STAGED_PAGES} "
                         "pages per slot")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    for t in (tables, lengths, *extra):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("tables, lengths and win_starts must be contiguous int32")
    for t in scales:
        if t.dtype != torch.float32 or not t.is_contiguous() or t.shape != k_pool.shape[:3]:
            raise ValueError(f"scales must be contiguous float32 {tuple(k_pool.shape[:3])}")
    if not (q.is_contiguous() and k_pool.is_contiguous() and v_pool.is_contiguous()) or (
            q.data_ptr() | k_pool.data_ptr() | v_pool.data_ptr()) % 16:
        raise ValueError("paged decode attention needs contiguous 16-byte-aligned q and pools")


def _launch(wrapper, entry, argtypes, q, pools, scales, tables, lengths, window,
            win_starts, sink) -> torch.Tensor:
    """Check the operands, launch ``entry`` of ``csrc/paged_attention.cu``
    with each slot's visible rows split ``split_plan`` ways, and count the launch
    (``build.count_launch``). The entry takes the pointers (q, pools, scales,
    tables, lengths, win_starts or null, out, the split workspace), then B,
    H, KH, D, P, MB, the window (0 for none), the sink, the splits,
    1/sqrt(D) and the stream."""
    extra = (win_starts,) if win_starts is not None else ()
    _check(q, pools, scales, tables, lengths, window, extra)
    out = torch.empty_like(q)
    B, H, D = q.shape
    if B == 0:
        return out
    P, KH, MB = pools[0].shape[1], pools[0].shape[2], tables.shape[1]
    dev = q.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    splits = split_plan(MB * P, B, KH, sm_count(dev.index))
    scratch = workspace(dev, build.scratch_stream(stream), B * KH, splits, D)
    fn = build.kernel("paged_attention", entry, argtypes)
    rc = fn(q.data_ptr(), *(t.data_ptr() for t in (*pools, *scales, tables, lengths)),
            win_starts.data_ptr() if win_starts is not None else None, out.data_ptr(),
            *scratch, B, H, KH, D, P, MB, window or 0,
            int(sink) if win_starts is not None else 0, splits, 1.0 / math.sqrt(D), stream)
    build.check("paged_attention", rc)
    build.count_launch(wrapper)
    return out


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
    pools, int32 tables/lengths, D in {64, 128}, H/KH <= 8), each slot's
    rows split by ``split_plan``, or raise."""
    if win_starts is not None and sink is None:
        raise ValueError("win_starts needs a sink row count")
    extra = (win_starts,) if win_starts is not None else ()
    if build.device_of(q, k_pool, v_pool, tables, lengths, *extra).type == "cpu":
        return paged_decode_attention_reference(
            q, k_pool, v_pool, tables, lengths, window=window,
            win_starts=win_starts, sink=sink,
        )
    return _launch(paged_decode_attention, "aios_paged_decode_attention", _ARGTYPES, q,
                   (k_pool, v_pool), (), tables, lengths, window, win_starts, sink)


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
    int32 tables/lengths, D in {64, 128}, H/KH <= 8), each slot's rows split
    by ``split_plan``, or raise."""
    if win_starts is not None and sink is None:
        raise ValueError("win_starts needs a sink row count")
    extra = (win_starts,) if win_starts is not None else ()
    dev = build.device_of(q, k_pool, v_pool, k_scales, v_scales, tables, lengths, *extra)
    if dev.type == "cpu":
        return paged_decode_attention_int8_reference(
            q, k_pool, v_pool, k_scales, v_scales, tables, lengths, window=window,
            win_starts=win_starts, sink=sink,
        )
    return _launch(paged_decode_attention_int8, "aios_paged_decode_attention_int8",
                   _ARGTYPES_INT8, q, (k_pool, v_pool), (k_scales, v_scales), tables,
                   lengths, window, win_starts, sink)


paged_decode_attention_int8.launches = 0
