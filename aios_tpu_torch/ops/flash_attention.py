"""Blockwise (flash) causal GQA attention for prefill.

The [T, S] score matrix never exists in device memory: each kv tile folds
into a running online softmax (max, sum, value accumulator) in fp32. GQA maps
query head h to kv head ``h // (H // KH)``; a sliding window is optional and
tiles outside the causal triangle or the window are skipped. On CUDA tensors
this runs the hand-written kernel ``csrc/flash_attention.cu`` (TMA copies and
``wgmma`` products; one block serves the G query heads of a kv head, stacked
on its 128 query rows); on CPU tensors ``flash_attention_reference``. The
layout is the model's, [B, T, H, D].
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import build

NEG_INF = -1e30
HEAD_DIMS = (64, 128)  # the kernel's builds: TMA spans of 64 columns, wgmma's N
MAX_GROUP = 64  # query heads per kv head: at least one position per 64 query rows

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]


def flash_attention_reference(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,  # [B, S, KH, D]
    v: torch.Tensor,  # [B, S, KH, D]
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Naive masked GQA attention with an fp32 softmax: the plain version of
    the kernel (the JAX package's ``flash_attention_reference``)."""
    B, T, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    G = H // KH
    qg = q.reshape(B, T, KH, G, D)
    s = torch.einsum("btkgd,bskd->bkgts", qg, k).to(torch.float32)
    s = s / math.sqrt(D)
    rows = torch.arange(T, device=q.device)[:, None]
    cols = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask = cols <= rows
    if window is not None:
        mask = mask & (cols > rows - window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", p, v)
    return out.reshape(B, T, H, D)


def check_launch(q, k, v, window) -> None:
    """The kernel's launch contract: bf16 q [B, T, H, D] and k/v [B, S, KH, D],
    contiguous and 16-byte aligned (TMA), D in HEAD_DIMS, H a multiple of KH
    with H / KH <= MAX_GROUP, a positive window or none; raises on anything
    else, before any launch."""
    B, T, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    build.require(
        q.dtype == k.dtype == v.dtype == torch.bfloat16,
        f"q/k/v must be bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}",
    )
    build.require(k.shape == v.shape == (B, S, KH, D), f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)}")
    build.require(H % KH == 0 and H // KH <= MAX_GROUP,
                  f"H={H}, KH={KH}: need H % KH == 0 and H / KH <= {MAX_GROUP}")
    build.require(D in HEAD_DIMS, f"head_dim D={D} not in {HEAD_DIMS}")
    build.require(window is None or window > 0, f"window must be positive, got {window}")
    build.require(B <= 65535 and KH <= 65535, f"B={B}, KH={KH}: at most 65535 each")
    build.require(q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
                  and (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16 == 0,
                  "flash_attention needs contiguous 16-byte-aligned operands")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Flash GQA attention; CPU operands take ``flash_attention_reference``,
    CUDA operands launch the kernel (bf16, contiguous, D in {64, 128},
    H / KH <= 64) or raise."""
    dev = build.device_of(q, k, v)
    if dev.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, window=window)
    check_launch(q, k, v, window)
    B, T, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0 or S == 0:
        return out.zero_()
    fn = build.kernel("flash_attention", "aios_flash_attention", _ARGTYPES)
    rc = fn(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(out),
        B, T, S, H, KH, D, int(causal), window or 0, 1.0 / math.sqrt(D),
        build.stream(dev),
    )
    build.check("flash_attention", rc)
    build.count_launch(flash_attention)
    return out


flash_attention.launches = 0
