"""Blockwise (flash) causal GQA attention for prefill.

The [T, S] score matrix never exists in device memory: each kv tile folds
into a running online softmax (max, sum, value accumulator) in fp32. GQA maps
query head h to kv head ``h // (H // KH)``; a sliding window is optional and
tiles outside the causal triangle or the window are skipped. On CUDA tensors
this runs the hand-written kernel ``csrc/flash_attention.cu``; on CPU tensors
``flash_attention_reference``. The layout is the model's, [B, T, H, D].
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import build

NEG_INF = -1e30

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


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Flash GQA attention; CPU operands take ``flash_attention_reference``,
    CUDA operands launch the kernel (bf16, contiguous, D in {32, 64, 128})
    or raise."""
    dev = build.device_of(q, k, v)
    if dev.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, window=window)
    B, T, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    build.require(
        q.dtype == k.dtype == v.dtype == torch.bfloat16,
        f"q/k/v must be bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}",
    )
    build.require(k.shape == v.shape == (B, S, KH, D), f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)}")
    build.require(H % KH == 0, f"H={H} is not a multiple of KH={KH}")
    build.require(D in (32, 64, 128), f"head_dim {D} not in (32, 64, 128)")
    build.require(window is None or window > 0, f"window must be positive, got {window}")
    for t in (q, k, v):
        build.require(t.is_contiguous() and t.data_ptr() % 16 == 0,
                      "flash_attention needs contiguous 16-byte-aligned operands")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = build.kernel("flash_attention", "aios_flash_attention", _ARGTYPES)
    rc = fn(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(out),
        B, T, S, H, KH, D, int(causal), window or 0, 1.0 / math.sqrt(D),
        build.stream(dev),
    )
    build.check("flash_attention", rc)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
