"""Int8-weight matmul: ``x @ (w_q * s)`` without the dequantized weight ever
existing in device memory.

Symmetric per-output-channel int8 (scale = absmax / 127 over the contraction
axis), the serving format of ``quantize_params``. On CUDA tensors the product
runs in the hand-written kernel ``csrc/quantized_matmul.cu``; on CPU tensors
in ``quantized_matmul_reference``, which dequantizes first.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from . import build

BLOCK_N = 64
BLOCK_K = {16: 128, 64: 64}  # K tile depth of each block_m variant

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def quantize_int8(w: torch.Tensor, axis: int = -2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization along ``axis`` (the contraction dim).

    Returns (w_q int8, scale f32) with scale shaped like w but size 1 on
    ``axis`` — for a [K, N] weight that is [1, N]. Rounds half to even, the
    same bytes as the JAX package's ``quantize_int8``.
    """
    wf = w.to(torch.float32)
    absmax = wf.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    w_q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return w_q, scale


def dequantize(w_q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return (w_q.to(torch.float32) * scale).to(dtype)


def quantized_matmul_reference(x: torch.Tensor, w_q: torch.Tensor,
                               scale: torch.Tensor) -> torch.Tensor:
    """Dequantize-then-matmul: the plain version of the kernel."""
    w = dequantize(w_q, scale, dtype=torch.float32)
    return (x.to(torch.float32) @ w).to(x.dtype)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan(M: int, N: int, K: int, sms: int, block_k: int = 0) -> Tuple[int, int, int]:
    """(block_m, splits, k_per_split) for an [M, K] @ [K, N] launch: 16-row
    tiles for decode-sized M, 64 otherwise, K tiles ``block_k`` deep (by
    default the block_m variant's depth), and K split over blocks until
    about two blocks per SM are in flight."""
    block_m = 16 if M <= 16 else 64
    block_k = block_k or BLOCK_K[block_m]
    tiles = math.ceil(M / block_m) * math.ceil(N / BLOCK_N)
    k_tiles = math.ceil(K / block_k)
    want = max(1, min(k_tiles, math.ceil(2 * sms / tiles)))
    per = math.ceil(k_tiles / want)
    return block_m, math.ceil(k_tiles / per), per * block_k


def quantized_matmul(x: torch.Tensor, w_q: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ dequant(w_q [K, N] int8, scale [1, N] f32) -> [..., N].

    CPU operands take ``quantized_matmul_reference``; CUDA operands launch
    the kernel (bf16 activations, contiguous operands) or raise."""
    dev = build.device_of(x, w_q, scale)
    if dev.type == "cpu":
        return quantized_matmul_reference(x, w_q, scale)
    K, N = w_q.shape
    build.require(x.dtype == torch.bfloat16, f"x must be bfloat16, got {x.dtype}")
    build.require(w_q.dtype == torch.int8, f"w_q must be int8, got {w_q.dtype}")
    build.require(scale.dtype == torch.float32, f"scale must be float32, got {scale.dtype}")
    build.require(x.shape[-1] == K and K > 0,
                  f"x {tuple(x.shape)} does not contract with w_q {(K, N)}")
    build.require(scale.numel() == N, f"scale has {scale.numel()} entries for N={N}")
    build.require(
        x.is_contiguous() and w_q.is_contiguous() and scale.is_contiguous(),
        "quantized_matmul needs contiguous operands",
    )
    lead = x.shape[:-1]
    M = math.prod(lead)
    y = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    if M == 0:
        return y.reshape(*lead, N)
    block_m, splits, k_per_split = plan(M, N, K, sm_count(dev.index or 0))
    partial = (
        torch.empty((splits, M, N), dtype=torch.float32, device=dev)
        if splits > 1 else y
    )
    fn = build.kernel("quantized_matmul", "aios_quantized_matmul", _ARGTYPES)
    rc = fn(
        build.ptr(x), build.ptr(w_q), build.ptr(scale), build.ptr(y),
        build.ptr(partial), M, N, K, block_m, splits, k_per_split,
        build.stream(dev),
    )
    build.check("quantized_matmul", rc)
    quantized_matmul.launches += 1
    return y.reshape(*lead, N)


quantized_matmul.launches = 0
