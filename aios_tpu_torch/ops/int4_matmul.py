"""Int4-weight matmul: ``x @ dequant(packed, scale)`` without the dequantized
weight ever existing in device memory.

Group-wise symmetric int4, the serving format of ``quantize_params(mode=
"int4")``: one f32 scale per ``group`` rows of the contraction dim per output
column, the same bytes as the JAX package's ``quantize_int4``. Storage is
split-half: within each group of ``group`` K-rows, packed byte row ``r``
holds K-row ``r`` in its low nibble and K-row ``r + group/2`` in its high
nibble, both offset-binary (``q + 8`` in [0, 15]). Scales are
``[K/group, 1, N]``. On CUDA tensors the product runs in the hand-written
kernel ``csrc/int4_matmul.cu``; on CPU tensors in ``int4_matmul_reference``,
which dequantizes to bf16 first.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import build
from . import quantized_matmul as qmm

# Rows of the contraction dim per scale: divides every matmul dim of every
# model tier, and is the kernel's K tile.
GROUP = 128

# Clip-factor candidates for the per-group squared-error search (pure
# round-to-nearest first, then mild clipping of the group absmax).
CLIP_CANDIDATES = (1.0, 0.9, 0.8, 0.7)

def pick_group(K: int) -> int:
    """Largest supported scale-group size dividing K (0 if none): 128
    wherever it fits, smaller powers of two for tiny test geometries."""
    for g in (GROUP, 64, 32, 16):
        if K % g == 0:
            return g
    return 0


def supports_int4(K: int, N: int, group: int) -> bool:
    """Whether a [K, N] weight can take the int4 storage layout."""
    return group != 0 and K % group == 0 and group % 2 == 0


def kernel_supported(K: int, N: int, group: int) -> bool:
    """Whether the CUDA kernel serves this layout: a pipeline stage is one
    128-row group, and TMA reads the packed rows, whose stride must be a
    multiple of 16 bytes (N % 16 == 0); M may be ragged."""
    return group == GROUP and K > 0 and K % group == 0 and N > 0 and N % 16 == 0


def _quantize_2d(w: torch.Tensor, group: int, folded: bool):
    K, N = w.shape
    wf = w.to(torch.float32).reshape(K // group, group, N)
    absmax = wf.abs().amax(dim=-2, keepdim=True)
    one = torch.ones_like(absmax)
    best_err = best_scale = None
    for c in CLIP_CANDIDATES:
        # c * absmax / 7 in f32; ``folded``: absmax * (c * (1/7)), the
        # arithmetic XLA compiles that expression to inside the JAX
        # function's map over stacked layers (one constant multiplier), so
        # the scales agree bit for bit with the JAX package either way
        if folded:
            m = torch.tensor(c, dtype=torch.float32) * torch.tensor(1 / 7, dtype=torch.float32)
            s = torch.where(absmax > 0, absmax * m.to(absmax.device), one)
        else:
            s = torch.where(absmax > 0, c * absmax / 7.0, one)
        qc = torch.clamp(torch.round(wf / s), -8, 7)
        err = ((wf - qc * s) ** 2).sum(dim=-2, keepdim=True)
        if best_err is None:
            best_err, best_scale = err, s
        else:
            take = err < best_err
            best_err = torch.where(take, err, best_err)
            best_scale = torch.where(take, s, best_scale)
    q = (torch.clamp(torch.round(wf / best_scale), -8, 7) + 8).to(torch.uint8)
    q = q.reshape(K // group, 2, group // 2, N)
    packed = q[:, 0] | (q[:, 1] << 4)
    return packed.reshape(K // 2, N), best_scale


def quantize_int4(w: torch.Tensor, group: int = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group-wise symmetric int4 quantization along the contraction dim.

    For ``w`` [..., K, N] returns (packed uint8 [..., K/2, N], scales f32
    [..., K/group, 1, N]). Leading axes (stacked layers) are quantized one
    slice at a time, so the clip search's f32 temporaries stay at one
    layer's size. Per (group, column) the scale is the one among
    ``CLIP_CANDIDATES * absmax / 7`` with the strictly smallest f32 squared
    reconstruction error (the first candidate wins ties). Stacked
    input takes the arithmetic of the JAX function's compiled map (see
    ``_quantize_2d``)."""
    *lead, K, N = w.shape
    if group is None:
        group = pick_group(K)
    if not supports_int4(K, N, group):
        raise ValueError(f"no int4 group layout for weight shape {tuple(w.shape)}")
    flat = w.reshape(-1, K, N)
    packed = torch.empty((flat.shape[0], K // 2, N), dtype=torch.uint8, device=w.device)
    scales = torch.empty((flat.shape[0], K // group, 1, N), dtype=torch.float32,
                         device=w.device)
    for i in range(flat.shape[0]):
        packed[i], scales[i] = _quantize_2d(flat[i], group, folded=bool(lead))
    return packed.reshape(*lead, K // 2, N), scales.reshape(*lead, K // group, 1, N)


def unpack_int4(packed: torch.Tensor, group: int = GROUP) -> torch.Tensor:
    """Packed uint8 [..., K/2, N] -> int8 [..., K, N] (no scales applied)."""
    *lead, Kh, N = packed.shape
    K = Kh * 2
    p = packed.reshape(*lead, K // group, group // 2, N).to(torch.int16)
    lo = (p & 0xF) - 8
    hi = (p >> 4) - 8
    return torch.cat([lo, hi], dim=-2).reshape(*lead, K, N).to(torch.int8)


def infer_group(packed: torch.Tensor, scale: torch.Tensor) -> int:
    """The scale-group size, from the leaf shapes (no metadata)."""
    return packed.shape[-2] * 2 // scale.shape[-3]


def dequantize_int4(packed: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Full dequantization: float(nibble - 8) * scale, rounded to ``dtype``."""
    *lead, Kh, N = packed.shape
    K = Kh * 2
    group = infer_group(packed, scale)
    w = unpack_int4(packed, group).reshape(*lead, K // group, group, N)
    w = w.to(torch.float32) * scale
    return w.reshape(*lead, K, N).to(dtype)


def int4_matmul_reference(x: torch.Tensor, packed: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """Dequantize-then-matmul, the plain version of the kernel: the weight
    rounds to bf16 exactly as the kernel's shared-memory tile does, x rounds
    to bf16, the product accumulates in f32 and lands in ``x.dtype``."""
    w = dequantize_int4(packed, scale, dtype=torch.bfloat16)
    y = x.to(torch.bfloat16).to(torch.float32) @ w.to(torch.float32)
    return y.to(x.dtype)


def plan(M: int, N: int, K: int, sms: int) -> qmm.Plan:
    """K1's plan with one 128-row scale group per pipeline stage, so every
    split holds whole groups."""
    return qmm.plan(M, N, K, sms, kt=GROUP)


def int4_matmul(x: torch.Tensor, packed: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ dequant(packed [K/2, N] uint8, scale [K/group, 1, N] f32)
    -> [..., N] in x.dtype.

    CPU operands take ``int4_matmul_reference``; CUDA operands launch the
    kernel (bf16 activations, 128-row groups, N % 16 == 0, contiguous
    16-byte aligned operands) or raise."""
    dev = build.device_of(x, packed, scale)
    if dev.type == "cpu":
        return int4_matmul_reference(x, packed, scale)
    Kh, N = packed.shape
    K = 2 * Kh
    group = infer_group(packed, scale)
    build.require(packed.dtype == torch.uint8, f"packed must be uint8, got {packed.dtype}")
    build.require(kernel_supported(K, N, group),
                  f"int4 kernel needs {GROUP}-row groups and N % 16 == 0, "
                  f"got group={group} for K={K}, N={N}")
    build.require(scale.shape == (K // group, 1, N),
                  f"scale {tuple(scale.shape)} for packed {(Kh, N)}")
    return qmm.launch(int4_matmul, "int4_matmul", "aios_int4_matmul", x, packed, scale,
                      N, K, GROUP)


int4_matmul.launches = 0
