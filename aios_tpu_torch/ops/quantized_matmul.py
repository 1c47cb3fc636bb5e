"""Int8-weight matmul: ``x @ (w_q * s)`` without the dequantized weight ever
existing in device memory.

Symmetric per-output-channel int8 (scale = absmax / 127 over the contraction
axis), the serving format of ``quantize_params``. On CUDA tensors the product
runs in the hand-written kernel ``csrc/quantized_matmul.cu``; on CPU tensors
in ``quantized_matmul_reference``, which dequantizes first.

``quantized_matmul_experts`` is the kernel's expert-batched entry, for the
stacked int8 experts of a mixture-of-experts layer ([X, K, N] with [X, 1, N]
scales): every expert over shared rows, each expert over its own rows, or
each row over the expert its pick names, the picks read on the device.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from . import build

# Activation rows per block of each path. Up to 64 rows (decode, verify, the
# smallest prefill buckets) the weight-streaming path takes the next of 8,
# 16, 32, 64; larger M the prefill path's 128-row tiles.
STREAM_ROWS = (8, 16, 32, 64)
PREFILL_ROWS = 128
# Blocks resident per SM for each activation-row count: the kernel's
# kBlocksPerSm table (csrc/wq_matmul.cuh), which sizes its stages and its
# __launch_bounds__; a test holds the two equal.
BLOCKS_PER_SM = {8: 3, 16: 3, 32: 3, 64: 2, 128: 1}
WG_COLS = 64  # weight columns per consumer warpgroup; prefill blocks have two
KT = 64  # K rows per pipeline stage of the int8 kernel (int4: one 128-row group)
COUNTERS = 1024  # split-K ticket counters per (device, stream): one per tile

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_EXPERT_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
_counters: Dict[Tuple[int, int], torch.Tensor] = {}


class Plan(NamedTuple):
    block_t: int  # activation rows per block; with cols, the kernel's build
    cols: int  # weight columns per block
    tiles: int  # output tiles, the grid's x * y
    splits: int
    k_per_split: int

    @property
    def partial_floats(self) -> int:
        """fp32 scratch for the split-K partials (0 without a split)."""
        return self.splits * self.tiles * self.block_t * self.cols if self.splits > 1 else 0


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


@functools.lru_cache(maxsize=4096)  # a pure function of its ints, asked once per launch
def plan(M: int, N: int, K: int, sms: int, kt: int = KT, batches: int = 1) -> Plan:
    """The tile and K split of an [M, K] @ [K, N] launch, from the
    shapes and the SM count alone (so the same launch always sums in the
    same order). ``kt`` is the kernel's K rows per stage; splits hold whole
    stages and none is empty. ``batches`` (the expert entry's experts or
    picks) multiplies the output tiles: one launch holds them all.

    Weight streaming (M <= 64): one block per 64 weight columns, K split
    into as many parts as one wave of resident blocks (three or two per
    SM) holds, so a decode step keeps at least two blocks per SM
    streaming; a grid of more tiles than that keeps K whole. At 64 rows a
    split's partial tile is as large as eight stages of weights, so there
    a part keeps at least eight stages. Prefill: 128 x 128 tiles, one
    block per SM, K whole (a split's partial sums cost more than the idle
    SMs it fills); a grid of at most half as many such tiles as SMs takes
    the streaming path's 64 x 64 tiles instead."""
    k_tiles = math.ceil(K / kt)
    if M <= STREAM_ROWS[-1]:
        block_t, cols = next(r for r in STREAM_ROWS if r >= M), WG_COLS
        tiles = batches * math.ceil(N / cols)
        least = 8 if block_t == STREAM_ROWS[-1] else 1  # stages per part
        splits = max(1, min(BLOCKS_PER_SM[block_t] * sms // tiles, k_tiles // least))
        per = math.ceil(k_tiles / splits)
        return Plan(block_t, cols, tiles, math.ceil(k_tiles / per), per * kt)
    block_t, cols = PREFILL_ROWS, 2 * WG_COLS
    if batches * math.ceil(M / block_t) * math.ceil(N / cols) <= sms // 2:
        block_t, cols = STREAM_ROWS[-1], WG_COLS
    tiles = batches * math.ceil(M / block_t) * math.ceil(N / cols)
    return Plan(block_t, cols, tiles, 1, k_tiles * kt)


def kernel_supported(K: int, N: int) -> bool:
    """Whether the kernel serves a [K, N] int8 weight: TMA reads x rows of
    K bf16 and weight rows of N bytes, whose strides must be multiples of 16
    bytes (K % 8 == 0, N % 16 == 0); M may be ragged."""
    return K > 0 and K % 8 == 0 and N > 0 and N % 16 == 0


def counters_for(dev: torch.device, stream: int) -> torch.Tensor:
    """The zeroed ticket counters of ``stream`` on ``dev``: each split
    launch leaves them at 0 again. Made once and never replaced, so a CUDA
    graph may hold their address; an engine makes its stream's before its
    first capture, so that no capture records their zeroing."""
    key = (dev.index, stream)
    c = _counters.get(key)
    if c is None:
        c = _counters[key] = torch.zeros(COUNTERS, dtype=torch.int32, device=dev)
    return c


def _require_contract(library: str, x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                      N: int, K: int) -> None:
    """The launch contract of the shared core (``csrc/wq_matmul.cuh``)."""
    build.require(x.dtype == torch.bfloat16, f"x must be bfloat16, got {x.dtype}")
    build.require(scale.dtype == torch.float32, f"scale must be float32, got {scale.dtype}")
    build.require(x.shape[-1] == K,
                  f"x {tuple(x.shape)} does not contract with K={K}")
    build.require(
        x.is_contiguous() and w.is_contiguous() and scale.is_contiguous(),
        f"{library} needs contiguous operands",
    )
    build.require(kernel_supported(K, N),
                  f"{library} needs K % 8 == 0 and N % 16 == 0, got K={K} N={N}")
    build.require((x.data_ptr() | w.data_ptr() | scale.data_ptr()) % 16 == 0,
                  f"{library} needs 16-byte aligned operands")


def _split_scratch(p: Plan, dev: torch.device, stream: int, y: torch.Tensor):
    """(partial, counters) of a launch: the split-K partials and the ticket
    counters of ``stream`` when ``p`` splits K, else ``y`` for both (never
    read)."""
    if p.splits == 1:
        return y, y
    build.require(p.tiles <= COUNTERS, f"{p.tiles} split tiles exceed {COUNTERS} counters")
    # under a graph capture this comes from the graph's private pool, whose
    # addresses stay the graph's for its life
    return (torch.empty(p.partial_floats, dtype=torch.float32, device=dev),
            counters_for(dev, stream))


def launch(wrapper, library: str, entry: str, x: torch.Tensor, w: torch.Tensor,
           scale: torch.Tensor, N: int, K: int, kt: int) -> torch.Tensor:
    """Check the launch contract of the shared core (``csrc/wq_matmul.cuh``),
    plan, launch ``entry`` of ``library`` and count the launch
    (``build.count_launch``). ``w`` is the raw weight (int8 rows or packed
    nibbles) and ``scale`` its f32 scales."""
    _require_contract(library, x, w, scale, N, K)
    dev = x.device
    lead = x.shape[:-1]
    M = math.prod(lead)
    y = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    if M == 0:
        return y.reshape(*lead, N)
    p = plan(M, N, K, sm_count(dev.index), kt)
    # the host's cost per launch is most of a decode step's: one stream
    # query serves the counters and the launch
    stream = torch.cuda.current_stream(dev).cuda_stream
    partial, counters = _split_scratch(p, dev, build.scratch_stream(stream), y)
    fn = build.kernel(library, entry, _ARGTYPES)
    rc = fn(
        build.ptr(x), build.ptr(w), build.ptr(scale), build.ptr(y), build.ptr(partial),
        build.ptr(counters), M, N, K, p.block_t, p.cols, p.splits, p.k_per_split,
        ctypes.c_void_p(stream),
    )
    build.check(library, rc)
    build.count_launch(wrapper)
    return y.reshape(*lead, N)


def quantized_matmul(x: torch.Tensor, w_q: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ dequant(w_q [K, N] int8, scale [1, N] f32) -> [..., N].

    CPU operands take ``quantized_matmul_reference``; CUDA operands launch
    the kernel (bf16 activations, contiguous 16-byte aligned operands,
    K % 8 == 0, N % 16 == 0) or raise."""
    dev = build.device_of(x, w_q, scale)
    if dev.type == "cpu":
        return quantized_matmul_reference(x, w_q, scale)
    K, N = w_q.shape
    build.require(w_q.dtype == torch.int8, f"w_q must be int8, got {w_q.dtype}")
    build.require(scale.numel() == N, f"scale has {scale.numel()} entries for N={N}")
    return launch(quantized_matmul, "quantized_matmul", "aios_quantized_matmul",
                  x, w_q, scale, N, K, KT)


quantized_matmul.launches = 0


def quantized_matmul_experts_reference(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                                       picks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of ``quantized_matmul_experts``, expert by expert:
    each expert's fp32 product with its int8 rows, times its column scales,
    cast to x's dtype (the JAX ``_expert_einsum`` and ``pick_einsum``
    order). Builds no dequantized stack; the per-pick form runs every row
    through every expert and keeps the picked one."""
    X, N = w_q.shape[0], w_q.shape[-1]
    s = scale.reshape(X, 1, N).to(torch.float32)
    xf = x.to(torch.float32)
    if picks is None:
        rows = [xf[e] if x.dim() == 3 else xf for e in range(X)]
        return torch.stack([(r @ w_q[e].to(torch.float32)) * s[e]
                            for e, r in enumerate(rows)]).to(x.dtype)
    y = xf.new_zeros(x.shape[0], N)
    for e in range(X):
        y = torch.where((picks == e)[:, None], (xf @ w_q[e].to(torch.float32)) * s[e], y)
    return y.to(x.dtype)


def quantized_matmul_experts(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                             picks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stacked int8 experts w_q [X, K, N] with scales [X, 1, N] in one
    launch, in three row layouts:

      * shared: x [M, K] through every expert -> [X, M, N];
      * per expert: x [X, C, K], expert e's own C rows -> [X, C, N];
      * per pick: x [P, K] with ``picks`` [P] int32, row p through expert
        picks[p] -> [P, N].

    Each expert's scale multiplies its fp32 sums before the cast to bf16, as
    ``_expert_einsum`` scales before any sum over experts. CPU operands take
    ``quantized_matmul_experts_reference``; CUDA operands launch the
    kernel's expert entry (``csrc/quantized_matmul.cu``, K1's contract:
    bf16 activations, contiguous 16-byte aligned operands, K % 8 == 0,
    N % 16 == 0) or raise. The picks stay on the device."""
    dev = build.device_of(x, w_q, scale, *(() if picks is None else (picks,)))
    if dev.type == "cpu":
        return quantized_matmul_experts_reference(x, w_q, scale, picks)
    library = "quantized_matmul"
    build.require(w_q.dim() == 3 and w_q.dtype == torch.int8,
                  f"w_q must be int8 [X, K, N], got {w_q.dtype} {tuple(w_q.shape)}")
    X, K, N = w_q.shape
    build.require(scale.numel() == X * N, f"scale has {scale.numel()} entries for X={X} N={N}")
    if picks is not None:
        build.require(x.dim() == 2 and picks.shape == (x.shape[0],)
                      and picks.dtype == torch.int32 and picks.is_contiguous(),
                      f"picks must be int32 [P] for x [P, K], got {picks.dtype} "
                      f"{tuple(picks.shape)} for x {tuple(x.shape)}")
        batches, M, x_batched, out = x.shape[0], 1, 1, (x.shape[0], N)
    elif x.dim() == 3:
        build.require(x.shape[0] == X, f"x {tuple(x.shape)} holds no rows of {X} experts")
        batches, M, x_batched, out = X, x.shape[1], 1, (X, x.shape[1], N)
    else:
        build.require(x.dim() == 2, f"x must be [M, K], [X, C, K] or [P, K], got "
                                    f"{tuple(x.shape)}")
        batches, M, x_batched, out = X, x.shape[0], 0, (X, x.shape[0], N)
    _require_contract(library, x, w_q, scale, N, K)
    y = torch.empty(out, dtype=torch.bfloat16, device=dev)
    if batches * M == 0:
        return y
    p = plan(M, N, K, sm_count(dev.index), KT, batches)
    stream = torch.cuda.current_stream(dev).cuda_stream
    partial, counters = _split_scratch(p, dev, build.scratch_stream(stream), y)
    fn = build.kernel(library, "aios_quantized_matmul_experts", _EXPERT_ARGTYPES)
    rc = fn(
        build.ptr(x), build.ptr(w_q), build.ptr(scale),
        None if picks is None else build.ptr(picks), build.ptr(y), build.ptr(partial),
        build.ptr(counters), batches, M, x_batched, X, N, K, p.block_t, p.cols, p.splits,
        p.k_per_split, ctypes.c_void_p(stream),
    )
    build.check(library, rc)
    build.count_launch(quantized_matmul_experts)
    return y


quantized_matmul_experts.launches = 0
