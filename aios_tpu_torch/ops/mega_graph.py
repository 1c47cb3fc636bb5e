"""The decode megagraph's early exit: a gate per tick and the IF node it sets.

The JAX engine runs up to K decode ticks a dispatch in one
``lax.while_loop`` (``aios_tpu/engine/engine.py``, ``_mega_impl``) whose
condition is evaluated on the device between ticks: the tick index is below
the dispatch's cap and some slot is live (active, no stop id sampled, budget
left, below the context cap). A captured CUDA graph cannot branch from the
host, so the port builds each tick of its megagraph as a conditional IF
node of the graph (``csrc/mega_graph.cu``): ``mega_gate`` evaluates the
condition in one thread and sets the node's handle; the node's body is the
tick's decode step, captured straight into the node's own graph on a side
stream (``mega_tick``). A tick past the real count k runs nothing, so it
writes no pool row, length, history or token; every gate after a skipped
tick sees the same state and skips too, so the ticks that ran are a prefix.

On CPU tensors ``mega_gate`` computes the gate with plain tensor ops (the
eager loop breaks on it); on CUDA tensors it launches the kernel without a
handle, which writes the same flag (the eager twin on the card, and the
kernel's check against its plain version). ``mega_tick`` exists only inside
a CUDA capture.
"""

from __future__ import annotations

import ctypes
from contextlib import contextmanager
from typing import Iterator

import torch

from . import build

_V = ctypes.c_void_p
# handle, has_handle, tick, then cap, active, done, rem, lengths, ctx_cap,
# slots, go, the stream
_GATE_ARGTYPES = ([ctypes.c_ulonglong] + [ctypes.c_int] * 2 + [_V] * 5
                  + [ctypes.c_int] * 2 + [_V, _V])


def mega_gate_reference(tick: int, cap: torch.Tensor, active: torch.Tensor,
                        done: torch.Tensor, rem: torch.Tensor, lengths: torch.Tensor,
                        ctx_cap: int) -> torch.Tensor:
    """The gate in plain tensor ops, int32 [1]: 1 when ``tick < cap[0]``
    and some slot s has active[s], not done[s], rem[s] > 0 and lengths[s]
    < ctx_cap (the JAX loop's ``cond``)."""
    live = active & ~done & (rem > 0) & (lengths < ctx_cap)
    return ((cap[:1] > tick) & live.any()).to(torch.int32)


def _check(cap, active, done, rem, lengths, go) -> None:
    S = active.shape[0]
    for name, t, dtype, shape in (("cap", cap, torch.int32, (1,)),
                                  ("active", active, torch.bool, (S,)),
                                  ("done", done, torch.bool, (S,)),
                                  ("rem", rem, torch.int32, (S,)),
                                  ("lengths", lengths, torch.int32, (S,))):
        build.require(t.dtype == dtype and tuple(t.shape) == shape and t.is_contiguous(),
                      f"{name} must be contiguous {dtype} {shape}")
    build.require(go.dtype == torch.int32 and go.dim() == 1 and go.is_contiguous(),
                  "go must be a contiguous int32 vector")


def _gate_args(tick, cap, active, done, rem, lengths, ctx_cap, go):
    return (int(tick), *(build.ptr(t) for t in (cap, active, done, rem, lengths)),
            int(ctx_cap), active.shape[0], build.ptr(go))


def mega_gate(tick: int, cap: torch.Tensor, active: torch.Tensor, done: torch.Tensor,
              rem: torch.Tensor, lengths: torch.Tensor, ctx_cap: int, go: torch.Tensor) -> None:
    """Write the gate of tick ``tick`` into ``go[tick]``
    (``mega_gate_reference``). CPU operands take the plain version; CUDA
    operands launch the kernel (int32 cap [1], rem and lengths [S], bool
    active and done [S], int32 go), or raise."""
    dev = build.device_of(cap, active, done, rem, lengths, go)
    build.require(0 <= tick < go.shape[0], f"tick {tick} outside go[{go.shape[0]}]")
    if dev.type == "cpu":
        go[tick:tick + 1] = mega_gate_reference(tick, cap, active, done, rem, lengths,
                                                ctx_cap)
        return
    _check(cap, active, done, rem, lengths, go)
    fn = build.kernel("mega_graph", "aios_mega_gate", _GATE_ARGTYPES)
    rc = fn(0, 0, *_gate_args(tick, cap, active, done, rem, lengths, ctx_cap, go),
            build.stream(dev))
    build.check("mega_graph", rc)
    build.count_launch(mega_gate)


mega_gate.launches = 0


@contextmanager
def mega_tick(body_stream: torch.cuda.Stream, pool, tick: int, cap: torch.Tensor,
              active: torch.Tensor, done: torch.Tensor, rem: torch.Tensor,
              lengths: torch.Tensor, ctx_cap: int, go: torch.Tensor) -> Iterator[None]:
    """Inside a CUDA graph capture on the current stream: append the gate
    of tick ``tick`` (with a fresh conditional handle of the graph) and an
    IF node on that handle, then capture the block's work into the node's
    body on ``body_stream``, whose allocations come from the memory pool
    ``pool`` (a ``graph_pool_handle``, one reference taken per tick: the
    caller releases them with ``release_pool``) and whose split workspace
    is the capture stream's (``build.scratch_alias``). The gate's launch
    is counted (recorded by the capture); the body's are the caller's."""
    dev = go.device
    _check(cap, active, done, rem, lengths, go)
    graph_stream = torch.cuda.current_stream(dev).cuda_stream
    handle = ctypes.c_ulonglong(0)
    mk = build.kernel("mega_graph", "aios_cond_handle", [_V, ctypes.POINTER(ctypes.c_ulonglong)])
    build.check("mega_graph", mk(_V(graph_stream), ctypes.byref(handle)))
    gate = build.kernel("mega_graph", "aios_mega_gate", _GATE_ARGTYPES)
    build.check("mega_graph", gate(handle.value, 1, *_gate_args(
        tick, cap, active, done, rem, lengths, ctx_cap, go), _V(graph_stream)))
    build.count_launch(mega_gate)
    begin = build.kernel("mega_graph", "aios_cond_if_begin", [_V, _V, ctypes.c_ulonglong])
    build.check("mega_graph", begin(_V(graph_stream), _V(body_stream.cuda_stream),
                                    handle.value))
    end = build.kernel("mega_graph", "aios_cond_if_end", [_V])
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        with torch.cuda.stream(body_stream), \
                build.scratch_alias(body_stream.cuda_stream, graph_stream):
            torch._C._cuda_beginAllocateCurrentStreamToPool(index, pool)
            try:
                yield
            finally:
                torch._C._cuda_endAllocateToPool(index, pool)
    finally:
        build.check("mega_graph", end(_V(body_stream.cuda_stream)))


def release_pool(device: torch.device, pool, references: int) -> None:
    """Give back the ``references`` that ``mega_tick`` took on ``pool``,
    once the graphs whose bodies live there are gone."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    for _ in range(references):
        torch._C._cuda_releasePool(index, pool)
