"""CUDA graphs of the engine's decode and admission dispatches.

The port's counterpart of the JAX engine's compiled executables
(``TPUEngine._compile_aot``, ``compile_step_fn``, ``compile_spec_fn``,
``compile_prefill_fn`` and ``compile_chunk_fn`` in
``aios_tpu/engine/engine.py``): the JAX engine never issues a decode step
or an admission op by op; it compiles each once, behind the readiness gate,
and dispatches the executable. Here the body of one decode step, one
speculative round, one whole-prompt prefill at a bucket or one admission
chunk (embedding, every layer, the final norm and lm_head, on-device
sampling, the state updates) is captured once into a CUDA graph on the
engine's own stream and replayed once per dispatch: one host dispatch for
the thousand-odd kernels of a forward.

A capture bakes in every address the body touches, so the body reads and
writes only storage that lives as long as its graph: the engine's weights,
caches and static state buffers, the graph's memory pool, and the
split workspace and ticket counters of the engine's stream, reserved before
the first capture and held, never replaced, while a graph holds them
(``ops/split.py``). The body reads nothing back and branches on no tensor.
Capturing counts no kernel launch; each replay counts the launches its
capture recorded (``build.recording_launches``), so the wrappers' counters
read as if every launch had been issued one by one.

The decode step and round each keep a private memory pool. The admission
graphs of one engine share one pool (``pool``), so that its size is the
largest admission's intermediates and not their sum. That is safe under
one ownership rule: an admission graph returns no tensor from the shared
pool and stores none on the engine; its results go into engine buffers
allocated before the first capture. PyTorch asks graphs that share a pool
to replay in capture order because a graph's outputs may live in the pool,
where another graph's intermediates can overwrite them; with no output in
the pool, any order is safe, and the batcher replays a mid chunk, a final
chunk and a bucket in any order.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Hashable

import torch

from ..ops import build, split

# one capture at a time in the process (the caching allocator's rule); the
# engines' replays and eager work go on meanwhile
_capture_lock = threading.Lock()


class Graph:
    """One captured body: its CUDA graph, the outputs the capture returned
    (static tensors that every replay overwrites) and the kernel launches
    of one run, {wrapper: launches}."""

    def __init__(self, graph, outputs, launches: Dict[object, int]) -> None:
        self.graph = graph
        self.outputs = outputs
        self.launches = launches

    def replay(self):
        """Run the captured kernels on the current stream, count their
        launches and return the static outputs."""
        self.graph.replay()
        build.add_launches(self.launches)
        return self.outputs


class GraphSet:
    """The graphs of one engine by key, captured on the engine's own stream
    with the engine's sampling generator registered, so that every replay
    draws fresh noise from it. Counts like the JAX engine's compiles, under
    the port's names: ``captures`` and ``capture_seconds`` (the JAX
    ``xla_compiles``), ``replays``. Disabled (it captures nothing and every
    counter stays 0) off CUDA, where the engine runs its bodies eagerly."""

    def __init__(self, device: torch.device, generator: torch.Generator) -> None:
        self.device = device
        self.generator = generator
        self.enabled = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.enabled else None
        self.graphs: Dict[Hashable, Graph] = {}
        self.captures = 0
        self.capture_seconds = 0.0
        self.replays = 0
        self._holds_workspace = False

    def __contains__(self, key: Hashable) -> bool:
        return key in self.graphs

    def new_pool(self):
        """A memory pool for graphs to share (``capture``'s ``pool``); None
        off CUDA."""
        return torch.cuda.graph_pool_handle() if self.enabled else None

    def reserved_bytes(self) -> int:
        """Bytes the caching allocator holds on the device once its unused
        cache is released, 0 off CUDA: read before and after captures, the
        difference is what the captured graphs' pools took."""
        if self.device.type != "cuda":
            return 0
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved(self.device)

    def capture(self, key: Hashable, body: Callable[[], object],
                prepare: Callable[[], None], pool=None) -> Graph:
        """Capture ``body()`` as graph ``key``, in a private memory pool or
        in the shared ``pool`` (``new_pool``). ``prepare()`` first runs
        eagerly on the capture stream: it reserves the workspaces and runs
        the body once where that touches no live state, or rewrites what
        the replay will rewrite, so that every lazy set-up (kernel
        libraries, plans, counters) happens outside the capture. Raises if
        the capture fails: nothing falls back to the eager body."""
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            prepare()
        current.wait_stream(self.stream)
        graph = torch.cuda.CUDAGraph()
        # without this a capture refuses a draw from a generator of its own,
        # and it is what makes each replay draw new noise
        graph.register_generator_state(self.generator)
        # another engine may load, and launch, on another thread meanwhile
        with _capture_lock, build.recording_launches() as launches:
            with torch.cuda.graph(graph, pool=pool, stream=self.stream,
                                  capture_error_mode="thread_local"):
                outputs = body()
        if not self._holds_workspace:
            split.hold(self.device, self.stream.cuda_stream)
            self._holds_workspace = True
        self.graphs[key] = Graph(graph, outputs, launches)
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0
        return self.graphs[key]

    def replay(self, key: Hashable):
        """Replay graph ``key``; returns its static outputs."""
        outputs = self.graphs[key].replay()
        self.replays += 1
        return outputs

    def close(self) -> None:
        """Drop every graph (and its private memory) and release the
        workspace they held, once the device is done with them."""
        if self.enabled:
            torch.cuda.synchronize(self.device)
        self.graphs.clear()
        if self._holds_workspace:
            split.release(self.device, self.stream.cuda_stream)
            self._holds_workspace = False

