"""aios_tpu_torch — the PyTorch/CUDA port of aios_tpu for NVIDIA Hopper.

Serves the same ``aios.runtime.AIRuntime`` gRPC surface as ``aios_tpu``:
continuous batching over a paged bf16 KV pool, whole-prompt bucketed
prefill, batched decode and on-device sampling, with int8 serving weights.
The hot ops run in hand-written CUDA kernels (``ops/``, sources in
``csrc/``); each has a plain PyTorch twin that CPU tensors take.

Entry points run on CUDA unless the caller passes ``device="cpu"``; without
a CUDA device they raise instead of falling back. The package imports
nothing of JAX or of ``aios_tpu``: where it needs a piece of a jax-free
``aios_tpu`` module it keeps its own copy.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
