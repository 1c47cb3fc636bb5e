"""aios_tpu_torch — the PyTorch/CUDA port of aios_tpu for NVIDIA Hopper.

Serves the same gRPC surfaces as ``aios_tpu``. The runtime
(``aios.runtime.AIRuntime``) serves continuous batching over a paged bf16
KV pool, whole-prompt bucketed prefill, batched decode and on-device
sampling, with int8 serving weights. The hot ops run in hand-written CUDA
kernels (``ops/``, sources in ``csrc/``); each has a plain PyTorch twin that
CPU tensors take. The service plane above it (memory, tools, gateway,
orchestrator, agents, boot, native) is host code copied from ``aios_tpu``
and imports no torch.

Entry points run on CUDA unless the caller passes ``device="cpu"``; without
a CUDA device they raise instead of falling back. The package imports
nothing of JAX or of ``aios_tpu``: where it needs a piece of a jax-free
``aios_tpu`` module it keeps its own copy.
"""

__all__ = ["resolve_device"]

__version__ = "0.1.0"


def __getattr__(name: str):
    # lazy: the host-only subpackages (memory, tools, gateway, orchestrator,
    # agents, boot, native) run in processes that never load torch
    if name == "resolve_device":
        from .device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
