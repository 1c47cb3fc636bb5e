"""Device resolution for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the CUDA device; it raises when there is none rather
    than running on the CPU. Pass ``"cpu"`` to run the plain versions on the
    CPU (the tests do)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{dev} requested but no CUDA device is available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        # with its index, as the tensors made on it report it (the split
        # workspaces are keyed by it)
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# The abort reason of every request a device fault ends, and the prefix of
# the error its model then reports.
DEVICE_FAULT_REASON = "device fault"


class DeviceFault(RuntimeError):
    """A submit to a model whose device faulted: nothing on it can run
    again in this process, so the caller must not retry here."""


def is_device_fault(exc: BaseException) -> bool:
    """Whether ``exc`` is a CUDA error. Such an error is sticky: it poisons
    the process's CUDA context, which every replica of a card shares, so no
    respawn or retry can get past it (``torch.AcceleratorError``, or a
    RuntimeError whose text starts with "CUDA error" on a build without that
    class)."""
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return True
    return isinstance(exc, RuntimeError) and str(exc).startswith("CUDA error")
