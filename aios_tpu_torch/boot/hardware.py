"""Hardware detection at boot.

Reference parity (initd/src/hardware.rs:37+): CPU/memory/disk discovery from
/proc and /sys. Accelerator addition: detects attached CUDA devices through
torch (deferred import so boot works on hosts without accelerators); the
fields keep the JAX package's ``tpu_`` names, so the two report alike.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

import psutil


@dataclass
class HardwareInfo:
    cpu_model: str = ""
    cpu_cores: int = 0
    cpu_threads: int = 0
    memory_total_mb: int = 0
    disks: List[Dict] = field(default_factory=list)
    tpu_devices: List[str] = field(default_factory=list)
    tpu_backend: str = ""

    @property
    def has_tpu(self) -> bool:
        return bool(self.tpu_devices)


def detect(probe_tpu: bool = True) -> HardwareInfo:
    info = HardwareInfo()
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                info.cpu_model = line.split(":", 1)[1].strip()
                break
    except OSError:
        pass
    info.cpu_cores = psutil.cpu_count(logical=False) or 0
    info.cpu_threads = psutil.cpu_count() or 0
    info.memory_total_mb = int(psutil.virtual_memory().total / 1e6)
    for part in psutil.disk_partitions(all=False):
        try:
            usage = psutil.disk_usage(part.mountpoint)
        except OSError:
            continue
        info.disks.append(
            {"mount": part.mountpoint, "total_gb": round(usage.total / 1e9, 1)}
        )
    if probe_tpu:
        try:
            import torch

            info.tpu_devices = [
                f"cuda:{i} {torch.cuda.get_device_name(i)}"
                for i in range(torch.cuda.device_count())
            ]
            info.tpu_backend = "cuda" if info.tpu_devices else "cpu"
        except Exception:  # no accelerator / no torch — boot proceeds
            pass
    return info
