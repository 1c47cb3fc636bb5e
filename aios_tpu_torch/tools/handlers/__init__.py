"""Tool handler namespaces.

Reference parity: tools/src/{fs,process,service,net,firewall,pkg,sec,
monitor,hw,web,git,code,self_update,plugin,container,email}/ — the full
handler table at executor.rs:111-501. Each handler takes a JSON-dict input
and returns a JSON-dict output; failures raise ToolError.
"""

from __future__ import annotations

import shutil
import subprocess
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional


class ToolError(Exception):
    """Handler failure — becomes ExecuteResponse.error."""


@dataclass(frozen=True)
class ToolSpec:
    fn: Callable[[dict], dict]
    description: str
    reversible: bool = False
    idempotent: bool = False
    target_arg: Optional[str] = None  # which arg names the path to back up
    requires_confirmation: bool = False
    timeout_ms: int = 30_000
    version: str = "1.0.0"


def run_cmd(argv, timeout: float = 30.0, input_text: str | None = None) -> dict:
    """Run a host command; ToolError if the binary is missing or it fails."""
    if shutil.which(argv[0]) is None:
        raise ToolError(f"{argv[0]} is not available on this host")
    try:
        proc = subprocess.run(
            argv,
            capture_output=True,
            text=True,
            timeout=timeout,
            input=input_text,
        )
    except subprocess.TimeoutExpired as exc:
        raise ToolError(f"{argv[0]} timed out after {timeout}s") from exc
    out = {
        "stdout": proc.stdout[-20_000:],
        "stderr": proc.stderr[-5_000:],
        "exit_code": proc.returncode,
    }
    if proc.returncode != 0:
        raise ToolError(
            f"{' '.join(argv[:3])} exited {proc.returncode}: {proc.stderr[:500]}"
        )
    return out


def collect_all() -> Dict[str, ToolSpec]:
    """Aggregate every namespace's TOOLS table."""
    from . import dev, filesystem, netops, pkgsec, system

    table: Dict[str, ToolSpec] = {}
    for mod in (filesystem, system, netops, pkgsec, dev):
        overlap = table.keys() & mod.TOOLS.keys()
        assert not overlap, f"duplicate tool names: {overlap}"
        table.update(mod.TOOLS)
    return table
