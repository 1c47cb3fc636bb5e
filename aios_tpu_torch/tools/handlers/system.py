"""process.* / service.* / monitor.* / hw.* — system tools.

Reference: tools/src/{process,service,monitor,hw}/ (18 handlers). psutil
backs the read-only paths; systemctl/journalctl paths degrade with a clear
error when the host has no systemd (e.g. containers).
"""

from __future__ import annotations

import os
import signal as signal_mod
import subprocess
import time
from pathlib import Path

import psutil

from . import ToolError, ToolSpec, run_cmd

# ---------------------------------------------------------------------------
# process.*
# ---------------------------------------------------------------------------


def process_list(args: dict) -> dict:
    limit = int(args.get("limit", 50))
    sort_by = args.get("sort_by", "cpu")
    procs = []
    for p in psutil.process_iter(["pid", "name", "username", "cpu_percent",
                                  "memory_info", "status"]):
        try:
            info = p.info
            procs.append(
                {
                    "pid": info["pid"],
                    "name": info["name"],
                    "user": info.get("username"),
                    "cpu_percent": info.get("cpu_percent") or 0.0,
                    "rss_mb": round((info["memory_info"].rss if info.get("memory_info") else 0) / 1e6, 1),
                    "status": info.get("status"),
                }
            )
        except (psutil.NoSuchProcess, psutil.AccessDenied):
            continue
    key = "cpu_percent" if sort_by == "cpu" else "rss_mb"
    procs.sort(key=lambda x: x[key], reverse=True)
    return {"processes": procs[:limit], "total": len(procs)}


def process_spawn(args: dict) -> dict:
    argv = args.get("argv") or args.get("command", "").split()
    if not argv:
        raise ToolError("missing argv/command")
    proc = subprocess.Popen(
        argv,
        stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL,
        start_new_session=True,
    )
    return {"pid": proc.pid, "argv": argv}


def process_kill(args: dict) -> dict:
    pid = int(args.get("pid", 0))
    if pid <= 1:
        raise ToolError(f"refusing to kill pid {pid}")
    sig = getattr(signal_mod, args.get("signal", "SIGTERM"), signal_mod.SIGTERM)
    try:
        os.kill(pid, sig)
    except ProcessLookupError as exc:
        raise ToolError(f"no such process {pid}") from exc
    except PermissionError as exc:
        raise ToolError(f"permission denied killing {pid}") from exc
    return {"pid": pid, "signal": int(sig)}


def process_info(args: dict) -> dict:
    pid = int(args.get("pid", 0))
    try:
        p = psutil.Process(pid)
        with p.oneshot():
            return {
                "pid": pid,
                "name": p.name(),
                "status": p.status(),
                "cpu_percent": p.cpu_percent(interval=0.05),
                "rss_mb": round(p.memory_info().rss / 1e6, 1),
                "cmdline": p.cmdline()[:20],
                "create_time": int(p.create_time()),
                "num_threads": p.num_threads(),
            }
    except psutil.NoSuchProcess as exc:
        raise ToolError(f"no such process {pid}") from exc


def process_signal(args: dict) -> dict:
    args = dict(args)
    args.setdefault("signal", "SIGHUP")
    return process_kill(args)


def process_cgroup(args: dict) -> dict:
    pid = int(args.get("pid", os.getpid()))
    path = Path(f"/proc/{pid}/cgroup")
    if not path.exists():
        raise ToolError(f"no cgroup info for pid {pid}")
    return {"pid": pid, "cgroup": path.read_text().strip().splitlines()}


# ---------------------------------------------------------------------------
# service.* — systemd wrappers with graceful degradation
# ---------------------------------------------------------------------------


def _systemctl(*argv: str) -> dict:
    return run_cmd(["systemctl", "--no-pager", *argv], timeout=30)


def service_list(args: dict) -> dict:
    out = _systemctl("list-units", "--type=service", "--all", "--plain",
                     "--no-legend")
    services = []
    for line in out["stdout"].splitlines()[: int(args.get("limit", 100))]:
        parts = line.split(None, 4)
        if len(parts) >= 4:
            services.append(
                {"unit": parts[0], "load": parts[1], "active": parts[2],
                 "sub": parts[3]}
            )
    return {"services": services}


def _service_verb(verb: str):
    def handler(args: dict) -> dict:
        name = args.get("name") or args.get("service")
        if not name:
            raise ToolError("missing service name")
        _systemctl(verb, name)
        return {"service": name, "action": verb}

    return handler


def service_status(args: dict) -> dict:
    name = args.get("name") or args.get("service")
    if not name:
        raise ToolError("missing service name")
    try:
        out = run_cmd(["systemctl", "is-active", name], timeout=10)
        state = out["stdout"].strip()
    except ToolError:
        state = "inactive-or-unknown"
    return {"service": name, "state": state}


# ---------------------------------------------------------------------------
# monitor.*
# ---------------------------------------------------------------------------


def monitor_cpu(args: dict) -> dict:
    return {
        "percent": psutil.cpu_percent(interval=float(args.get("interval", 0.1))),
        "per_core": psutil.cpu_percent(percpu=True),
        "load_avg": list(os.getloadavg()),
        "cores": psutil.cpu_count(),
    }


def monitor_memory(args: dict) -> dict:
    vm = psutil.virtual_memory()
    swap = psutil.swap_memory()
    return {
        "total_mb": round(vm.total / 1e6, 1),
        "used_mb": round(vm.used / 1e6, 1),
        "available_mb": round(vm.available / 1e6, 1),
        "percent": vm.percent,
        "swap_used_mb": round(swap.used / 1e6, 1),
    }


def monitor_disk(args: dict) -> dict:
    parts = []
    for part in psutil.disk_partitions(all=False):
        try:
            usage = psutil.disk_usage(part.mountpoint)
        except OSError:
            continue
        parts.append(
            {
                "mount": part.mountpoint,
                "fstype": part.fstype,
                "total_gb": round(usage.total / 1e9, 2),
                "percent": usage.percent,
            }
        )
    return {"partitions": parts}


def monitor_network(args: dict) -> dict:
    io = psutil.net_io_counters()
    return {
        "bytes_sent": io.bytes_sent,
        "bytes_recv": io.bytes_recv,
        "packets_sent": io.packets_sent,
        "packets_recv": io.packets_recv,
        "errin": io.errin,
        "errout": io.errout,
    }


def monitor_logs(args: dict) -> dict:
    source = args.get("source", "")
    lines = int(args.get("lines", 50))
    if source and Path(source).is_file():
        text = Path(source).read_text(errors="replace").splitlines()[-lines:]
        return {"source": source, "lines": text}
    out = run_cmd(["journalctl", "-n", str(lines), "--no-pager"], timeout=20)
    return {"source": "journalctl", "lines": out["stdout"].splitlines()}


def monitor_ebpf_trace(args: dict) -> dict:
    # the reference shells out to bpftrace; degrade identically when missing
    probe = args.get("probe", "tracepoint:syscalls:sys_enter_execve")
    duration = min(int(args.get("duration", 5)), 30)
    out = run_cmd(
        ["timeout", str(duration), "bpftrace", "-e", f"{probe} {{ printf(\"%s\\n\", comm); }}"],
        timeout=duration + 10,
    )
    return {"probe": probe, "output": out["stdout"].splitlines()[:200]}


def monitor_fs_watch(args: dict) -> dict:
    """Poll-based change snapshot (no inotify dependency): two stats."""
    path = Path(args.get("path", "/tmp"))
    interval = min(float(args.get("interval", 1.0)), 10.0)
    if not path.is_dir():
        raise ToolError(f"{path} is not a directory")

    def snap():
        return {
            str(f): f.stat().st_mtime
            for f in list(path.iterdir())[:500]
            if f.exists()
        }

    before = snap()
    time.sleep(interval)
    after = snap()
    changed = [f for f in after if before.get(f) != after[f]]
    added = [f for f in after if f not in before]
    removed = [f for f in before if f not in after]
    return {"path": str(path), "changed": changed, "added": added,
            "removed": removed}


# ---------------------------------------------------------------------------
# hw.info
# ---------------------------------------------------------------------------


def hw_info(args: dict) -> dict:
    cpu_model = ""
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                cpu_model = line.split(":", 1)[1].strip()
                break
    except OSError:
        pass
    info = {
        "cpu_model": cpu_model,
        "cpu_cores": psutil.cpu_count(logical=False) or psutil.cpu_count(),
        "cpu_threads": psutil.cpu_count(),
        "memory_total_mb": round(psutil.virtual_memory().total / 1e6),
        "boot_time": int(psutil.boot_time()),
    }
    # accelerator presence: the port serves on CUDA devices
    try:
        import torch

        info["accelerators"] = [
            f"cuda:{i} {torch.cuda.get_device_name(i)}"
            for i in range(torch.cuda.device_count())
        ]
        info["accelerator_backend"] = "cuda" if info["accelerators"] else "cpu"
    except Exception:
        info["accelerators"] = []
    return info


TOOLS = {
    "process.list": ToolSpec(process_list, "List processes by cpu/mem",
                             idempotent=True),
    "process.spawn": ToolSpec(process_spawn, "Spawn a detached process"),
    "process.kill": ToolSpec(process_kill, "Send a signal to a process",
                             requires_confirmation=True),
    "process.info": ToolSpec(process_info, "Details for one pid",
                             idempotent=True),
    "process.signal": ToolSpec(process_signal, "Send a specific signal"),
    "process.cgroup": ToolSpec(process_cgroup, "Read a pid's cgroup info",
                               idempotent=True),
    "service.list": ToolSpec(service_list, "List systemd services",
                             idempotent=True),
    "service.start": ToolSpec(_service_verb("start"), "Start a service"),
    "service.stop": ToolSpec(_service_verb("stop"), "Stop a service",
                             requires_confirmation=True),
    "service.restart": ToolSpec(_service_verb("restart"), "Restart a service"),
    "service.status": ToolSpec(service_status, "Service active state",
                               idempotent=True),
    "monitor.cpu": ToolSpec(monitor_cpu, "CPU utilization", idempotent=True),
    "monitor.memory": ToolSpec(monitor_memory, "Memory usage", idempotent=True),
    "monitor.disk": ToolSpec(monitor_disk, "Disk usage by partition",
                             idempotent=True),
    "monitor.network": ToolSpec(monitor_network, "Network IO counters",
                                idempotent=True),
    "monitor.logs": ToolSpec(monitor_logs, "Tail a log file or the journal",
                             idempotent=True),
    "monitor.ebpf_trace": ToolSpec(monitor_ebpf_trace,
                                   "Short bpftrace capture"),
    "monitor.fs_watch": ToolSpec(monitor_fs_watch,
                                 "Watch a directory for changes"),
    "hw.info": ToolSpec(hw_info, "Hardware summary incl. TPU devices",
                        idempotent=True),
}
