"""Service supervisor: topo-sorted start, health gates, restart caps.

Reference parity (initd/src/{main,service}.rs):
  * dependency-ordered startup via topological sort — runtime, memory,
    tools, gateway start first; the orchestrator depends on all four
    (initd/src/main.rs:74-131);
  * each service is spawned as a child process and gated on a TCP health
    probe before dependents start (ServiceSupervisor::wait_for_health,
    service.rs:42-82);
  * supervision loop reaps exits and restarts within a capped window
    (service.rs:97-129 + config [boot] max_restart_attempts);
  * clean-shutdown flag file (initd main.rs:161); a fatal boot error raises
    instead of the reference's emergency shell (we are not PID 1).

The mount/hostname/first-boot duties of the reference's PID-1 do not apply
on a managed TPU-VM host and are intentionally absent.
"""

from __future__ import annotations

import logging
import os
import socket
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

from .config import AiosConfig, load_config

log = logging.getLogger("aios.boot")


@dataclass
class ServiceDef:
    name: str
    module: str  # python -m <module>
    port: int
    deps: List[str] = field(default_factory=list)
    env: Dict[str, str] = field(default_factory=dict)
    args: List[str] = field(default_factory=list)  # after -m <module>


def default_services(config=None) -> Dict[str, ServiceDef]:
    """The five-service topology. With a boot ``config``, the [models]
    serving knobs translate into AIOS_TPU_* env for every child
    (boot/config.serving_env) — one TOML section drives the whole stack's
    serving mode, like the reference's config.toml -> service flags."""
    from ..services import DEFAULT_PORTS

    env: Dict[str, str] = {}
    if config is not None:
        from .config import serving_env

        env = serving_env(config)
    return {
        "runtime": ServiceDef("runtime", "aios_tpu_torch.runtime.service",
                              DEFAULT_PORTS["runtime"], env=dict(env)),
        "memory": ServiceDef("memory", "aios_tpu_torch.memory.service",
                             DEFAULT_PORTS["memory"], env=dict(env)),
        "tools": ServiceDef("tools", "aios_tpu_torch.tools.service",
                            DEFAULT_PORTS["tools"], env=dict(env)),
        "gateway": ServiceDef("gateway", "aios_tpu_torch.gateway.service",
                              DEFAULT_PORTS["gateway"], env=dict(env)),
        "orchestrator": ServiceDef(
            "orchestrator", "aios_tpu_torch.orchestrator.main",
            DEFAULT_PORTS["orchestrator"],
            deps=["runtime", "memory", "tools", "gateway"],
            env=dict(env),
        ),
    }


def topo_sort(services: Dict[str, ServiceDef]) -> List[str]:
    """Dependency-ordered service names (initd main.rs:74-131)."""
    order: List[str] = []
    seen: Dict[str, int] = {}  # 0=visiting, 1=done

    def visit(name: str) -> None:
        state = seen.get(name)
        if state == 1:
            return
        if state == 0:
            raise ValueError(f"dependency cycle at {name}")
        seen[name] = 0
        for dep in services[name].deps:
            visit(dep)
        seen[name] = 1
        order.append(name)

    for name in services:
        visit(name)
    return order


@dataclass
class Supervised:
    definition: ServiceDef
    process: Optional[subprocess.Popen] = None
    restarts: int = 0
    restart_times: List[float] = field(default_factory=list)
    gave_up: bool = False


class Supervisor:
    def __init__(
        self,
        config: Optional[AiosConfig] = None,
        services: Optional[Dict[str, ServiceDef]] = None,
    ):
        self.config = config or load_config()
        # default topology picks up the config's [models] serving knobs
        # (serving_env) so the TOML drives the whole stack's serving mode
        self.services = services or default_services(self.config)
        self.supervised: Dict[str, Supervised] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.max_restarts = int(self.config.get("boot", "max_restart_attempts", 5))
        self.restart_window = float(
            self.config.get("boot", "restart_window_seconds", 300)
        )
        self.health_timeout = float(
            self.config.get("boot", "health_timeout_seconds", 60)
        )

    # -- health -------------------------------------------------------------

    @staticmethod
    def port_open(port: int, host: str = "127.0.0.1", timeout: float = 1.0) -> bool:
        try:
            with socket.create_connection((host, port), timeout=timeout):
                return True
        except OSError:
            return False

    def wait_for_health(self, name: str) -> bool:
        port = self.services[name].port
        deadline = time.time() + self.health_timeout
        while time.time() < deadline:
            if self.port_open(port):
                return True
            entry = self.supervised.get(name)
            if entry and entry.process and entry.process.poll() is not None:
                return False  # died during startup
            time.sleep(0.5)
        return False

    # -- lifecycle ----------------------------------------------------------

    def _spawn(self, entry: Supervised) -> None:
        d = entry.definition
        env = {**os.environ, **d.env}
        entry.process = subprocess.Popen(
            [sys.executable, "-m", d.module, *d.args],
            env=env,
            stdout=subprocess.DEVNULL,
            stderr=subprocess.STDOUT,
        )
        log.info("started %s (pid %d, :%d)", d.name, entry.process.pid, d.port)

    def boot(self) -> List[str]:
        """Start everything in dependency order; returns started names."""
        started = []
        flag = Path(self.config.data_dir) / "clean-shutdown"
        flag.unlink(missing_ok=True)
        for name in topo_sort(self.services):
            entry = Supervised(definition=self.services[name])
            self.supervised[name] = entry
            self._spawn(entry)
            if not self.wait_for_health(name):
                raise RuntimeError(
                    f"service {name} failed its health gate within "
                    f"{self.health_timeout}s"
                )
            started.append(name)
        self._thread = threading.Thread(target=self._supervise_loop,
                                        name="supervisor", daemon=True)
        self._thread.start()
        log.info("aiOS boot complete: %s", ", ".join(started))
        return started

    def _supervise_loop(self) -> None:
        while not self._stop.wait(2.0):
            for entry in self.supervised.values():
                p = entry.process
                if p is None or entry.gave_up or p.poll() is None:
                    continue
                now = time.time()
                entry.restart_times = [
                    t for t in entry.restart_times
                    if now - t < self.restart_window
                ]
                if len(entry.restart_times) >= self.max_restarts:
                    entry.gave_up = True
                    log.error("%s exceeded restart cap; giving up",
                              entry.definition.name)
                    continue
                entry.restarts += 1
                entry.restart_times.append(now)
                log.warning("%s exited (%s); restarting (%d in window)",
                            entry.definition.name, p.returncode,
                            len(entry.restart_times))
                try:
                    self._spawn(entry)
                except OSError as exc:
                    log.error("respawn %s failed: %s",
                              entry.definition.name, exc)

    def shutdown(self, clean: bool = True) -> None:
        """Tear down the service tree. clean=False reaps children after a
        FAILED boot without writing the clean-shutdown flag — the flag is
        how the next boot distinguishes a deliberate stop from a crash
        (reference initd main.rs:161), so a failed run must not bless
        itself."""
        self._stop.set()
        # reverse dependency order
        for name in reversed(topo_sort(self.services)):
            entry = self.supervised.get(name)
            if entry and entry.process and entry.process.poll() is None:
                entry.process.terminate()
        deadline = time.time() + 10
        for entry in self.supervised.values():
            if entry.process:
                try:
                    entry.process.wait(timeout=max(0.1, deadline - time.time()))
                except subprocess.TimeoutExpired:
                    entry.process.kill()
        if self._thread:
            self._thread.join(timeout=5)
        if clean:
            flag_dir = Path(self.config.data_dir)
            flag_dir.mkdir(parents=True, exist_ok=True)
            (flag_dir / "clean-shutdown").write_text(str(int(time.time())))
            log.info("clean shutdown complete")
        else:
            log.info("service tree reaped after failed boot (not clean)")


def main() -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    from .hardware import detect

    hw = detect()
    log.info(
        "hardware: %d cores, %d MB RAM, TPU=%s",
        hw.cpu_threads, hw.memory_total_mb,
        ",".join(hw.tpu_devices) or "none",
    )
    sup = Supervisor()

    # SIGTERM must shut the tree down like SIGINT does: systemd's stop,
    # a bare `kill`, and container runtimes all send TERM — without this
    # the supervisor dies and ORPHANS all five services plus the agents
    # (the reference's initd reaps its tree the same way)
    import signal

    def _term(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _term)

    # boot() runs inside the try: it spawns five services sequentially and
    # waits for readiness, a long window during which TERM/INT must still
    # tear down the partially-booted tree instead of orphaning it
    try:
        sup.boot()
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        sup.shutdown()
    except Exception:
        # a failed boot (e.g. a service missing its health gate) must also
        # tear down whatever did spawn before the error surfaces
        sup.shutdown(clean=False)
        raise
    return 0


if __name__ == "__main__":
    sys.exit(main())
