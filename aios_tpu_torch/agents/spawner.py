"""Agent process spawner + supervisor.

Reference parity (agent-core/src/agent_spawner.rs): loads per-agent TOML
configs from the config dir (defaults to system/network/security when none
exist, agent_spawner.rs:140-175), spawns `python3 -m aios_tpu_torch.agents.run`
child processes with AIOS_AGENT_NAME/AIOS_AGENT_TYPE/AIOS_ORCHESTRATOR_ADDR
in the environment (179-218), and monitors/restarts them with a cap of 5
restarts at 5 s delay (agent_spawner.rs:118-119).
"""

from __future__ import annotations

import logging
import os
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

from . import AGENT_TYPES
from .._compat import tomllib
from ..obs import instruments as obs

log = logging.getLogger("aios.spawner")

MAX_RESTARTS = 5
RESTART_DELAY = 5.0
DEFAULT_AGENTS = ["system", "network", "security"]


@dataclass
class AgentConfig:
    name: str
    agent_type: str
    enabled: bool = True
    env: Dict[str, str] = field(default_factory=dict)


@dataclass
class SpawnedAgent:
    config: AgentConfig
    process: Optional[subprocess.Popen] = None
    restarts: int = 0
    gave_up: bool = False


def load_agent_configs(config_dir: Optional[str] = None) -> List[AgentConfig]:
    config_dir = config_dir or os.environ.get(
        "AIOS_AGENT_CONFIG_DIR", "/etc/aios/agents"
    )
    d = Path(config_dir)
    configs: List[AgentConfig] = []
    if d.is_dir():
        for f in sorted(d.glob("*.toml")):
            try:
                data = tomllib.loads(f.read_text())
            except (OSError, ValueError):
                continue
            section = data.get("agent", data)
            atype = section.get("type", f.stem)
            if atype not in AGENT_TYPES:
                continue
            configs.append(
                AgentConfig(
                    name=section.get("name", f"{atype}_agent"),
                    agent_type=atype,
                    enabled=section.get("enabled", True),
                    env={k: str(v) for k, v in data.get("env", {}).items()},
                )
            )
    if not configs:  # defaults (agent_spawner.rs:140-175)
        configs = [
            AgentConfig(name=f"{t}_agent", agent_type=t) for t in DEFAULT_AGENTS
        ]
    return [c for c in configs if c.enabled]


class AgentSpawner:
    def __init__(self, config_dir: Optional[str] = None,
                 orchestrator_addr: Optional[str] = None):
        from ..services import service_address

        self.configs = load_agent_configs(config_dir)
        self.orchestrator_addr = orchestrator_addr or service_address(
            "orchestrator"
        )
        self.spawned: Dict[str, SpawnedAgent] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _spawn(self, entry: SpawnedAgent) -> None:
        cfg = entry.config
        env = {
            **os.environ,
            "AIOS_AGENT_NAME": cfg.name,
            "AIOS_AGENT_TYPE": cfg.agent_type,
            "AIOS_ORCHESTRATOR_ADDR": self.orchestrator_addr,
            **cfg.env,
        }
        entry.process = subprocess.Popen(
            [sys.executable, "-m", "aios_tpu_torch.agents.run"],
            env=env,
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        )
        log.info("spawned %s (pid %d)", cfg.name, entry.process.pid)

    def start(self) -> None:
        for cfg in self.configs:
            entry = SpawnedAgent(config=cfg)
            self.spawned[cfg.name] = entry
            try:
                self._spawn(entry)
            except OSError as exc:
                log.error("spawn %s failed: %s", cfg.name, exc)
        self._thread = threading.Thread(target=self._monitor_loop,
                                        name="agent-spawner", daemon=True)
        self._thread.start()

    def _monitor_loop(self) -> None:
        while not self._stop.wait(RESTART_DELAY):
            for entry in self.spawned.values():
                p = entry.process
                if p is None or entry.gave_up:
                    continue
                if p.poll() is None:
                    continue  # still running
                if entry.restarts >= MAX_RESTARTS:
                    entry.gave_up = True
                    log.error("agent %s exceeded %d restarts; giving up",
                              entry.config.name, MAX_RESTARTS)
                    continue
                entry.restarts += 1
                obs.AGENT_RESTARTS.labels(agent=entry.config.name).inc()
                log.warning("agent %s exited (%s); restart %d/%d",
                            entry.config.name, p.returncode,
                            entry.restarts, MAX_RESTARTS)
                try:
                    self._spawn(entry)
                except OSError as exc:
                    log.error("respawn failed: %s", exc)

    def failed_agents(self) -> List[str]:
        return [name for name, e in self.spawned.items() if e.gave_up]

    def stop(self) -> None:
        self._stop.set()
        for entry in self.spawned.values():
            if entry.process and entry.process.poll() is None:
                entry.process.terminate()
        deadline = time.time() + 5
        for entry in self.spawned.values():
            if entry.process:
                try:
                    entry.process.wait(timeout=max(0.1, deadline - time.time()))
                except subprocess.TimeoutExpired:
                    entry.process.kill()
        if self._thread:
            self._thread.join(timeout=5)
