"""Proactive goal generation.

Reference parity (agent-core/src/proactive.rs): a 60 s loop that auto-creates
remediation goals on CPU > 90%, memory > 85%, disk > 90%, failed agents,
>= 6 consecutive service-health failures, TLS certs expiring within 30 days,
and backups staler than 24 h (proactive.rs:74-200), deduplicating against
already-active goals.

TPU-serving extension (no reference counterpart — llama-server exposes no
serving counters): the runtime HealthCheck's per-model serving stats feed
two escalations, mirroring the reference's health->goal pattern
(proactive.rs:144-159):
  * KV page-pool exhaustion — pool_evictions GREW since the last pass:
    live streams are being truncated to admit new work (pool undersized
    or a runaway long context);
  * slot starvation — requests queued behind full slots
    (waiting > 0 with every slot active) on two CONSECUTIVE passes, so a
    transient burst does not page anyone.
"""

from __future__ import annotations

import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional

import psutil


@dataclass
class ProactiveConfig:
    interval: float = 60.0
    cpu_threshold: float = 90.0
    memory_threshold: float = 85.0
    disk_threshold: float = 90.0
    health_failure_threshold: int = 6
    cert_warning_days: int = 30
    backup_max_age_hours: float = 24.0
    cert_dir: str = "/tmp/aios/certs"
    backup_dir: str = "/tmp/aios/backups"
    # serving escalations: consecutive starved passes before a goal
    starvation_threshold: int = 2


class ProactiveGenerator:
    def __init__(
        self,
        submit_goal: Callable[[str, int], object],
        active_goal_descriptions: Callable[[], List[str]],
        health_failures: Optional[Callable[[], dict]] = None,
        failed_agents: Optional[Callable[[], List[str]]] = None,
        serving_stats: Optional[Callable[[], dict]] = None,
        config: Optional[ProactiveConfig] = None,
    ):
        self.submit_goal = submit_goal
        self.active_goal_descriptions = active_goal_descriptions
        self.health_failures = health_failures
        self.failed_agents = failed_agents
        # model name -> {counter: float} from the runtime HealthCheck
        # (orchestrator/main.py parses the `<model>.serving` details)
        self.serving_stats = serving_stats
        self.config = config or ProactiveConfig()
        self._evictions_seen: dict = {}
        self._starved_passes: dict = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _maybe_submit(self, description: str, priority: int) -> bool:
        """Dedupe against active goals (proactive.rs dedupe). The key is
        the description up to its first parenthetical — the parentheses
        hold volatile readings (percentages, counts) while the prefix
        carries the condition AND its subject (e.g. the model name), so
        per-model escalations never collapse into one key."""
        key = description.split("(")[0].strip().lower()[:80]
        for active in self.active_goal_descriptions():
            if key in active.lower():
                return False
        self.submit_goal(description, priority)
        return True

    def check_once(self) -> List[str]:
        """One pass; returns descriptions of goals created."""
        cfg = self.config
        created: List[str] = []

        cpu = psutil.cpu_percent(interval=None)
        if cpu > cfg.cpu_threshold:
            if self._maybe_submit(
                f"Investigate and reduce high CPU usage ({cpu:.0f}%)", 8
            ):
                created.append("cpu")

        mem = psutil.virtual_memory().percent
        if mem > cfg.memory_threshold:
            if self._maybe_submit(
                f"Investigate and reduce high memory usage ({mem:.0f}%)", 8
            ):
                created.append("memory")

        disk = psutil.disk_usage("/").percent
        if disk > cfg.disk_threshold:
            if self._maybe_submit(
                f"Free disk space on / (at {disk:.0f}%)", 9
            ):
                created.append("disk")

        if self.failed_agents is not None:
            for agent in self.failed_agents():
                if self._maybe_submit(
                    f"Recover failed agent {agent}", 7
                ):
                    created.append(f"agent:{agent}")

        if self.health_failures is not None:
            for service, failures in self.health_failures().items():
                if failures >= cfg.health_failure_threshold:
                    if self._maybe_submit(
                        f"Remediate unhealthy service {service}"
                        f" ({failures} consecutive failures)", 9
                    ):
                        created.append(f"service:{service}")

        created.extend(self._check_certs())
        created.extend(self._check_backups())
        created.extend(self._check_serving())
        return created

    def _check_serving(self) -> List[str]:
        """TPU serving escalations from the runtime's per-model counters."""
        if self.serving_stats is None:
            return []
        created: List[str] = []
        try:
            per_model = self.serving_stats() or {}
        except Exception:  # noqa: BLE001 — runtime down is the health
            return []      # checker's escalation, not this one's
        for model, stats in per_model.items():
            ev = stats.get("pool_evictions", 0)
            first_sighting = model not in self._evictions_seen
            last = self._evictions_seen.get(model, ev)
            self._evictions_seen[model] = ev
            # pool_evictions is cumulative since RUNTIME start: on this
            # generator's first sighting only record the baseline, or an
            # orchestrator restart would report days-old evictions as new
            if not first_sighting and ev > last:
                if self._maybe_submit(
                    f"Investigate KV page-pool exhaustion on model {model}"
                    f" ({int(ev - last)} stream(s) evicted since last"
                    " check; grow paged_kv_rows or shorten contexts)", 8,
                ):
                    created.append(f"pool:{model}")
            slots = stats.get("num_slots", 0)
            starved = (
                stats.get("waiting", 0) > 0
                and slots > 0
                and stats.get("active_slots", 0) >= slots
            )
            if starved:
                n = self._starved_passes.get(model, 0) + 1
                self._starved_passes[model] = n
                if n >= self.config.starvation_threshold:
                    if self._maybe_submit(
                        f"Relieve request starvation on model {model}"
                        f" (all {int(slots)} slots busy with"
                        f" {int(stats.get('waiting', 0))} request(s)"
                        " queued; raise num_slots or add a replica)", 7,
                    ):
                        created.append(f"starvation:{model}")
            else:
                self._starved_passes[model] = 0
        return created

    def _check_certs(self) -> List[str]:
        created = []
        cert_dir = Path(self.config.cert_dir)
        if not cert_dir.is_dir():
            return created
        for cert in cert_dir.glob("*.crt"):
            days = cert_expiry_days(str(cert))
            if days is not None and days < self.config.cert_warning_days:
                if self._maybe_submit(
                    f"Rotate TLS certificate {cert.name}"
                    f" (expires in {days} days)", 6
                ):
                    created.append(f"cert:{cert.name}")
        return created

    def _check_backups(self) -> List[str]:
        backup_dir = Path(self.config.backup_dir)
        if not backup_dir.is_dir():
            return []
        newest = 0.0
        for f in backup_dir.iterdir():
            try:
                newest = max(newest, f.stat().st_mtime)
            except OSError:
                continue
        if newest == 0.0:
            return []
        age_hours = (time.time() - newest) / 3600
        if age_hours > self.config.backup_max_age_hours:
            if self._maybe_submit(
                f"Run system backup (last backup {age_hours:.0f}h ago)", 5
            ):
                return ["backup"]
        return []

    def start(self) -> None:
        def loop():
            while not self._stop.wait(self.config.interval):
                try:
                    self.check_once()
                except Exception:  # noqa: BLE001
                    pass

        self._thread = threading.Thread(target=loop, name="proactive",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)


def cert_expiry_days(cert_path: str) -> Optional[int]:
    """Days until a PEM cert expires (openssl-based; rcgen in the reference)."""
    try:
        out = subprocess.run(
            ["openssl", "x509", "-enddate", "-noout", "-in", cert_path],
            capture_output=True, text=True, timeout=10,
        )
        if out.returncode != 0:
            return None
        # notAfter=Jan  1 00:00:00 2027 GMT
        raw = out.stdout.strip().split("=", 1)[1]
        expiry = time.mktime(time.strptime(raw, "%b %d %H:%M:%S %Y %Z"))
        return int((expiry - time.time()) / 86400)
    except (OSError, ValueError, IndexError):
        return None
