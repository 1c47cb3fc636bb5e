"""The 10 system agents.

Reference parity (agent-core/python/aios_agent/agents/, 5,078 LoC): same set
of 10 agent types with the same duty cycles — system (health loop 30 s),
network (connectivity loop 60 s against 8.8.8.8/1.1.1.1/9.9.9.9), security
(intrusion/rootkit/ports/integrity), package, monitoring (30 s collection +
rolling-baseline anomaly detection over 100 points), learning (5-minute
learning cycle over patterns/decisions), storage, task (general executor),
web, creator. Task handling is keyword dispatch over call_tool/think, as in
the reference agents.
"""

from __future__ import annotations

import collections
import json
import statistics
import time
from typing import Any, Dict, List

from ..proto_gen import common_pb2
from .base import BaseAgent


class SystemAgent(BaseAgent):
    """Service/process health keeper (reference system.py)."""

    periodic_interval = 30.0

    def get_agent_type(self) -> str:
        return "system"

    def get_capabilities(self) -> List[str]:
        return ["fs.read", "fs.write", "process.read", "process.manage",
                "service.read", "service.manage", "monitor.read", "hw.read"]

    def get_tool_namespaces(self) -> List[str]:
        return ["fs", "process", "service", "monitor", "hw"]

    def periodic(self) -> None:
        health = self.call_tool("self.health")
        if not health["success"]:
            return
        down = [s for s, state in health["output"]["services"].items()
                if state == "down"]
        if down:
            self.push_event("system.services_down", {"services": down},
                            critical=True)
        self.update_metric("system.services_down", float(len(down)))

    def handle_task(self, task: Dict[str, Any]) -> Dict[str, Any]:
        desc = task["description"].lower()
        if "restart" in desc:
            name = task["input"].get("service") or _extract_service_name(desc)
            if not name:
                raise ValueError("no service name found in task")
            status = self.call_tool("service.status", {"name": name})
            result = self.call_tool("service.restart", {"name": name},
                                    reason=task["description"])
            if not result["success"]:
                raise RuntimeError(result["error"])
            after = self.call_tool("service.status", {"name": name})
            return {"service": name, "before": status["output"],
                    "after": after["output"]}
        if "process" in desc and ("list" in desc or "top" in desc):
            return self.call_tool("process.list", {"limit": 15})["output"]
        if "hardware" in desc or "hw" in desc:
            return self.call_tool("hw.info")["output"]
        if "status" in desc or "health" in desc or "check" in desc:
            return {
                "cpu": self.call_tool("monitor.cpu")["output"],
                "memory": self.call_tool("monitor.memory")["output"],
                "services": self.call_tool("self.health")["output"],
            }
        return self._generic(task)

    def _generic(self, task):
        out = self.call_tool("monitor.cpu")
        return {"note": "system agent default health snapshot",
                "cpu": out["output"]}


class NetworkAgent(BaseAgent):
    """Connectivity watchdog + firewall hands (reference network.py)."""

    periodic_interval = 60.0
    PROBE_HOSTS = ("8.8.8.8", "1.1.1.1", "9.9.9.9")

    def get_agent_type(self) -> str:
        return "network"

    def get_capabilities(self) -> List[str]:
        return ["net.diagnose", "net.scan", "firewall.read",
                "firewall.manage", "monitor.read"]

    def get_tool_namespaces(self) -> List[str]:
        return ["net", "firewall", "monitor"]

    def periodic(self) -> None:
        reachable = 0
        for host in self.PROBE_HOSTS:
            res = self.call_tool("net.ping", {"host": host, "count": 1})
            if res["success"] and res["output"].get("reachable"):
                reachable += 1
        self.update_metric("network.reachable_probes", float(reachable))
        if reachable == 0:
            self.push_event("network.offline",
                            {"probes": list(self.PROBE_HOSTS)}, critical=True)

    def handle_task(self, task: Dict[str, Any]) -> Dict[str, Any]:
        desc = task["description"].lower()
        if "interface" in desc:
            return self.call_tool("net.interfaces")["output"]
        if "ping" in desc or "connectivity" in desc or "reachab" in desc:
            results = {}
            for host in task["input"].get("hosts", self.PROBE_HOSTS):
                results[host] = self.call_tool("net.ping",
                                               {"host": host})["output"]
            return {"probes": results}
        if "dns" in desc or "resolve" in desc:
            host = task["input"].get("host", "example.com")
            return self.call_tool("net.dns", {"host": host})["output"]
        if "port" in desc or "scan" in desc:
            return self.call_tool("net.port_scan",
                                  task["input"] or {})["output"]
        if "firewall" in desc:
            return self.call_tool("firewall.rules")["output"]
        return {"interfaces": self.call_tool("net.interfaces")["output"]}


class SecurityAgent(BaseAgent):
    """Scans + audit monitoring (reference security.py)."""

    periodic_interval = 300.0

    def get_agent_type(self) -> str:
        return "security"

    def get_capabilities(self) -> List[str]:
        return ["sec.audit", "sec.admin", "fs.read", "process.read",
                "monitor.read", "net.scan"]

    def get_tool_namespaces(self) -> List[str]:
        return ["sec", "monitor", "net"]

    def periodic(self) -> None:
        audit = self.call_tool("sec.audit")
        if audit["success"] and not audit["output"].get("chain_valid", True):
            self.push_event("security.audit_chain_broken", audit["output"],
                            critical=True)

    def handle_task(self, task: Dict[str, Any]) -> Dict[str, Any]:
        desc = task["description"].lower()
        if "rootkit" in desc:
            return self.call_tool("sec.scan_rootkits")["output"]
        if "integrity" in desc:
            path = task["input"].get("path", "/etc")
            return self.call_tool("sec.file_integrity", {"path": path})["output"]
        if "cert" in desc or "tls" in desc:
            return self.call_tool("sec.cert_rotate",
                                  task["input"] or {})["output"]
        if "audit" in desc:
            return {
                "chain": self.call_tool("sec.audit")["output"],
                "recent": self.call_tool("sec.audit_query",
                                         {"limit": 20})["output"],
            }
        if "perm" in desc or "suid" in desc:
            return self.call_tool("sec.check_perms",
                                  task["input"] or {})["output"]
        # full sweep default
        return {
            "ports": self.call_tool("sec.scan")["output"],
            "rootkits": self.call_tool("sec.scan_rootkits")["output"],
            "perms": self.call_tool("sec.check_perms",
                                    {"path": "/tmp"})["output"],
        }


class PackageAgent(BaseAgent):
    """Package management (reference package.py)."""

    periodic_interval = 3600.0

    def get_agent_type(self) -> str:
        return "package"

    def get_capabilities(self) -> List[str]:
        return ["pkg.read", "pkg.manage", "fs.read"]

    def get_tool_namespaces(self) -> List[str]:
        return ["pkg"]

    def handle_task(self, task: Dict[str, Any]) -> Dict[str, Any]:
        desc = task["description"].lower()
        name = task["input"].get("name") or _last_word(desc)
        if "install" in desc:
            found = self.call_tool("pkg.search", {"query": name})
            if not found["success"] or not found["output"].get("results"):
                raise RuntimeError(f"package {name!r} not found")
            result = self.call_tool("pkg.install", {"name": name},
                                    reason=task["description"])
            if not result["success"]:
                raise RuntimeError(result["error"])
            return result["output"]
        if "remove" in desc or "uninstall" in desc:
            return self.call_tool("pkg.remove", {"name": name})["output"]
        if "update" in desc or "upgrade" in desc:
            return self.call_tool("pkg.update")["output"]
        if "search" in desc:
            return self.call_tool("pkg.search", {"query": name})["output"]
        return self.call_tool("pkg.list_installed", {"limit": 100})["output"]


class MonitoringAgent(BaseAgent):
    """Metric collection + rolling-baseline anomaly detection
    (reference monitoring.py:20-23; 100-point baseline)."""

    periodic_interval = 30.0
    BASELINE_POINTS = 100
    ANOMALY_SIGMA = 3.0

    def __init__(self, name=None):
        super().__init__(name)
        self._history: Dict[str, collections.deque] = collections.defaultdict(
            lambda: collections.deque(maxlen=self.BASELINE_POINTS)
        )

    def get_agent_type(self) -> str:
        return "monitoring"

    def get_capabilities(self) -> List[str]:
        return ["monitor.read", "fs.read", "process.read", "hw.read"]

    def get_tool_namespaces(self) -> List[str]:
        return ["monitor", "hw"]

    def observe(self, key: str, value: float) -> bool:
        """Record a point; True if it is anomalous vs the rolling baseline.

        The stdev floor is scale-proportional, not epsilon: counters that
        sit perfectly flat while idle (KV pages free overnight) would
        otherwise flag the first 1-unit move after a zero-variance
        baseline as a 3-sigma event and spam anomalies on every routine
        transition."""
        hist = self._history[key]
        anomalous = False
        if len(hist) >= 10:
            mean = statistics.fmean(hist)
            stdev = max(statistics.pstdev(hist), 0.01 * abs(mean), 1e-9)
            anomalous = abs(value - mean) > self.ANOMALY_SIGMA * stdev
        hist.append(value)
        return anomalous

    def periodic(self) -> None:
        cpu = self.call_tool("monitor.cpu")["output"].get("percent", 0.0)
        mem = self.call_tool("monitor.memory")["output"].get("percent", 0.0)
        self.update_metric("cpu.percent", cpu)
        self.update_metric("memory.percent", mem)
        for key, value in (("cpu.percent", cpu), ("memory.percent", mem)):
            if self.observe(key, value):
                self.push_event(
                    "monitoring.anomaly",
                    {"metric": key, "value": value},
                    critical=value > 95,
                )
        self.collect_serving_metrics()

    def collect_serving_metrics(self) -> None:
        """Scrape the TPU runtime's per-model serving counters
        (HealthCheck `<model>.serving` details: spec acceptance, KV page
        usage, prefix hits — runtime/service.py) into the memory service's
        metric store, with the same rolling-baseline anomaly detection as
        the system metrics. Quietly skips when the runtime is down — its
        own health is the health checker's job."""
        try:
            h = self.runtime.HealthCheck(common_pb2.Empty(), timeout=5)
            items = list(h.details.items())
        except Exception:  # noqa: BLE001 — runtime absent/restarting
            return
        for key, blob in items:
            if not key.endswith(".serving"):
                continue
            model = key[: -len(".serving")]
            for pair in blob.split(","):
                name, _, raw = pair.partition("=")
                try:
                    value = float(raw)
                except ValueError:
                    continue
                metric = f"runtime.{model}.{name}"
                self.update_metric(metric, value)
                if name in ("kv_pages_free", "spec_tokens_per_round"):
                    if self.observe(metric, value):
                        self.push_event(
                            "monitoring.anomaly",
                            {"metric": metric, "value": value},
                            critical=name == "kv_pages_free" and value == 0,
                        )

    def handle_task(self, task: Dict[str, Any]) -> Dict[str, Any]:
        desc = task["description"].lower()
        if "log" in desc:
            return self.call_tool("monitor.logs", task["input"] or {})["output"]
        if "network" in desc:
            return self.call_tool("monitor.network")["output"]
        if "disk" in desc:
            return self.call_tool("monitor.disk")["output"]
        if "memory" in desc:
            return self.call_tool("monitor.memory")["output"]
        return {
            "cpu": self.call_tool("monitor.cpu")["output"],
            "memory": self.call_tool("monitor.memory")["output"],
            "disk": self.call_tool("monitor.disk")["output"],
        }


class LearningAgent(BaseAgent):
    """5-minute learning cycle over events/decisions (reference
    learning.py:24,698-732): pattern extraction + tool-effectiveness stats."""

    periodic_interval = 300.0

    def get_agent_type(self) -> str:
        return "learning"

    def get_capabilities(self) -> List[str]:
        return ["monitor.read", "fs.read"]

    def get_tool_namespaces(self) -> List[str]:
        return ["monitor"]

    def periodic(self) -> None:
        self.learn_cycle()

    def learn_cycle(self) -> Dict[str, Any]:
        events = self.get_recent_events(count=100)
        by_category = collections.Counter(e["category"] for e in events)
        learned = []
        for category, count in by_category.items():
            if count >= 5:  # recurring situation worth a pattern
                self.store_pattern(
                    trigger=category,
                    action=f"investigate recurring {category} events",
                    success_rate=0.6,
                )
                learned.append(category)
        self.update_metric("learning.patterns_stored", float(len(learned)))
        return {"recurring": dict(by_category), "patterns_stored": learned}

    def handle_task(self, task: Dict[str, Any]) -> Dict[str, Any]:
        return self.learn_cycle()


class StorageAgent(BaseAgent):
    """Disk health + backups (reference storage.py)."""

    periodic_interval = 600.0

    def get_agent_type(self) -> str:
        return "storage"

    def get_capabilities(self) -> List[str]:
        return ["fs.read", "fs.write", "hw.read", "monitor.read"]

    def get_tool_namespaces(self) -> List[str]:
        return ["fs", "monitor", "hw"]

    def periodic(self) -> None:
        disk = self.call_tool("fs.disk_usage", {"path": "/"})
        pct = disk["output"].get("percent_used", 0)
        self.update_metric("disk.percent_used", float(pct))
        if pct > 90:
            self.push_event("storage.disk_pressure", disk["output"],
                            critical=True)

    def handle_task(self, task: Dict[str, Any]) -> Dict[str, Any]:
        desc = task["description"].lower()
        if "backup" in desc:
            src = task["input"].get("src", "/etc")
            dst = task["input"].get(
                "dst", f"/tmp/aios/backups/manual-{int(time.time())}"
            )
            result = self.call_tool("fs.copy", {"src": src, "dst": dst},
                                    reason="backup")
            if not result["success"]:
                raise RuntimeError(result["error"])
            return {"backed_up": src, "to": dst}
        if "usage" in desc or "space" in desc or "disk" in desc:
            return self.call_tool("monitor.disk")["output"]
        if "largest" in desc or "clean" in desc:
            found = self.call_tool(
                "fs.search", {"path": task["input"].get("path", "/tmp"),
                              "pattern": "*", "limit": 50},
            )
            return found["output"]
        return self.call_tool("fs.disk_usage", {"path": "/"})["output"]


class TaskAgent(BaseAgent):
    """General executor: NL parsing, multi-step plans, delegation
    (reference task.py)."""

    periodic_interval = 3600.0

    def get_agent_type(self) -> str:
        return "task"

    def get_capabilities(self) -> List[str]:
        return ["fs.read", "fs.write", "process.read", "service.read",
                "monitor.read", "web.access", "code.generate"]

    def get_tool_namespaces(self) -> List[str]:
        return ["fs", "process", "service", "monitor", "web", "code"]

    def handle_task(self, task: Dict[str, Any]) -> Dict[str, Any]:
        context = ""
        try:
            context = self.assemble_context(task["description"])
        except Exception:  # noqa: BLE001
            pass
        plan_text = self.think(
            "Plan tool calls for this task and reply with a JSON array of "
            '{"tool": "ns.name", "args": {...}} items.\n'
            f"Task: {task['description']}\nContext:\n{context}",
            level=task.get("intelligence_level", "operational"),
        )
        from ..orchestrator.task_planner import extract_json_array

        steps = extract_json_array(plan_text) or []
        results = []
        for step in steps[:8]:
            if not isinstance(step, dict) or not step.get("tool"):
                continue
            res = self.call_tool(step["tool"], step.get("args", {}),
                                 reason=task["description"])
            results.append({"tool": step["tool"], "success": res["success"],
                            "output": res["output"]})
            if not res["success"]:
                raise RuntimeError(f"{step['tool']}: {res['error']}")
        if not results:
            return {"answer": plan_text[:2000]}
        return {"steps": results}


class WebAgent(BaseAgent):
    """Browse/scrape/API calls/URL monitoring (reference web.py)."""

    periodic_interval = 300.0

    def __init__(self, name=None):
        super().__init__(name)
        self.watched_urls: List[str] = []

    def get_agent_type(self) -> str:
        return "web"

    def get_capabilities(self) -> List[str]:
        return ["web.access", "net.diagnose", "fs.read", "fs.write"]

    def get_tool_namespaces(self) -> List[str]:
        return ["web", "net"]

    def periodic(self) -> None:
        for url in self.watched_urls:
            res = self.call_tool("web.http_request", {"url": url})
            ok = res["success"] and res["output"].get("status") == 200
            if not ok:
                self.push_event("web.url_down", {"url": url}, critical=False)

    def handle_task(self, task: Dict[str, Any]) -> Dict[str, Any]:
        desc = task["description"].lower()
        url = task["input"].get("url") or _extract_url(task["description"])
        if "scrape" in desc or "browse" in desc or "read page" in desc:
            if not url:
                raise ValueError("no url in task")
            return self.call_tool("web.scrape", {"url": url})["output"]
        if "download" in desc:
            return self.call_tool(
                "web.download", {"url": url, "dest": task["input"].get("dest",
                                 "/tmp/aios/download.bin")})["output"]
        if "webhook" in desc:
            return self.call_tool("web.webhook", task["input"])["output"]
        if "monitor" in desc and url:
            self.watched_urls.append(url)
            return {"watching": self.watched_urls}
        if url:
            return self.call_tool("web.api_call", {"url": url})["output"]
        raise ValueError("web task needs a url")


class CreatorAgent(BaseAgent):
    """Project scaffolding + AI code generation (reference creator.py)."""

    periodic_interval = 3600.0

    def get_agent_type(self) -> str:
        return "creator"

    def get_capabilities(self) -> List[str]:
        return ["code.generate", "fs.read", "fs.write", "git.use"]

    def get_tool_namespaces(self) -> List[str]:
        return ["code", "fs", "git"]

    def handle_task(self, task: Dict[str, Any]) -> Dict[str, Any]:
        desc = task["description"].lower()
        name = task["input"].get("name", "project")
        if "scaffold" in desc or "new project" in desc or "create a" in desc:
            kind = "web" if ("web" in desc or "site" in desc) else "python"
            result = self.call_tool("code.scaffold",
                                    {"name": name, "kind": kind})
            if not result["success"]:
                raise RuntimeError(result["error"])
            dest = result["output"]["files"][0].rsplit("/", 1)[0]
            self.call_tool("git.init", {"path": dest})
            return {**result["output"], "git": "initialized"}
        if "generate" in desc or "write code" in desc:
            code = self.think(
                f"Write the complete file content for: {task['description']}.\n"
                "Reply with ONLY the code, no commentary.",
                level="tactical", max_tokens=1024,
            )
            dest = task["input"].get("dest", f"/tmp/aios/projects/{name}.py")
            result = self.call_tool("code.generate",
                                    {"dest": dest, "content": code})
            return result["output"]
        raise ValueError("creator task needs scaffold/generate intent")


# ---------------------------------------------------------------------------


def _extract_service_name(desc: str) -> str:
    import re

    m = re.search(r"restart(?:\s+the)?\s+([a-z0-9_.@-]+?)(?:\s+service)?(?:\s|$)",
                  desc)
    return m.group(1) if m else ""


def _extract_url(text: str):
    import re

    m = re.search(r"https?://\S+", text)
    return m.group(0).rstrip(".,)") if m else None


def _last_word(desc: str) -> str:
    words = [w for w in desc.replace("?", "").split() if w not in
             ("the", "a", "an", "package", "install", "remove", "search")]
    return words[-1] if words else ""


CLASSES = {
    "system": SystemAgent,
    "network": NetworkAgent,
    "security": SecurityAgent,
    "package": PackageAgent,
    "monitoring": MonitoringAgent,
    "learning": LearningAgent,
    "storage": StorageAgent,
    "task": TaskAgent,
    "web": WebAgent,
    "creator": CreatorAgent,
}
