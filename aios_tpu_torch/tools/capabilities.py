"""Capability ACL with risk levels.

Reference parity (tools/src/capabilities.rs): ~30 capability strings,
tool-pattern -> required-capability mapping with four risk levels
(Low/Medium/High/Critical, capabilities.rs:10-28), and per-agent grant
tables hardcoded for the autonomy loop (ALL) and each system agent
(capabilities.rs:49-181). Grants can be extended/revoked at runtime via the
orchestrator's capability RPCs.
"""

from __future__ import annotations

import fnmatch
import threading
from typing import Dict, List, Set

RISK_LOW = "low"
RISK_MEDIUM = "medium"
RISK_HIGH = "high"
RISK_CRITICAL = "critical"

# tool-name pattern -> (required capabilities, risk level)
TOOL_REQUIREMENTS: List[tuple[str, List[str], str]] = [
    ("fs.read", ["fs.read"], RISK_LOW),
    ("fs.list", ["fs.read"], RISK_LOW),
    ("fs.stat", ["fs.read"], RISK_LOW),
    ("fs.search", ["fs.read"], RISK_LOW),
    ("fs.disk_usage", ["fs.read"], RISK_LOW),
    ("fs.delete", ["fs.write"], RISK_HIGH),
    ("fs.*", ["fs.write"], RISK_MEDIUM),
    ("process.list", ["process.read"], RISK_LOW),
    ("process.info", ["process.read"], RISK_LOW),
    ("process.kill", ["process.manage"], RISK_HIGH),
    ("process.*", ["process.manage"], RISK_MEDIUM),
    ("service.list", ["service.read"], RISK_LOW),
    ("service.status", ["service.read"], RISK_LOW),
    ("service.*", ["service.manage"], RISK_HIGH),
    ("net.port_scan", ["net.scan"], RISK_MEDIUM),
    ("net.*", ["net.diagnose"], RISK_LOW),
    ("firewall.rules", ["firewall.read"], RISK_LOW),
    ("firewall.*", ["firewall.manage"], RISK_CRITICAL),
    ("pkg.search", ["pkg.read"], RISK_LOW),
    ("pkg.list_installed", ["pkg.read"], RISK_LOW),
    ("pkg.*", ["pkg.manage"], RISK_HIGH),
    ("sec.grant", ["sec.admin"], RISK_CRITICAL),
    ("sec.revoke", ["sec.admin"], RISK_CRITICAL),
    ("sec.*", ["sec.audit"], RISK_MEDIUM),
    ("monitor.*", ["monitor.read"], RISK_LOW),
    ("hw.*", ["hw.read"], RISK_LOW),
    ("web.*", ["web.access"], RISK_MEDIUM),
    ("git.*", ["git.use"], RISK_MEDIUM),
    ("code.*", ["code.generate"], RISK_MEDIUM),
    ("self.inspect", ["self.read"], RISK_LOW),
    ("self.*", ["self.manage"], RISK_CRITICAL),
    ("plugin.list", ["plugin.read"], RISK_LOW),
    ("plugin.*", ["plugin.manage"], RISK_HIGH),
    ("container.list", ["container.read"], RISK_LOW),
    ("container.logs", ["container.read"], RISK_LOW),
    ("container.*", ["container.manage"], RISK_HIGH),
    ("email.*", ["email.send"], RISK_MEDIUM),
]

ALL_CAPABILITIES: Set[str] = {
    cap for _, caps, _ in TOOL_REQUIREMENTS for cap in caps
}

# Per-agent default grants (capabilities.rs:49-181). The autonomy loop runs
# with everything; each Python agent gets its own namespace slice.
DEFAULT_GRANTS: Dict[str, Set[str]] = {
    "autonomy-loop": set(ALL_CAPABILITIES),
    "orchestrator": set(ALL_CAPABILITIES),
    "system_agent": {
        "fs.read", "fs.write", "process.read", "process.manage",
        "service.read", "service.manage", "monitor.read", "hw.read",
    },
    "network_agent": {
        "net.diagnose", "net.scan", "firewall.read", "firewall.manage",
        "monitor.read",
    },
    "security_agent": {
        "sec.audit", "sec.admin", "fs.read", "process.read", "monitor.read",
        "net.scan",
    },
    "package_agent": {"pkg.read", "pkg.manage", "fs.read"},
    "monitoring_agent": {"monitor.read", "fs.read", "process.read", "hw.read"},
    "learning_agent": {"monitor.read", "fs.read"},
    "storage_agent": {"fs.read", "fs.write", "hw.read", "monitor.read"},
    "task_agent": {
        "fs.read", "fs.write", "process.read", "service.read", "monitor.read",
        "web.access", "code.generate",
    },
    "web_agent": {"web.access", "net.diagnose", "fs.read", "fs.write"},
    "creator_agent": {"code.generate", "fs.read", "fs.write", "git.use"},
}


def requirements_for(tool_name: str) -> tuple[List[str], str]:
    """First matching pattern wins (patterns are ordered specific-first)."""
    for pattern, caps, risk in TOOL_REQUIREMENTS:
        if fnmatch.fnmatch(tool_name, pattern):
            return caps, risk
    return [], RISK_LOW


class CapabilityChecker:
    def __init__(self):
        self._grants: Dict[str, Set[str]] = {
            agent: set(caps) for agent, caps in DEFAULT_GRANTS.items()
        }
        self._lock = threading.Lock()

    def grants_for(self, agent_id: str) -> Set[str]:
        with self._lock:
            if agent_id in self._grants:
                return set(self._grants[agent_id])
            # agent ids look like "system_agent-1234"; fall back on the type
            for known, caps in self._grants.items():
                if agent_id.startswith(known):
                    return set(caps)
            return set()

    def check(self, agent_id: str, tool_name: str) -> tuple[bool, str]:
        required, risk = requirements_for(tool_name)
        have = self.grants_for(agent_id)
        missing = [c for c in required if c not in have]
        if missing:
            return False, (
                f"agent {agent_id} lacks capabilities {missing} "
                f"for {tool_name} (risk {risk})"
            )
        return True, ""

    def grant(self, agent_id: str, capabilities: List[str]) -> None:
        with self._lock:
            self._grants.setdefault(agent_id, set()).update(capabilities)

    def revoke(self, agent_id: str, capabilities: List[str], all_: bool = False):
        with self._lock:
            if agent_id not in self._grants:
                return
            if all_:
                self._grants[agent_id] = set()
            else:
                self._grants[agent_id] -= set(capabilities)
