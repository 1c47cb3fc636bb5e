"""Goal -> task-DAG decomposition with the intelligence hierarchy.

Reference parity (agent-core/src/task_planner.rs):
  * classify_complexity keyword rules -> Reactive / Operational / Tactical /
    Strategic (task_planner.rs:493-546);
  * Reactive/Operational goals become a single task (549-598);
  * Tactical/Strategic goals get AI decomposition — api-gateway first, then
    runtime fallback — prompted to emit a JSON array of steps (117-223),
    parsed with <think>-tag stripping and markdown-fence extraction
    (226-353), then chained linearly via depends_on (313-341);
  * keyword multi-step fallbacks for restart/security/install/network goals
    when the AI path is unavailable (357-490);
  * infer_required_tools keyword -> tool-namespace map (601-676).
"""

from __future__ import annotations

import json
import re
import uuid
from typing import Callable, List, Optional

from .goal_engine import Goal, Task

# ---------------------------------------------------------------------------
# Intelligence levels
# ---------------------------------------------------------------------------

REACTIVE = "reactive"
OPERATIONAL = "operational"
TACTICAL = "tactical"
STRATEGIC = "strategic"

_STRATEGIC_KW = (
    "design", "architect", "plan ", "migrate", "overhaul", "refactor",
    "build a", "create a system", "set up a", "deploy a", "research",
    "analyze and", "optimize the whole", "harden",
)
_TACTICAL_KW = (
    "investigate", "diagnose", "troubleshoot", "fix", "configure",
    "install and", "secure", "audit", "backup and", "update all",
    "clean up", "optimize", "scan",
)
_REACTIVE_KW = (
    "ping", "check cpu", "check memory", "check disk", "uptime", "status of",
    "list ", "show ", "read ", "get ",
)


def classify_complexity(description: str) -> str:
    """Keyword ladder, most-complex match wins (task_planner.rs:493-546)."""
    low = description.lower()
    if any(k in low for k in _STRATEGIC_KW):
        return STRATEGIC
    if any(k in low for k in _TACTICAL_KW):
        return TACTICAL
    if any(k in low for k in _REACTIVE_KW):
        return REACTIVE
    return OPERATIONAL


# ---------------------------------------------------------------------------
# Tool inference
# ---------------------------------------------------------------------------

_TOOL_KEYWORDS = [
    (("file", "directory", "folder", "read", "write", "disk space"), "fs"),
    (("process", "pid", "running"), "process"),
    (("service", "daemon", "systemd", "restart", "nginx", "sshd"), "service"),
    (("network", "ping", "dns", "connectivity", "interface", "port"), "net"),
    (("firewall", "nftables", "iptables", "block ip"), "firewall"),
    (("package", "install", "apt", "upgrade", "update"), "pkg"),
    (("security", "audit", "permission", "rootkit", "cert", "tls",
      "intrusion"), "sec"),
    (("cpu", "memory", "monitor", "metric", "log", "usage"), "monitor"),
    (("hardware", "device"), "hw"),
    (("http", "url", "website", "scrape", "download", "webhook", "api"), "web"),
    (("git", "repository", "commit", "clone"), "git"),
    (("scaffold", "generate code", "new project"), "code"),
    (("container", "podman", "docker"), "container"),
    (("email", "mail", "notify"), "email"),
    (("plugin",), "plugin"),
]


def infer_required_tools(description: str) -> List[str]:
    """Keyword -> tool-namespace map (task_planner.rs:601-676).

    Whole-word matching: plain substring matching misfires ("port" inside
    "report", "install" inside "reinstallation").
    """
    low = description.lower()
    namespaces = []
    for keywords, namespace in _TOOL_KEYWORDS:
        hit = any(
            re.search(r"\b" + re.escape(k) + r"\b", low) for k in keywords
        )
        if hit and namespace not in namespaces:
            namespaces.append(namespace)
    return namespaces


# ---------------------------------------------------------------------------
# AI response parsing
# ---------------------------------------------------------------------------


def strip_think_tags(text: str) -> str:
    """Remove <think>...</think> reasoning blocks (task_planner.rs:226-250)."""
    return re.sub(r"<think>.*?</think>", "", text, flags=re.S).strip()


def extract_json_array(text: str) -> Optional[list]:
    """JSON array from raw text, markdown fences, or embedded brackets."""
    text = strip_think_tags(text)
    candidates = [text]
    fence = re.search(r"```(?:json)?\s*(.*?)```", text, flags=re.S)
    if fence:
        candidates.insert(0, fence.group(1))
    bracket = re.search(r"\[.*\]", text, flags=re.S)
    if bracket:
        candidates.append(bracket.group(0))
    for cand in candidates:
        try:
            parsed = json.loads(cand.strip())
            if isinstance(parsed, list):
                return parsed
        except ValueError:
            continue
    return None


DECOMPOSE_PROMPT = """\
Decompose this goal into a short ordered list of concrete system tasks.

Goal: {goal}

Respond with ONLY a JSON array, each element:
{{"description": "...", "required_tools": ["namespace", ...]}}
Use tool namespaces from: fs, process, service, net, firewall, pkg, sec,
monitor, hw, web, git, code, container, email, plugin. 2-6 tasks.
"""


# ---------------------------------------------------------------------------
# Keyword multi-step fallbacks (task_planner.rs:357-490)
# ---------------------------------------------------------------------------


def _fallback_steps(description: str) -> List[dict]:
    low = description.lower()
    if "restart" in low and ("service" in low or "nginx" in low or "daemon" in low):
        return [
            {"description": f"Check status before restart: {description}",
             "required_tools": ["service"]},
            {"description": f"Restart the service: {description}",
             "required_tools": ["service"]},
            {"description": "Verify the service is healthy after restart",
             "required_tools": ["service", "monitor"]},
        ]
    if any(k in low for k in ("security", "audit", "harden", "intrusion")):
        return [
            {"description": "Scan for open ports and listening services",
             "required_tools": ["sec", "net"]},
            {"description": "Check file permissions and setuid binaries",
             "required_tools": ["sec", "fs"]},
            {"description": "Run rootkit indicators scan",
             "required_tools": ["sec"]},
            {"description": "Summarize security findings",
             "required_tools": ["monitor"]},
        ]
    if "install" in low:
        return [
            {"description": f"Search for the package: {description}",
             "required_tools": ["pkg"]},
            {"description": f"Install: {description}",
             "required_tools": ["pkg"]},
            {"description": "Verify installation", "required_tools": ["pkg"]},
        ]
    if any(k in low for k in ("network", "connectivity", "dns")):
        return [
            {"description": "List network interfaces and their state",
             "required_tools": ["net"]},
            {"description": "Test external connectivity (ping/dns)",
             "required_tools": ["net"]},
            {"description": "Summarize network diagnosis",
             "required_tools": ["monitor"]},
        ]
    return [{"description": description,
             "required_tools": infer_required_tools(description)}]


# ---------------------------------------------------------------------------
# Planner
# ---------------------------------------------------------------------------


class TaskPlanner:
    """Decomposes goals; AI backends are injected as callables so the
    planner is testable without live services (mirrors the reference's
    gateway-then-runtime chain, task_planner.rs:143-223)."""

    def __init__(
        self,
        gateway_infer: Optional[Callable[[str], str]] = None,
        runtime_infer: Optional[Callable[[str], str]] = None,
    ):
        self.gateway_infer = gateway_infer
        self.runtime_infer = runtime_infer

    def _try_ai_decompose(self, goal: Goal) -> Optional[List[dict]]:
        prompt = DECOMPOSE_PROMPT.format(goal=goal.description)
        for backend in (self.gateway_infer, self.runtime_infer):
            if backend is None:
                continue
            try:
                raw = backend(prompt)
            except Exception:  # noqa: BLE001 — backend down, try next
                continue
            steps = extract_json_array(raw)
            if steps:
                cleaned = []
                for s in steps[:8]:
                    if isinstance(s, dict) and s.get("description"):
                        cleaned.append(
                            {
                                "description": str(s["description"]),
                                "required_tools": [
                                    str(t) for t in s.get("required_tools", [])
                                ],
                            }
                        )
                    elif isinstance(s, str):
                        cleaned.append(
                            {"description": s,
                             "required_tools": infer_required_tools(s)}
                        )
                if cleaned:
                    return cleaned
        return None

    def decompose_goal(self, goal: Goal) -> List[Task]:
        """Goal -> ordered task list with linear depends_on chaining."""
        level = classify_complexity(goal.description)

        if level in (REACTIVE, OPERATIONAL):
            steps = [
                {
                    "description": goal.description,
                    "required_tools": infer_required_tools(goal.description),
                }
            ]
        else:
            steps = self._try_ai_decompose(goal) or _fallback_steps(
                goal.description
            )

        tasks: List[Task] = []
        prev_id: Optional[str] = None
        for step in steps:
            task = Task(
                id=str(uuid.uuid4()),
                goal_id=goal.id,
                description=step["description"],
                intelligence_level=level,
                required_tools=step.get("required_tools", []),
                depends_on=[prev_id] if prev_id else [],
            )
            tasks.append(task)
            prev_id = task.id
        return tasks
