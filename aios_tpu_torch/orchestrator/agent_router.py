"""Agent registry + task routing.

Reference parity (agent-core/src/agent_router.rs):
  * TrackedAgent registry with heartbeat timestamps, status, counters;
  * route_task: agents whose tool_namespaces cover the task's required
    tools AND heartbeat < 15 s AND idle; fallback to busy-but-capable;
    idle-first then most-experienced ordering (agent_router.rs:73-141);
  * tasks with empty required_tools are deliberately unroutable -> they go
    to the AI reasoning path instead (agent_router.rs:91-95);
  * dead_agents() for timeout-based task requeue (192-198);
  * cluster spillover via route_task_to_node (202-226).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..obs import instruments as obs
from .goal_engine import Task

HEARTBEAT_TIMEOUT = 15.0


def _now() -> float:
    return time.monotonic()


@dataclass
class TrackedAgent:
    agent_id: str
    agent_type: str
    capabilities: List[str] = field(default_factory=list)
    tool_namespaces: List[str] = field(default_factory=list)
    status: str = "idle"  # idle | busy
    current_task_id: str = ""
    last_heartbeat: float = field(default_factory=_now)
    tasks_completed: int = 0
    tasks_failed: int = 0
    registered_at: int = field(default_factory=lambda: int(time.time()))

    @property
    def alive(self) -> bool:
        return _now() - self.last_heartbeat < HEARTBEAT_TIMEOUT

    @property
    def idle(self) -> bool:
        return self.status == "idle" and not self.current_task_id


class AgentRouter:
    def __init__(self):
        self._agents: Dict[str, TrackedAgent] = {}
        self._assigned: Dict[str, List[Task]] = {}  # agent_id -> task queue
        self._lock = threading.RLock()

    # -- registry -----------------------------------------------------------

    def register(self, agent: TrackedAgent) -> None:
        with self._lock:
            self._agents[agent.agent_id] = agent
            self._assigned.setdefault(agent.agent_id, [])

    def unregister(self, agent_id: str) -> bool:
        with self._lock:
            self._assigned.pop(agent_id, None)
            return self._agents.pop(agent_id, None) is not None

    def heartbeat(
        self, agent_id: str, status: str = "", current_task_id: str = ""
    ) -> bool:
        with self._lock:
            a = self._agents.get(agent_id)
            if a is None:
                return False
            a.last_heartbeat = _now()
            if status:
                a.status = status
            a.current_task_id = current_task_id
            return True

    def agents(self) -> List[TrackedAgent]:
        with self._lock:
            return list(self._agents.values())

    def get(self, agent_id: str) -> Optional[TrackedAgent]:
        with self._lock:
            return self._agents.get(agent_id)

    def dead_agents(self) -> List[TrackedAgent]:
        with self._lock:
            return [a for a in self._agents.values() if not a.alive]

    def prune_dead(self) -> List[str]:
        with self._lock:
            dead = [aid for aid, a in self._agents.items() if not a.alive]
            for aid in dead:
                del self._agents[aid]
                self._assigned.pop(aid, None)
            return dead

    # -- routing ------------------------------------------------------------

    def route_task(self, task: Task) -> Optional[str]:
        """Pick an agent for the task; None -> AI path.

        Empty required_tools is deliberately unroutable (the AI reasoning
        loop handles those, agent_router.rs:91-95).
        """
        if not task.required_tools:
            obs.ROUTER_TASKS.labels(outcome="ai_path").inc()
            return None
        with self._lock:
            capable = [
                a
                for a in self._agents.values()
                if a.alive
                and all(ns in a.tool_namespaces for ns in task.required_tools)
            ]
            if not capable:
                obs.ROUTER_TASKS.labels(outcome="no_capable_agent").inc()
                return None
            # idle first, then most experienced (agent_router.rs:120-141)
            capable.sort(
                key=lambda a: (0 if a.idle else 1, -a.tasks_completed)
            )
            chosen = capable[0]
            self._assigned.setdefault(chosen.agent_id, []).append(task)
            chosen.status = "busy"
            chosen.current_task_id = task.id
            obs.ROUTER_TASKS.labels(outcome="routed").inc()
            return chosen.agent_id

    def next_task_for(self, agent_id: str) -> Optional[Task]:
        """Polling endpoint backing GetAssignedTask."""
        with self._lock:
            queue = self._assigned.get(agent_id)
            if queue:
                return queue.pop(0)
            return None

    def task_finished(self, agent_id: str, success: bool) -> None:
        with self._lock:
            a = self._agents.get(agent_id)
            if a is None:
                return
            a.status = "idle"
            a.current_task_id = ""
            if success:
                a.tasks_completed += 1
            else:
                a.tasks_failed += 1

    def requeue_from(self, agent_id: str) -> List[Task]:
        """Pull undelivered tasks back from a dead agent's queue."""
        with self._lock:
            queue = self._assigned.get(agent_id, [])
            tasks, queue[:] = list(queue), []
            return tasks
