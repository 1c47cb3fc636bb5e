"""Multi-node cluster manager + remote execution clients.

Reference parity:
  * ClusterManager (agent-core/src/cluster.rs): node registry keyed by
    node_id, 30 s heartbeat timeout, least-loaded routing by
    cpu + task-ratio score (cluster.rs:110-128), dead-node pruning
    (136-158), gated on AIOS_CLUSTER_ENABLED=true (cluster.rs:43);
  * RemoteExecutor (agent-core/src/remote_exec.rs): channel-cached gRPC
    clients to remote orchestrators/tool registries — submit_remote_goal,
    execute_remote_tool (remote_exec.rs:45-102).

TPU note (SURVEY.md section 2.4): this is the *orchestration-level*
multi-node plane and stays gRPC; multi-chip/multi-host model execution lives
below the runtime service boundary as JAX meshes over ICI/DCN.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

NODE_TIMEOUT = 30.0


@dataclass
class ClusterNode:
    node_id: str
    hostname: str
    address: str
    agents: List[str] = field(default_factory=list)
    metadata: Dict[str, str] = field(default_factory=dict)
    max_tasks: int = 10
    cpu_usage: float = 0.0
    memory_usage: float = 0.0
    active_tasks: int = 0
    last_heartbeat: float = field(default_factory=time.monotonic)

    @property
    def alive(self) -> bool:
        return time.monotonic() - self.last_heartbeat < NODE_TIMEOUT

    @property
    def load_score(self) -> float:
        """cpu + task-ratio blend (cluster.rs:110-128); lower is better."""
        task_ratio = self.active_tasks / max(self.max_tasks, 1)
        return self.cpu_usage / 100.0 + task_ratio


def cluster_enabled() -> bool:
    return os.environ.get("AIOS_CLUSTER_ENABLED", "").lower() == "true"


class ClusterManager:
    def __init__(self):
        self._nodes: Dict[str, ClusterNode] = {}
        self._lock = threading.Lock()

    def register(self, node: ClusterNode) -> None:
        with self._lock:
            self._nodes[node.node_id] = node

    def heartbeat(
        self, node_id: str, cpu: float, memory: float, active_tasks: int
    ) -> bool:
        with self._lock:
            n = self._nodes.get(node_id)
            if n is None:
                return False
            n.cpu_usage = cpu
            n.memory_usage = memory
            n.active_tasks = active_tasks
            n.last_heartbeat = time.monotonic()
            return True

    def nodes(self, include_dead: bool = False) -> List[ClusterNode]:
        with self._lock:
            out = list(self._nodes.values())
        return out if include_dead else [n for n in out if n.alive]

    def least_loaded(self) -> Optional[ClusterNode]:
        live = [n for n in self.nodes() if n.active_tasks < n.max_tasks]
        if not live:
            return None
        return min(live, key=lambda n: n.load_score)

    def prune_dead(self) -> List[str]:
        with self._lock:
            dead = [nid for nid, n in self._nodes.items() if not n.alive]
            for nid in dead:
                del self._nodes[nid]
            return dead


class RemoteExecutor:
    """Channel-cached clients to other nodes' orchestrator/tool services."""

    def __init__(self):
        self._channels: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _channel(self, address: str):
        from .. import rpc

        with self._lock:
            ch = self._channels.get(address)
            if ch is None:
                ch = rpc.insecure_channel(address)
                self._channels[address] = ch
            return ch

    def submit_remote_goal(
        self, address: str, description: str, priority: int = 5
    ) -> str:
        from ..proto_gen import orchestrator_pb2
        from ..services import OrchestratorStub

        stub = OrchestratorStub(self._channel(address))
        resp = stub.SubmitGoal(
            orchestrator_pb2.SubmitGoalRequest(
                description=description, priority=priority, source="cluster"
            ),
            timeout=10,
        )
        return resp.id

    def execute_remote_tool(
        self, address: str, tool_name: str, input_json: bytes, agent_id: str
    ):
        from ..proto_gen import tools_pb2
        from ..services import ToolRegistryStub

        stub = ToolRegistryStub(self._channel(address))
        return stub.Execute(
            tools_pb2.ExecuteRequest(
                tool_name=tool_name, agent_id=agent_id, input_json=input_json
            ),
            timeout=30,
        )

    def close(self) -> None:
        with self._lock:
            for ch in self._channels.values():
                ch.close()
            self._channels.clear()
