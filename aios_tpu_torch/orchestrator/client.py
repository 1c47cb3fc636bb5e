"""Standalone orchestrator client + CLI.

The reference ships a high-level retrying client wrapper outside the service
tree (agent-core/python/aios_agent/orchestrator_client.py:33-100: submit
goals, poll status, list agents, system status, wait_for_goal with retries)
so operators and external programs can drive the orchestrator without the
agent framework. This is that surface for the TPU stack, synchronous like
the rest of the gRPC layer here, plus an argparse CLI:

    python -m aios_tpu_torch.orchestrator.client submit "check disk usage"
    python -m aios_tpu_torch.orchestrator.client status <goal-id>
    python -m aios_tpu_torch.orchestrator.client wait <goal-id> --timeout 120
    python -m aios_tpu_torch.orchestrator.client goals --filter active
    python -m aios_tpu_torch.orchestrator.client agents
    python -m aios_tpu_torch.orchestrator.client system
    python -m aios_tpu_torch.orchestrator.client cancel <goal-id>
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import grpc

from .. import rpc
from ..proto_gen import common_pb2, orchestrator_pb2
from ..services import OrchestratorStub, service_address

TERMINAL_GOAL_STATES = {"completed", "failed", "cancelled"}


@dataclass
class ClientConfig:
    """Connection settings (reference orchestrator_client.py:23-30)."""

    address: str = ""
    timeout_s: float = 30.0
    max_retries: int = 3
    retry_delay_s: float = 1.0

    def __post_init__(self) -> None:
        if not self.address:
            self.address = os.getenv(
                "AIOS_ORCHESTRATOR_ADDR", service_address("orchestrator")
            )


class OrchestratorClient:
    """Retrying synchronous client for the Orchestrator gRPC service.

    Usage::

        with OrchestratorClient() as client:
            goal_id = client.submit_goal("check disk usage")
            status = client.wait_for_goal(goal_id, timeout_s=120)
    """

    def __init__(self, config: Optional[ClientConfig] = None) -> None:
        self.config = config or ClientConfig()
        self._channel = None
        self._stub = None

    def __enter__(self) -> "OrchestratorClient":
        self.connect()
        return self

    def __exit__(self, *_: Any) -> None:
        self.close()

    def connect(self) -> None:
        if self._channel is None:
            self._channel = rpc.insecure_channel(self.config.address)
            self._stub = OrchestratorStub(self._channel)

    def close(self) -> None:
        if self._channel is not None:
            self._channel.close()
            self._channel = None
            self._stub = None

    # -- internal -----------------------------------------------------------

    def _call(self, method: str, request):
        """Unary call with bounded retries on transient errors
        (UNAVAILABLE / DEADLINE_EXCEEDED, like the reference's _call)."""
        self.connect()
        attempts = max(1, self.config.max_retries)
        delay = self.config.retry_delay_s
        for attempt in range(attempts):
            try:
                return getattr(self._stub, method)(
                    request, timeout=self.config.timeout_s
                )
            except grpc.RpcError as exc:
                if exc.code() not in (
                    grpc.StatusCode.UNAVAILABLE,
                    grpc.StatusCode.DEADLINE_EXCEEDED,
                ):
                    raise
                if attempt == attempts - 1:
                    raise  # no point sleeping after the final attempt
                time.sleep(delay)
                delay *= 2

    # -- goals --------------------------------------------------------------

    def submit_goal(
        self,
        description: str,
        priority: int = 5,
        source: str = "client",
        tags: Optional[List[str]] = None,
        metadata: Optional[Dict[str, Any]] = None,
    ) -> str:
        resp = self._call(
            "SubmitGoal",
            orchestrator_pb2.SubmitGoalRequest(
                description=description,
                priority=priority,
                source=source,
                tags=tags or [],
                metadata_json=json.dumps(metadata or {}).encode(),
            ),
        )
        return resp.id

    def get_goal_status(self, goal_id: str) -> Dict[str, Any]:
        resp = self._call("GetGoalStatus", common_pb2.GoalId(id=goal_id))
        return {
            "goal_id": resp.goal.id,
            "description": resp.goal.description,
            "status": resp.goal.status,
            "current_phase": resp.current_phase,
            "progress_percent": resp.progress_percent,
            "tasks": [
                {"id": t.id, "description": t.description, "status": t.status}
                for t in resp.tasks
            ],
        }

    def cancel_goal(self, goal_id: str) -> bool:
        return self._call("CancelGoal", common_pb2.GoalId(id=goal_id)).success

    def list_goals(
        self, status_filter: str = "", limit: int = 20, offset: int = 0
    ) -> List[Dict[str, Any]]:
        resp = self._call(
            "ListGoals",
            orchestrator_pb2.ListGoalsRequest(
                status_filter=status_filter, limit=limit, offset=offset
            ),
        )
        return [
            {"id": g.id, "description": g.description, "status": g.status}
            for g in resp.goals
        ]

    def wait_for_goal(
        self, goal_id: str, timeout_s: float = 300.0, poll_s: float = 1.0
    ) -> Dict[str, Any]:
        """Poll until the goal reaches a terminal state (reference
        wait_for_goal, orchestrator_client.py:290+)."""
        deadline = time.time() + timeout_s
        while True:
            status = self.get_goal_status(goal_id)
            if status["status"] in TERMINAL_GOAL_STATES:
                return status
            if time.time() >= deadline:
                raise TimeoutError(
                    f"goal {goal_id} still {status['status']} "
                    f"after {timeout_s:.0f}s"
                )
            time.sleep(poll_s)

    # -- agents / system ----------------------------------------------------

    def list_agents(self) -> List[Dict[str, Any]]:
        resp = self._call("ListAgents", common_pb2.Empty())
        return [
            {
                "id": a.agent_id,
                "type": a.agent_type,
                "status": a.status,
                "capabilities": list(a.capabilities),
            }
            for a in resp.agents
        ]

    def get_system_status(self) -> Dict[str, Any]:
        resp = self._call("GetSystemStatus", common_pb2.Empty())
        return {
            "active_goals": resp.active_goals,
            "pending_tasks": resp.pending_tasks,
            "active_agents": resp.active_agents,
            "loaded_models": list(resp.loaded_models),
            "autonomy_level": resp.autonomy_level,
            "uptime_seconds": resp.uptime_seconds,
        }


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="aios-orchestrator-client",
        description="Drive the aiOS-TPU orchestrator from the command line.",
    )
    ap.add_argument("--address", default="", help="host:port (default: env "
                    "AIOS_ORCHESTRATOR_ADDR or the service registry)")
    ap.add_argument("--timeout", type=float, default=30.0)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("submit", help="submit a goal")
    p.add_argument("description")
    p.add_argument("--priority", type=int, default=5)
    p.add_argument("--wait", action="store_true", help="block until terminal")

    p = sub.add_parser("status", help="goal status")
    p.add_argument("goal_id")

    p = sub.add_parser("wait", help="wait for a goal to finish")
    p.add_argument("goal_id")
    p.add_argument("--timeout", dest="wait_timeout", type=float, default=300.0)

    p = sub.add_parser("cancel", help="cancel a goal")
    p.add_argument("goal_id")

    p = sub.add_parser("goals", help="list goals")
    p.add_argument("--filter", default="", dest="status_filter")
    p.add_argument("--limit", type=int, default=20)

    sub.add_parser("agents", help="list registered agents")
    sub.add_parser("system", help="system status")

    args = ap.parse_args(argv)
    cfg = ClientConfig(address=args.address, timeout_s=args.timeout)

    with OrchestratorClient(cfg) as client:
        if args.cmd == "submit":
            goal_id = client.submit_goal(args.description, priority=args.priority)
            if args.wait:
                out: Any = client.wait_for_goal(goal_id)
            else:
                out = {"goal_id": goal_id}
        elif args.cmd == "status":
            out = client.get_goal_status(args.goal_id)
        elif args.cmd == "wait":
            out = client.wait_for_goal(args.goal_id, timeout_s=args.wait_timeout)
        elif args.cmd == "cancel":
            out = {"cancelled": client.cancel_goal(args.goal_id)}
        elif args.cmd == "goals":
            out = client.list_goals(args.status_filter, limit=args.limit)
        elif args.cmd == "agents":
            out = client.list_agents()
        else:
            out = client.get_system_status()

    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
