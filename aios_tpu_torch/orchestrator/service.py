"""aios.orchestrator.Orchestrator gRPC service — 19 RPCs.

Reference parity (agent-core/src/main.rs:142-553): goal submission triggers
decomposition; agents register/heartbeat/poll via GetAssignedTask/
ReportTaskResult; capability requests are auto-granted (a reference quirk,
main.rs:395-411, preserved consciously); node RPCs back the cluster plane.

Conscious fix vs the reference: the schedule RPCs actually create/list/
delete entries in the GoalScheduler — in the reference they are stubs that
never touch it (main.rs:426-468; SURVEY.md "known quirks").
"""

from __future__ import annotations

import json
import logging
import time
from typing import Optional

import psutil

from .. import rpc
from ..obs.http import maybe_start_metrics_server
from ..proto_gen import common_pb2, orchestrator_pb2
from ..services import ORCHESTRATOR, OrchestratorServicer, service_address
from .agent_router import AgentRouter, TrackedAgent
from .autonomy import AutonomyLoop
from .cluster import ClusterManager, ClusterNode
from .goal_engine import GoalEngine, Task
from .scheduler import GoalScheduler
from .task_planner import TaskPlanner
from .telemetry import ResultAggregator, TaskOutcome

log = logging.getLogger("aios.orchestrator")


class OrchestratorService(OrchestratorServicer):
    def __init__(
        self,
        engine: Optional[GoalEngine] = None,
        planner: Optional[TaskPlanner] = None,
        router: Optional[AgentRouter] = None,
        autonomy: Optional[AutonomyLoop] = None,
        scheduler: Optional[GoalScheduler] = None,
        cluster: Optional[ClusterManager] = None,
        aggregator: Optional[ResultAggregator] = None,
        loaded_models: Optional[callable] = None,
    ):
        self.engine = engine or GoalEngine()
        self.planner = planner or TaskPlanner()
        self.router = router or AgentRouter()
        self.autonomy = autonomy
        self.scheduler = scheduler or GoalScheduler(
            lambda d, p: self.engine.submit_goal(d, p, source="scheduler")
        )
        self.cluster = cluster or ClusterManager()
        self.aggregator = aggregator or ResultAggregator()
        self.loaded_models = loaded_models or (lambda: [])
        self.started_at = time.time()

    # -- goals --------------------------------------------------------------

    def SubmitGoal(self, request, context):
        metadata = {}
        if request.metadata_json:
            try:
                metadata = json.loads(request.metadata_json)
            except ValueError:
                pass
        goal = self.engine.submit_goal(
            request.description,
            priority=request.priority or 5,
            source=request.source or "user",
            tags=list(request.tags),
            metadata=metadata,
        )
        self.engine.add_message(goal.id, "user", request.description)
        return common_pb2.GoalId(id=goal.id)

    def GetGoalStatus(self, request, context):
        goal = self.engine.goals.get(request.id)
        if goal is None:
            import grpc

            context.set_code(grpc.StatusCode.NOT_FOUND)
            context.set_details(f"goal {request.id} not found")
            return orchestrator_pb2.GoalStatusResponse()
        tasks = self.engine.tasks_for_goal(goal.id)
        return orchestrator_pb2.GoalStatusResponse(
            goal=self._goal_proto(goal),
            tasks=[self._task_proto(t) for t in tasks],
            current_phase=goal.status,
            progress_percent=self.engine.progress(goal.id),
        )

    def cancel_goal_by_id(self, goal_id: str) -> bool:
        """Shared by the CancelGoal RPC and the console's cancel route:
        cancel the goal AND abort any in-flight AI inference for it (the
        loop's between-rounds check only stops future rounds)."""
        ok = self.engine.cancel_goal(goal_id)
        if ok and self.autonomy is not None:
            self.autonomy.notify_goal_cancelled(goal_id)
        return ok

    def CancelGoal(self, request, context):
        ok = self.cancel_goal_by_id(request.id)
        return common_pb2.Status(
            success=ok, message="cancelled" if ok else "not cancellable"
        )

    def ListGoals(self, request, context):
        goals = self.engine.list_goals(
            status_filter=request.status_filter,
            limit=request.limit or 100,
            offset=request.offset,
        )
        return orchestrator_pb2.GoalListResponse(
            goals=[self._goal_proto(g) for g in goals],
            total=len(self.engine.goals),
        )

    # -- agents -------------------------------------------------------------

    def RegisterAgent(self, request, context):
        self.router.register(
            TrackedAgent(
                agent_id=request.agent_id,
                agent_type=request.agent_type,
                capabilities=list(request.capabilities),
                tool_namespaces=list(request.tool_namespaces),
            )
        )
        log.info("agent %s (%s) registered", request.agent_id,
                 request.agent_type)
        return common_pb2.Status(success=True, message="registered")

    def UnregisterAgent(self, request, context):
        ok = self.router.unregister(request.id)
        return common_pb2.Status(success=ok)

    def Heartbeat(self, request, context):
        ok = self.router.heartbeat(
            request.agent_id,
            status=request.status,
            current_task_id=request.current_task_id,
        )
        return common_pb2.Status(
            success=ok, message="" if ok else "agent not registered"
        )

    def ListAgents(self, request, context):
        return orchestrator_pb2.AgentListResponse(
            agents=[
                common_pb2.AgentRegistration(
                    agent_id=a.agent_id,
                    agent_type=a.agent_type,
                    capabilities=a.capabilities,
                    tool_namespaces=a.tool_namespaces,
                    status=a.status if a.alive else "dead",
                    registered_at=a.registered_at,
                )
                for a in self.router.agents()
            ]
        )

    # -- system -------------------------------------------------------------

    def GetSystemStatus(self, request, context):
        vm = psutil.virtual_memory()
        active = self.engine.active_goals()
        pending = self.engine.unblocked_pending_tasks(limit=1000)
        return orchestrator_pb2.SystemStatusResponse(
            active_goals=len(active),
            pending_tasks=len(pending),
            active_agents=sum(1 for a in self.router.agents() if a.alive),
            loaded_models=list(self.loaded_models()),
            cpu_percent=psutil.cpu_percent(interval=None),
            memory_used_mb=vm.used / 1e6,
            memory_total_mb=vm.total / 1e6,
            autonomy_level="full",
            uptime_seconds=int(time.time() - self.started_at),
        )

    # -- task dispatch (polling pair, main.rs:299-383) ----------------------

    def GetAssignedTask(self, request, context):
        task = self.router.next_task_for(request.id)
        if task is None:
            return common_pb2.Task()  # empty = nothing assigned
        self.engine.set_task_status(task.id, "in_progress", agent=request.id)
        return self._task_proto(task)

    def ReportTaskResult(self, request, context):
        task = self.engine.tasks.get(request.task_id)
        if task is None:
            return common_pb2.Status(success=False, message="unknown task")
        output = {}
        if request.output_json:
            try:
                output = json.loads(request.output_json)
            except ValueError:
                output = {"raw": request.output_json.decode("utf-8", "replace")}
        if request.success:
            self.engine.complete_task(request.task_id, output=output)
        else:
            self.engine.set_task_status(
                request.task_id, "failed", error=request.error
            )
        if task.assigned_agent:
            self.router.task_finished(task.assigned_agent, request.success)
        self.aggregator.record(
            task.goal_id,
            TaskOutcome(
                task_id=task.id,
                success=request.success,
                output=output,
                error=request.error,
                duration_ms=request.duration_ms,
                tokens_used=request.tokens_used,
                model_used=request.model_used,
            ),
        )
        self.engine.check_goal_completion(task.goal_id)
        return common_pb2.Status(success=True)

    # -- capabilities (auto-grant quirk preserved, main.rs:395-411) ---------

    def RequestCapability(self, request, context):
        return orchestrator_pb2.CapabilityResponse(
            granted=True,
            capabilities=list(request.capabilities),
            expires_at="",
        )

    def RevokeCapability(self, request, context):
        return common_pb2.Status(success=True, message="revoked")

    # -- schedules (wired for real, unlike the reference stubs) -------------

    def CreateSchedule(self, request, context):
        try:
            sid = self.scheduler.create(
                request.cron_expr, request.goal_template,
                priority=request.priority or 5,
            )
        except ValueError as exc:
            return orchestrator_pb2.ScheduleResponse(success=False,
                                                     schedule_id=str(exc))
        return orchestrator_pb2.ScheduleResponse(schedule_id=sid, success=True)

    def ListSchedules(self, request, context):
        return orchestrator_pb2.ScheduleListResponse(
            schedules=[
                orchestrator_pb2.ScheduleEntry(
                    id=s.id,
                    cron_expr=s.cron_expr,
                    goal_template=s.goal_template,
                    priority=s.priority,
                    enabled=s.enabled,
                    last_run=s.last_run,
                )
                for s in self.scheduler.list()
            ]
        )

    def DeleteSchedule(self, request, context):
        ok = self.scheduler.delete(request.schedule_id)
        return common_pb2.Status(success=ok)

    # -- cluster (main.rs:470-553) ------------------------------------------

    def RegisterNode(self, request, context):
        self.cluster.register(
            ClusterNode(
                node_id=request.node_id,
                hostname=request.hostname,
                address=request.address,
                agents=list(request.agents),
                metadata=dict(request.metadata),
                max_tasks=request.max_tasks or 10,
            )
        )
        return common_pb2.Status(success=True)

    def NodeHeartbeat(self, request, context):
        ok = self.cluster.heartbeat(
            request.node_id,
            cpu=request.cpu_usage,
            memory=request.memory_usage,
            active_tasks=request.active_tasks,
        )
        return common_pb2.Status(success=ok)

    def ListNodes(self, request, context):
        return orchestrator_pb2.NodeListResponse(
            nodes=[
                orchestrator_pb2.NodeInfo(
                    node_id=n.node_id,
                    hostname=n.hostname,
                    address=n.address,
                    agents=n.agents,
                    cpu_usage=n.cpu_usage,
                    memory_usage=n.memory_usage,
                    active_tasks=n.active_tasks,
                    healthy=n.alive,
                )
                for n in self.cluster.nodes(include_dead=request.include_dead)
            ]
        )

    # -- proto adapters -----------------------------------------------------

    @staticmethod
    def _goal_proto(g) -> common_pb2.Goal:
        return common_pb2.Goal(
            id=g.id,
            description=g.description,
            priority=g.priority,
            source=g.source,
            status=g.status,
            created_at=g.created_at,
            updated_at=g.updated_at,
            tags=g.tags,
            metadata_json=json.dumps(g.metadata).encode(),
        )

    @staticmethod
    def _task_proto(t: Task) -> common_pb2.Task:
        return common_pb2.Task(
            id=t.id,
            goal_id=t.goal_id,
            description=t.description,
            assigned_agent=t.assigned_agent,
            status=t.status,
            intelligence_level=t.intelligence_level,
            required_tools=t.required_tools,
            depends_on=t.depends_on,
            input_json=json.dumps(t.input).encode(),
            output_json=json.dumps(t.output).encode(),
            created_at=t.created_at,
            started_at=t.started_at,
            completed_at=t.completed_at,
            error=t.error,
        )


def serve(
    address: Optional[str] = None,
    service: Optional[OrchestratorService] = None,
    block: bool = True,
    metrics_port: Optional[int] = None,
):
    """Start the orchestrator server (reference binds 0.0.0.0:50051,
    main.rs:791). ``metrics_port`` (or AIOS_ORCHESTRATOR_METRICS_PORT)
    also starts the /metrics + /healthz endpoint."""
    address = address or service_address("orchestrator")
    server = rpc.create_server(max_workers=32)
    service = service or OrchestratorService()
    rpc.add_to_server(ORCHESTRATOR, service, server)
    port = server.add_insecure_port(address)
    server.start()
    service.metrics_server, service.metrics_port = maybe_start_metrics_server(
        "orchestrator",
        metrics_port,
        health_fn=lambda: {"service": "orchestrator"},
    )
    log.info("Orchestrator listening on %s", address)
    if block:
        server.wait_for_termination()
    return server, service, port
