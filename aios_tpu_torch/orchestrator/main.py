"""Orchestrator process wiring: service + background loops.

Reference parity (agent-core/src/main.rs:592-798): builds the shared state
and spawns the background loops — management console, health checker, agent
spawner, autonomy loop, proactive generator, scheduler, event bus, cluster
prune — then serves gRPC on :50051. All cross-service calls go through
gRPC stubs exactly as the reference's ServiceClients do.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Optional

import grpc

from ..proto_gen import api_gateway_pb2, memory_pb2, runtime_pb2, tools_pb2
from .agent_router import AgentRouter
from .autonomy import (
    TOKEN_BUDGETS,
    AutonomyConfig,
    AutonomyLoop,
    InferenceCancelled,
)
from .clients import HealthChecker, ServiceClients, ServiceRegistry
from .cluster import ClusterManager, RemoteExecutor
from .event_bus import EventBus, Subscription
from .goal_engine import GoalEngine
from .management import ManagementConsole
from .proactive import ProactiveGenerator
from .scheduler import GoalScheduler
from .service import OrchestratorService, serve
from .task_planner import TACTICAL, TaskPlanner
from .telemetry import DecisionLogger, ResultAggregator

log = logging.getLogger("aios.orchestrator.main")


def build_orchestrator(
    data_dir: str = "/tmp/aios/orchestrator",
    clients: Optional[ServiceClients] = None,
    autonomy_config: Optional[AutonomyConfig] = None,
):
    """Construct the full orchestrator state (no sockets yet)."""
    os.makedirs(data_dir, exist_ok=True)
    clients = clients or ServiceClients()

    # --- gRPC glue ---------------------------------------------------------

    def _infer_future(method, request, cancel_event):
        """Run a unary infer as a cancellable future: when cancel_event
        fires (CancelGoal mid-inference), cancel the gRPC call — the
        server's RPC-termination callback then aborts the downstream
        decode/cloud call — and raise InferenceCancelled so the autonomy
        loop stops without recording a failure."""
        fut = method.future(request, timeout=150)
        if cancel_event is None:
            return fut.result()
        while True:
            if cancel_event.is_set():
                fut.cancel()
                raise InferenceCancelled()
            try:
                return fut.result(timeout=0.1)
            except grpc.FutureTimeoutError:
                continue

    def gateway_infer(prompt: str, level: str = "", max_tokens: int = 0,
                      json_schema: str = "", cancel_event=None) -> str:
        """max_tokens carries the autonomy loop's per-level reasoning budget
        (autonomy.TOKEN_BUDGETS; reference autonomy.rs:596-607);
        json_schema the guided tool_calls shape (AIOS_TPU_GUIDED_TOOLCALLS),
        honored by the local TPU provider; cancel_event aborts the call
        mid-flight when its goal is cancelled."""
        resp = _infer_future(
            clients.gateway.Infer,
            api_gateway_pb2.ApiInferRequest(
                prompt=prompt,
                max_tokens=max_tokens,
                preferred_provider=(autonomy_config or AutonomyConfig()).preferred_provider,
                allow_fallback=True,
                requesting_agent="autonomy-loop",
                json_schema=json_schema,
            ),
            cancel_event,
        )
        return resp.text

    def runtime_infer(prompt: str, level: str = "", max_tokens: int = 0,
                      json_schema: str = "", cancel_event=None) -> str:
        resp = _infer_future(
            clients.runtime.Infer,
            runtime_pb2.InferRequest(
                prompt=prompt,
                max_tokens=max_tokens,
                intelligence_level=level or "tactical",
                requesting_agent="autonomy-loop",
                json_schema=json_schema,
            ),
            cancel_event,
        )
        return resp.text

    def execute_tool(tool: str, agent_id: str, args: dict) -> dict:
        resp = clients.tools.Execute(
            tools_pb2.ExecuteRequest(
                tool_name=tool,
                agent_id=agent_id,
                input_json=json.dumps(args).encode(),
                reason="autonomy",
            ),
            timeout=120,
        )
        output = {}
        if resp.output_json:
            try:
                output = json.loads(resp.output_json)
            except ValueError:
                pass
        return {"success": resp.success, "output": output, "error": resp.error}

    def memory_context(description: str, max_tokens: int) -> str:
        try:
            resp = clients.memory.AssembleContext(
                memory_pb2.ContextRequest(
                    task_description=description, max_tokens=max_tokens
                ),
                timeout=5,
            )
            return "\n".join(f"[{c.source}] {c.content}" for c in resp.chunks)
        except grpc.RpcError:
            return ""

    def tool_catalog() -> list:
        try:
            resp = clients.tools.ListTools(
                tools_pb2.ListToolsRequest(), timeout=5
            )
            return [t.name for t in resp.tools]
        except grpc.RpcError:
            return []

    def loaded_models() -> list:
        try:
            from ..proto_gen import common_pb2

            resp = clients.runtime.ListModels(common_pb2.Empty(), timeout=5)
            return [m.model_name for m in resp.models if m.status == "ready"]
        except grpc.RpcError:
            return []

    def serving_stats() -> dict:
        """Per-model serving counters from the runtime HealthCheck's
        `<model>.serving` detail strings ("k=v,k=v") — the proactive
        generator's pool-exhaustion / slot-starvation feed."""
        try:
            from ..proto_gen import common_pb2

            resp = clients.runtime.HealthCheck(common_pb2.Empty(), timeout=5)
        except grpc.RpcError:
            return {}
        out: dict = {}
        for key, raw in resp.details.items():
            if not key.endswith(".serving"):
                continue
            stats: dict = {}
            for pair in raw.split(","):
                k, _, v = pair.partition("=")
                try:
                    stats[k] = float(v)
                except ValueError:
                    continue
            out[key[: -len(".serving")]] = stats
        return out

    # --- components --------------------------------------------------------

    engine = GoalEngine(os.path.join(data_dir, "goals.db"))
    engine.recover()
    # planner decomposition runs at the tactical budget (8192 tokens)
    _plan_budget = TOKEN_BUDGETS[TACTICAL]
    planner = TaskPlanner(
        gateway_infer=lambda p: gateway_infer(p, TACTICAL, _plan_budget),
        runtime_infer=lambda p: runtime_infer(p, TACTICAL, _plan_budget),
    )
    router = AgentRouter()
    cluster = ClusterManager()
    aggregator = ResultAggregator()
    decisions = DecisionLogger()
    autonomy = AutonomyLoop(
        engine=engine,
        planner=planner,
        router=router,
        execute_tool=execute_tool,
        gateway_infer=gateway_infer,
        runtime_infer=runtime_infer,
        memory_context=memory_context,
        tool_catalog=tool_catalog,
        aggregator=aggregator,
        decisions=decisions,
        cluster=cluster,
        remote=RemoteExecutor(),
        config=autonomy_config,
    )
    scheduler = GoalScheduler(
        lambda d, p: engine.submit_goal(d, p, source="scheduler"),
        db_path=os.path.join(data_dir, "scheduler.db"),
    )
    event_bus = EventBus(
        submit_goal=lambda d, p: engine.submit_goal(d, p, source="event")
    )
    event_bus.subscribe(Subscription(
        pattern="service.unhealthy",
        min_severity="error",
        goal_template="Remediate unhealthy service reported by {source}",
        priority=9,
    ))
    from .event_bus import Event

    def _on_health_failure(name: str, failures: int) -> None:
        # >= 6 consecutive failures becomes a remediation goal via the bus
        # (proactive.rs:144-159 threshold)
        if failures >= 6:
            event_bus.publish(Event(
                "service.unhealthy", name, severity="error",
                data={"failures": failures},
            ))

    health = HealthChecker(on_failure=_on_health_failure)
    proactive = ProactiveGenerator(
        submit_goal=lambda d, p: engine.submit_goal(d, p, source="proactive"),
        active_goal_descriptions=lambda: [
            g.description for g in engine.active_goals()
        ],
        health_failures=health.failure_snapshot,
        failed_agents=lambda: [a.agent_id for a in router.dead_agents()],
        serving_stats=serving_stats,
    )
    service = OrchestratorService(
        engine=engine,
        planner=planner,
        router=router,
        autonomy=autonomy,
        scheduler=scheduler,
        cluster=cluster,
        aggregator=aggregator,
        loaded_models=loaded_models,
    )
    # run()'s console needs the same runtime-counters feed the proactive
    # generator uses — return it explicitly so the wiring stays fail-fast
    # (an ad-hoc service attribute + getattr fallback would degrade to a
    # silent None feed on the next refactor)
    return (service, autonomy, scheduler, proactive, health, event_bus,
            serving_stats)


def run(
    data_dir: str = "/tmp/aios/orchestrator",
    grpc_address: Optional[str] = None,
    console_port: int = 9090,
    spawn_agents: bool = True,
    block: bool = True,
):
    """Boot the full orchestrator process (main.rs:592-798 equivalent)."""
    (service, autonomy, scheduler, proactive, health, _bus,
     serving_stats) = build_orchestrator(data_dir)
    autonomy.start()
    scheduler.start()
    proactive.start()
    health.start()
    console = ManagementConsole(
        service, port=console_port, serving_stats=serving_stats,
        service_health=lambda: {
            name: fails == 0
            for name, fails in health.failure_snapshot().items()
        },
    )
    console.start()

    spawner = None
    if spawn_agents:
        from ..agents.spawner import AgentSpawner

        spawner = AgentSpawner()
        spawner.start()

    server, service, port = serve(address=grpc_address, service=service,
                                  block=False)
    log.info("orchestrator up: grpc :%s console :%s", port, console.bound_port)

    def shutdown():
        """Stop every loop run() started (embedders/tests; the supervisor
        child never calls it — it dies with the process)."""
        autonomy.stop()
        scheduler.stop()
        proactive.stop()
        health.stop()
        if spawner is not None:
            spawner.stop()
        console.stop()
        server.stop(grace=None)

    if block:
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass
    return server, service, console, autonomy, spawner, shutdown


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    run(data_dir=os.environ.get("AIOS_DATA_DIR", "/tmp/aios/orchestrator"))
