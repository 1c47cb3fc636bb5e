"""Method tables for every aiOS gRPC service.

One `ServiceSpec` per proto service; `aios_tpu_torch.rpc` turns these into stub and
servicer classes at import time. The method lists mirror the proto files in
`aios_tpu/protos/` exactly (which in turn are wire-compatible with the
reference's agent-core/proto).

Default port assignments follow the reference truth table (SURVEY.md section 1):
orchestrator 50051, tools 50052, memory 50053, api-gateway 50054, runtime 50055,
management console HTTP 9090.
"""

from __future__ import annotations

import os

from .proto_gen import (
    agent_pb2,
    api_gateway_pb2,
    common_pb2,
    fleet_pb2,
    memory_pb2,
    orchestrator_pb2,
    runtime_pb2,
    tools_pb2,
)
from .rpc import Method, ServiceSpec, make_servicer, make_stub

# ---------------------------------------------------------------------------
# Default service addresses (env-overridable, same vars as the reference's
# agent-core/src/clients.rs:37-44 / base.py:59-62).
# ---------------------------------------------------------------------------

DEFAULT_PORTS = {
    "orchestrator": 50051,
    "tools": 50052,
    "memory": 50053,
    "gateway": 50054,
    "runtime": 50055,
    "console": 9090,
}


def service_address(name: str) -> str:
    """Resolve a service address, honoring AIOS_<NAME>_ADDR overrides."""
    env = os.environ.get(f"AIOS_{name.upper()}_ADDR")
    if env:
        return env
    return f"127.0.0.1:{DEFAULT_PORTS[name]}"


# ---------------------------------------------------------------------------
# aios.runtime.AIRuntime
# ---------------------------------------------------------------------------

RUNTIME = ServiceSpec(
    "aios.runtime.AIRuntime",
    {
        "LoadModel": Method(runtime_pb2.LoadModelRequest, runtime_pb2.ModelStatus),
        "UnloadModel": Method(runtime_pb2.UnloadModelRequest, common_pb2.Status),
        "ListModels": Method(common_pb2.Empty, runtime_pb2.ModelList),
        "Infer": Method(runtime_pb2.InferRequest, runtime_pb2.InferResponse),
        "StreamInfer": Method(
            runtime_pb2.InferRequest, runtime_pb2.InferChunk, server_streaming=True
        ),
        "HealthCheck": Method(common_pb2.Empty, common_pb2.HealthStatus),
    },
)

# ---------------------------------------------------------------------------
# aios.orchestrator.Orchestrator (19 RPCs)
# ---------------------------------------------------------------------------

ORCHESTRATOR = ServiceSpec(
    "aios.orchestrator.Orchestrator",
    {
        "SubmitGoal": Method(orchestrator_pb2.SubmitGoalRequest, common_pb2.GoalId),
        "GetGoalStatus": Method(
            common_pb2.GoalId, orchestrator_pb2.GoalStatusResponse
        ),
        "CancelGoal": Method(common_pb2.GoalId, common_pb2.Status),
        "ListGoals": Method(
            orchestrator_pb2.ListGoalsRequest, orchestrator_pb2.GoalListResponse
        ),
        "RegisterAgent": Method(common_pb2.AgentRegistration, common_pb2.Status),
        "UnregisterAgent": Method(common_pb2.AgentId, common_pb2.Status),
        "Heartbeat": Method(orchestrator_pb2.HeartbeatRequest, common_pb2.Status),
        "ListAgents": Method(common_pb2.Empty, orchestrator_pb2.AgentListResponse),
        "GetSystemStatus": Method(
            common_pb2.Empty, orchestrator_pb2.SystemStatusResponse
        ),
        "GetAssignedTask": Method(common_pb2.AgentId, common_pb2.Task),
        "ReportTaskResult": Method(common_pb2.TaskResult, common_pb2.Status),
        "RequestCapability": Method(
            orchestrator_pb2.CapabilityRequest, orchestrator_pb2.CapabilityResponse
        ),
        "RevokeCapability": Method(
            orchestrator_pb2.CapabilityRevocation, common_pb2.Status
        ),
        "CreateSchedule": Method(
            orchestrator_pb2.CreateScheduleRequest, orchestrator_pb2.ScheduleResponse
        ),
        "ListSchedules": Method(
            common_pb2.Empty, orchestrator_pb2.ScheduleListResponse
        ),
        "DeleteSchedule": Method(
            orchestrator_pb2.DeleteScheduleRequest, common_pb2.Status
        ),
        "RegisterNode": Method(orchestrator_pb2.NodeRegistration, common_pb2.Status),
        "NodeHeartbeat": Method(orchestrator_pb2.NodeStatus, common_pb2.Status),
        "ListNodes": Method(
            orchestrator_pb2.ListNodesRequest, orchestrator_pb2.NodeListResponse
        ),
    },
)

# ---------------------------------------------------------------------------
# aios.agent.Agent
# ---------------------------------------------------------------------------

AGENT = ServiceSpec(
    "aios.agent.Agent",
    {
        "ExecuteTask": Method(common_pb2.Task, common_pb2.TaskResult),
        "CancelTask": Method(agent_pb2.CancelTaskRequest, common_pb2.Status),
        "GetStatus": Method(common_pb2.Empty, agent_pb2.AgentStatusResponse),
        "Shutdown": Method(common_pb2.Empty, common_pb2.Status),
    },
)

# ---------------------------------------------------------------------------
# aios.tools.ToolRegistry
# ---------------------------------------------------------------------------

TOOLS = ServiceSpec(
    "aios.tools.ToolRegistry",
    {
        "ListTools": Method(tools_pb2.ListToolsRequest, tools_pb2.ListToolsResponse),
        "GetTool": Method(tools_pb2.GetToolRequest, tools_pb2.ToolDefinition),
        "Execute": Method(tools_pb2.ExecuteRequest, tools_pb2.ExecuteResponse),
        "Rollback": Method(tools_pb2.RollbackRequest, tools_pb2.RollbackResponse),
        "Register": Method(
            tools_pb2.RegisterToolRequest, tools_pb2.RegisterToolResponse
        ),
        "Deregister": Method(tools_pb2.DeregisterToolRequest, tools_pb2.Status),
    },
)

# ---------------------------------------------------------------------------
# aios.api_gateway.ApiGateway
# ---------------------------------------------------------------------------

GATEWAY = ServiceSpec(
    "aios.api_gateway.ApiGateway",
    {
        "Infer": Method(
            api_gateway_pb2.ApiInferRequest, common_pb2.InferenceResponse
        ),
        "StreamInfer": Method(
            api_gateway_pb2.ApiInferRequest,
            api_gateway_pb2.StreamChunk,
            server_streaming=True,
        ),
        "GetBudget": Method(common_pb2.Empty, api_gateway_pb2.BudgetStatus),
        "GetUsage": Method(
            api_gateway_pb2.UsageRequest, api_gateway_pb2.UsageResponse
        ),
    },
)

# ---------------------------------------------------------------------------
# aios.memory.MemoryService (23 RPCs)
# ---------------------------------------------------------------------------

_M = memory_pb2
MEMORY = ServiceSpec(
    "aios.memory.MemoryService",
    {
        # operational
        "PushEvent": Method(_M.Event, _M.Empty),
        "GetRecentEvents": Method(_M.RecentEventsRequest, _M.EventList),
        "UpdateMetric": Method(_M.MetricUpdate, _M.Empty),
        "GetMetric": Method(_M.MetricRequest, _M.MetricValue),
        "GetSystemSnapshot": Method(_M.Empty, _M.SystemSnapshot),
        # working
        "StoreGoal": Method(_M.GoalRecord, _M.Empty),
        "UpdateGoal": Method(_M.GoalUpdate, _M.Empty),
        "GetActiveGoals": Method(_M.Empty, _M.GoalList),
        "StoreTask": Method(_M.TaskRecord, _M.Empty),
        "GetTasksForGoal": Method(_M.GoalIdRequest, _M.TaskList),
        "StoreToolCall": Method(_M.ToolCallRecord, _M.Empty),
        "StoreDecision": Method(_M.Decision, _M.Empty),
        "StorePattern": Method(_M.Pattern, _M.Empty),
        "FindPattern": Method(_M.PatternQuery, _M.PatternResult),
        "UpdatePatternStats": Method(_M.PatternStatsUpdate, _M.Empty),
        "StoreAgentState": Method(_M.AgentState, _M.Empty),
        "GetAgentState": Method(_M.AgentStateRequest, _M.AgentState),
        # long-term
        "SemanticSearch": Method(_M.SemanticSearchRequest, _M.SearchResults),
        "StoreProcedure": Method(_M.Procedure, _M.Empty),
        "StoreIncident": Method(_M.Incident, _M.Empty),
        "StoreConfigChange": Method(_M.ConfigChange, _M.Empty),
        # knowledge
        "SearchKnowledge": Method(_M.SemanticSearchRequest, _M.SearchResults),
        "AddKnowledge": Method(_M.KnowledgeEntry, _M.Empty),
        # context
        "AssembleContext": Method(_M.ContextRequest, _M.ContextResponse),
    },
)

# ---------------------------------------------------------------------------
# aios.fleet.KvTransfer — the fleet data plane (aios_tpu_torch/fleet/): cross-host
# HostPageStore transfer (pull-on-miss Fetch, push-on-prefill Push) and the
# disaggregated prefill->decode Handoff stream. No reference counterpart.
# ---------------------------------------------------------------------------

KVTRANSFER = ServiceSpec(
    "aios.fleet.KvTransfer",
    {
        "Fetch": Method(
            fleet_pb2.FetchRequest, fleet_pb2.PageChunk,
            server_streaming=True,
        ),
        "Push": Method(
            fleet_pb2.PageChunk, fleet_pb2.PushAck, client_streaming=True,
        ),
        "Handoff": Method(
            fleet_pb2.HandoffRequest, fleet_pb2.HandoffChunk,
            server_streaming=True,
        ),
    },
)

ALL_SPECS = {
    "runtime": RUNTIME,
    "orchestrator": ORCHESTRATOR,
    "agent": AGENT,
    "tools": TOOLS,
    "gateway": GATEWAY,
    "memory": MEMORY,
    "kvtransfer": KVTRANSFER,
}

# Stub / servicer classes (equivalent surface to grpcio-tools output).
AIRuntimeStub = make_stub(RUNTIME)
AIRuntimeServicer = make_servicer(RUNTIME)
OrchestratorStub = make_stub(ORCHESTRATOR)
OrchestratorServicer = make_servicer(ORCHESTRATOR)
AgentStub = make_stub(AGENT)
AgentServicer = make_servicer(AGENT)
ToolRegistryStub = make_stub(TOOLS)
ToolRegistryServicer = make_servicer(TOOLS)
ApiGatewayStub = make_stub(GATEWAY)
ApiGatewayServicer = make_servicer(GATEWAY)
MemoryServiceStub = make_stub(MEMORY)
MemoryServiceServicer = make_servicer(MEMORY)
KvTransferStub = make_stub(KVTRANSFER)
KvTransferServicer = make_servicer(KVTRANSFER)
