"""aios.memory.MemoryService gRPC implementation (24 RPCs).

Reference parity: memory/src/main.rs — operational/working/long-term tiers,
knowledge base, and AssembleContext which merges tiers into token-budgeted
chunks (4-chars-per-token estimate, same as the reference's context
assembler, agent-core/src/context.rs:64-66,119-122).
"""

from __future__ import annotations

import logging
import time
from typing import Optional

from .. import rpc
from ..proto_gen import memory_pb2 as pb
from ..services import MEMORY, MemoryServiceServicer, service_address
from .migration import MigrationPipeline
from .tiers import LongTermMemory, OperationalMemory, WorkingMemory

log = logging.getLogger("aios.memory")

CHARS_PER_TOKEN = 4  # context.rs:64-66 token estimate


def _estimate_tokens(text: str) -> int:
    return max(1, len(text) // CHARS_PER_TOKEN)


class MemoryService(MemoryServiceServicer):
    def __init__(
        self,
        working_path: str = ":memory:",
        longterm_path: str = ":memory:",
        start_migration: bool = False,
    ):
        self.operational = OperationalMemory()
        self.working = WorkingMemory(working_path)
        self.longterm = LongTermMemory(longterm_path)
        self.migration = MigrationPipeline(
            self.operational, self.working, self.longterm
        )
        if start_migration:
            self.migration.start()
        self.started_at = time.time()

    # -- operational --------------------------------------------------------

    def PushEvent(self, request, context):
        self.operational.push_event(
            {
                "id": request.id,
                "timestamp": request.timestamp,
                "category": request.category,
                "source": request.source,
                "data_json": request.data_json.decode("utf-8", "replace"),
                "critical": request.critical,
            }
        )
        return pb.Empty()

    def GetRecentEvents(self, request, context):
        events = self.operational.recent_events(
            count=request.count or 50,
            category=request.category,
            source=request.source,
        )
        return pb.EventList(
            events=[
                pb.Event(
                    id=e.get("id", ""),
                    timestamp=e.get("timestamp", 0),
                    category=e.get("category", ""),
                    source=e.get("source", ""),
                    data_json=e.get("data_json", "").encode(),
                    critical=e.get("critical", False),
                )
                for e in events
            ]
        )

    def UpdateMetric(self, request, context):
        self.operational.update_metric(request.key, request.value, request.timestamp)
        return pb.Empty()

    def GetMetric(self, request, context):
        got = self.operational.get_metric(request.key)
        if got is None:
            return pb.MetricValue(key=request.key, value=0.0, timestamp=0)
        return pb.MetricValue(key=request.key, value=got[0], timestamp=got[1])

    def GetSystemSnapshot(self, request, context):
        try:
            import psutil

            vm = psutil.virtual_memory()
            disk = psutil.disk_usage("/")
            cpu = psutil.cpu_percent(interval=None)
            snap = pb.SystemSnapshot(
                cpu_percent=cpu,
                memory_used_mb=vm.used / 1e6,
                memory_total_mb=vm.total / 1e6,
                disk_used_gb=disk.used / 1e9,
                disk_total_gb=disk.total / 1e9,
            )
        except Exception:  # psutil unavailable -> zeros
            snap = pb.SystemSnapshot()
        active = self.operational.get_metric("tasks.active")
        agents = self.operational.get_metric("agents.active")
        snap.active_tasks = int(active[0]) if active else 0
        snap.active_agents = int(agents[0]) if agents else 0
        return snap

    # -- working ------------------------------------------------------------

    def StoreGoal(self, request, context):
        self.working.store_goal(
            {
                "id": request.id,
                "description": request.description,
                "status": request.status,
                "priority": request.priority,
                "created_at": request.created_at,
                "completed_at": request.completed_at,
                "result": request.result,
                "metadata_json": request.metadata_json.decode("utf-8", "replace"),
            }
        )
        return pb.Empty()

    def UpdateGoal(self, request, context):
        self.working.update_goal(request.id, request.status, request.result)
        return pb.Empty()

    def GetActiveGoals(self, request, context):
        return pb.GoalList(
            goals=[
                pb.GoalRecord(
                    id=g["id"],
                    description=g["description"],
                    status=g["status"],
                    priority=g["priority"],
                    created_at=g["created_at"],
                    completed_at=g["completed_at"],
                    result=g["result"],
                    metadata_json=g["metadata_json"].encode(),
                )
                for g in self.working.active_goals()
            ]
        )

    def StoreTask(self, request, context):
        self.working.store_task(
            {
                "id": request.id,
                "goal_id": request.goal_id,
                "description": request.description,
                "agent": request.agent,
                "status": request.status,
                "input_json": request.input_json.decode("utf-8", "replace"),
                "output_json": request.output_json.decode("utf-8", "replace"),
                "started_at": request.started_at,
                "completed_at": request.completed_at,
                "duration_ms": request.duration_ms,
                "error": request.error,
            }
        )
        return pb.Empty()

    def GetTasksForGoal(self, request, context):
        return pb.TaskList(
            tasks=[
                pb.TaskRecord(
                    id=t["id"],
                    goal_id=t["goal_id"],
                    description=t["description"],
                    agent=t["agent"],
                    status=t["status"],
                    input_json=t["input_json"].encode(),
                    output_json=t["output_json"].encode(),
                    started_at=t["started_at"],
                    completed_at=t["completed_at"],
                    duration_ms=t["duration_ms"],
                    error=t["error"],
                )
                for t in self.working.tasks_for_goal(request.goal_id)
            ]
        )

    def StoreToolCall(self, request, context):
        self.working.store_tool_call(
            {
                "id": request.id,
                "task_id": request.task_id,
                "tool_name": request.tool_name,
                "agent": request.agent,
                "input_json": request.input_json.decode("utf-8", "replace"),
                "output_json": request.output_json.decode("utf-8", "replace"),
                "success": request.success,
                "duration_ms": request.duration_ms,
                "reason": request.reason,
                "timestamp": request.timestamp,
            }
        )
        return pb.Empty()

    def StoreDecision(self, request, context):
        self.working.store_decision(
            {
                "id": request.id,
                "context": request.context,
                "options_json": request.options_json.decode("utf-8", "replace"),
                "chosen": request.chosen,
                "reasoning": request.reasoning,
                "intelligence_level": request.intelligence_level,
                "model_used": request.model_used,
                "outcome": request.outcome,
                "timestamp": request.timestamp,
            }
        )
        return pb.Empty()

    def StorePattern(self, request, context):
        self.working.store_pattern(
            {
                "id": request.id,
                "trigger": request.trigger,
                "action": request.action,
                "success_rate": request.success_rate,
                "uses": request.uses,
                "last_used": request.last_used,
                "created_from": request.created_from,
            }
        )
        return pb.Empty()

    def FindPattern(self, request, context):
        found = self.working.find_pattern(request.trigger, request.min_success_rate)
        if found is None:
            return pb.PatternResult(found=False)
        return pb.PatternResult(
            found=True,
            pattern=pb.Pattern(
                id=found["id"],
                trigger=found["trigger"],
                action=found["action"],
                success_rate=found["success_rate"],
                uses=found["uses"],
                last_used=found["last_used"],
                created_from=found["created_from"],
            ),
        )

    def UpdatePatternStats(self, request, context):
        self.working.update_pattern_stats(request.id, request.success)
        return pb.Empty()

    def StoreAgentState(self, request, context):
        self.working.store_agent_state(
            request.agent_name, request.state_json.decode("utf-8", "replace")
        )
        return pb.Empty()

    def GetAgentState(self, request, context):
        got = self.working.get_agent_state(request.agent_name)
        if got is None:
            return pb.AgentState(agent_name=request.agent_name)
        return pb.AgentState(
            agent_name=request.agent_name,
            state_json=got[0].encode(),
            updated_at=got[1],
        )

    # -- long-term ----------------------------------------------------------

    def SemanticSearch(self, request, context):
        results = self.longterm.search(
            request.query,
            collections=list(request.collections) or None,
            n_results=request.n_results or 5,
            min_relevance=request.min_relevance,
        )
        return self._search_results(results)

    def StoreProcedure(self, request, context):
        self.longterm.store_procedure(
            {
                "id": request.id,
                "name": request.name,
                "description": request.description,
                "steps_json": request.steps_json.decode("utf-8", "replace"),
                "success_count": request.success_count,
                "fail_count": request.fail_count,
                "avg_duration_ms": request.avg_duration_ms,
                "tags": list(request.tags),
                "created_at": request.created_at,
                "last_used": request.last_used,
            }
        )
        return pb.Empty()

    def StoreIncident(self, request, context):
        self.longterm.store_incident(
            {
                "id": request.id,
                "description": request.description,
                "symptoms_json": request.symptoms_json.decode("utf-8", "replace"),
                "root_cause": request.root_cause,
                "resolution": request.resolution,
                "resolved_by": request.resolved_by,
                "prevention": request.prevention,
                "timestamp": request.timestamp,
            }
        )
        return pb.Empty()

    def StoreConfigChange(self, request, context):
        self.longterm.store_config_change(
            {
                "id": request.id,
                "file_path": request.file_path,
                "content": request.content,
                "changed_by": request.changed_by,
                "reason": request.reason,
                "timestamp": request.timestamp,
            }
        )
        return pb.Empty()

    # -- knowledge ----------------------------------------------------------

    def SearchKnowledge(self, request, context):
        results = self.longterm.search_knowledge(
            request.query,
            n_results=request.n_results or 5,
            min_relevance=request.min_relevance,
        )
        return self._search_results(results)

    def AddKnowledge(self, request, context):
        self.longterm.add_knowledge(
            request.title, request.content, request.source, list(request.tags)
        )
        return pb.Empty()

    # -- context assembly ---------------------------------------------------

    def AssembleContext(self, request, context):
        """Merge tiers into token-budgeted chunks (memory.proto:255-259)."""
        budget = request.max_tokens or 1024
        tiers = set(request.memory_tiers) or {"operational", "working", "longterm"}
        query = request.task_description
        chunks = []
        used = 0

        def add(source: str, content: str, relevance: float) -> bool:
            nonlocal used
            tokens = _estimate_tokens(content)
            if used + tokens > budget:
                return False
            chunks.append(
                pb.ContextChunk(
                    source=source, content=content, relevance=relevance, tokens=tokens
                )
            )
            used += tokens
            return True

        if "longterm" in tiers:
            for r in self.longterm.search(query, n_results=5):
                if not add(f"longterm/{r['collection']}", r["content"], r["relevance"]):
                    break
            for r in self.longterm.search_knowledge(query, n_results=3):
                if not add("knowledge", r["content"], r["relevance"]):
                    break
        if "working" in tiers:
            pattern = self.working.find_pattern(query)
            if pattern is not None:
                add(
                    "working/pattern",
                    f"known pattern '{pattern['trigger']}' -> {pattern['action']}"
                    f" (success {pattern['success_rate']:.0%})",
                    pattern["success_rate"],
                )
            for g in self.working.active_goals()[:3]:
                add("working/goal", f"active goal: {g['description']}", 0.5)
        if "operational" in tiers:
            for ev in self.operational.recent_events(count=5):
                add(
                    "operational/event",
                    f"[{ev.get('category','')}] {ev.get('data_json','')}",
                    0.3,
                )

        return pb.ContextResponse(chunks=chunks, total_tokens=used)

    def _search_results(self, results) -> pb.SearchResults:
        return pb.SearchResults(
            results=[
                pb.SearchResult(
                    content=r["content"],
                    metadata_json=r["metadata_json"].encode(),
                    relevance=r["relevance"],
                    collection=r["collection"],
                    id=r["id"],
                )
                for r in results
            ]
        )


def serve(
    address: Optional[str] = None,
    data_dir: Optional[str] = None,
    block: bool = True,
    metrics_port: Optional[int] = None,
):
    """Start the memory service (reference binds 0.0.0.0:50053,
    memory/src/main.rs:511). ``metrics_port`` (or
    AIOS_MEMORY_METRICS_PORT) also starts /metrics + /healthz."""
    from ..obs.http import maybe_start_metrics_server

    address = address or service_address("memory")
    if data_dir:
        import os

        os.makedirs(data_dir, exist_ok=True)
        service = MemoryService(
            working_path=f"{data_dir}/working.db",
            longterm_path=f"{data_dir}/longterm.db",
            start_migration=True,
        )
    else:
        service = MemoryService(start_migration=True)
    server = rpc.create_server()
    rpc.add_to_server(MEMORY, service, server)
    port = server.add_insecure_port(address)
    server.start()
    service.metrics_server, service.metrics_port = maybe_start_metrics_server(
        "memory", metrics_port, health_fn=lambda: {"service": "memory"}
    )
    log.info("MemoryService listening on %s", address)
    if block:
        server.wait_for_termination()
    return server, service, port


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    import os

    serve(data_dir=os.environ.get("AIOS_DATA_DIR", "/tmp/aios/memory"))
