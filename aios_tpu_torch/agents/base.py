"""BaseAgent: lifecycle, service stubs, tool/memory/think helpers.

Reference parity (agent-core/python/aios_agent/base.py, 922 LoC):
  * run() = RegisterAgent + heartbeat loop (10 s) + task poll loop (2 s)
    (base.py:871-901); poll -> execute -> ReportTaskResult (749-802);
  * lazily-created stubs to orchestrator/tools/memory/runtime/gateway
    (147-197) with env-overridable addresses;
  * call_tool / rollback_tool / list_tools (271-324);
  * memory helpers: store/recall/push_event/get_recent_events/
    update_metric/get_metric/store_pattern/find_pattern/store_decision/
    semantic_search/assemble_context (356-566);
  * think(prompt, level) -> runtime Infer (572-616);
  * execute_task bookkeeping wrapper with duration + error capture (808-855).

Deliberate deviation: the reference uses grpc.aio; this build uses sync gRPC
stubs driven by daemon threads — one fewer runtime (no asyncio) in the agent
processes and identical observable behavior through the wire.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import uuid
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional

import grpc

from .. import rpc
from ..proto_gen import (
    api_gateway_pb2,
    common_pb2,
    memory_pb2,
    orchestrator_pb2,
    runtime_pb2,
    tools_pb2,
)
from ..services import (
    AIRuntimeStub,
    ApiGatewayStub,
    MemoryServiceStub,
    OrchestratorStub,
    ToolRegistryStub,
    service_address,
)

HEARTBEAT_INTERVAL = 10.0  # base.py:63
POLL_INTERVAL = 2.0  # base.py:112


class BaseAgent(ABC):
    """Abstract agent; subclasses implement handle_task and metadata."""

    def __init__(self, name: Optional[str] = None):
        agent_type = self.get_agent_type()
        self.agent_id = (
            name
            or os.environ.get("AIOS_AGENT_NAME")
            or f"{agent_type}_agent-{uuid.uuid4().hex[:6]}"
        )
        self.log = logging.getLogger(f"aios.agent.{self.agent_id}")
        self.status = "idle"
        self.current_task_id = ""
        self.tasks_completed = 0
        self.tasks_failed = 0
        self.started_at = time.time()
        self._stubs: Dict[str, Any] = {}
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

    # -- abstract surface (base.py:121-141) ---------------------------------

    @abstractmethod
    def get_agent_type(self) -> str: ...

    @abstractmethod
    def get_capabilities(self) -> List[str]: ...

    @abstractmethod
    def get_tool_namespaces(self) -> List[str]: ...

    @abstractmethod
    def handle_task(self, task: Dict[str, Any]) -> Dict[str, Any]:
        """Execute one task dict; return a JSON-able output dict."""

    def periodic(self) -> None:
        """Optional background duty cycle (overridden by agents)."""

    periodic_interval: float = 30.0

    # -- stubs --------------------------------------------------------------

    def _stub(self, name: str, cls):
        stub = self._stubs.get(name)
        if stub is None:
            stub = cls(rpc.insecure_channel(service_address(name)))
            self._stubs[name] = stub
        return stub

    @property
    def orchestrator(self) -> OrchestratorStub:  # type: ignore[valid-type]
        return self._stub("orchestrator", OrchestratorStub)

    @property
    def tools(self) -> ToolRegistryStub:  # type: ignore[valid-type]
        return self._stub("tools", ToolRegistryStub)

    @property
    def memory(self) -> MemoryServiceStub:  # type: ignore[valid-type]
        return self._stub("memory", MemoryServiceStub)

    @property
    def runtime(self) -> AIRuntimeStub:  # type: ignore[valid-type]
        return self._stub("runtime", AIRuntimeStub)

    @property
    def gateway(self) -> ApiGatewayStub:  # type: ignore[valid-type]
        return self._stub("gateway", ApiGatewayStub)

    # -- tools (base.py:271-324) --------------------------------------------

    def call_tool(
        self, tool_name: str, args: Optional[dict] = None, reason: str = ""
    ) -> Dict[str, Any]:
        resp = self.tools.Execute(
            tools_pb2.ExecuteRequest(
                tool_name=tool_name,
                agent_id=self.agent_id,
                task_id=self.current_task_id,
                input_json=json.dumps(args or {}).encode(),
                reason=reason,
            ),
            timeout=120,
        )
        output = {}
        if resp.output_json:
            try:
                output = json.loads(resp.output_json)
            except ValueError:
                pass
        result = {
            "success": resp.success,
            "output": output,
            "error": resp.error,
            "execution_id": resp.execution_id,
        }
        self.store_tool_call(tool_name, args or {}, result)
        return result

    def rollback_tool(self, execution_id: str, reason: str = "") -> bool:
        resp = self.tools.Rollback(
            tools_pb2.RollbackRequest(execution_id=execution_id, reason=reason),
            timeout=60,
        )
        return resp.success

    def list_tools(self, namespace: str = "") -> List[str]:
        resp = self.tools.ListTools(
            tools_pb2.ListToolsRequest(namespace=namespace), timeout=10
        )
        return [t.name for t in resp.tools]

    # -- memory helpers (base.py:356-566) -----------------------------------

    def push_event(
        self, category: str, data: dict, critical: bool = False
    ) -> None:
        self.memory.PushEvent(
            memory_pb2.Event(
                category=category,
                source=self.agent_id,
                data_json=json.dumps(data).encode(),
                critical=critical,
                timestamp=int(time.time()),
            ),
            timeout=5,
        )

    def get_recent_events(self, count: int = 20, category: str = "") -> List[dict]:
        resp = self.memory.GetRecentEvents(
            memory_pb2.RecentEventsRequest(count=count, category=category),
            timeout=5,
        )
        return [
            {
                "category": e.category,
                "source": e.source,
                "data": json.loads(e.data_json or b"{}"),
                "timestamp": e.timestamp,
            }
            for e in resp.events
        ]

    def update_metric(self, key: str, value: float) -> None:
        self.memory.UpdateMetric(
            memory_pb2.MetricUpdate(key=key, value=value,
                                    timestamp=int(time.time())),
            timeout=5,
        )

    def get_metric(self, key: str) -> Optional[float]:
        resp = self.memory.GetMetric(memory_pb2.MetricRequest(key=key),
                                     timeout=5)
        return resp.value if resp.timestamp else None

    def store_pattern(self, trigger: str, action: str,
                      success_rate: float = 1.0) -> None:
        self.memory.StorePattern(
            memory_pb2.Pattern(
                id=str(uuid.uuid4()), trigger=trigger, action=action,
                success_rate=success_rate, uses=1,
                last_used=int(time.time()),
                created_from=self.agent_id,
            ),
            timeout=5,
        )

    def find_pattern(self, trigger: str,
                     min_success_rate: float = 0.5) -> Optional[dict]:
        resp = self.memory.FindPattern(
            memory_pb2.PatternQuery(trigger=trigger,
                                    min_success_rate=min_success_rate),
            timeout=5,
        )
        if not resp.found:
            return None
        return {
            "id": resp.pattern.id,
            "trigger": resp.pattern.trigger,
            "action": resp.pattern.action,
            "success_rate": resp.pattern.success_rate,
        }

    def store_decision(self, context: str, chosen: str, reasoning: str,
                       outcome: str = "") -> None:
        self.memory.StoreDecision(
            memory_pb2.Decision(
                id=str(uuid.uuid4()), context=context, chosen=chosen,
                reasoning=reasoning, outcome=outcome,
                timestamp=int(time.time()),
            ),
            timeout=5,
        )

    def store_tool_call(self, tool: str, args: dict, result: dict) -> None:
        try:
            self.memory.StoreToolCall(
                memory_pb2.ToolCallRecord(
                    id=str(uuid.uuid4()),
                    task_id=self.current_task_id,
                    tool_name=tool,
                    agent=self.agent_id,
                    input_json=json.dumps(args).encode(),
                    output_json=json.dumps(result.get("output", {}))[:4000].encode(),
                    success=bool(result.get("success")),
                    timestamp=int(time.time()),
                ),
                timeout=5,
            )
        except grpc.RpcError:
            pass  # memory being down must not break tool calls

    def semantic_search(self, query: str, n_results: int = 5) -> List[dict]:
        resp = self.memory.SemanticSearch(
            memory_pb2.SemanticSearchRequest(query=query, n_results=n_results),
            timeout=10,
        )
        return [
            {"content": r.content, "relevance": r.relevance,
             "collection": r.collection}
            for r in resp.results
        ]

    def assemble_context(self, description: str, max_tokens: int = 512) -> str:
        resp = self.memory.AssembleContext(
            memory_pb2.ContextRequest(task_description=description,
                                      max_tokens=max_tokens),
            timeout=10,
        )
        return "\n".join(f"[{c.source}] {c.content}" for c in resp.chunks)

    # -- inference (base.py:572-616) ----------------------------------------

    def think(self, prompt: str, level: str = "operational",
              max_tokens: int = 512) -> str:
        resp = self.runtime.Infer(
            runtime_pb2.InferRequest(
                prompt=prompt,
                intelligence_level=level,
                max_tokens=max_tokens,
                requesting_agent=self.agent_id,
                task_id=self.current_task_id,
            ),
            timeout=150,
        )
        return resp.text

    # -- lifecycle (base.py:871-901) ----------------------------------------

    def register(self) -> bool:
        resp = self.orchestrator.RegisterAgent(
            common_pb2.AgentRegistration(
                agent_id=self.agent_id,
                agent_type=self.get_agent_type(),
                capabilities=self.get_capabilities(),
                tool_namespaces=self.get_tool_namespaces(),
                status="idle",
                registered_at=int(time.time()),
            ),
            timeout=10,
        )
        return resp.success

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(HEARTBEAT_INTERVAL):
            try:
                self.orchestrator.Heartbeat(
                    orchestrator_pb2.HeartbeatRequest(
                        agent_id=self.agent_id,
                        status=self.status,
                        current_task_id=self.current_task_id,
                    ),
                    timeout=5,
                )
            except grpc.RpcError:
                self.log.warning("heartbeat failed; orchestrator unreachable")

    def _poll_loop(self) -> None:
        while not self._stop.wait(POLL_INTERVAL):
            try:
                self._poll_and_execute()
            except grpc.RpcError:
                continue
            except Exception:  # noqa: BLE001
                self.log.exception("task execution crashed")

    def _poll_and_execute(self) -> None:
        task = self.orchestrator.GetAssignedTask(
            common_pb2.AgentId(id=self.agent_id), timeout=10
        )
        if not task.id:
            return
        result = self.execute_task(
            {
                "id": task.id,
                "goal_id": task.goal_id,
                "description": task.description,
                "intelligence_level": task.intelligence_level,
                "required_tools": list(task.required_tools),
                "input": json.loads(task.input_json or b"{}"),
            }
        )
        self.orchestrator.ReportTaskResult(
            common_pb2.TaskResult(
                task_id=task.id,
                success=result["success"],
                output_json=json.dumps(result.get("output", {})).encode(),
                error=result.get("error", ""),
                duration_ms=result.get("duration_ms", 0),
                tokens_used=result.get("tokens_used", 0),
                model_used=result.get("model_used", ""),
            ),
            timeout=10,
        )

    def execute_task(self, task: Dict[str, Any]) -> Dict[str, Any]:
        """Bookkeeping wrapper around handle_task (base.py:808-855)."""
        self.status = "busy"
        self.current_task_id = task["id"]
        t0 = time.time()
        try:
            output = self.handle_task(task)
            result = {
                "success": True,
                "output": output or {},
                "duration_ms": int((time.time() - t0) * 1000),
            }
            self.tasks_completed += 1
        except Exception as exc:  # noqa: BLE001
            result = {
                "success": False,
                "output": {},
                "error": str(exc),
                "duration_ms": int((time.time() - t0) * 1000),
            }
            self.tasks_failed += 1
            self.log.warning("task %s failed: %s", task["id"], exc)
        finally:
            self.status = "idle"
            self.current_task_id = ""
        return result

    def _periodic_loop(self) -> None:
        while not self._stop.wait(self.periodic_interval):
            try:
                self.periodic()
            except Exception:  # noqa: BLE001
                self.log.exception("periodic duty failed")

    def run(self, block: bool = True) -> None:
        deadline = time.time() + 60
        while time.time() < deadline:
            try:
                if self.register():
                    break
            except grpc.RpcError:
                time.sleep(2)
        else:
            raise RuntimeError("could not register with orchestrator")
        self.log.info("registered as %s", self.agent_id)
        for target in (self._heartbeat_loop, self._poll_loop,
                       self._periodic_loop):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)
        if block:
            try:
                while not self._stop.wait(3600):
                    pass
            except KeyboardInterrupt:
                self.shutdown()

    def shutdown(self) -> None:
        self._stop.set()
        try:
            self.orchestrator.UnregisterAgent(
                common_pb2.AgentId(id=self.agent_id), timeout=5
            )
        except grpc.RpcError:
            pass
        for t in self._threads:
            t.join(timeout=2)
