"""aios.tools.ToolRegistry gRPC service.

Reference parity: tools/src/main.rs — ListTools/GetTool/Execute/Rollback/
Register/Deregister over the executor pipeline (binds 0.0.0.0:50052,
main.rs:330).
"""

from __future__ import annotations

import json
import logging
from typing import Optional

import grpc

from .. import rpc
from ..proto_gen import tools_pb2 as pb
from ..services import TOOLS, ToolRegistryServicer, service_address
from .executor import ToolExecutor

log = logging.getLogger("aios.tools")


class ToolRegistryService(ToolRegistryServicer):
    def __init__(self, executor: Optional[ToolExecutor] = None):
        self.executor = executor or ToolExecutor()

    def ListTools(self, request, context):
        defs = self.executor.list_definitions(namespace=request.namespace)
        return pb.ListToolsResponse(tools=[self._to_proto(d) for d in defs])

    def GetTool(self, request, context):
        d = self.executor.definition(request.name)
        if d is None:
            context.set_code(grpc.StatusCode.NOT_FOUND)
            context.set_details(f"tool {request.name} not registered")
            return pb.ToolDefinition()
        return self._to_proto(d)

    def Execute(self, request, context):
        result = self.executor.execute(
            agent_id=request.agent_id,
            tool_name=request.tool_name,
            input_json=request.input_json,
            task_id=request.task_id,
            reason=request.reason,
        )
        return pb.ExecuteResponse(
            success=result.success,
            output_json=json.dumps(result.output).encode(),
            error=result.error,
            execution_id=result.execution_id,
            duration_ms=result.duration_ms,
            backup_id=result.backup_id,
        )

    def Rollback(self, request, context):
        ok, msg = self.executor.rollback(request.execution_id, request.reason)
        return pb.RollbackResponse(success=ok, error="" if ok else msg)

    def Register(self, request, context):
        if not request.tool.name:
            return pb.RegisterToolResponse(accepted=False, error="missing name")
        self.executor.register_external(
            {
                "name": request.tool.name,
                "namespace": request.tool.namespace,
                "version": request.tool.version or "0.0.1",
                "description": request.tool.description,
                "required_capabilities": list(request.tool.required_capabilities),
                "risk_level": request.tool.risk_level or "medium",
                "requires_confirmation": request.tool.requires_confirmation,
                "idempotent": request.tool.idempotent,
                "reversible": request.tool.reversible,
                "timeout_ms": request.tool.timeout_ms or 30_000,
                "rollback_tool": request.tool.rollback_tool,
            },
            request.handler_address,
        )
        return pb.RegisterToolResponse(accepted=True)

    def Deregister(self, request, context):
        ok = self.executor.deregister(request.tool_name)
        return pb.Status(
            success=ok,
            message="deregistered" if ok else f"{request.tool_name} not found",
        )

    @staticmethod
    def _to_proto(d: dict) -> pb.ToolDefinition:
        return pb.ToolDefinition(
            name=d["name"],
            namespace=d["namespace"],
            version=d.get("version", "1.0.0"),
            description=d.get("description", ""),
            required_capabilities=d.get("required_capabilities", []),
            risk_level=d.get("risk_level", "low"),
            requires_confirmation=d.get("requires_confirmation", False),
            idempotent=d.get("idempotent", False),
            reversible=d.get("reversible", False),
            timeout_ms=d.get("timeout_ms", 30_000),
            rollback_tool=d.get("rollback_tool", ""),
        )


def serve(
    address: Optional[str] = None,
    executor: Optional[ToolExecutor] = None,
    block: bool = True,
    metrics_port: Optional[int] = None,
):
    from ..obs.http import maybe_start_metrics_server

    address = address or service_address("tools")
    server = rpc.create_server()
    service = ToolRegistryService(executor)
    rpc.add_to_server(TOOLS, service, server)
    port = server.add_insecure_port(address)
    server.start()
    service.metrics_server, service.metrics_port = maybe_start_metrics_server(
        "tools",
        metrics_port,
        health_fn=lambda: {
            "service": "tools",
            "tools": len(service.executor.registry),
        },
    )
    log.info("ToolRegistry listening on %s (%d tools)",
             address, len(service.executor.registry))
    if block:
        server.wait_for_termination()
    return server, service, port


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    import os

    # under AIOS_DATA_DIR, the tree a boot gives its services, when set
    data_dir = os.environ.get("AIOS_DATA_DIR")
    dirs = {"backup_dir": os.path.join(data_dir, "backups"),
            "plugin_dir": os.path.join(data_dir, "plugins")} if data_dir else {}
    serve(
        executor=ToolExecutor(
            audit_path=os.environ.get("AIOS_AUDIT_DB", "/tmp/aios/audit.db"),
            **dirs,
        )
    )
