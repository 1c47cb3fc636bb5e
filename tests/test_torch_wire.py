"""Wire compatibility: the JAX package's service plane, unchanged, over the
port's runtime. Memory, tools, the gateway and the orchestrator of
``aios_tpu`` run on 127.0.0.1:0 with ``aios_tpu_torch``'s AIRuntime
(``synthetic://tiny-test`` on the CPU) behind the gateway's local provider:
a gateway Infer and StreamInfer return the port's tokens, the orchestrator
reads the port's models and serving counters, and a heuristic goal
completes."""

import json
import time

import pytest
import torch

from aios_tpu import rpc, services
from aios_tpu.proto_gen import api_gateway_pb2, common_pb2, orchestrator_pb2

torch.set_num_threads(1)

GOAL_DEADLINE = 60.0


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    from aios_tpu.gateway.router import RequestRouter
    from aios_tpu.gateway.service import serve as serve_gateway
    from aios_tpu.memory.service import serve as serve_memory
    from aios_tpu.orchestrator.autonomy import AutonomyConfig
    from aios_tpu.orchestrator.clients import ServiceClients
    from aios_tpu.orchestrator.main import build_orchestrator
    from aios_tpu.orchestrator.service import serve as serve_orch
    from aios_tpu.tools.executor import ToolExecutor
    from aios_tpu.tools.service import serve as serve_tools
    from aios_tpu_torch.proto_gen import runtime_pb2 as port_runtime_pb2
    from aios_tpu_torch.runtime.model_manager import ModelManager
    from aios_tpu_torch.runtime.service import serve as serve_port_runtime
    from aios_tpu_torch.services import AIRuntimeStub as PortRuntimeStub

    tmp = tmp_path_factory.mktemp("wire")
    servers, channels = [], []
    manager = ModelManager(num_slots=2, device="cpu")
    autonomy = None
    with pytest.MonkeyPatch.context() as mp:
        for var in ("CLAUDE_API_KEY", "OPENAI_API_KEY", "QWEN3_API_KEY",
                    "AIOS_TPU_GUIDED_TOOLCALLS"):
            mp.delenv(var, raising=False)
        try:
            server, _, mem_port = serve_memory(address="127.0.0.1:0", block=False)
            servers.append(server)
            server, _, tools_port = serve_tools(
                address="127.0.0.1:0",
                executor=ToolExecutor(audit_path=str(tmp / "audit.db"),
                                      backup_dir=str(tmp / "backups"),
                                      plugin_dir=str(tmp / "plugins")),
                block=False)
            servers.append(server)
            server, _, rt_port = serve_port_runtime("127.0.0.1:0", manager, block=False)
            servers.append(server)
            ch = rpc.insecure_channel(f"127.0.0.1:{rt_port}")
            channels.append(ch)
            st = PortRuntimeStub(ch).LoadModel(port_runtime_pb2.LoadModelRequest(
                model_name="tiny-port", model_path="synthetic://tiny-test"), timeout=300)
            assert st.status == "ready"
            server, _, gw_port = serve_gateway(
                address="127.0.0.1:0",
                router=RequestRouter(runtime_address=f"127.0.0.1:{rt_port}"), block=False)
            servers.append(server)
            clients = ServiceClients(
                runtime_addr=f"127.0.0.1:{rt_port}", tools_addr=f"127.0.0.1:{tools_port}",
                memory_addr=f"127.0.0.1:{mem_port}", gateway_addr=f"127.0.0.1:{gw_port}")
            (service, autonomy, *_rest, serving) = build_orchestrator(
                data_dir=str(tmp / "orch"), clients=clients,
                autonomy_config=AutonomyConfig(tick_interval=0.05))
            autonomy.start()
            server, _, orch_port = serve_orch(address="127.0.0.1:0", service=service,
                                              block=False)
            servers.append(server)

            def stub(port, cls):
                ch = rpc.insecure_channel(f"127.0.0.1:{port}")
                channels.append(ch)
                return cls(ch)

            yield {
                "orch": stub(orch_port, services.OrchestratorStub),
                "gateway": stub(gw_port, services.ApiGatewayStub),
                "runtime": stub(rt_port, services.AIRuntimeStub),
                "service": service, "serving": serving,
            }
        finally:
            if autonomy is not None:
                autonomy.stop()
            for ch in channels:
                ch.close()
            for server in servers:
                server.stop(grace=None)
            manager.close()


def test_jax_gateway_infer_reaches_the_port_runtime(mixed):
    resp = mixed["gateway"].Infer(
        api_gateway_pb2.ApiInferRequest(prompt="hello", max_tokens=8), timeout=120)
    assert resp.model_used.startswith("local/")
    assert resp.tokens_used > 0
    chunks = list(mixed["gateway"].StreamInfer(
        api_gateway_pb2.ApiInferRequest(prompt="stream it", max_tokens=8), timeout=120))
    assert chunks[-1].done and any(c.text for c in chunks[:-1])


def test_jax_stubs_read_the_port_runtime(mixed):
    models = mixed["runtime"].ListModels(common_pb2.Empty(), timeout=30)
    assert [m.model_name for m in models.models] == ["tiny-port"]
    health = mixed["runtime"].HealthCheck(common_pb2.Empty(), timeout=30)
    assert health.details["backend"] == "torch-cpu"
    # the orchestrator's serving feed parses the port's "k=v,..." counters
    stats = mixed["serving"]()
    assert stats["tiny-port"]["num_slots"] == 2.0


def test_jax_orchestrator_heuristic_goal_completes(mixed):
    orch = mixed["orch"]
    gid = orch.SubmitGoal(orchestrator_pb2.SubmitGoalRequest(description="check cpu usage"),
                          timeout=30).id
    deadline = time.time() + GOAL_DEADLINE
    status = orch.GetGoalStatus(common_pb2.GoalId(id=gid), timeout=30)
    while status.goal.status not in ("completed", "failed", "cancelled"):
        assert time.time() < deadline, status.goal.status
        time.sleep(0.02)
        status = orch.GetGoalStatus(common_pb2.GoalId(id=gid), timeout=30)
    assert status.goal.status == "completed"
    out = json.loads(status.tasks[0].output_json)
    assert out["tool_results"][0]["tool"] == "monitor.cpu"
    assert out["tool_results"][0]["success"]
