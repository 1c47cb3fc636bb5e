"""The port's AIRuntime gRPC service over a live localhost socket, on the CPU
(``device="cpu"``): the surface of tests/test_runtime_service.py."""

import grpc
import pytest
import torch

from aios_tpu_torch import rpc, services
from aios_tpu_torch.proto_gen import common_pb2, runtime_pb2
from aios_tpu_torch.runtime.model_manager import ModelManager
from aios_tpu_torch.runtime.service import serve

# The shapes here are tiny: one intra-op thread is faster and leaves the
# cores to the other test workers.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runtime_stub():
    manager = ModelManager(num_slots=2, device="cpu")
    server, _, port = serve(address="127.0.0.1:0", manager=manager, block=False)
    channel = rpc.insecure_channel(f"127.0.0.1:{port}")
    yield services.AIRuntimeStub(channel), manager
    manager.close()
    channel.close()
    server.stop(grace=None)


def test_no_models_unavailable(runtime_stub):
    stub, _ = runtime_stub
    with pytest.raises(grpc.RpcError) as err:
        stub.Infer(runtime_pb2.InferRequest(prompt="hi"))
    assert err.value.code() == grpc.StatusCode.UNAVAILABLE


def test_load_model_and_infer(runtime_stub):
    stub, _ = runtime_stub
    status = stub.LoadModel(runtime_pb2.LoadModelRequest(
        model_name="tinyllama-test", model_path="synthetic://tiny-test"))
    assert status.status == "ready"
    resp = stub.Infer(runtime_pb2.InferRequest(prompt="hello", max_tokens=8))
    assert resp.model_used == "tinyllama-test"
    assert resp.tokens_used > 0
    models = stub.ListModels(common_pb2.Empty())
    assert [m.model_name for m in models.models] == ["tinyllama-test"]
    assert models.models[0].request_count >= 1


def test_stream_infer_ends_with_done(runtime_stub):
    stub, _ = runtime_stub
    chunks = list(stub.StreamInfer(
        runtime_pb2.InferRequest(prompt="hello", max_tokens=6, temperature=0.3)))
    assert chunks[-1].done
    assert all(not c.done for c in chunks[:-1])


def test_level_routing_and_errors(runtime_stub):
    stub, _ = runtime_stub
    resp = stub.Infer(runtime_pb2.InferRequest(
        prompt="status?", intelligence_level="operational", max_tokens=4))
    assert resp.model_used == "tinyllama-test"
    with pytest.raises(grpc.RpcError) as err:
        stub.Infer(runtime_pb2.InferRequest(prompt="x", intelligence_level="reactive"))
    assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    with pytest.raises(grpc.RpcError) as err:
        stub.Infer(runtime_pb2.InferRequest(prompt="x", model="nonexistent-13b"))
    assert err.value.code() == grpc.StatusCode.NOT_FOUND


def test_health_reports_backend_and_models(runtime_stub):
    stub, _ = runtime_stub
    h = stub.HealthCheck(common_pb2.Empty())
    assert h.healthy
    assert h.details["backend"] == "torch-cpu"
    assert h.details["tinyllama-test"] == "ready"
    assert "completed=" in h.details["tinyllama-test.serving"]


def test_unload_model(runtime_stub):
    stub, manager = runtime_stub
    assert stub.UnloadModel(runtime_pb2.UnloadModelRequest(model_name="tinyllama-test")).success
    assert not manager.models
