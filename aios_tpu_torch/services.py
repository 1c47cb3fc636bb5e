"""Method table of the ``aios.runtime.AIRuntime`` gRPC service.

A copy of the runtime part of ``aios_tpu/services.py``: the method list
mirrors ``runtime.proto``, and ``rpc`` turns it into stub and servicer
classes at import time.
"""

from __future__ import annotations

import os

from .proto_gen import common_pb2, runtime_pb2
from .rpc import Method, ServiceSpec, make_servicer, make_stub

RUNTIME_PORT = 50055  # the reference's runtime port


def service_address() -> str:
    """The runtime's address, honoring the AIOS_RUNTIME_ADDR override."""
    return os.environ.get("AIOS_RUNTIME_ADDR") or f"127.0.0.1:{RUNTIME_PORT}"


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

AIRuntimeStub = make_stub(RUNTIME)
AIRuntimeServicer = make_servicer(RUNTIME)
