"""Generated protobuf modules: byte-identical copies of aios_tpu's, so that
both packages' stubs can share one process (protobuf accepts a second
registration of an identical serialized file)."""
from . import common_pb2
from . import runtime_pb2
from . import orchestrator_pb2
from . import agent_pb2
from . import tools_pb2
from . import api_gateway_pb2
from . import memory_pb2
from . import fleet_pb2

__all__ = [
    "common_pb2",
    "runtime_pb2",
    "orchestrator_pb2",
    "agent_pb2",
    "tools_pb2",
    "api_gateway_pb2",
    "memory_pb2",
    "fleet_pb2",
]
