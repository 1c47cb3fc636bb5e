"""Generated protobuf modules: byte-identical copies of aios_tpu's, so that
both packages' stubs can share one process (protobuf accepts a second
registration of an identical serialized file)."""
from . import common_pb2
from . import runtime_pb2

__all__ = ["common_pb2", "runtime_pb2"]
