"""Programmatic gRPC stub/servicer construction.

A copy of the parts of ``aios_tpu/rpc.py`` the services need: each
service is described once by a ``ServiceSpec`` (method name -> request and
response classes + streaming flags) and turned, at import time, into what
grpcio-tools would generate — a Stub class, an abstract Servicer base and a
registration function. The JAX package's observability, fault-injection and
per-edge network-fault interceptors are not ported yet.
"""

from __future__ import annotations

import concurrent.futures
from dataclasses import dataclass, field
from typing import Any, Callable, Dict

import grpc

_MAX_MESSAGE = 64 * 1024 * 1024


@dataclass(frozen=True)
class Method:
    """One RPC: request/response message classes and streaming flags."""

    request: Any
    response: Any
    server_streaming: bool = False
    client_streaming: bool = False

    @property
    def cardinality(self) -> str:
        lhs = "stream" if self.client_streaming else "unary"
        rhs = "stream" if self.server_streaming else "unary"
        return f"{lhs}_{rhs}"


@dataclass(frozen=True)
class ServiceSpec:
    """A full gRPC service: package-qualified name plus its method table."""

    full_name: str  # e.g. "aios.runtime.AIRuntime"
    methods: Dict[str, Method] = field(default_factory=dict)

    def path(self, method: str) -> str:
        return f"/{self.full_name}/{method}"


def make_stub(spec: ServiceSpec) -> type:
    """Build a Stub class equivalent to grpcio-tools' ``<Service>Stub``."""

    def __init__(self, channel: grpc.Channel) -> None:
        for name, m in spec.methods.items():
            factory = getattr(channel, m.cardinality)
            setattr(
                self,
                name,
                factory(
                    spec.path(name),
                    request_serializer=m.request.SerializeToString,
                    response_deserializer=m.response.FromString,
                ),
            )

    return type(
        spec.full_name.rsplit(".", 1)[-1] + "Stub",
        (object,),
        {"__init__": __init__, "__doc__": f"Client stub for {spec.full_name}."},
    )


def make_servicer(spec: ServiceSpec) -> type:
    """Build an abstract Servicer base (methods default to UNIMPLEMENTED)."""

    def _unimplemented(name: str) -> Callable:
        def method(self, request, context):  # noqa: ANN001
            context.set_code(grpc.StatusCode.UNIMPLEMENTED)
            context.set_details(f"{name} is not implemented")
            raise NotImplementedError(name)

        method.__name__ = name
        return method

    body = {name: _unimplemented(name) for name in spec.methods}
    body["__doc__"] = f"Servicer base for {spec.full_name}."
    return type(spec.full_name.rsplit(".", 1)[-1] + "Servicer", (object,), body)


def add_to_server(spec: ServiceSpec, servicer: Any, server: grpc.Server) -> None:
    """Register ``servicer``'s methods on ``server`` under ``spec.full_name``."""
    handlers = {}
    for name, m in spec.methods.items():
        handler_factory = getattr(grpc, f"{m.cardinality}_rpc_method_handler")
        handlers[name] = handler_factory(
            getattr(servicer, name),
            request_deserializer=m.request.FromString,
            response_serializer=m.response.SerializeToString,
        )
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(spec.full_name, handlers),)
    )


_CHANNEL_OPTIONS = (
    ("grpc.max_send_message_length", _MAX_MESSAGE),
    ("grpc.max_receive_message_length", _MAX_MESSAGE),
)


def create_server(max_workers: int = 16) -> grpc.Server:
    """A threaded gRPC server with aiOS-standard channel options."""
    return grpc.server(
        concurrent.futures.ThreadPoolExecutor(max_workers=max_workers),
        options=list(_CHANNEL_OPTIONS),
    )


def insecure_channel(address: str) -> grpc.Channel:
    return grpc.insecure_channel(address, options=list(_CHANNEL_OPTIONS))
