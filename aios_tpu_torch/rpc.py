"""Programmatic gRPC stub/servicer construction.

The environment has no grpcio-tools, so instead of checked-in generated
`*_pb2_grpc.py` files each service is described once by a `ServiceSpec`
(method name -> request/response classes + streaming flags) and this module
builds, at import time, the same three artifacts grpcio-tools would emit:

  * ``make_stub(spec)``      -> a Stub class taking a ``grpc.Channel``
  * ``make_servicer(spec)``  -> an abstract Servicer base class
  * ``add_to_server(spec, servicer, server)`` -> registers generic handlers

All aiOS services are unary-unary or unary-stream; the builder supports all
four cardinalities anyway for completeness.

Reference parity: replaces the generated tonic (Rust) / grpcio (Python) stubs
of agent-core/proto (SURVEY.md section 1, "IPC protos" row).
"""

from __future__ import annotations

import concurrent.futures
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Tuple

import grpc


def _obs_enabled() -> bool:
    """Observability interceptors are on by default on every server and
    channel this module builds; AIOS_OBS_DISABLED=1 opts out (perf A/B,
    debugging the interceptors themselves)."""
    return os.environ.get("AIOS_OBS_DISABLED", "") not in ("1", "true", "on")


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


class _FaultUnavailableInterceptor(grpc.ServerInterceptor):
    """Chaos hook (docs/FAULTS.md): when the ``rpc.unavailable`` fault
    point fires, the RPC aborts UNAVAILABLE with ``retry-after-ms``
    trailing metadata instead of reaching the servicer — the exact shape
    a client sees when a whole serving process is mid-restart, for
    driving client retry/backoff paths on demand. A no-op (one global
    load in ``faults.point``) unless a fault schedule is armed."""

    def intercept_service(self, continuation, handler_call_details):
        handler = continuation(handler_call_details)
        if handler is None:
            return None
        from . import faults

        act = faults.point("rpc.unavailable")
        if act is None:
            return handler

        def abort(request, context):
            context.set_trailing_metadata(
                (("retry-after-ms", str(act.retry_after_ms)),)
            )
            context.abort(
                grpc.StatusCode.UNAVAILABLE,
                f"injected rpc.unavailable (hit {act.hit})",
            )

        if handler.unary_unary is not None:
            return grpc.unary_unary_rpc_method_handler(
                abort,
                request_deserializer=handler.request_deserializer,
                response_serializer=handler.response_serializer,
            )
        if handler.unary_stream is not None:
            return grpc.unary_stream_rpc_method_handler(
                abort,
                request_deserializer=handler.request_deserializer,
                response_serializer=handler.response_serializer,
            )
        return handler  # stream-request cardinalities: not injected


class _NetFaultClientInterceptor(
    grpc.UnaryUnaryClientInterceptor,
    grpc.UnaryStreamClientInterceptor,
    grpc.StreamUnaryClientInterceptor,
    grpc.StreamStreamClientInterceptor,
):
    """Chaos hook (docs/FAULTS.md "Per-edge network faults"): every
    channel this module builds carries one of these, so KVX, Handoff,
    and every other cross-host RPC traverse the same seeded per-edge
    fault surface as the fleet HTTP helpers. A fired partition raises
    :class:`aios_tpu_torch.faults.net.NetFaultRefused` (an UNAVAILABLE-coded
    grpc.RpcError) before the wire; a fired ``net.drop_after`` lets a
    unary-stream call start and severs it after ``after_msgs``
    messages. A no-op — one global None check — unless a fault schedule
    is armed."""

    def __init__(self, address: str) -> None:
        self._address = address

    def intercept_unary_unary(self, continuation, client_call_details,
                              request):
        from . import faults

        if faults.active():
            from .faults import net

            net.check_send(self._address, "rpc")
        return continuation(client_call_details, request)

    def intercept_unary_stream(self, continuation, client_call_details,
                               request):
        from . import faults

        if not faults.active():
            return continuation(client_call_details, request)
        from .faults import net

        net.check_send(self._address, "rpc")
        return net.sever_stream(
            self._address, continuation(client_call_details, request)
        )

    def intercept_stream_unary(self, continuation, client_call_details,
                               request_iterator):
        from . import faults

        if faults.active():
            from .faults import net

            net.check_send(self._address, "rpc")
        return continuation(client_call_details, request_iterator)

    def intercept_stream_stream(self, continuation, client_call_details,
                                request_iterator):
        from . import faults

        if not faults.active():
            return continuation(client_call_details, request_iterator)
        from .faults import net

        net.check_send(self._address, "rpc")
        return net.sever_stream(
            self._address,
            continuation(client_call_details, request_iterator),
        )


def create_server(
    max_workers: int = 16, options: Tuple[Tuple[str, Any], ...] | None = None
) -> grpc.Server:
    """A threaded gRPC server with aiOS-standard channel options and the
    observability interceptors (per-RPC span + rpc_* metrics)."""
    opts = list(
        options
        or (
            ("grpc.max_send_message_length", 64 * 1024 * 1024),
            ("grpc.max_receive_message_length", 64 * 1024 * 1024),
        )
    )
    # the fault interceptor goes INNERMOST (last): an injected
    # UNAVAILABLE must still flow through the obs interceptors' metrics
    # and spans — the operator drilling chaos is watching exactly those
    interceptors: Tuple[Any, ...] = (_FaultUnavailableInterceptor(),)
    if _obs_enabled():
        from .obs.interceptors import server_interceptors

        interceptors = tuple(server_interceptors()) + interceptors
    return grpc.server(
        concurrent.futures.ThreadPoolExecutor(max_workers=max_workers),
        options=opts,
        interceptors=interceptors,
    )


def insecure_channel(address: str) -> grpc.Channel:
    channel = grpc.insecure_channel(
        address,
        options=[
            ("grpc.max_send_message_length", 64 * 1024 * 1024),
            ("grpc.max_receive_message_length", 64 * 1024 * 1024),
        ],
    )
    if _obs_enabled():
        from .obs.interceptors import intercept_client_channel

        channel = intercept_client_channel(channel)
    # the net-fault interceptor goes OUTERMOST: a refused send never
    # happened, so it must not count on the client rpc_* metrics — the
    # caller's recovery path (and the faults journal) carry the evidence
    return grpc.intercept_channel(
        channel, _NetFaultClientInterceptor(address)
    )
