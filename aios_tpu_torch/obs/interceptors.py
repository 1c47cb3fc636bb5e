"""gRPC client/server interceptors: rpc_* metrics + trace propagation.

Installed by ``aios_tpu_torch.rpc`` on every server (``create_server``) and
client channel (``insecure_channel``), so all six services and all their
stubs get, with zero per-service code:

  * ``aios_tpu_rpc_requests_total{side,service,method}``
  * ``aios_tpu_rpc_errors_total{side,service,method,code}``
  * ``aios_tpu_rpc_latency_seconds{side,service,method}``
  * a server span per RPC, parented to the caller's span through the
    ``traceparent`` metadata entry the client interceptor injects.

Set ``AIOS_OBS_DISABLED=1`` to serve without interceptors (perf A/B).
"""

from __future__ import annotations

import collections
import time
from typing import Optional, Tuple

import grpc

from . import instruments, tracing

TRACE_METADATA_KEY = "traceparent"


def _split_method(full_method: str) -> Tuple[str, str]:
    """"/aios.runtime.AIRuntime/Infer" -> ("aios.runtime.AIRuntime", "Infer")."""
    parts = (full_method or "/unknown/unknown").lstrip("/").split("/", 1)
    if len(parts) != 2:
        return full_method, "unknown"
    return parts[0], parts[1]


def _record(side: str, service: str, method: str, t0: float,
            code: Optional[grpc.StatusCode]) -> None:
    instruments.RPC_LATENCY.labels(
        side=side, service=service, method=method
    ).observe(time.perf_counter() - t0)
    if code is not None and code != grpc.StatusCode.OK:
        instruments.RPC_ERRORS.labels(
            side=side, service=service, method=method, code=code.name
        ).inc()


# -- server ----------------------------------------------------------------


class ServerObsInterceptor(grpc.ServerInterceptor):
    """Wraps every handler behavior with a span + the rpc_* metrics."""

    def intercept_service(self, continuation, handler_call_details):
        handler = continuation(handler_call_details)
        if handler is None:
            return None
        service, method = _split_method(handler_call_details.method)
        traceparent = ""
        for key, value in handler_call_details.invocation_metadata or ():
            if key == TRACE_METADATA_KEY:
                traceparent = value
        request_streaming = handler.request_streaming
        response_streaming = handler.response_streaming
        behavior = (
            handler.stream_stream if request_streaming and response_streaming
            else handler.stream_unary if request_streaming
            else handler.unary_stream if response_streaming
            else handler.unary_unary
        )
        span_name = f"rpc.server.{service}/{method}"

        def observe_start() -> float:
            instruments.RPC_REQUESTS.labels(
                side="server", service=service, method=method
            ).inc()
            return time.perf_counter()

        if response_streaming:

            def wrapped(request_or_iterator, context):
                t0 = observe_start()
                code: Optional[grpc.StatusCode] = grpc.StatusCode.OK
                try:
                    with tracing.continue_span(traceparent, span_name):
                        yield from behavior(request_or_iterator, context)
                    code = _ctx_code(context) or grpc.StatusCode.OK
                except BaseException as exc:
                    code = _ctx_code(context) or _code_of(exc)
                    raise
                finally:
                    _record("server", service, method, t0, code)

        else:

            def wrapped(request_or_iterator, context):
                t0 = observe_start()
                code: Optional[grpc.StatusCode] = grpc.StatusCode.OK
                try:
                    with tracing.continue_span(traceparent, span_name):
                        response = behavior(request_or_iterator, context)
                    code = _ctx_code(context) or grpc.StatusCode.OK
                    return response
                except BaseException as exc:
                    code = _ctx_code(context) or _code_of(exc)
                    raise
                finally:
                    _record("server", service, method, t0, code)

        factory = getattr(
            grpc,
            ("stream_" if request_streaming else "unary_")
            + ("stream" if response_streaming else "unary")
            + "_rpc_method_handler",
        )
        return factory(
            wrapped,
            request_deserializer=handler.request_deserializer,
            response_serializer=handler.response_serializer,
        )


def _ctx_code(context) -> Optional[grpc.StatusCode]:
    """The status the handler set on its ServicerContext (set_code /
    abort), if any — the authoritative server-side code for both the
    return path (set_code + normal return) and the abort path (abort
    raises a BARE Exception after setting it)."""
    getter = getattr(context, "code", None)
    if callable(getter):
        try:
            code = getter()
            if isinstance(code, grpc.StatusCode):
                return code
        except Exception:  # noqa: BLE001 - private-ish API; degrade
            pass
    return None


def _code_of(exc: BaseException) -> grpc.StatusCode:
    """Fallback status mapping for exceptions when the context carries no
    explicit code."""
    if isinstance(exc, grpc.RpcError):
        try:
            return exc.code()  # type: ignore[return-value]
        except Exception:  # noqa: BLE001
            return grpc.StatusCode.UNKNOWN
    if isinstance(exc, NotImplementedError):
        return grpc.StatusCode.UNIMPLEMENTED
    return grpc.StatusCode.UNKNOWN


# -- client ----------------------------------------------------------------


class _ClientCallDetails(
    collections.namedtuple(
        "_ClientCallDetails",
        ("method", "timeout", "metadata", "credentials", "wait_for_ready",
         "compression"),
    ),
    grpc.ClientCallDetails,
):
    pass


class ClientObsInterceptor(
    grpc.UnaryUnaryClientInterceptor,
    grpc.UnaryStreamClientInterceptor,
    grpc.StreamUnaryClientInterceptor,
    grpc.StreamStreamClientInterceptor,
):
    """Injects traceparent metadata + records client-side rpc_* metrics."""

    def _prepare(self, client_call_details):
        service, method = _split_method(client_call_details.method)
        metadata = list(client_call_details.metadata or ())
        traceparent = tracing.current_traceparent()
        if traceparent:
            metadata.append((TRACE_METADATA_KEY, traceparent))
        details = _ClientCallDetails(
            client_call_details.method,
            client_call_details.timeout,
            metadata,
            client_call_details.credentials,
            getattr(client_call_details, "wait_for_ready", None),
            getattr(client_call_details, "compression", None),
        )
        instruments.RPC_REQUESTS.labels(
            side="client", service=service, method=method
        ).inc()
        return details, service, method, time.perf_counter()

    def _attach(self, call, service: str, method: str, t0: float):
        def on_done(*_args) -> None:
            try:
                code = call.code()
            except Exception:  # noqa: BLE001
                code = grpc.StatusCode.UNKNOWN
            _record("client", service, method, t0, code)

        add_done = getattr(call, "add_done_callback", None)
        if add_done is not None:
            add_done(on_done)
        elif not call.add_callback(on_done):
            on_done()  # already terminated
        return call

    def intercept_unary_unary(self, continuation, client_call_details, request):
        details, service, method, t0 = self._prepare(client_call_details)
        return self._attach(continuation(details, request), service, method, t0)

    def intercept_unary_stream(self, continuation, client_call_details, request):
        details, service, method, t0 = self._prepare(client_call_details)
        return self._attach(continuation(details, request), service, method, t0)

    def intercept_stream_unary(
        self, continuation, client_call_details, request_iterator
    ):
        details, service, method, t0 = self._prepare(client_call_details)
        return self._attach(
            continuation(details, request_iterator), service, method, t0
        )

    def intercept_stream_stream(
        self, continuation, client_call_details, request_iterator
    ):
        details, service, method, t0 = self._prepare(client_call_details)
        return self._attach(
            continuation(details, request_iterator), service, method, t0
        )


_SERVER_INTERCEPTOR = ServerObsInterceptor()
_CLIENT_INTERCEPTOR = ClientObsInterceptor()


def server_interceptors() -> Tuple[grpc.ServerInterceptor, ...]:
    return (_SERVER_INTERCEPTOR,)


def intercept_client_channel(channel: grpc.Channel) -> grpc.Channel:
    return grpc.intercept_channel(channel, _CLIENT_INTERCEPTOR)
