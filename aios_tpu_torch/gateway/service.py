"""aios.api_gateway.ApiGateway gRPC service.

Reference parity: api-gateway/src/main.rs (binds 0.0.0.0:50054) — Infer/
StreamInfer/GetBudget/GetUsage over the router + budget manager.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import grpc

from .. import rpc
from ..obs.http import maybe_start_metrics_server
from ..proto_gen import api_gateway_pb2 as pb
from ..proto_gen import common_pb2
from ..services import GATEWAY, ApiGatewayServicer, service_address
from .budget import BudgetManager
from .providers import ProviderError
from .router import RequestRouter

log = logging.getLogger("aios.gateway")


class GatewayService(ApiGatewayServicer):
    def __init__(self, router: Optional[RequestRouter] = None):
        self.router = router or RequestRouter()

    def Infer(self, request, context):
        t0 = time.time()
        try:
            result = self.router.route(
                prompt=request.prompt,
                system=request.system_prompt,
                max_tokens=request.max_tokens or 1024,
                temperature=request.temperature or 0.7,
                preferred=request.preferred_provider,
                allow_fallback=request.allow_fallback,
                json_schema=getattr(request, "json_schema", ""),
                agent=request.requesting_agent,
                task_id=request.task_id,
            )
        except ProviderError as exc:
            context.set_code(grpc.StatusCode.UNAVAILABLE)
            context.set_details(str(exc))
            return common_pb2.InferenceResponse()
        return common_pb2.InferenceResponse(
            text=result.text,
            tokens_used=result.input_tokens + result.output_tokens,
            latency_ms=int((time.time() - t0) * 1000),
            model_used=f"{result.provider}/{result.model}",
        )

    def StreamInfer(self, request, context):
        """True streaming: deltas are relayed as the serving provider emits
        them (live token stream for the local TPU runtime; 64-char rechunk
        only for providers without a streaming client — router.route_stream)."""
        provider = ""
        emitted = False
        # Disconnect propagation while NO delta is flowing: this generator
        # parks in the provider's next() then, so GeneratorExit can't reach
        # it — the termination callback cancels the registered downstream
        # call(s) cross-thread instead, which unblocks the provider loop
        # and aborts the runtime's decode. Registration after the RPC died
        # cancels immediately (add_callback no longer fires).
        downstream = []

        def register_call(call):
            downstream.append(call)
            if not context.is_active():
                call.cancel()

        context.add_callback(lambda: [c.cancel() for c in downstream])
        try:
            for delta, provider in self.router.route_stream(
                prompt=request.prompt,
                system=request.system_prompt,
                max_tokens=request.max_tokens or 1024,
                temperature=request.temperature or 0.7,
                preferred=request.preferred_provider,
                allow_fallback=request.allow_fallback,
                json_schema=getattr(request, "json_schema", ""),
                agent=request.requesting_agent,
                task_id=request.task_id,
                register_call=register_call,
                client_alive=context.is_active,
            ):
                emitted = True
                yield pb.StreamChunk(text=delta, done=False, provider=provider)
        except ProviderError as exc:
            if not context.is_active():
                # our client is gone (its disconnect tore the downstream
                # call); nothing to report to nobody
                return
            if not emitted:
                context.set_code(grpc.StatusCode.UNAVAILABLE)
                context.set_details(str(exc))
                return
            context.set_code(grpc.StatusCode.ABORTED)
            context.set_details(f"stream interrupted: {exc}")
            return
        yield pb.StreamChunk(text="", done=True, provider=provider)

    def GetBudget(self, request, context):
        s = self.router.budget.status()
        return pb.BudgetStatus(
            claude_monthly_budget_usd=s["claude_monthly_budget_usd"],
            claude_used_usd=s["claude_used_usd"],
            openai_monthly_budget_usd=s["openai_monthly_budget_usd"],
            openai_used_usd=s["openai_used_usd"],
            days_remaining=s["days_remaining"],
            daily_rate_usd=s["daily_rate_usd"],
            budget_exceeded=s["budget_exceeded"],
        )

    def GetUsage(self, request, context):
        records = self.router.budget.usage(
            provider=request.provider, days=request.days or 30
        )
        return pb.UsageResponse(
            records=[
                pb.UsageRecord(
                    provider=r.provider,
                    model=r.model,
                    input_tokens=r.input_tokens,
                    output_tokens=r.output_tokens,
                    cost_usd=r.cost_usd,
                    timestamp=r.timestamp,
                    requesting_agent=r.requesting_agent,
                    task_id=r.task_id,
                )
                for r in records
            ],
            total_cost_usd=sum(r.cost_usd for r in records),
            total_requests=len(records),
            total_tokens=sum(r.input_tokens + r.output_tokens for r in records),
        )


def serve(
    address: Optional[str] = None,
    router: Optional[RequestRouter] = None,
    block: bool = True,
    metrics_port: Optional[int] = None,
):
    address = address or service_address("gateway")
    server = rpc.create_server()
    service = GatewayService(router)
    rpc.add_to_server(GATEWAY, service, server)
    port = server.add_insecure_port(address)
    server.start()
    service.metrics_server, service.metrics_port = maybe_start_metrics_server(
        "gateway", metrics_port, health_fn=lambda: {"service": "gateway"}
    )
    log.info("ApiGateway listening on %s", address)
    if block:
        server.wait_for_termination()
    return server, service, port


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    serve()
