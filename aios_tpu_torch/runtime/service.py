"""aios.runtime.AIRuntime gRPC service over the PyTorch engine.

The port of ``aios_tpu/runtime/service.py`` for the main path:
  * resolution for Infer: explicit model name -> intelligence-level ladder ->
    any ready model -> UNAVAILABLE; reactive is INVALID_ARGUMENT, strategic
    with no big model FAILED_PRECONDITION ("route via api-gateway");
  * defaults: max_tokens 512, temperature 0.7 (proto3 0 means unset);
  * StreamInfer streams incremental detokenized text per token and ends with
    a done=true chunk; a client that goes away cancels its request;
  * ``InferRequest.json_schema`` constrains the output to the schema's shape
    (the ``engine/jsonschema.py`` subset): malformed JSON or a root that is
    not an object is INVALID_ARGUMENT "invalid json_schema", a construct the
    compiler rejects INVALID_ARGUMENT "unsupported json_schema";
    ``AIOS_TPU_JSON_MODE=force`` constrains every non-streaming Infer
    without a schema to one JSON object (the reference's llama-server
    ``response_format``);
  * the serving front door: every Infer/StreamInfer goes through the
    model's ``ReplicaPool`` with its tenant (``tenant_of`` under the pool's
    ``tenant_by``) and the gRPC deadline (``context.time_remaining()``, a
    year or more read as none); a shed is RESOURCE_EXHAUSTED with
    ``retry-after-ms`` trailing metadata (INVALID_ARGUMENT when no retry
    can fit it), a submit racing an unload UNAVAILABLE, and a stream whose
    failover budget ran out UNAVAILABLE with ``retry-after-ms``; a CUDA
    error (the port's own case) is INTERNAL with no hint, since the card's
    context is lost for the process;
  * one flight-recorder timeline per request, opened here with the tenant
    (an empty trace id: tracing is not ported); HealthCheck's
    ``<model>.serving`` is ``pool.stats()``.
Tracing, SLOs, the HTTP metrics endpoint and the fleet plane are not ported
yet.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Iterator, Optional

import grpc

from .. import rpc
from ..device import DEVICE_FAULT_REASON, DeviceFault
from ..engine.batching import Request
from ..engine.tokenizer import render_chat
from ..obs import flightrec
from ..obs import instruments as obs
from ..proto_gen import common_pb2, runtime_pb2
from ..serving import AdmissionError, tenant_of
from ..services import RUNTIME, AIRuntimeServicer, service_address
from .model_manager import ManagedModel, ModelManager, json_mode_forced

log = logging.getLogger("aios.torch.runtime")

DEFAULT_MAX_TOKENS = 512
DEFAULT_TEMPERATURE = 0.7
DEFAULT_TOP_P = 0.95
LEVEL_PRIORITY = {"strategic": 3, "tactical": 2, "operational": 1, "reactive": 1}


class RuntimeService(AIRuntimeServicer):
    def __init__(self, manager: Optional[ModelManager] = None):
        self.manager = manager or ModelManager()
        self.started_at = time.time()

    # -- lifecycle RPCs -----------------------------------------------------

    def LoadModel(self, request, context):
        try:
            m = self.manager.load_model(
                request.model_name, request.model_path,
                context_length=request.context_length,
            )
        except Exception as exc:  # noqa: BLE001 - reported to the caller
            context.set_code(grpc.StatusCode.INTERNAL)
            context.set_details(f"load failed: {exc}")
            return runtime_pb2.ModelStatus(model_name=request.model_name, status="error")
        return self._status_of(m)

    def UnloadModel(self, request, context):
        ok = self.manager.unload_model(request.model_name)
        return common_pb2.Status(
            success=ok,
            message="unloaded" if ok else f"model {request.model_name} not loaded",
        )

    def ListModels(self, request, context):
        return runtime_pb2.ModelList(
            models=[self._status_of(m) for m in list(self.manager.models.values())]
        )

    def HealthCheck(self, request, context):
        models = list(self.manager.models.values())
        details = {m.name: m.state for m in models}
        details["backend"] = self.manager.backend
        for m in models:
            # snapshot: an unload or a hot swap nulls these mid-iteration
            pool, engine, batcher = m.pool, m.engine, m.batcher
            if pool is None or engine is None or batcher is None:
                continue
            # the pool-level engine.stats(): counters summed across
            # replicas, routing, shed and restart tallies
            stats = pool.stats()
            stats["prefill_chunk"] = batcher.prefill_chunk or 0
            details[f"{m.name}.serving"] = ",".join(
                f"{k}={v}" for k, v in sorted(stats.items())
            )
        ready = len(self.manager.ready_models())
        return common_pb2.HealthStatus(
            healthy=True,
            service="runtime",
            message=f"{ready} model(s) ready",
            uptime_seconds=int(time.time() - self.started_at),
            details=details,
        )

    # -- inference RPCs -----------------------------------------------------

    def Infer(self, request, context):
        t0 = time.time()
        m = self._resolve_model(request, context)
        if m is None:
            return runtime_pb2.InferResponse()
        handle, n_prompt = self._submit(m, request, context, streaming=False)
        token_ids = [t for t in handle if t != m.tokenizer.eos_id]
        obs.RUNTIME_INFER_LATENCY.labels(model=m.name, rpc="Infer").observe(time.time() - t0)
        if handle.aborted:
            # a truncation is an error; a retryable cause (a crashed replica
            # whose failover budget ran out) carries a backoff hint, and a
            # device fault is final in this process
            if handle.abort_reason.startswith(DEVICE_FAULT_REASON):
                context.abort(grpc.StatusCode.INTERNAL,
                              f"request aborted: {handle.abort_reason}")
            if handle.retry_after_ms:
                context.set_trailing_metadata(
                    (("retry-after-ms", str(handle.retry_after_ms)),))
            context.abort(grpc.StatusCode.UNAVAILABLE,
                          f"request aborted: {handle.abort_reason}")
        return runtime_pb2.InferResponse(
            text=m.tokenizer.decode(token_ids),
            tokens_used=n_prompt + len(token_ids),
            latency_ms=int((time.time() - t0) * 1000),
            model_used=m.name,
        )

    def StreamInfer(self, request, context) -> Iterator[runtime_pb2.InferChunk]:
        t0 = time.time()
        m = self._resolve_model(request, context)
        if m is None:
            return
        handle, _ = self._submit(m, request, context, streaming=True)
        chunk_counter = obs.RUNTIME_STREAM_CHUNKS.labels(model=m.name)
        emitted = ""
        ids = []
        try:
            for tok in handle:
                if tok == m.tokenizer.eos_id:
                    break
                ids.append(tok)
                # incremental detokenization: emit the stable text delta
                text = m.tokenizer.decode(ids)
                delta = text[len(emitted):] if text.startswith(emitted) else text
                if delta:
                    emitted = text
                    chunk_counter.inc()
                    yield runtime_pb2.InferChunk(text=delta, done=False)
            obs.RUNTIME_INFER_LATENCY.labels(model=m.name, rpc="StreamInfer").observe(
                time.time() - t0)
            if handle.aborted:
                # an error status, never a done chunk: a retryable cause
                # (failover budget spent) is UNAVAILABLE with a backoff
                # hint, a deliberate abort (unload) stays ABORTED, and a
                # device fault, final in this process, is INTERNAL
                if handle.abort_reason.startswith(DEVICE_FAULT_REASON):
                    context.set_code(grpc.StatusCode.INTERNAL)
                elif handle.retry_after_ms:
                    context.set_trailing_metadata(
                        (("retry-after-ms", str(handle.retry_after_ms)),))
                    context.set_code(grpc.StatusCode.UNAVAILABLE)
                else:
                    context.set_code(grpc.StatusCode.ABORTED)
                context.set_details(f"stream aborted: {handle.abort_reason}")
                return
            yield runtime_pb2.InferChunk(text="", done=True)
        finally:
            # a client that disconnected closes this generator: free the
            # slot now instead of decoding to max_tokens for nobody
            handle.cancel()

    # -- helpers ------------------------------------------------------------

    def _submit(self, m: ManagedModel, request, context, streaming: bool):
        schema = None
        if request.json_schema:
            try:
                schema = json.loads(request.json_schema)
                if not isinstance(schema, dict):
                    raise ValueError("schema must be a JSON object")
            except ValueError as e:  # json.JSONDecodeError is one
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, f"invalid json_schema: {e}")
        m.touch()
        prompt_ids = m.tokenizer.encode(
            render_chat(m.config.name, request.prompt, request.system_prompt)
        )
        stop = (m.tokenizer.eos_id,) if m.tokenizer.eos_id is not None else ()
        req = Request(
            prompt_ids=prompt_ids,
            max_tokens=request.max_tokens or DEFAULT_MAX_TOKENS,
            temperature=(
                request.temperature if request.temperature > 0 else DEFAULT_TEMPERATURE
            ),
            top_p=DEFAULT_TOP_P,
            stop_ids=stop,
            request_id=request.task_id or "",
            # the reference forces response_format=json_object on every
            # NON-streaming local inference; the JAX stack's default is off
            # (it would garble plain-text flows) and force restores it
            json_mode=schema is None and not streaming and json_mode_forced(),
            json_schema=schema,
            priority=LEVEL_PRIORITY.get(request.intelligence_level.lower(), 0),
        )
        # the front door: the tenant's quota, the bounded queue and the
        # deadline's feasibility, with the gRPC deadline as the budget
        tenant = tenant_of(request, m.pool.cfg.tenant_by)
        req.rec = flightrec.RECORDER.begin(
            m.name, req.request_id, tenant, trace_id="",
            prompt_tokens=len(prompt_ids), priority=req.priority)
        deadline_s = None
        remaining = context.time_remaining()
        if remaining is not None and remaining < 3600 * 24 * 365:
            deadline_s = remaining
        try:
            handle = m.submit(req, tenant=tenant, deadline_s=deadline_s)
        except AdmissionError as e:
            # shed: a backoff hint instead of an unbounded queue; a cost no
            # bucket refill can cover is permanent, so no retry is invited
            if not e.retriable:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                              f"request not admittable ({e.cause}): {e}")
            context.set_trailing_metadata((("retry-after-ms", str(e.retry_after_ms)),))
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, f"request shed ({e.cause}): {e}")
        except DeviceFault as e:  # the card failed; no retry can succeed here
            context.abort(grpc.StatusCode.INTERNAL, str(e))
        except RuntimeError as e:  # raced UnloadModel's shutdown
            context.abort(grpc.StatusCode.UNAVAILABLE, f"model {m.name} is unloading: {e}")
        except ValueError as e:  # an unsupported schema construct or a scalar root
            if schema is None:
                raise
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, f"unsupported json_schema: {e}")
        if not context.add_callback(handle.cancel):
            handle.cancel()  # the RPC already ended
        return handle, len(prompt_ids)

    def _resolve_model(self, request, context) -> Optional[ManagedModel]:
        """explicit name -> level ladder -> any ready -> gRPC error."""
        if request.model:
            m = self.manager.find_by_partial_name(request.model)
            if m is not None:
                return m
            context.set_code(grpc.StatusCode.NOT_FOUND)
            context.set_details(f"model {request.model} not loaded")
            return None
        level = request.intelligence_level.lower()
        if level == "reactive":
            context.set_code(grpc.StatusCode.INVALID_ARGUMENT)
            context.set_details("reactive tasks use heuristics, not model inference")
            return None
        if level:
            m = self.manager.select_for_level(level)
            if m is not None:
                return m
            if level == "strategic":
                context.set_code(grpc.StatusCode.FAILED_PRECONDITION)
                context.set_details("no strategic-tier model loaded; route via api-gateway")
                return None
        ready = self.manager.ready_models()
        if ready:
            return ready[0]
        context.set_code(grpc.StatusCode.UNAVAILABLE)
        context.set_details("no models loaded")
        return None

    @staticmethod
    def _status_of(m: ManagedModel) -> runtime_pb2.ModelStatus:
        return runtime_pb2.ModelStatus(
            model_name=m.name,
            status=m.state,
            port=0,  # no HTTP sidecar
            loaded_at=m.loaded_at,
            last_used=m.last_used,
            request_count=m.request_count,
        )


def serve(address: Optional[str] = None, manager: Optional[ModelManager] = None,
          block: bool = True):
    """Start the runtime gRPC server; returns (server, service, port)."""
    address = address or service_address()
    server = rpc.create_server()
    service = RuntimeService(manager)
    rpc.add_to_server(RUNTIME, service, server)
    port = server.add_insecure_port(address)
    server.start()
    log.info("AIRuntime (%s) listening on %s", service.manager.backend, address)
    if block:
        server.wait_for_termination()
    return server, service, port


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    manager = ModelManager()
    manager.autoload()  # every *.gguf in AIOS_MODEL_DIR
    serve(manager=manager)
