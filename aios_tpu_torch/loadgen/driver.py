"""Storm driver: replay a trace against a live runtime gRPC endpoint.

One worker thread per in-flight call (storms are CPU-sized — tens to a
few hundred calls; the point is contention realism, not driver
throughput). Each worker issues the call at its scheduled time through
the REAL service surface — ``StreamInfer`` for streaming tenants (TTFT
measured at the first delta), ``Infer`` otherwise — propagating the
scenario's per-call gRPC deadline so the admission layer's feasibility
gate sees exactly what production clients send.

Outcomes record what the PLANE did, classified off the gRPC status the
service contract promises: ``RESOURCE_EXHAUSTED`` + ``retry-after-ms``
is a retriable shed (cause parsed from the detail string the service
formats), ``INVALID_ARGUMENT`` with a shed cause is a permanent
rejection (a cost no bucket refill can cover), anything else non-OK is
an error the verdict fails on.
"""

from __future__ import annotations

import json
import re
import threading
import time
import urllib.request
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import grpc

from .. import rpc, services
from ..proto_gen import runtime_pb2
from .trace import Call

_SHED_RE = re.compile(r"request (?:shed|not admittable) \((\w+)\)")


@dataclass
class Outcome:
    call: Call
    status: str = "ok"  # ok | shed | rejected | error
    shed_cause: str = ""
    code: str = ""
    retry_after_ms: int = 0
    text: str = ""
    ttft_ms: float = 0.0  # streaming calls only (first delta)
    wall_ms: float = 0.0
    chunks: int = 0
    detail: str = ""
    extras: dict = field(default_factory=dict)


class StormDriver:
    def __init__(self, address: str, model: str,
                 metrics_port: Optional[int] = None,
                 time_scale: float = 1.0) -> None:
        self.address = address
        self.model = model
        self.metrics_port = metrics_port
        self.time_scale = time_scale
        self._channel = rpc.insecure_channel(address)
        self._stub = services.AIRuntimeStub(self._channel)

    def close(self) -> None:
        self._channel.close()

    # -- one call ------------------------------------------------------------

    def _request(self, c: Call) -> runtime_pb2.InferRequest:
        # proto temperature 0 means UNSET to the service (it substitutes
        # the 0.7 default, inference.rs parity) — greedy rides just
        # under sampling.GREEDY_EPS so the engine takes argmax
        temp = c.temperature if c.temperature > 0 else 5e-5
        return runtime_pb2.InferRequest(
            model=self.model,
            prompt=c.prompt,
            max_tokens=c.max_tokens,
            temperature=temp,
            intelligence_level=c.level,
            requesting_agent=c.tenant,  # tenant identity (AIOS_TPU_TENANT_BY)
            task_id=c.task_id,
        )

    def _classify(self, out: Outcome, err: grpc.RpcError) -> None:
        code = err.code()
        out.code = code.name if code is not None else "UNKNOWN"
        out.detail = (err.details() or "")[:200]
        m = _SHED_RE.search(out.detail)
        for k, v in (err.trailing_metadata() or ()):  # retry hint, if any
            if k == "retry-after-ms":
                try:
                    out.retry_after_ms = int(v)
                except ValueError:
                    pass
        if m and code == grpc.StatusCode.RESOURCE_EXHAUSTED:
            out.status, out.shed_cause = "shed", m.group(1)
        elif m and code == grpc.StatusCode.INVALID_ARGUMENT:
            out.status, out.shed_cause = "rejected", m.group(1)
        else:
            out.status = "error"

    def _fire(self, c: Call, out: Outcome) -> None:
        req = self._request(c)
        timeout = c.deadline_ms / 1000.0 if c.deadline_ms else None
        t0 = time.monotonic()
        try:
            if c.streaming:
                text = []
                for chunk in self._stub.StreamInfer(req, timeout=timeout):
                    if chunk.text and not text:
                        out.ttft_ms = (time.monotonic() - t0) * 1000.0
                    if chunk.text:
                        text.append(chunk.text)
                        out.chunks += 1
                out.text = "".join(text)
            else:
                resp = self._stub.Infer(req, timeout=timeout)
                out.text = resp.text
                out.extras["tokens_used"] = resp.tokens_used
        except grpc.RpcError as err:
            self._classify(out, err)
        out.wall_ms = (time.monotonic() - t0) * 1000.0

    # -- warmup prologue -----------------------------------------------------

    def warmup(self, n: int = 3, max_tokens: int = 8) -> None:
        """Sequential throwaway greedy requests before the clock starts:
        the first dispatches of a cold pool compile for seconds, and the
        batcher's first observed tokens/sec window is compile-polluted —
        a deadline-carrying call judged against that rate sheds on a
        COLD run and admits on a warm one, which is exactly the
        cold-vs-warm asymmetry the determinism contract forbids (the
        bench.py gateway-disconnect deflake lesson, now at storm scale).
        Warmup requests never enter the verdict (their task ids are not
        in the trace)."""
        for i in range(n):
            try:
                self._stub.Infer(runtime_pb2.InferRequest(
                    model=self.model,
                    prompt=f"[storm warmup {i}] prime the decode graphs",
                    max_tokens=max_tokens,
                    temperature=5e-5,
                    task_id=f"storm-warmup-{i}",
                ), timeout=120)
            except grpc.RpcError as err:  # warmup must not kill the storm
                code = err.code()
                raise RuntimeError(
                    f"storm warmup request {i} failed "
                    f"({code.name if code else '?'}): {err.details()}"
                ) from err

    # -- the storm -----------------------------------------------------------

    def run(self, calls: List[Call],
            join_timeout: float = 180.0) -> List[Outcome]:
        """Replay the trace on the wall clock (``time_scale`` stretches
        it: 2.0 = half speed). Returns outcomes in trace order; a worker
        still blocked after the join budget marks its outcome
        ``error/stuck`` (the zero-leak contract the verdict enforces)."""
        outcomes = [Outcome(call=c) for c in calls]
        threads = []
        t0 = time.monotonic()
        for c, out in zip(calls, outcomes):
            delay = c.t * self.time_scale - (time.monotonic() - t0)
            if delay > 0:
                time.sleep(delay)
            th = threading.Thread(
                target=self._fire, args=(c, out), daemon=True,
                name=f"storm-{c.task_id}",
            )
            th.start()
            threads.append(th)
        deadline = time.monotonic() + join_timeout
        for th, out in zip(threads, outcomes):
            th.join(timeout=max(deadline - time.monotonic(), 0.1))
            if th.is_alive():
                out.status, out.detail = "error", "stuck"
        return outcomes

    # -- live SLO surface ----------------------------------------------------

    def slo_surface(self) -> dict:
        """Read the live ``/debug/slo`` view off the service's metrics
        port — the storm records the PLANE's own windowed attainment
        next to the driver-side measurements."""
        if not self.metrics_port:
            return {}
        try:
            with urllib.request.urlopen(
                f"http://127.0.0.1:{self.metrics_port}/debug/slo",
                timeout=5,
            ) as r:
                return json.loads(r.read().decode())
        except Exception as exc:  # noqa: BLE001 - surface absence is data
            return {"error": repr(exc)[:120]}


def target_of(tenant: str, n_targets: int) -> int:
    """Deterministic tenant -> target routing for multi-endpoint storms:
    a pure function of the tenant NAME, so (a) two seeded runs route
    identically (the per-target fingerprint is comparable with ``==``)
    and (b) cache-coupled families (shared preambles, fork children —
    always same-tenant) land on one target, keeping the radix-cache
    determinism argument intact across the fan-out."""
    if n_targets <= 1:
        return 0
    return zlib.crc32(tenant.encode("utf-8")) % n_targets


class FleetStormDriver:
    """The multi-target storm driver: one :class:`StormDriver` per
    endpoint, the trace spread over them by :func:`target_of`. The
    verdict side (loadgen/report.py) aggregates one fingerprint per
    target off the ``target`` extra stamped on every outcome."""

    def __init__(self, addresses: Sequence[str], model: str,
                 metrics_ports: Optional[Sequence[Optional[int]]] = None,
                 time_scale: float = 1.0) -> None:
        if not addresses:
            raise ValueError("FleetStormDriver needs at least one address")
        ports: Sequence[Optional[int]] = (
            metrics_ports if metrics_ports is not None
            else [None] * len(addresses)
        )
        if len(ports) != len(addresses):
            raise ValueError("metrics_ports must match addresses")
        self.drivers = [
            StormDriver(addr, model, metrics_port=p, time_scale=time_scale)
            for addr, p in zip(addresses, ports)
        ]
        self.time_scale = time_scale

    def close(self) -> None:
        for d in self.drivers:
            d.close()

    def warmup(self, n: int = 3, max_tokens: int = 8) -> None:
        for d in self.drivers:
            d.warmup(n=n, max_tokens=max_tokens)

    def run(self, calls: List[Call],
            join_timeout: float = 180.0) -> List[Outcome]:
        """Same wall-clock replay contract as StormDriver.run, each call
        fired at its tenant's target; outcomes carry
        ``extras["target"]``."""
        outcomes = [Outcome(call=c) for c in calls]
        n = len(self.drivers)
        threads = []
        t0 = time.monotonic()
        for c, out in zip(calls, outcomes):
            delay = c.t * self.time_scale - (time.monotonic() - t0)
            if delay > 0:
                time.sleep(delay)
            target = target_of(c.tenant, n)
            out.extras["target"] = target
            th = threading.Thread(
                target=self.drivers[target]._fire, args=(c, out),
                daemon=True, name=f"storm-{c.task_id}",
            )
            th.start()
            threads.append(th)
        deadline = time.monotonic() + join_timeout
        for th, out in zip(threads, outcomes):
            th.join(timeout=max(deadline - time.monotonic(), 0.1))
            if th.is_alive():
                out.status, out.detail = "error", "stuck"
        return outcomes

    def slo_surface(self) -> Dict[str, dict]:
        """Per-target /debug/slo readback, keyed by target index."""
        return {
            str(i): d.slo_surface() for i, d in enumerate(self.drivers)
        }
