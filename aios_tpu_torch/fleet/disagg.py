"""Disaggregated prefill/decode roles over the transfer plane.

``AIOS_TPU_FLEET_ROLE`` splits a fleet into *prefill* hosts (admission
+ prefill + first token, then hand the stream off), *decode* hosts
(serve ``Handoff`` RPCs — resumed decode off transferred KV), and
*mixed* hosts (serve everything; the fleet router's pull-on-miss rung
applies). The handoff reuses failover's resume-from-emitted contract
(serving/failover.py ``build_resume_request``): the decode host
resubmits ``prompt + emitted`` with the remaining budget, its prefill
of the grown prompt is a host-tier restore of the pushed pages, and it
samples exactly the token the prefill host would have produced next —
greedy streams are token-identical to a single-host run.

Failure ladder, every rung counted on the closed
``router.FLEET_ROUTE_REASONS`` enum:

  1. ``handoff``        — first decode target accepted the stream;
  2. ``handoff_resume`` — the target died mid-stream (real crash, or
     the ``fleet.host_kill`` chaos point); the prefill host re-hands
     ``prompt + ALL emitted tokens`` to a surviving decode host —
     tokens already relayed to the client are never re-sent;
  3. ``fallback_local`` — no survivor took it (or a transfer failed):
     the request resumes on the prefill host itself via
     ``pool.submit_failover``, admission skipped (it was judged once).

A failed/corrupt KV push never blocks the handoff: the decode host
pulls on miss (``kv_pushed=false`` -> ``Fetch`` back to the source) and,
when that also fails, simply recomputes the prefill locally — the host
tier's ``restore_fail`` contract, one hop out.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Iterator, List, Optional, Tuple

import grpc

from .. import services
from ..analysis.locks import make_lock
from ..engine.batching import Request
from ..faults import inject as faults
from ..obs import flightrec
from ..serving.failover import build_resume_request
from . import kvx
from .router import FleetRouter, count_route, register_route_metrics

log = logging.getLogger("aios.fleet.disagg")

ROLES = ("prefill", "decode", "mixed")

# exit status for an injected fleet.host_kill with exit=1: distinct from
# crash-loop codes so the disagg smoke can assert the kill it scheduled
# is the death it observed
KILL_EXIT_STATUS = 17


def role() -> str:
    """This process's data-plane role (AIOS_TPU_FLEET_ROLE). Unknown
    values degrade to "mixed" — the lenient-env pattern; a typo must
    not silently turn a serving host into a prefill-only one."""
    r = os.environ.get("AIOS_TPU_FLEET_ROLE", "").strip().lower()
    return r if r in ROLES else "mixed"


def handoff_retries() -> int:
    """Decode-target re-handoff budget (AIOS_TPU_FLEET_HANDOFF_RETRIES)
    before the stream falls back to local decode."""
    try:
        return int(os.environ.get("AIOS_TPU_FLEET_HANDOFF_RETRIES", "") or 2)
    except ValueError:
        return 2


# -- decode-host half: the Handoff servicer ----------------------------------

class DisaggService(kvx.KvxService):
    """The full KvTransfer servicer: Fetch/Push from
    :class:`~aios_tpu_torch.fleet.kvx.KvxService` plus the Handoff stream —
    registered on the runtime's gRPC server whenever the fleet plane
    could be armed (answering is harmless on a solo host)."""

    def Handoff(self, request, context) -> Iterator[object]:
        from ..proto_gen import fleet_pb2
        from . import drain

        if drain.draining():
            # a draining host refuses NEW handoffs immediately — the
            # source's retry ladder re-hands to a surviving peer
            context.abort(
                grpc.StatusCode.UNAVAILABLE, "handoff refused: draining"
            )
        m = self.manager.get(request.model)
        if m is None or m.pool is None:
            context.abort(
                grpc.StatusCode.NOT_FOUND,
                f"model {request.model} not loaded here",
            )
        prompt = list(request.prompt_ids)
        emitted = list(request.emitted_ids)
        engine = m.engine
        # pull-on-miss: the source pushed pages before handing off; when
        # that push failed (kv_pushed=false) fetch the chain back from
        # the source before submitting, so the local prefill of
        # prompt+emitted is a restore, not a recompute. RPC happens
        # HERE, before any lock, on this handler thread.
        if (
            engine is not None and not request.kv_pushed
            and request.source_addr and engine.host_store is not None
        ):
            hashes = engine.prefix_hashes(prompt)
            if hashes:
                n_hbm = engine.prefix_index.peek(hashes)
                n_host = engine.host_store.peek_chain(hashes[n_hbm:])
                missing = hashes[n_hbm + n_host:]
                if missing:
                    from ..faults import net

                    for h, entry in kvx.fetch_chain(
                        request.source_addr, m.name, missing,
                        peer=net.host_of(request.source_addr),
                    ):
                        engine.host_store.put(h, entry)
        req = Request(
            prompt_ids=prompt + emitted,
            max_tokens=max(int(request.max_tokens), 1),
            temperature=request.temperature,
            top_p=request.top_p or 1.0,
            stop_ids=tuple(request.stop_ids),
            request_id=request.request_id,
            priority=int(request.priority),
        )
        req.rec = flightrec.RECORDER.begin(
            m.name, req.request_id, request.tenant or "fleet",
            prompt_tokens=len(req.prompt_ids), priority=req.priority,
        )
        req.rec.event(
            "handoff", source=request.source_addr,
            attempt=int(request.attempt), kv_pushed=bool(request.kv_pushed),
            resumed_tokens=len(emitted),
        )
        try:
            # admission is SKIPPED by design: the prefill host's gates
            # judged this request and debited its quota at first
            # admission — a handoff must not double-bill or shed a
            # stream the client is already consuming
            handle = m.pool.submit_failover(
                req, cause="handoff", attempt=int(request.attempt),
                backoff_ms=0.0,
            )
        except Exception as exc:  # noqa: BLE001 - a draining/teardown pool
            # refuses; the source falls back (the abort IS the signal)
            flightrec.RECORDER.finish(
                req.rec, "aborted", abort_reason="handoff_refused"
            )
            context.abort(
                grpc.StatusCode.UNAVAILABLE, f"handoff refused: {exc}"
            )
        try:
            for tok in handle:
                if drain.draining():
                    # drain arrived mid-stream: abort so the SOURCE's
                    # resume ladder re-hands prompt+emitted to a
                    # survivor — tokens already relayed are never lost
                    handle.cancel()
                    context.abort(
                        grpc.StatusCode.UNAVAILABLE,
                        "draining_host: stream re-handed",
                    )
                act = faults.point("fleet.host_kill", m.name)
                if act is not None:
                    if act.exit:
                        log.error(
                            "fleet.host_kill(exit=1): killing decode host"
                        )
                        os._exit(KILL_EXIT_STATUS)
                    handle.cancel()
                    context.abort(
                        grpc.StatusCode.UNAVAILABLE,
                        "fleet.host_kill injected",
                    )
                yield fleet_pb2.HandoffChunk(token=tok, done=False)
            yield fleet_pb2.HandoffChunk(
                done=True,
                abort_reason=handle.abort_reason,
                retry_after_ms=handle.retry_after_ms if handle.aborted else 0,
            )
        finally:
            # source gone / stream torn down: free the slot now
            handle.cancel()


# -- prefill-host half: the handoff handle -----------------------------------

class HandoffHandle:
    """Caller-side view of a disaggregated request: iterates like a
    RequestHandle, splicing the local first token and the remote decode
    stream (plus any re-handoffs and the local fallback) into one
    token-identical stream. The LOCAL submit runs eagerly in the
    constructor so admission sheds raise where the runtime service
    expects them; everything after the first token is lazy."""

    def __init__(self, plane: "DisaggPlane", m, req: Request, tenant: str,
                 deadline_s: Optional[float]) -> None:
        self._plane = plane
        self._m = m
        self._req = req
        self._tenant_label = tenant
        self._emitted: List[int] = []
        self._attempts = 0
        self._t0 = time.monotonic()
        self._deadline_s = deadline_s
        self._ttft_at = 0.0
        self._terminal_abort = ""
        self._terminal_retry_ms = 0
        self._lock = make_lock("handoff")
        #: guarded_by _lock
        self._cancelled = False
        #: guarded_by _lock — the live local handle (first token / fallback)
        self._local = m.submit(req, tenant=tenant, deadline_s=deadline_s)

    # -- RequestHandle surface ----------------------------------------------

    def __iter__(self):
        with self._lock:
            local = self._local
        first = next(iter(local), None)
        if first is None or local.aborted:
            self._finish_local(local)
            return
        self._ttft_at = time.monotonic()
        self._emitted.append(first)
        yield first
        if (
            len(self._emitted) >= self._req.max_tokens
            or first in (self._req.stop_ids or ())
        ):
            # the stream is already complete — nothing to disaggregate
            return
        # the prefill host's job ends here: free the local slot (the
        # prefix pages it computed stay cached for the export) and move
        # the stream to a decode host
        local.cancel()
        yield from self._relay()

    def _relay(self):
        """Hand off to decode hosts until the stream completes; local
        fallback when the retry budget or the peer set runs dry."""
        from ..proto_gen import fleet_pb2

        from . import breaker

        pool = self._m.pool
        route_ids, _ = pool._route_ids(self._req)
        pairs = None
        tried: List[str] = []
        while self._attempts <= handoff_retries():
            with self._lock:
                if self._cancelled:
                    return
            timeout = self._remaining_deadline()
            if timeout is not None and timeout <= 0.0:
                # the client's own gRPC deadline has passed — a gray
                # decode host must not hold this stream any longer, and
                # no survivor could deliver tokens the client will see
                self._terminal("handoff_deadline", 0)
                return
            target = self._plane.pick_decode(self._m.name, exclude=tried)
            if target is None:
                break
            host, addr = target
            tried.append(host)
            self._attempts += 1
            reason = "handoff" if self._attempts == 1 else "handoff_resume"
            if pairs is None:
                # export once: the chain is content-addressed, so every
                # retry pushes the same pages (a survivor that already
                # received them just overwrites identical entries)
                pairs = self._m.engine.export_prefix(route_ids)
            pushed = kvx.push_chain(addr, self._m.name, pairs, peer=host) > 0
            hreq = fleet_pb2.HandoffRequest(
                model=self._m.name,
                prompt_ids=route_ids,
                emitted_ids=self._emitted,
                max_tokens=self._req.max_tokens - len(self._emitted),
                temperature=self._req.temperature,
                top_p=self._req.top_p,
                stop_ids=list(self._req.stop_ids or ()),
                request_id=self._req.request_id,
                priority=self._req.priority,
                source_addr=self._plane.self_addr(),
                kv_pushed=pushed,
                attempt=self._attempts,
                tenant=self._tenant_label,
            )
            count_route(self._m.name, reason)
            rec = getattr(self._req, "rec", None)
            if rec is not None:
                rec.event(
                    "handoff", target=host, attempt=self._attempts,
                    kv_pushed=pushed, emitted=len(self._emitted),
                )
            log.info(
                "%s: handing off %s to %s (attempt %d, %d tokens "
                "emitted, kv_pushed=%s)", self._m.name,
                self._req.request_id or "<anon>", host, self._attempts,
                len(self._emitted), pushed,
            )
            t_call = time.monotonic()
            try:
                stream = kvx._stub(addr).Handoff(hreq, timeout=timeout)
                for chunk in stream:
                    if chunk.done:
                        breaker.BOARD.record_ok(
                            host, time.monotonic() - t_call
                        )
                        if chunk.abort_reason and not self._retryable(
                            chunk.abort_reason
                        ):
                            self._terminal(
                                chunk.abort_reason, chunk.retry_after_ms
                            )
                            return
                        if chunk.abort_reason:
                            raise _RemoteDied(chunk.abort_reason)
                        return  # clean completion on the decode host
                    self._emitted.append(chunk.token)
                    yield chunk.token
                breaker.BOARD.record_ok(host, time.monotonic() - t_call)
                return  # stream closed without a done-chunk: treat as done
            except (_RemoteDied, grpc.RpcError) as exc:
                # a _RemoteDied is the DECODE host aborting its own
                # pool — that is the remote's replica health, not the
                # network edge, so only transport failures feed the
                # breaker
                if not isinstance(exc, _RemoteDied):
                    breaker.BOARD.record_failure(host, _handoff_cause(exc))
                with self._lock:
                    if self._cancelled:
                        return
                log.warning(
                    "%s: decode host %s lost mid-handoff (%s, %d tokens "
                    "relayed); resuming", self._m.name, host,
                    getattr(exc, "code", lambda: exc)(),
                    len(self._emitted),
                )
                continue
        yield from self._fallback_local()

    def _fallback_local(self):
        """No decode host could finish the stream: resume it HERE off
        the resume-from-emitted contract — the prefill host still holds
        the prefix pages, so this is a cache-hit re-prefill."""
        count_route(self._m.name, "fallback_local")
        resumed = build_resume_request(self._m.pool, self._req, self._emitted)
        try:
            handle = self._m.pool.submit_failover(
                resumed, cause="handoff", attempt=self._attempts,
                backoff_ms=0.0,
            )
        except Exception as exc:  # noqa: BLE001 - pool draining/teardown:
            # surface the abort, never a silent truncation
            log.warning(
                "%s: local fallback submit failed: %r", self._m.name, exc
            )
            self._terminal("handoff_exhausted", 0)
            return
        with self._lock:
            self._local = handle
            if self._cancelled:
                handle.cancel()
        for tok in handle:
            self._emitted.append(tok)
            yield tok
        if handle.aborted:
            self._terminal(handle.abort_reason, handle.retry_after_ms)

    def _remaining_deadline(self) -> Optional[float]:
        """Seconds left of the client's deadline budget, measured from
        the submit — propagated as the Handoff RPC timeout so a gray
        decode host can never hold this stream past the point where the
        client's own gRPC call has already expired."""
        if self._deadline_s is None:
            return None
        return self._deadline_s - (time.monotonic() - self._t0)

    def _retryable(self, abort_reason: str) -> bool:
        return (
            flightrec.abort_cause(abort_reason)
            in flightrec.RETRYABLE_ABORT_CAUSES
        )

    def _finish_local(self, local) -> None:
        if local.aborted:
            self._terminal(
                local.abort_reason, getattr(local, "retry_after_ms", 0)
            )

    def _terminal(self, reason: str, retry_ms: int) -> None:
        with self._lock:
            if not self._terminal_abort:
                self._terminal_abort = reason
                self._terminal_retry_ms = int(retry_ms or 0)

    def tokens(self) -> List[int]:
        return list(self)

    def cancel(self) -> None:
        with self._lock:
            self._cancelled = True
            local = self._local
        if local is not None:
            local.cancel()

    @property
    def aborted(self) -> bool:
        return bool(self._terminal_abort)

    @property
    def abort_reason(self) -> str:
        return self._terminal_abort

    @property
    def retry_after_ms(self) -> int:
        return self._terminal_retry_ms

    @property
    def ttft_ms(self) -> float:
        if not self._ttft_at:
            return 0.0
        return (self._ttft_at - self._t0) * 1000.0


class _RemoteDied(Exception):
    """Internal: the decode host reported a retryable abort in its final
    chunk — same recovery as a transport-level stream failure."""


def _handoff_cause(exc: Exception) -> str:
    """Map a transport-level handoff failure onto the breaker's
    cause vocabulary (kvx.KVX_FAIL_CAUSES flavors)."""
    code = getattr(exc, "code", lambda: None)()
    if code == grpc.StatusCode.DEADLINE_EXCEEDED:
        return "timeout"
    return "unavailable"


# -- the plane ---------------------------------------------------------------

class DisaggPlane:
    """Per-process handle on the fleet data plane: the manager, the
    fleet router rung, and this process's transfer endpoint."""

    def __init__(self, manager) -> None:
        self.manager = manager
        self.router = FleetRouter(manager)

    def self_addr(self) -> str:
        from ..obs import fleet

        return fleet._transfer_addr

    def _members(self) -> List[dict]:
        from ..obs import fleet

        reg = fleet.FLEET
        return reg.members() if reg is not None else []

    def pick_decode(self, model: str,
                    exclude: Optional[List[str]] = None
                    ) -> Optional[Tuple[str, str]]:
        """Choose a decode target: live, not self, transfer-capable,
        role ``decode`` (falling back to ``mixed`` peers when no
        dedicated decode host survives), least heartbeat-reported load
        first. Quarantined peers (gray hosts — the breaker overlay, NOT
        membership state) and draining/leaving peers are treated as
        absent. -> (host, kvx_addr) or None."""
        from . import breaker

        skip = set(exclude or ())
        candidates: List[Tuple[float, str, str]] = []
        fallback: List[Tuple[float, str, str]] = []
        for p in self._members():
            if (
                p.get("self") or p.get("state") != "up"
                or not p.get("kvx_addr") or p["host"] in skip
                or (p.get("phase") or "serving") != "serving"
                or breaker.BOARD.quarantined(p["host"])
            ):
                continue
            load = 0.0
            for stats in (p.get("pools") or {}).values():
                if isinstance(stats, dict):
                    load += float(stats.get("occupancy", 0.0) or 0.0)
                    load += float(stats.get("waiting", 0.0) or 0.0)
            row = (load, p["host"], p["kvx_addr"])
            if p.get("role") == "decode":
                candidates.append(row)
            elif p.get("role") == "mixed":
                fallback.append(row)
        pool = candidates or fallback
        if not pool:
            return None
        _, host, addr = min(pool)
        return host, addr


# the armed plane; None = disaggregation off (solo host / telemetry-only
# fleet) and route_submit degrades to a plain pool submit
PLANE: Optional[DisaggPlane] = None


def arm(manager) -> DisaggPlane:
    """Arm the data plane for this process (runtime serve() calls this
    once the KvTransfer servicer is registered) and pre-register every
    ready model's transfer/routing metric children."""
    global PLANE
    PLANE = DisaggPlane(manager)
    for m in manager.ready_models():
        kvx.register_kvx_metrics(m.name)
        register_route_metrics(m.name)
    log.info("fleet data plane armed (role=%s)", role())
    return PLANE


def disarm() -> None:
    """Test isolation."""
    global PLANE
    PLANE = None


def route_submit(m, req: Request, tenant: str = "anonymous",
                 deadline_s: Optional[float] = None):
    """The serving front door's fleet rung: exactly ``m.submit`` when
    the plane is disarmed; otherwise the role decides —

      * ``prefill``: admission + prefill + first token locally, then a
        :class:`HandoffHandle` moves the stream to a decode host;
      * ``mixed``: the fleet router's pull-on-miss rung runs first (a
        peer's deeper chain lands in the local host tier before the
        pool routes), then a plain local submit;
      * ``decode``: plain local submit (handoffs arrive via RPC, not
        through this door).

    Grammar-constrained requests never disaggregate — the same
    first-token-reproducibility limitation as failover."""
    plane = PLANE
    if plane is None or m.pool is None:
        return m.submit(req, tenant=tenant, deadline_s=deadline_s)
    r = role()
    eligible = (
        getattr(req, "json_schema", None) is None
        and not getattr(req, "json_mode", False)
    )
    if r == "prefill" and eligible:
        if plane.pick_decode(m.name) is None:
            count_route(m.name, "no_peer")
            return m.submit(req, tenant=tenant, deadline_s=deadline_s)
        return HandoffHandle(plane, m, req, tenant, deadline_s)
    if r == "mixed" and eligible:
        route_ids, _ = m.pool._route_ids(req)
        plane.router.pull_before_submit(m, route_ids)
    return m.submit(req, tenant=tenant, deadline_s=deadline_s)
