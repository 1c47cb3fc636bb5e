"""Seeded per-edge network faults — the fleet's messy-failure surface.

The ``fleet.host_kill`` point covers the CLEAN loss (a process dies, exit
17, everyone agrees). Production fleets mostly die messily: partitions,
asymmetric reachability, links that accept a connection and then sever
the stream mid-transfer. This module extends the seeded determinism
contract of :mod:`aios_tpu_torch.faults.inject` to *edges* — every fault is
keyed ``(src_host, dst_host)`` with its own hit counter, so the k-th
send on one edge fires the same way across re-runs no matter how other
edges interleave (docs/FAULTS.md "Per-edge network faults"):

    net.partition          both directions refused (send refused AND
                           inbound announces rejected at the server)
    net.partition_oneway   src->dst dropped, the reverse edge clean —
                           the asymmetric case the up/suspect/dead
                           machine in obs/fleet.py has never seen
    net.delay              per-edge latency (``delay_ms``) before send
    net.drop_after         the connection is accepted and the stream
                           severed after ``after_msgs`` messages

Injection happens at exactly two choke points so membership,
federation, KVX, and Handoff all traverse ONE fault surface: the shared
gRPC client interceptor (``rpc.insecure_channel``) and the
``obs/fleet.py`` announce/scrape/stitch HTTP helpers. Each is a
near-zero-cost no-op unless a schedule is armed — the gate is one
module-global None check inside :func:`aios_tpu_torch.faults.point`.

Edges are named by fleet HOST IDS (``AIOS_TPU_FLEET_HOST``), not
addresses: schedules survive ephemeral ports. The addr->host map is fed
by membership gossip (``obs/fleet._observe`` calls :func:`map_addr` for
every descriptor it folds); an address never seen in gossip resolves to
itself, so addr-keyed schedules also work in addressless tests.

:class:`NetFault` subclasses BOTH :class:`ConnectionError` and
``grpc.RpcError`` with an UNAVAILABLE ``code()`` — every existing
``except grpc.RpcError`` recovery path (kvx cause accounting, the
Handoff resume ladder) catches an injected edge fault exactly as it
catches a real dead peer, which is the point.
"""

from __future__ import annotations

import logging
import os
import socket
import threading
import time
from typing import Dict, Iterator, Tuple

import grpc

from . import inject

log = logging.getLogger("aios.faults.net")

__all__ = [
    "NET_POINTS", "SURFACES", "NetFault", "NetFaultRefused",
    "NetFaultSevered", "self_host", "host_of", "map_addr", "check_send",
    "check_drop_response", "sever_stream", "gate_announce",
]

# The per-edge subset of faults.POINTS this module injects (pinned
# against the catalog by tests/test_fleet_faults.py).
NET_POINTS = (
    "net.partition",
    "net.partition_oneway",
    "net.delay",
    "net.drop_after",
)

# Legal surface= filter values; "" in a schedule means both surfaces.
SURFACES = ("rpc", "http")


class NetFault(ConnectionError, grpc.RpcError):
    """An injected network-edge fault. Doubles as a grpc.RpcError with
    an UNAVAILABLE code so RPC-shaped recovery paths treat it as the
    dead-peer error it is simulating."""

    def __init__(self, point: str, edge: Tuple[str, str], hit: int) -> None:
        super().__init__(
            f"injected {point} on edge {edge[0]}->{edge[1]} (hit {hit})"
        )
        self.point = point
        self.edge = edge
        self.hit = hit

    def code(self) -> grpc.StatusCode:
        return grpc.StatusCode.UNAVAILABLE

    def details(self) -> str:
        return str(self)


class NetFaultRefused(NetFault):
    """net.partition / net.partition_oneway: the send never left."""


class NetFaultSevered(NetFault):
    """net.drop_after: the transfer started and the link cut it."""


# -- edge naming -------------------------------------------------------------

# self host id: env wins (the fleet worker contract), else the same
# hostname:pid fallback process_identity() uses. The fallback is cached
# (stable for the process lifetime); the env read is live so tests that
# flip AIOS_TPU_FLEET_HOST see the change.
_fallback_host = ""

# peer address -> fleet host id, fed by membership gossip. Writes are
# rare (first sight of a member); reads ride the GIL-atomic dict get.
_addr_hosts: Dict[str, str] = {}
_addr_lock = threading.Lock()  # map writes only — never on hot paths


def self_host() -> str:
    """This process's fleet host id — the src of every outbound edge."""
    env = os.environ.get("AIOS_TPU_FLEET_HOST", "")
    if env:
        return env
    global _fallback_host
    if not _fallback_host:
        _fallback_host = f"{socket.gethostname()}:{os.getpid()}"
    return _fallback_host


def map_addr(addr: str, host: str) -> None:
    """Teach the edge namer that ``addr`` (host:port) belongs to fleet
    host ``host`` — called by obs/fleet._observe for every descriptor's
    metrics_addr and kvx_addr."""
    if not addr or not host:
        return
    with _addr_lock:
        _addr_hosts[addr] = host


def host_of(addr: str) -> str:
    """Fleet host id for a peer address (URL or host:port); an address
    gossip has not named yet resolves to itself."""
    a = addr
    if "//" in a:
        a = a.split("//", 1)[1]
    a = a.split("/", 1)[0]
    return _addr_hosts.get(a, a)


def _reset() -> None:
    """Test isolation: drop the addr->host map and host cache."""
    global _fallback_host
    with _addr_lock:
        _addr_hosts.clear()
    _fallback_host = ""


# -- client-side injection gates ---------------------------------------------

def check_send(dst: str, surface: str) -> None:
    """The outbound gate, called before a send on ``surface`` to ``dst``
    (URL or host:port). Raises :class:`NetFaultRefused` on a fired
    partition (either flavor — the send direction is the dropped one),
    sleeps on a fired net.delay. No-op unless a schedule is armed."""
    if not inject.active():
        return
    edge = (self_host(), host_of(dst))
    act = inject.point("net.partition", edge=edge, surface=surface)
    if act is None:
        act = inject.point(
            "net.partition_oneway", edge=edge, surface=surface
        )
    if act is not None:
        raise NetFaultRefused(act.point, edge, act.hit)
    act = inject.point("net.delay", edge=edge, surface=surface)
    if act is not None and act.delay_s > 0:
        time.sleep(act.delay_s)


def check_drop_response(dst: str, surface: str = "http") -> None:
    """The HTTP half of net.drop_after, called AFTER a successful fetch:
    the request reached the server (its side effects happened — that is
    what distinguishes a sever from a refusal) but the response is
    discarded on the floor. Raises :class:`NetFaultSevered` when the
    point fires."""
    if not inject.active():
        return
    edge = (self_host(), host_of(dst))
    act = inject.point("net.drop_after", edge=edge, surface=surface)
    if act is not None:
        raise NetFaultSevered(act.point, edge, act.hit)


class _SeveredStream:
    """A response-stream wrapper that delivers ``after_msgs`` messages
    and then cuts the link — the caller sees a healthy stream die
    mid-transfer, exactly the failure the resume ladder must absorb."""

    def __init__(self, inner: Iterator, act: inject.FaultAction,
                 edge: Tuple[str, str]) -> None:
        self._inner = inner
        self._left = max(0, act.after_msgs)
        self._act = act
        self._edge = edge

    def __iter__(self) -> "_SeveredStream":
        return self

    def __next__(self):
        if self._left <= 0:
            try:
                self._inner.cancel()  # type: ignore[attr-defined]
            except Exception:  # noqa: BLE001 - best-effort upstream cancel
                pass
            raise NetFaultSevered(
                self._act.point, self._edge, self._act.hit
            )
        self._left -= 1
        return next(self._inner)

    def __getattr__(self, name: str):
        # delegate the grpc call surface (code/cancel/trailing metadata)
        return getattr(self._inner, name)


def sever_stream(dst: str, response: Iterator) -> Iterator:
    """The gRPC half of net.drop_after: consulted ONCE per unary-stream
    call; when the point fires the returned iterator yields
    ``after_msgs`` messages then raises :class:`NetFaultSevered`."""
    if not inject.active():
        return response
    edge = (self_host(), host_of(dst))
    act = inject.point("net.drop_after", edge=edge, surface="rpc")
    if act is None:
        return response
    return _SeveredStream(response, act, edge)


# -- server-side announce gate -----------------------------------------------

def gate_announce(peer_host: str) -> Tuple[bool, bool]:
    """The server side of ``/fleet/announce`` under a per-edge schedule
    -> ``(fold, reply)``. A one-process schedule must be able to model
    an asymmetric partition end to end, and the announce REPLY travels
    the self->announcer edge: when ``net.partition_oneway`` fires on it
    the peer's descriptor still folds (their data reached us) but the
    reply body — our descriptor AND the gossip list — is withheld
    (``reply=False`` -> the handler answers 503). A full
    ``net.partition`` additionally refuses the inbound fold
    (``fold=False``): both directions dead."""
    if not inject.active():
        return True, True
    edge = (self_host(), peer_host)
    if inject.point("net.partition", edge=edge, surface="http") is not None:
        return False, False
    if inject.point(
        "net.partition_oneway", edge=edge, surface="http"
    ) is not None:
        return True, False
    return True, True


def active_points() -> Tuple[str, ...]:
    """Which net points the active plan schedules (breaker/drain tests
    and fleetctl debugging); empty when faults are off."""
    plan = inject._PLAN
    if plan is None:
        return ()
    return tuple(n for n in plan.schedule if n in NET_POINTS)
