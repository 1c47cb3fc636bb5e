"""KV transfer protocol (``aios.fleet.KvTransfer``): HostPageStore
entries over gRPC, crc32-verified at both ends.

The wire unit is one prefix-cache page: ``PageEntry(hash, crc32,
payload)`` where ``payload`` is :func:`aios_tpu_torch.engine.paged.pack_entry`
bytes and ``crc32`` is ``HostPageStore._entry_crc`` over the ARRAYS (the
same checksum the host tier computes at spill time) — so the receiver
re-derives it from the unpacked entry and a flipped bit anywhere in
transit, or in the sender's host RAM, fails verification and never
scatters into live KV. Entries ride in ``PageChunk`` batches bounded by
``AIOS_TPU_FLEET_KVX_CHUNK_BYTES`` (the gRPC message ceiling is 64 MB;
chunking keeps one transfer from monopolizing the stream).

Two verbs move pages (the closed :data:`KVX_DIRECTIONS` enum):

  * ``push`` — the prefill host streams pages it just computed to its
    decode target (:func:`push_chain` -> the ``Push`` RPC);
  * ``pull`` — a decode host fetches a chain the fleet router promised
    (:func:`fetch_chain` -> the ``Fetch`` RPC; the server exports
    HBM-resident pages first, then its host tier).

Every failure mode is a closed-enum cause (:data:`KVX_FAIL_CAUSES`) on
``aios_tpu_fleet_kvx_failures_total`` and degrades to local prefill —
the host tier's ``restore_fail`` contract: a failed transfer is a cache miss,
never a wrong answer. Client stubs are NEVER called under a declared
lock (the analyzer's rpc-under-lock rule).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .. import services
from ..engine import paged
from ..obs import instruments as obs

log = logging.getLogger("aios.fleet.kvx")

# Transfer directions — THE closed enum (pinned by test_obs_lint):
# push = prefill host streaming pages out, pull = decode host fetching
# a promised chain on miss.
KVX_DIRECTIONS = ("push", "pull")

# Transfer-failure causes — closed enum, iterated at registration:
#   unavailable   peer unreachable / RPC failed outright
#   timeout       RPC deadline expired mid-transfer
#   crc_mismatch  receiving end re-derived a different crc32 (the
#                 verified-at-both-ends contract rejecting a payload)
#   decode_error  payload failed pack_entry framing
#   empty         the promised chain came back with zero entries (the
#                 gossiped digest was stale, or a 64-bit tail collided)
#   breaker_open  the per-peer circuit breaker (fleet/breaker.py) refused
#                 the transfer locally — no wire traffic, no timeout
#                 stall; the peer is quarantined until probes clear it
KVX_FAIL_CAUSES = (
    "unavailable", "timeout", "crc_mismatch", "decode_error", "empty",
    "breaker_open",
)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def chunk_bytes() -> int:
    """Per-PageChunk payload budget (AIOS_TPU_FLEET_KVX_CHUNK_BYTES)."""
    return int(_env_float("AIOS_TPU_FLEET_KVX_CHUNK_BYTES", 8 << 20))


def transfer_timeout() -> float:
    """Per-RPC deadline (AIOS_TPU_FLEET_KVX_TIMEOUT_SECS)."""
    return _env_float("AIOS_TPU_FLEET_KVX_TIMEOUT_SECS", 5.0)


def fetch_budget() -> int:
    """Total bytes one Fetch may return (AIOS_TPU_FLEET_KVX_BUDGET_BYTES)
    — bounds how much host RAM a single pull can claim on either end."""
    return int(_env_float("AIOS_TPU_FLEET_KVX_BUDGET_BYTES", 128 << 20))


def register_kvx_metrics(model: str) -> None:
    """Pre-register every transfer metric child for ``model`` by
    iterating the closed enums (the fleet/autoscale registration
    pattern): a new direction or cause is a reviewed enum change, never
    a stray label value."""
    for direction in KVX_DIRECTIONS:
        obs.FLEET_KVX_PAGES.labels(model=model, direction=direction)
        obs.FLEET_KVX_BYTES.labels(model=model, direction=direction)
    for cause in KVX_FAIL_CAUSES:
        obs.FLEET_KVX_FAILURES.labels(model=model, cause=cause)


def count_failure(model: str, cause: str) -> None:
    """One failed transfer, by closed-enum cause."""
    obs.FLEET_KVX_FAILURES.labels(model=model, cause=cause).inc()


# -- wire helpers ------------------------------------------------------------

def entries_to_chunks(
    model: str, triples: Sequence[Tuple[bytes, int, bytes]]
) -> Iterator[object]:
    """``(hash, crc32, payload-bytes)`` triples -> a PageChunk stream
    bounded by :func:`chunk_bytes` per message."""
    from ..proto_gen import fleet_pb2

    budget = chunk_bytes()
    batch: List[object] = []
    size = 0
    for h, crc, payload in triples:
        entry = fleet_pb2.PageEntry(hash=h, crc32=crc, payload=payload)
        if batch and size + len(payload) > budget:
            yield fleet_pb2.PageChunk(model=model, entries=batch)
            batch, size = [], 0
        batch.append(entry)
        size += len(payload)
    if batch:
        yield fleet_pb2.PageChunk(model=model, entries=batch)


def verify_entry(e) -> Dict[str, np.ndarray]:
    """Receiving-end half of the verified-at-both-ends contract: unpack
    the payload and re-derive its crc32 from the ARRAYS. Raises
    ``ValueError`` on framing damage (a ``decode_error``) and
    :class:`CrcMismatch` when the checksum disagrees."""
    entry = paged.unpack_entry(e.payload)
    if paged.HostPageStore._entry_crc(entry) != e.crc32:
        raise CrcMismatch(f"page {e.hash.hex()[:16]} failed crc32")
    return entry


class CrcMismatch(ValueError):
    """A transferred page whose receiving-end crc32 disagrees with the
    wire's — distinct type so call sites count the right cause."""


# -- the servicer ------------------------------------------------------------

class KvxService(services.KvTransferServicer):
    """Fetch/Push halves of the transfer plane, backed by a
    :class:`~aios_tpu_torch.runtime.model_manager.ModelManager`. ``Handoff``
    stays UNIMPLEMENTED here — :class:`aios_tpu_torch.fleet.disagg
    .DisaggService` subclasses in the disaggregation half."""

    def __init__(self, manager) -> None:
        self.manager = manager

    def _engine_of(self, model: str, context):
        import grpc

        m = self.manager.get(model)
        if m is None or m.engine is None:
            context.abort(
                grpc.StatusCode.NOT_FOUND, f"model {model} not loaded"
            )
        return m.engine

    def Fetch(self, request, context):
        """Serve a promised chain: HBM-resident pages first (the
        engine's export pays the device->host copy), then the host
        spill tier for the remainder — mirroring ``_match_prefix``'s
        two-tier probe. Stops at the first gap (a chain transfer past a
        hole would restore nothing) and at the byte budget."""
        engine = self._engine_of(request.model, context)
        hashes = list(request.hashes)
        budget = int(request.budget_bytes) or fetch_budget()
        triples: List[Tuple[bytes, int, bytes]] = []
        total = 0
        hbm = engine.export_hashes(hashes)
        for h, entry in hbm:
            payload = paged.pack_entry(entry)
            crc = paged.HostPageStore._entry_crc(entry)
            if triples and total + len(payload) > budget:
                break
            triples.append((h, crc, payload))
            total += len(payload)
        store = engine.host_store
        if store is not None and len(triples) == len(hbm) and total < budget:
            for h, crc, entry in store.export_chain(
                hashes[len(hbm):], budget_bytes=budget - total
            ):
                payload = paged.pack_entry(entry)
                triples.append((h, crc, payload))
                total += len(payload)
        log.debug(
            "kvx fetch: %s serving %d/%d pages (%d bytes)",
            request.model, len(triples), len(hashes), total,
        )
        yield from entries_to_chunks(request.model, triples)

    def Push(self, request_iterator, context):
        """Accept pushed pages into the local host tier. Every entry is
        verified HERE (the receiving end): a crc mismatch or framing
        error rejects THAT entry and counts the closed-enum cause —
        accepting its siblings is safe because host-store entries are
        independent (`match_chain` just truncates at the hole)."""
        from ..proto_gen import fleet_pb2

        accepted = rejected = 0
        model = ""
        for chunk in request_iterator:
            model = chunk.model or model
            store = None
            m = self.manager.get(model) if model else None
            if m is not None and m.engine is not None:
                store = m.engine.host_store
            for e in chunk.entries:
                if store is None:
                    rejected += 1
                    continue
                try:
                    entry = verify_entry(e)
                except CrcMismatch:
                    count_failure(model, "crc_mismatch")
                    rejected += 1
                    continue
                except ValueError:
                    count_failure(model, "decode_error")
                    rejected += 1
                    continue
                store.put(e.hash, entry)
                accepted += 1
        if model:
            log.debug(
                "kvx push: %s accepted %d rejected %d", model, accepted,
                rejected,
            )
        return fleet_pb2.PushAck(accepted=accepted, rejected=rejected)


# -- client helpers ----------------------------------------------------------

# channel cache: one gRPC channel per peer address for process life
# (plain lock, never on a request hot path past the first call per addr)
_channels: Dict[str, object] = {}
_channels_lock = threading.Lock()


def _stub(addr: str):
    from .. import rpc

    with _channels_lock:
        ch = _channels.get(addr)
        if ch is None:
            ch = _channels[addr] = rpc.insecure_channel(addr)
    return services.KvTransferStub(ch)


def reset_channels() -> None:
    """Test isolation: drop cached peer channels."""
    with _channels_lock:
        chans = list(_channels.values())
        _channels.clear()
    for ch in chans:
        try:
            ch.close()
        except Exception:  # noqa: BLE001 - closing a dead channel is fine
            pass


def _rpc_cause(exc) -> str:
    import grpc

    if isinstance(exc, grpc.RpcError) and (
        exc.code() is grpc.StatusCode.DEADLINE_EXCEEDED
    ):
        return "timeout"
    return "unavailable"


def push_chain(
    addr: str, model: str,
    pairs: Sequence[Tuple[bytes, Dict[str, np.ndarray]]],
    peer: str = "",
) -> int:
    """Push ``(hash, entry)`` pairs (``engine.export_prefix`` output) to
    ``addr``'s host tier. Returns the count the receiver ACCEPTED (its
    crc verification may reject pages ours passed — that is the point of
    verifying at both ends); 0 on any RPC failure, with the cause
    counted. Never raises: a failed push just means the decode host
    pulls or recomputes. ``peer`` (the target's fleet host id) gates the
    transfer on — and feeds — the per-peer circuit breaker: a
    quarantined peer costs a local ``breaker_open`` count instead of a
    full transfer-timeout stall."""
    if not pairs:
        return 0
    from . import breaker

    if peer and not breaker.BOARD.allow(peer):
        count_failure(model, "breaker_open")
        log.debug("kvx push to %s (%s) refused: breaker open", addr, peer)
        return 0
    triples = [
        (h, paged.HostPageStore._entry_crc(e), paged.pack_entry(e))
        for h, e in pairs
    ]
    sent_bytes = sum(len(p) for _, _, p in triples)
    t0 = time.monotonic()
    try:
        ack = _stub(addr).Push(
            entries_to_chunks(model, triples), timeout=transfer_timeout()
        )
    except Exception as exc:  # noqa: BLE001 - any transport failure is the
        # same outcome: the pages do not arrive; the counter carries why
        cause = _rpc_cause(exc)
        count_failure(model, cause)
        if peer:
            breaker.BOARD.record_failure(peer, cause)
        log.warning("kvx push to %s failed: %r", addr, exc)
        return 0
    if peer:
        breaker.BOARD.record_ok(peer, time.monotonic() - t0)
    obs.FLEET_KVX_PAGES.labels(model=model, direction="push").inc(
        float(ack.accepted)
    )
    obs.FLEET_KVX_BYTES.labels(model=model, direction="push").inc(
        float(sent_bytes)
    )
    return int(ack.accepted)


def fetch_chain(
    addr: str, model: str, hashes: Sequence[bytes],
    budget_bytes: int = 0, peer: str = "",
) -> List[Tuple[bytes, Dict[str, np.ndarray]]]:
    """Pull a promised chain from ``addr``. Every received entry is
    verified HERE (receiving end); the chain truncates at the first bad
    or out-of-order entry — a prefix chain with a hole restores nothing
    past it. Returns verified ``(hash, entry)`` pairs, possibly empty
    (the caller falls back to local prefill); never raises. ``peer``
    (the source's fleet host id) gates on — and feeds — the per-peer
    circuit breaker, same contract as :func:`push_chain`."""
    from ..proto_gen import fleet_pb2
    from . import breaker

    if peer and not breaker.BOARD.allow(peer):
        count_failure(model, "breaker_open")
        log.debug("kvx fetch from %s (%s) refused: breaker open",
                  addr, peer)
        return []
    want = list(hashes)
    out: List[Tuple[bytes, Dict[str, np.ndarray]]] = []
    got_bytes = 0
    counted = False
    fail_cause = ""
    t0 = time.monotonic()
    try:
        stream = _stub(addr).Fetch(
            fleet_pb2.FetchRequest(
                model=model, hashes=want,
                budget_bytes=budget_bytes or fetch_budget(),
            ),
            timeout=transfer_timeout(),
        )
        for chunk in stream:
            for e in chunk.entries:
                if len(out) >= len(want) or e.hash != want[len(out)]:
                    log.warning(
                        "kvx fetch from %s: out-of-chain page; truncating",
                        addr,
                    )
                    raise _Truncate()
                try:
                    entry = verify_entry(e)
                except CrcMismatch:
                    count_failure(model, "crc_mismatch")
                    counted = True
                    fail_cause = "crc_mismatch"
                    raise _Truncate()
                except ValueError:
                    count_failure(model, "decode_error")
                    counted = True
                    fail_cause = "decode_error"
                    raise _Truncate()
                out.append((e.hash, entry))
                got_bytes += len(e.payload)
    except _Truncate:
        pass
    except Exception as exc:  # noqa: BLE001 - transport failure mid-pull:
        # keep the verified prefix, count why the rest never came
        fail_cause = _rpc_cause(exc)
        count_failure(model, fail_cause)
        counted = True
        log.warning("kvx fetch from %s failed: %r", addr, exc)
    if peer:
        if fail_cause:
            breaker.BOARD.record_failure(peer, fail_cause)
        else:
            # an "empty" chain from a healthy peer is a stale digest,
            # not a peer fault — it does not feed the breaker
            breaker.BOARD.record_ok(peer, time.monotonic() - t0)
    if not out:
        # a promise that yielded nothing is its own cause — unless a
        # more specific failure already explained it
        if not counted:
            count_failure(model, "empty")
        return []
    obs.FLEET_KVX_PAGES.labels(model=model, direction="pull").inc(
        float(len(out))
    )
    obs.FLEET_KVX_BYTES.labels(model=model, direction="pull").inc(
        float(got_bytes)
    )
    return out


class _Truncate(Exception):
    """Internal: stop consuming a fetch stream at a bad entry, keeping
    the verified prefix (the failure cause is already counted)."""
