"""Gossiped prefix index: score remote cache overlap off heartbeats.

Each host piggybacks a bounded digest of its prefix caches on the
``/fleet/announce`` heartbeat (obs/fleet.py ``gprefix`` descriptor
field): per model, the page size and up to ``AIOS_TPU_FLEET_GPREFIX_MAX``
chain-hash *tails* — the first 16 hex chars (64 bits) of the sha256
chain hash — mapped to the chain depth in blocks where the index knows
it (0 = resident, depth unknown; the host spill tier advertises this
way). Chain hashes commit to the whole prefix, so tail membership is
enough to score overlap: for a request's hash chain h1..hn, the deepest
k with ``tail(h_k)`` advertised means the peer holds >= k full blocks
of exactly this prompt's prefix.

The digest is advisory by construction: it ages one heartbeat interval,
truncates at the cap, and 64-bit tails can collide. Every way it can be
wrong is safe — a misroute means the transfer fetches nothing (the
``empty`` kvx cause) and the request falls back to local prefill. No
extra RPC, no extra lock: building the digest takes only the index and
host-store locks (``engine.prefix_digest``), and scoring peers reads
the membership table snapshot.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

__all__ = [
    "digest_max", "tail", "build_digest", "provider", "score_tails",
    "best_peer",
]


def digest_max() -> int:
    """Per-model tail cap on the heartbeat digest
    (AIOS_TPU_FLEET_GPREFIX_MAX). Bounds heartbeat growth: 512 tails is
    ~20 KB of JSON against the announce body cap of 4 MB."""
    try:
        return int(os.environ.get("AIOS_TPU_FLEET_GPREFIX_MAX", "") or 512)
    except ValueError:
        return 512


def tail(h: bytes) -> str:
    """The gossiped form of one chain hash: first 64 bits, hex."""
    return h.hex()[:16]


def build_digest(manager) -> Dict[str, dict]:
    """The ``gprefix`` heartbeat field for every ready model:
    ``{model: {"page": page_size, "tails": {tail: depth_blocks}}}``.
    Models without a paged prefix cache are omitted — nothing to
    advertise, nothing to transfer."""
    cap = digest_max()
    out: Dict[str, dict] = {}
    for m in manager.ready_models():
        engine = m.engine
        if engine is None or getattr(engine, "prefix_index", None) is None:
            continue
        tails = engine.prefix_digest(cap)
        if tails:
            out[m.name] = {
                "page": int(engine.allocator.page_size), "tails": tails,
            }
    return out


def provider(manager):
    """A closure for :func:`aios_tpu_torch.obs.fleet.add_digest_provider` —
    bound to the manager, built fresh at each heartbeat."""
    return lambda: build_digest(manager)


def score_tails(digest: dict, hashes: Sequence[bytes]) -> int:
    """Overlap rows a peer's advertised digest promises for a request's
    chain ``hashes``: the longest advertised *prefix* of the chain,
    in rows (depth-in-blocks x page size). Prefix, not membership count:
    a transfer restores a contiguous chain from block 1, so an
    advertised deep block behind a hole is unreachable."""
    if not digest or not hashes:
        return 0
    tails: dict = digest.get("tails") or {}
    page = int(digest.get("page") or 0)
    if not tails or page <= 0:
        return 0
    k = 0
    for h in hashes:
        if tail(h) not in tails:
            break
        k += 1
    return k * page


def best_peer(peers: List[dict], model: str,
              hashes: Sequence[bytes]) -> tuple:
    """``(peer, rows)`` for the peer whose digest promises the deepest
    chain prefix for ``model`` — ``(None, 0)`` when nobody advertises
    overlap. ``peers`` are membership rows (obs/fleet.py ``members()``
    shape); only live, serving, non-quarantined ones with a transfer
    endpoint compete — a gray host's promised chain is a trap (the
    fetch would crawl or fail), so the breaker overlay hides it."""
    from . import breaker

    best, best_rows = None, 0
    for p in peers:
        if p.get("state") != "up" or p.get("self") or not p.get("kvx_addr"):
            continue
        if (p.get("phase") or "serving") != "serving":
            continue
        if breaker.BOARD.quarantined(p.get("host") or ""):
            continue
        rows = score_tails((p.get("gprefix") or {}).get(model) or {}, hashes)
        if rows > best_rows:
            best, best_rows = p, rows
    return best, best_rows
