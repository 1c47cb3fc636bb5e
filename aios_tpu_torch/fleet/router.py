"""Fleet-level routing: the pool's ladder extended across hosts.

Within one process the :class:`~aios_tpu_torch.serving.router.Router` walks
sticky -> overlap -> least-loaded across replicas. This module adds the
fleet rung on top: before a request prefills locally, compare the LOCAL
cache's overlap (``engine.prefix_overlap_rows``) against what live
peers advertise through the gossiped prefix index (fleet/gprefix.py),
and when a peer's promised chain is deep enough to beat a local
recompute — transfer cost included — pull it over the kvx plane into
the local host tier, so the very next ``_match_prefix`` restores it
with a memcpy instead of a prefill forward pass.

The decision is priced, not just scored: fetching ``rows`` costs
``rows x bytes_per_row / AIOS_TPU_FLEET_KVX_GBPS`` seconds of wire
time, recomputing them costs ``rows / prefill_rate`` seconds off the
devprof ledger's sampled prefill throughput (the same ledger the
admission deadline gate trusts). When devprof has no samples yet the
cost gate abstains and the overlap-gain threshold alone decides.

Every decision lands on ``aios_tpu_fleet_route_total`` under the closed
:data:`FLEET_ROUTE_REASONS` enum — the disagg handoff outcomes
(fleet/disagg.py) share the same family, so one counter tells the whole
fleet-routing story.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Tuple

from ..obs import instruments as obs
from . import gprefix

log = logging.getLogger("aios.fleet.router")

# Fleet routing decisions — THE closed enum (pinned by test_obs_lint):
#   local           fleet rung consulted, local cache already wins (or
#                   the gain/cost gates said the transfer isn't worth it)
#   no_peer         wanted a remote chain but no live peer advertises one
#   remote_pull     pulled a peer's chain into the local host tier
#   handoff         prefill host handed the stream to a decode host
#   handoff_resume  re-handed to a survivor after a decode host died
#   fallback_local  a transfer/handoff failed; the request ran locally
FLEET_ROUTE_REASONS = (
    "local", "no_peer", "remote_pull", "handoff", "handoff_resume",
    "fallback_local",
)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def min_gain_rows(prompt_rows: int) -> int:
    """How many MORE rows a peer must promise over the local cache
    before a pull is considered: ``AIOS_TPU_FLEET_OVERLAP_GAIN`` as a
    fraction of the prompt (default 0.25 — the pool router's overlap
    threshold, one level up), floored at one page-worth of progress."""
    frac = _env_float("AIOS_TPU_FLEET_OVERLAP_GAIN", 0.25)
    return max(1, int(prompt_rows * frac))


def wire_gbps() -> float:
    """Assumed cross-host transfer bandwidth in GB/s
    (AIOS_TPU_FLEET_KVX_GBPS) for the fetch-vs-recompute price."""
    return max(_env_float("AIOS_TPU_FLEET_KVX_GBPS", 10.0), 1e-3)


def register_route_metrics(model: str) -> None:
    """Pre-register every fleet-route child for ``model`` by iterating
    the closed reason enum (same pattern as kvx.register_kvx_metrics)."""
    for reason in FLEET_ROUTE_REASONS:
        obs.FLEET_ROUTE.labels(model=model, reason=reason)


def count_route(model: str, reason: str) -> None:
    obs.FLEET_ROUTE.labels(model=model, reason=reason).inc()


def _prefill_rate(pool) -> float:
    """Sampled prefill throughput (rows/sec) off the devprof ledger —
    0.0 (cost gate abstains) until devprof has prefill samples."""
    from ..obs import devprof

    means = [
        m for m in (
            led.mean_s("prefill") for led in devprof.ledgers_for(pool.name)
        ) if m
    ]
    if not means:
        return 0.0
    reps = pool.replicas
    if not reps:
        return 0.0
    # one prefill graph run fills one padded bucket; the engine's
    # smallest bucket is the conservative rows-per-run estimate
    rows = float(getattr(reps[0].engine, "buckets", (0,))[0] or 0)
    if rows <= 0:
        return 0.0
    return rows / (sum(means) / len(means))


def _bytes_per_row(engine) -> int:
    """Wire bytes one KV row costs: per-page entry bytes / page size,
    derived from the pool tensors' dtypes and dims (``k_pool``,
    ``v_pool`` and an int8 pool's scales, as ``engine.page_bytes()``
    sums them: shape/metadata reads only — no device sync)."""
    P = int(engine.allocator.page_size)
    return max(int(engine.page_bytes()) // P, 1)


class FleetRouter:
    """Per-process fleet routing rung. Stateless beyond the manager
    handle — peers and digests come from the membership table each
    decision (they age with the heartbeat, not with this object)."""

    def __init__(self, manager) -> None:
        self.manager = manager

    def _peers(self) -> List[dict]:
        from ..obs import fleet

        reg = fleet.FLEET
        return reg.members() if reg is not None else []

    def decide_pull(self, m, route_ids: List[int]) -> Tuple[str, dict]:
        """The fleet rung for one request on model ``m`` (a
        ManagedModel): -> ``(reason, detail)`` where reason is "local" /
        "no_peer", or "remote_pull" with ``detail`` carrying the chosen
        peer, its transfer addr, and the chain hashes to fetch."""
        engine = m.engine
        if engine is None or getattr(engine, "prefix_index", None) is None:
            return "local", {}
        hashes = engine.prefix_hashes(route_ids)
        if not hashes:
            return "local", {}
        local_rows = engine.prefix_overlap_rows(route_ids, hashes)
        prompt_rows = len(route_ids)
        peer, remote_rows = gprefix.best_peer(self._peers(), m.name, hashes)
        gain = remote_rows - local_rows
        if peer is None or remote_rows <= 0:
            # only count no_peer when a remote chain could actually have
            # helped — a fully-local-cached prompt is a "local" decision
            if local_rows < prompt_rows - min_gain_rows(prompt_rows):
                return "no_peer", {}
            return "local", {}
        if gain < min_gain_rows(prompt_rows):
            return "local", {}
        rate = _prefill_rate(m.pool) if m.pool is not None else 0.0
        if rate > 0.0:
            fetch_s = gain * _bytes_per_row(engine) / (wire_gbps() * 1e9)
            recompute_s = gain / rate
            if fetch_s >= recompute_s:
                log.debug(
                    "%s: fleet pull rejected on cost (fetch %.4fs >= "
                    "recompute %.4fs for %d rows)",
                    m.name, fetch_s, recompute_s, gain,
                )
                return "local", {}
        P = int(engine.allocator.page_size)
        return "remote_pull", {
            "peer": peer["host"],
            "addr": peer["kvx_addr"],
            "hashes": hashes[: max(remote_rows // P, 1)],
            "rows": remote_rows,
            "local_rows": local_rows,
        }

    def pull_before_submit(self, m, route_ids: List[int]) -> str:
        """Run the fleet rung and, on a remote win, fetch the chain into
        the local host tier so the imminent local submit restores it.
        Returns the counted reason. All RPC happens here, outside every
        declared lock, before the pool ever sees the request."""
        from . import kvx

        reason, detail = self.decide_pull(m, route_ids)
        if reason == "remote_pull":
            store = m.engine.host_store
            got = kvx.fetch_chain(
                detail["addr"], m.name, detail["hashes"],
                peer=detail["peer"],
            ) if store is not None else []
            if not got:
                reason = "fallback_local"  # transfer failed; kvx counted why
            else:
                for h, entry in got:
                    store.put(h, entry)
                log.info(
                    "%s: pulled %d pages from %s (%d promised rows, "
                    "%d local)", m.name, len(got), detail["peer"],
                    detail["rows"], detail["local_rows"],
                )
        count_route(m.name, reason)
        return reason
