"""Fleet data plane: disaggregated prefill/decode across processes.

The fleet *telemetry* plane (obs/fleet.py) carries membership,
federation, trace stitching — role-aware signals ACROSS processes. This
package is the data plane that routes on them (the RTP-LLM lesson:
disaggregated serving stands or falls on cache-aware, failure-aware
cross-host scheduling):

  * :mod:`~aios_tpu_torch.fleet.kvx` — the KV transfer protocol: a gRPC
    service (``aios.fleet.KvTransfer``, aios_tpu/protos/fleet.proto)
    shipping HostPageStore entries between hosts keyed by the same
    sha256 chain hashes the prefix caches use, crc32-verified at BOTH
    ends, chunked and byte-budgeted. Push-on-prefill (the prefill host
    streams pages to its decode target) and pull-on-miss (a decode host
    fetches a chain the router promised).
  * :mod:`~aios_tpu_torch.fleet.gprefix` — the gossiped prefix index: each
    host piggybacks a bounded digest of its cached chain tails on the
    ``/fleet/announce`` heartbeat; peers score remote prefix
    overlap without any extra RPC.
  * :mod:`~aios_tpu_torch.fleet.router` — fleet-level routing: extends the
    pool's sticky -> overlap -> least-loaded ladder fleet-wide, with
    transfer-cost-aware tie-breaking (fetch the chain vs recompute it,
    priced off the devprof ledger).
  * :mod:`~aios_tpu_torch.fleet.disagg` — disaggregated roles
    (``AIOS_TPU_FLEET_ROLE=prefill|decode|mixed``): prefill hosts run
    admission + prefill then hand the stream to a decode host over the
    transfer plane, reusing failover's resume-from-emitted contract, so
    greedy streams stay token-identical across the handoff AND across a
    decode-host kill (the ``fleet.host_kill`` chaos point).

Every failure on this plane — unreachable peer, crc mismatch, decode
error, empty chain — degrades to LOCAL prefill, exactly like the host
tier's ``restore_fail`` path: slower, never wrong. docs/SERVING.md covers the
routing ladder; docs/RUNBOOK.md §10 the triage.
"""

from . import disagg, gprefix, kvx, router  # noqa: F401

__all__ = ["disagg", "gprefix", "kvx", "router"]
