"""Fleet telemetry plane: membership, federation, trace stitching.

The obs stack below this module (metrics / flightrec / slo / devprof) is
entirely per-process; the ROADMAP's multi-host fleet needs role-aware
health, load, and SLO signals ACROSS processes before any data plane can
route on them (the RTP-LLM lesson — disaggregated serving stands or
falls on this layer). This module is that plane, stdlib-only, riding the
existing obs/http.py endpoint every service already starts:

  * **membership** — each process announces itself to its peers with a
    heartbeat (POST ``/fleet/announce``) carrying host id, role, rank,
    the bound metrics port, per-pool replica/occupancy stats, the
    devprof capacity annotation, and the SLO burn summary. A member that
    stops heartbeating ages ``up -> suspect -> dead`` (the closed
    :data:`MEMBER_STATES` enum); every edge lands in the bounded
    transition journal, on ``aios_tpu_fleet_member_transitions_total``,
    and on the flight recorder's fleet lane. Peers come from
    ``AIOS_TPU_FLEET_PEERS``, are seeded from ``AIOS_TPU_COORDINATOR``,
    and gossip through announce responses (each response carries the
    responder's known peer list, so a chain of seeds converges to a
    full mesh).
  * **federation** — ``/metrics/fleet`` scrapes every live peer's
    ``/metrics`` text exposition and re-exposes the union with a
    ``host`` label injected into every sample; the SLO rollup (worst-
    burn host, per-objective fleet attainment) folds into /healthz via
    ``slo.annotate_health``.
  * **trace stitching** — ``/debug/trace/fleet?trace=<id>`` fetches the
    trace's timelines from each peer's flight recorder (the traceparent
    already crosses the gRPC boundary via the interceptors) and merges
    them into one Chrome-trace JSON with one lane group per host.
  * ``scripts/fleetctl.py`` renders the membership table off
    ``/fleet/members`` — the operator surface RUNBOOK §9 points at.

Locking: ``_lock`` (registry role "fleet") is pure bookkeeping — member
table, journal, peer set. Network I/O (announces, scrapes, stitches)
always runs OUTSIDE it; metric/recorder emission for state edges happens
after the lock is released (no fleet->recorder lock edge).
"""

from __future__ import annotations

import json
import logging
import os
import random
import socket
import threading
import time
import urllib.parse
import urllib.request
from typing import Callable, Dict, List, Optional, Tuple

from ..analysis.locks import make_lock
from .metrics import REGISTRY, MetricsRegistry

log = logging.getLogger("aios.fleet")

# Member lifecycle — THE closed enum (pinned by test_obs_lint): a member
# with a fresh heartbeat is "up", one past the suspect window is
# "suspect" (still scraped — a GC pause or a slow box must not instantly
# drop its series from the federation), one past the dead window is
# "dead" (dropped from /metrics/fleet and flagged by fleetctl). A dead
# member that announces again flips straight back to "up" — restarts are
# the common case, not an error.
MEMBER_STATES = ("up", "suspect", "dead")

# Transition journal bound: membership churn is slow (heartbeat-scale);
# 256 edges is hours of history and keeps /fleet/members bounded.
_MAX_JOURNAL = 256

# Announce/scrape bodies are bounded reads: a confused peer must not be
# able to balloon the registry.
_MAX_BODY_BYTES = 4 << 20

# Worst-burn tenants per heartbeat: the announce payload must stay
# small under tenant churn; fleetctl top merges each host's worst few.
_MAX_SLO_TENANTS = 4


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class FleetConfig:
    """Knobs (docs/CONFIG.md "Fleet telemetry" section). Read live from
    the environment at construction so tests and deploy scripts can
    reconfigure per process."""

    def __init__(self) -> None:
        self.enabled = os.environ.get(
            "AIOS_TPU_FLEET", ""
        ).lower() in ("1", "true", "on")
        self.peers = tuple(
            p.strip()
            for p in os.environ.get("AIOS_TPU_FLEET_PEERS", "").split(",")
            if p.strip()
        )
        self.interval_secs = _env_float("AIOS_TPU_FLEET_INTERVAL_SECS", 2.0)
        # suspect/dead windows are absolute seconds since the last
        # heartbeat, not interval multiples — an operator tuning the
        # announce cadence must not silently retune failure detection
        self.suspect_secs = _env_float("AIOS_TPU_FLEET_SUSPECT_SECS", 6.0)
        self.dead_secs = _env_float("AIOS_TPU_FLEET_DEAD_SECS", 15.0)
        self.seed_port = int(_env_float("AIOS_TPU_FLEET_SEED_PORT", 9100))
        self.scrape_timeout = _env_float("AIOS_TPU_FLEET_SCRAPE_TIMEOUT", 2.0)

    def active(self) -> bool:
        return self.enabled or bool(self.peers)

    def seed_peers(self) -> Tuple[str, ...]:
        """AIOS_TPU_FLEET_PEERS — one seed is enough, announce-response
        gossip converges the rest. The port has no multihost env
        contract, so no coordinator seeds the peers."""
        return self.peers


def process_identity(role: str = "") -> Dict[str, str]:
    """The per-process identity stamped on every heartbeat, on the
    ``aios_tpu_process_info`` gauge, and on every bench.py JSON line:
    host id (AIOS_TPU_FLEET_HOST, else hostname:pid — unique when many
    processes share one box in tests), role (AIOS_TPU_FLEET_ROLE, else
    the service name passed in), rank 0 (the port has no multihost env
    contract: one process per rank), and the package version."""
    from .. import __version__

    return {
        "host": os.environ.get("AIOS_TPU_FLEET_HOST", "")
        or f"{socket.gethostname()}:{os.getpid()}",
        "role": os.environ.get("AIOS_TPU_FLEET_ROLE", "") or role or "service",
        "rank": "0",
        "version": __version__,
    }


def stamp_process_info(role: str = "") -> Dict[str, str]:
    """Set the ``aios_tpu_process_info`` info-gauge (value 1, identity
    in labels — the Prometheus *_info convention) and return the
    identity dict."""
    from . import instruments

    ident = process_identity(role)
    instruments.PROCESS_INFO.labels(**ident).set(1.0)
    return ident


def default_target() -> str:
    """fleetctl's default endpoint (AIOS_TPU_FLEET_TARGET, host:port of
    any member's metrics endpoint)."""
    return os.environ.get("AIOS_TPU_FLEET_TARGET", "127.0.0.1:9100")


# -- heartbeat payload helpers ----------------------------------------------

# pool-stats providers: serving/runtime layers register callables
# returning {model: {stat: scalar}}; consumed at each heartbeat build.
# Module-level so providers can register before (or without) a registry.
_stats_providers: List[Callable[[], Dict[str, dict]]] = []


def add_stats_provider(fn: Callable[[], Dict[str, dict]]) -> None:
    """Register a per-model pool-stats source for heartbeat payloads
    (e.g. the runtime service's ReplicaPool.heartbeat_stats view)."""
    _stats_providers.append(fn)


def clear_stats_providers() -> None:
    """Test isolation."""
    _stats_providers.clear()


def _self_pools() -> Dict[str, dict]:
    pools: Dict[str, dict] = {}
    for fn in list(_stats_providers):
        try:
            pools.update(fn())
        except Exception as exc:  # noqa: BLE001 - a sick pool must not
            # stop the heartbeat; the failure is the payload
            pools.setdefault("_error", {})["provider"] = repr(exc)[:120]
    return pools


# gossiped prefix digest providers (aios_tpu_torch/fleet/gprefix.py): callables
# returning {model: {"page": page_size, "tails": {hex16: blocks}}},
# consumed at each heartbeat build — same registration pattern as the
# pool-stats providers.
_digest_providers: List[Callable[[], Dict[str, dict]]] = []

# this process's KvTransfer endpoint (host:port), piggybacked on the
# heartbeat so peers know where to Fetch/Push/Handoff; "" = no data plane
_transfer_addr = ""


def add_digest_provider(fn: Callable[[], Dict[str, dict]]) -> None:
    """Register a per-model prefix-digest source for heartbeat payloads
    (the fleet data plane's gossiped prefix index)."""
    _digest_providers.append(fn)


def clear_digest_providers() -> None:
    """Test isolation."""
    _digest_providers.clear()


def set_transfer_addr(addr: str) -> None:
    """Publish this process's KvTransfer gRPC endpoint on the heartbeat
    (the runtime service calls this with its ACTUAL bound port)."""
    global _transfer_addr
    _transfer_addr = addr


def _self_gprefix() -> Dict[str, dict]:
    digest: Dict[str, dict] = {}
    for fn in list(_digest_providers):
        try:
            digest.update(fn())
        except Exception as exc:  # noqa: BLE001 - a sick engine must not
            # stop the heartbeat; the failure is the payload
            digest.setdefault("_error", {})["provider"] = repr(exc)[:120]
    return digest


def _self_slo() -> dict:
    """Compact SLO summary for the heartbeat: worst burn across models
    and objectives (None while no window is evaluable), per-model
    per-objective attainment, and the worst few tenants by TTFT burn
    (bounded — the heartbeat stays announce-sized; fleetctl top ranks
    the fleet-wide union)."""
    from . import slo as slomod

    worst: Optional[float] = None
    models: Dict[str, dict] = {}
    tenants: Dict[str, float] = {}  # "model/tenant" -> TTFT burn
    target = slomod.ENGINE.cfg.target
    for m in slomod.ENGINE.models():
        ev = slomod.ENGINE.evaluate(m)
        att = {}
        for o, v in ev.items():
            att[o] = v.get("attainment", 1.0)
            if v.get("samples", 0) >= slomod.ENGINE.cfg.min_samples:
                b = v.get("burn_rate", 0.0)
                worst = b if worst is None else max(worst, b)
        models[m] = att
        for ten, row in slomod.ENGINE.tenants(m).items():
            if row.get("samples", 0) < slomod.ENGINE.cfg.min_samples:
                continue
            burn = (1.0 - row.get("ttft_attainment", 1.0)) \
                / max(1.0 - target, 1e-9)
            tenants[f"{m}/{ten}"] = round(burn, 4)
    out: dict = {"worst_burn": worst, "attainment": models}
    if tenants:
        out["tenants"] = dict(sorted(
            tenants.items(), key=lambda kv: -kv[1]
        )[:_MAX_SLO_TENANTS])
    return out


def _self_capacity() -> dict:
    """Devprof capacity annotation: per-model device-seconds and best
    observed MFU across graph kinds (empty until devprof is armed)."""
    from . import devprof

    out: Dict[str, dict] = {}
    try:
        snap = devprof.snapshot_all()
    except Exception:  # noqa: BLE001 - devprof absence is data, log it
        log.debug("devprof snapshot unavailable for heartbeat", exc_info=True)
        return out
    for model, ledgers in snap.get("models", {}).items():
        secs, mfu = 0.0, None
        for led in ledgers:
            for g in led.get("graphs", {}).values():
                secs += g.get("device_seconds", 0.0)
                if "mfu" in g:
                    mfu = max(mfu or 0.0, g["mfu"])
        entry: dict = {"device_seconds": round(secs, 4)}
        if mfu is not None:
            entry["mfu"] = mfu
        out[model] = entry
    return out


def _http_json(url: str, payload: Optional[dict] = None,
               timeout: float = 2.0) -> dict:
    # the fleet's HTTP injection choke point (faults/net.py): announce,
    # stitch, and drain traffic all pass here — check_send models the
    # outbound edge, check_drop_response the severed reply
    from ..faults import net

    net.check_send(url, "http")
    data = json.dumps(payload).encode("utf-8") if payload is not None else None
    req = urllib.request.Request(
        url, data=data,
        headers={"Content-Type": "application/json"} if data else {},
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        body = json.loads(r.read(_MAX_BODY_BYTES).decode("utf-8"))
    net.check_drop_response(url, "http")
    return body


def _http_text(url: str, timeout: float = 2.0) -> str:
    from ..faults import net

    net.check_send(url, "http")
    with urllib.request.urlopen(url, timeout=timeout) as r:
        body = r.read(_MAX_BODY_BYTES).decode("utf-8")
    net.check_drop_response(url, "http")
    return body


# -- exposition relabeling ---------------------------------------------------

def relabel_exposition(text: str, host: str) -> List[tuple]:
    """Parse one Prometheus text exposition and inject ``host`` into
    every sample -> [(family, help, type, [sample lines])]. Samples
    attach to the most recent # HELP/# TYPE family when their name
    extends it (histogram _bucket/_sum/_count), else to their own name —
    federation must keep each family's samples contiguous."""
    fams: Dict[str, dict] = {}
    order: List[str] = []

    def fam(name: str) -> dict:
        f = fams.get(name)
        if f is None:
            f = fams[name] = {"help": "", "type": "", "samples": []}
            order.append(name)
        return f

    current = ""
    for line in text.splitlines():
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            parts = line.split(" ", 3)
            if len(parts) < 4:
                continue
            current = parts[2]
            fam(current)[parts[1].lower()] = parts[3]
            continue
        if not line or line.startswith("#"):
            continue
        brace = line.find("{")
        space = line.find(" ")
        if brace >= 0 and (space < 0 or brace < space):
            end = brace
        else:
            end = space
        if end <= 0:
            continue
        name = line[:end]
        rest = line[end:]
        if brace == end:
            # name{labels} value — host goes first; a sample already
            # carrying a host label (nested federation) passes through
            close = rest.rfind("}")
            labels = rest[1:close]
            value = rest[close + 1:]
            if 'host="' in labels:
                sample = line
            else:
                sep = "," if labels else ""
                sample = (f'{name}{{host="{host}"{sep}{labels}}}{value}')
        else:
            sample = f'{name}{{host="{host}"}}{rest}'
        owner = current if current and name.startswith(current) else name
        fam(owner)["samples"].append(sample)
    return [(n, fams[n]["help"], fams[n]["type"], fams[n]["samples"])
            for n in order]


def merge_expositions(sources: List[Tuple[str, str]]) -> str:
    """[(host, exposition text)] -> one union exposition with the host
    label injected, families contiguous across hosts, first HELP/TYPE
    text winning."""
    fams: Dict[str, dict] = {}
    order: List[str] = []
    for host, text in sources:
        for name, help_, type_, samples in relabel_exposition(text, host):
            f = fams.get(name)
            if f is None:
                f = fams[name] = {"help": help_, "type": type_, "samples": []}
                order.append(name)
            else:
                f["help"] = f["help"] or help_
                f["type"] = f["type"] or type_
            f["samples"].extend(samples)
    lines: List[str] = []
    for name in order:
        f = fams[name]
        if not f["samples"]:
            continue
        if f["help"]:
            lines.append(f"# HELP {name} {f['help']}")
        if f["type"]:
            lines.append(f"# TYPE {name} {f['type']}")
        lines.extend(f["samples"])
    return "\n".join(lines) + ("\n" if lines else "")


# -- trace stitching ---------------------------------------------------------

# pid stride between host lane groups in the stitched Chrome trace: each
# host's sub-trace keeps its own model-pid numbering inside its block
_PID_STRIDE = 100


def stitch_chrome_traces(host_timelines: Dict[str, list]) -> dict:
    """{host: [timeline dicts]} -> one Chrome-trace JSON with per-host
    lane groups: each host renders through the SAME flightrec renderer
    (snapshot/live parity), then its pids shift into a host-indexed
    block and its process names gain the host prefix — orchestrator,
    runtime, and engine lanes from different processes line up on one
    wall-clock axis."""
    from . import flightrec

    events: List[dict] = []
    for i, host in enumerate(sorted(host_timelines)):
        sub = flightrec.chrome_trace(host_timelines[host])
        offset = i * _PID_STRIDE
        for ev in sub["traceEvents"]:
            ev = dict(ev)
            ev["pid"] = ev.get("pid", 0) + offset
            if ev.get("name") == "process_name":
                args = dict(ev.get("args", {}))
                args["name"] = f"host:{host} {args.get('name', '')}".strip()
                ev["args"] = args
            events.append(ev)
    events.sort(key=lambda e: e.get("ts", 0))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# -- the registry ------------------------------------------------------------

class FleetRegistry:
    """One process's view of the fleet: the member table, the heartbeat
    loop, the failure-detector tick, and the federation/stitch fetches.
    ``clock`` is injectable for deterministic state-machine tests."""

    def __init__(self, identity: Dict[str, str], metrics_addr: str,
                 cfg: Optional[FleetConfig] = None,
                 registry: Optional[MetricsRegistry] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.identity = dict(identity)
        self.metrics_addr = metrics_addr
        self.cfg = cfg or FleetConfig()
        self.registry = registry or REGISTRY
        self.clock = clock
        self._lock = make_lock("fleet")
        self._members: Dict[Tuple[str, str], dict] = {}  #: guarded_by _lock
        self._journal: List[dict] = []  #: guarded_by _lock
        self._peer_addrs: List[str] = []  #: guarded_by _lock
        self._seq = 0  #: guarded_by _lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._register_member_metrics(identity["host"], identity["role"])
        self.self_descriptor()  # seeds the member table with self
        for addr in self.cfg.seed_peers():
            self._add_peer(addr)

    # -- metrics registration -------------------------------------------------

    def _register_member_metrics(self, host: str, role: str) -> None:
        """Pre-register every (host, role, state) transition child by
        iterating the closed MEMBER_STATES enum (the autoscale/SLO
        registration pattern): a new state is a reviewed enum change,
        never a stray label value."""
        from . import instruments

        instruments.FLEET_MEMBER_UP.labels(host=host, role=role)
        for state in MEMBER_STATES:
            instruments.FLEET_TRANSITIONS.labels(
                host=host, role=role, state=state
            )
        instruments.FLEET_SCRAPE_FAILURES.labels(host=host, role=role)

    # -- self descriptor ------------------------------------------------------

    def self_descriptor(self) -> dict:
        """The heartbeat payload: identity + bound metrics endpoint +
        pool stats + prefix digest + devprof capacity + SLO burn. Built
        OUTSIDE the fleet lock (providers may take pool/slo/engine
        locks)."""
        with self._lock:
            self._seq += 1
            seq = self._seq
        from ..fleet import drain

        desc = {
            **self.identity,
            "metrics_addr": self.metrics_addr,
            "kvx_addr": _transfer_addr,
            "pid": os.getpid(),
            "seq": seq,
            "pools": _self_pools(),
            "gprefix": _self_gprefix(),
            "capacity": _self_capacity(),
            "slo": _self_slo(),
            # the drain ladder phase (fleet/drain.py DRAIN_PHASES):
            # peers stop routing to a non-"serving" host before it dies
            "phase": drain.phase(),
        }
        # Every freshly built descriptor also refreshes OUR stored
        # member row. Before this, self's desc was folded in only at
        # construction, so /fleet/members reported the degrade-ladder
        # rung (and every other live pool stat) as of boot — a
        # controller mid-walk between ticks was invisible to fleetctl.
        self._apply_edges(self._observe(desc))
        return desc

    # -- membership state machine --------------------------------------------

    def _key(self, desc: dict) -> Optional[Tuple[str, str]]:
        host, role = desc.get("host"), desc.get("role")
        if not host or not role:
            return None
        return (str(host), str(role))

    def _observe(self, desc: dict) -> List[tuple]:
        """Fold one announce into the member table -> state edges to
        emit. Registers metric children for first-seen members."""
        key = self._key(desc)
        if key is None:
            return []
        now = self.clock()
        edges: List[tuple] = []
        with self._lock:
            m = self._members.get(key)
            if m is None:
                m = self._members[key] = {"state": "", "first_seen": now}
            m["desc"] = desc
            m["last_seen"] = now
            if m["state"] != "up":
                edges.append((key[0], key[1], m["state"], "up"))
                m["state"] = "up"
                self._journal_append(key[0], key[1], edges[-1][2], "up")
        if edges:
            self._register_member_metrics(*key)
        addr = desc.get("metrics_addr")
        if addr and addr != self.metrics_addr:
            self._add_peer(addr)
        # feed the fault layer's edge namer: every descriptor teaches it
        # which fleet host owns which address (outside the fleet lock)
        from ..faults import net

        for k in ("metrics_addr", "kvx_addr"):
            net.map_addr(desc.get(k) or "", key[0])
        return edges

    def receive(self, desc: dict) -> dict:
        """Server side of /fleet/announce: fold the peer's descriptor
        in, answer with OUR descriptor plus the peer addresses we know
        (the gossip that converges seeded membership to a mesh)."""
        reply = self.self_descriptor()
        self._apply_edges(self._observe(desc))
        with self._lock:
            peers = list(self._peer_addrs)
        return {"member": reply, "peers": peers}

    def tick(self, now: Optional[float] = None) -> List[tuple]:
        """Failure detector: age every non-self member through
        up -> suspect -> dead off its last heartbeat. Returns the edges
        (also emitted on metrics/recorder) — tests assert on them."""
        t = self.clock() if now is None else now
        self_key = (self.identity["host"], self.identity["role"])
        edges: List[tuple] = []
        with self._lock:
            for key, m in self._members.items():
                if key == self_key or not m["state"]:
                    continue
                age = t - m["last_seen"]
                if age > self.cfg.dead_secs:
                    want = "dead"
                elif age > self.cfg.suspect_secs:
                    want = "suspect"
                else:
                    want = "up"
                # the detector only ever worsens a state; recovery is an
                # announce (fresh evidence), never the mere passing of time
                if (MEMBER_STATES.index(want)
                        > MEMBER_STATES.index(m["state"])):
                    edges.append((key[0], key[1], m["state"], want))
                    self._journal_append(key[0], key[1], m["state"], want)
                    m["state"] = want
        self._apply_edges(edges)
        return edges

    def _journal_append(self, host: str, role: str, frm: str,
                        to: str) -> None:
        # caller holds _lock
        self._journal.append({
            "host": host, "role": role, "from": frm, "to": to,
            "at": time.time(),
        })
        if len(self._journal) > _MAX_JOURNAL:
            del self._journal[:-_MAX_JOURNAL]

    def _apply_edges(self, edges: List[tuple]) -> None:
        """Emit metric + flight-recorder evidence for state edges —
        outside the fleet lock (no fleet->recorder/metrics lock edge)."""
        from . import flightrec, instruments

        for host, role, frm, to in edges:
            instruments.FLEET_MEMBER_UP.labels(host=host, role=role).set(
                1.0 if to == "up" else 0.0
            )
            instruments.FLEET_TRANSITIONS.labels(
                host=host, role=role, state=to
            ).inc()
            flightrec.RECORDER.model_event(
                "fleet", "fleet_member", host=host, role=role,
                frm=frm or "new", to=to,
            )
            log.info("fleet member %s/%s: %s -> %s", host, role,
                     frm or "new", to)

    def _add_peer(self, addr: str) -> None:
        added = False
        with self._lock:
            if addr not in self._peer_addrs and addr != self.metrics_addr:
                self._peer_addrs.append(addr)
                added = True
        if added:
            # pre-register the announce-failure child so the family
            # renders 0 for a healthy peer (absence-vs-zero discipline);
            # OUTSIDE the fleet lock — registration takes registry locks
            from . import instruments

            instruments.FLEET_ANNOUNCE_FAILURES.labels(peer=addr)

    # -- surfaces -------------------------------------------------------------

    def members(self) -> List[dict]:
        """Membership table rows (JSON-shaped; /fleet/members and
        fleetctl render this)."""
        now = self.clock()
        with self._lock:
            rows = [
                {
                    "host": key[0], "role": key[1], "state": m["state"],
                    "age_secs": round(now - m["last_seen"], 3),
                    "self": key == (self.identity["host"],
                                    self.identity["role"]),
                    **{
                        k: m.get("desc", {}).get(k)
                        for k in ("rank", "version", "metrics_addr",
                                  "kvx_addr", "pid", "seq", "pools",
                                  "gprefix", "capacity", "slo", "phase")
                    },
                }
                for key, m in sorted(self._members.items())
            ]
        # the quarantine overlay (fleet/breaker.py) — computed OUTSIDE
        # the fleet lock (no fleet->quarantine lock edge); orthogonal to
        # "state": a host can be "up" by heartbeat and still gray
        from ..fleet import breaker

        for r in rows:
            r["quarantined"] = (
                not r["self"] and breaker.BOARD.quarantined(r["host"])
            )
        return rows

    def journal(self) -> List[dict]:
        with self._lock:
            return list(self._journal)

    def health_summary(self) -> dict:
        """The /healthz fleet section: member counts by state + SLO
        rollup (worst-burn host, per-objective fleet attainment = the
        minimum any member reports)."""
        rows = self.members()
        counts = {s: 0 for s in MEMBER_STATES}
        worst: Optional[dict] = None
        attain: Dict[str, float] = {}
        for r in rows:
            if r["state"] in counts:
                counts[r["state"]] += 1
            slo = r.get("slo") or {}
            burn = slo.get("worst_burn")
            if burn is not None and (worst is None or burn > worst["burn"]):
                worst = {"host": r["host"], "burn": burn}
            for model_att in (slo.get("attainment") or {}).values():
                for obj, v in model_att.items():
                    attain[obj] = min(attain.get(obj, 1.0), v)
        out: dict = {"size": len(rows), **counts}
        if worst is not None:
            out["worst_burn"] = worst
        if attain:
            out["attainment"] = {k: round(v, 6)
                                 for k, v in sorted(attain.items())}
        return out

    # -- federation -----------------------------------------------------------

    def _scrape_targets(self) -> List[Tuple[str, str, str]]:
        """(host, role, metrics_addr) for every non-dead member with a
        known endpoint, self excluded (rendered locally)."""
        self_key = (self.identity["host"], self.identity["role"])
        with self._lock:
            return [
                (key[0], key[1], m["desc"]["metrics_addr"])
                for key, m in sorted(self._members.items())
                if key != self_key and m["state"] != "dead"
                and m.get("desc", {}).get("metrics_addr")
            ]

    def federate(self) -> str:
        """The /metrics/fleet body: our own registry plus every live
        peer's /metrics, host label injected. A failing scrape drops
        the host from this response and counts on
        aios_tpu_fleet_scrape_failures_total — absence IS the signal."""
        from ..fleet import breaker
        from . import instruments

        sources = [(self.identity["host"], self.registry.render())]
        for host, role, addr in self._scrape_targets():
            # scrapes double as the quarantine's half-open probes: an
            # open breaker skips the scrape (absence IS the signal), a
            # half-open one spends a probe slot on the real fetch — an
            # idle fleet heals through its own federation loop
            if not breaker.BOARD.allow(host):
                continue
            t0 = self.clock()
            try:
                sources.append((host, _http_text(
                    f"http://{addr}/metrics",
                    timeout=self.cfg.scrape_timeout,
                )))
                breaker.BOARD.record_ok(host, self.clock() - t0)
            except Exception as exc:  # noqa: BLE001 - a dead scrape is
                # evidence, not an error; the counter records it
                breaker.BOARD.record_failure(host, "unavailable")
                instruments.FLEET_SCRAPE_FAILURES.labels(
                    host=host, role=role
                ).inc()
                log.debug("fleet scrape of %s (%s) failed: %r",
                          host, addr, exc)
        return merge_expositions(sources)

    def federate_tsdb(self, query: Dict[str, List[str]]) -> dict:
        """The /debug/tsdb/fleet body: every live member answers the
        SAME parsed query against its own ring, keyed by host and
        annotated with role (the federate() discipline — breaker-gated
        scrapes, a failing host is an absent key plus a scrape-failure
        count, never a lost response)."""
        from ..fleet import breaker
        from . import instruments, tsdb as tsdb_mod

        local, _ = tsdb_mod.handle_query(query)
        hosts: Dict[str, dict] = {
            self.identity["host"]: dict(
                local, role=self.identity["role"]
            ),
        }
        qs = urllib.parse.urlencode(query, doseq=True)
        for host, role, addr in self._scrape_targets():
            if not breaker.BOARD.allow(host):
                continue
            t0 = self.clock()
            try:
                got = _http_json(
                    f"http://{addr}/debug/tsdb" + (f"?{qs}" if qs else ""),
                    timeout=self.cfg.scrape_timeout,
                )
                breaker.BOARD.record_ok(host, self.clock() - t0)
            except Exception as exc:  # noqa: BLE001 - an absent host IS
                # the signal; the counter records the failed range read
                breaker.BOARD.record_failure(host, "unavailable")
                instruments.FLEET_SCRAPE_FAILURES.labels(
                    host=host, role=role
                ).inc()
                log.debug("fleet tsdb fetch from %s failed: %r", host, exc)
                continue
            hosts[host] = dict(got, role=role)
        return {"hosts": hosts}

    # -- trace stitching ------------------------------------------------------

    def stitch(self, trace_id: str, limit: int = 64) -> dict:
        """One Chrome trace for ``trace_id`` across the fleet: local
        recorder timelines plus each live peer's, one lane group per
        host."""
        from . import flightrec

        host_tls: Dict[str, list] = {}
        local = [
            t.to_dict()
            for t in flightrec.RECORDER.recent(limit=limit * 4)
            if t.trace_id == trace_id
        ]
        if local:
            host_tls[self.identity["host"]] = local[:limit]
        from ..fleet import breaker

        for host, role, addr in self._scrape_targets():
            if not breaker.BOARD.allow(host):
                continue
            t0 = self.clock()
            try:
                got = _http_json(
                    f"http://{addr}/debug/requests?trace={trace_id}"
                    f"&limit={limit}",
                    timeout=self.cfg.scrape_timeout,
                )
                breaker.BOARD.record_ok(host, self.clock() - t0)
            except Exception as exc:  # noqa: BLE001 - a peer missing from
                # the stitch is visible as a missing lane; count it
                from . import instruments

                breaker.BOARD.record_failure(host, "unavailable")
                instruments.FLEET_SCRAPE_FAILURES.labels(
                    host=host, role=role
                ).inc()
                log.debug("fleet stitch fetch from %s failed: %r", host, exc)
                continue
            tls = got.get("requests", [])
            if tls:
                host_tls[host] = tls
        return stitch_chrome_traces(host_tls)

    # -- heartbeat loop -------------------------------------------------------

    def announce_once(self) -> None:
        """One announce round: POST our descriptor to every known peer,
        fold each response's member + gossip in, then run the failure
        detector. All network I/O outside the lock."""
        desc = self.self_descriptor()
        with self._lock:
            targets = list(self._peer_addrs)
        from . import instruments

        for addr in targets:
            try:
                reply = _http_json(
                    f"http://{addr}/fleet/announce", payload=desc,
                    timeout=self.cfg.scrape_timeout,
                )
            except Exception as exc:  # noqa: BLE001 - unreachable peers
                # age out through the state machine; the counter makes a
                # silently-failing edge visible BEFORE suspect/dead does
                instruments.FLEET_ANNOUNCE_FAILURES.labels(peer=addr).inc()
                log.debug("fleet announce to %s failed: %r", addr, exc)
                continue
            member = reply.get("member")
            if isinstance(member, dict):
                self._apply_edges(self._observe(member))
            for peer in reply.get("peers", ()):
                if isinstance(peer, str) and peer:
                    self._add_peer(peer)
        self.tick()

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="fleet-heartbeat", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        # seeded per-host jitter: N workers booted by one supervisor
        # would otherwise announce in lockstep forever, synchronizing
        # their scrape bursts; +/-25% desynchronizes them while staying
        # deterministic per host (no global-RNG draw on the hot loop)
        rng = random.Random(f"announce:{self.identity['host']}")
        while not self._stop.is_set():
            try:
                self.announce_once()
            except Exception:  # noqa: BLE001 - the heartbeat must outlive
                # any single bad round; the log carries the evidence
                log.exception("fleet heartbeat round failed")
            self._stop.wait(
                self.cfg.interval_secs * (0.75 + 0.5 * rng.random())
            )

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None


# -- process-wide instance ---------------------------------------------------

# The one registry obs/http.py routes and slo.annotate_health read;
# None until maybe_start() arms it (single-process deployments never do).
FLEET: Optional[FleetRegistry] = None


def maybe_start(service_name: str, bound_port: int,
                host: str = "127.0.0.1") -> Optional[FleetRegistry]:
    """Arm the fleet plane for this process when configured
    (AIOS_TPU_FLEET=1 or AIOS_TPU_FLEET_PEERS non-empty) — called by
    maybe_start_metrics_server with the service name and the ACTUAL
    bound port, so ephemeral-port processes announce a reachable
    endpoint. Idempotent; always stamps aios_tpu_process_info."""
    global FLEET
    ident = stamp_process_info(service_name)
    cfg = FleetConfig()
    if FLEET is not None or not cfg.active():
        return FLEET
    reach = "127.0.0.1" if host in ("", "0.0.0.0", "::") else host
    FLEET = FleetRegistry(ident, f"{reach}:{bound_port}", cfg=cfg)
    FLEET.start()
    log.info(
        "fleet telemetry armed: host=%s role=%s metrics_addr=%s peers=%s",
        ident["host"], ident["role"], FLEET.metrics_addr,
        ",".join(cfg.seed_peers()) or "(none yet)",
    )
    return FLEET


def install(reg: Optional[FleetRegistry]) -> Optional[FleetRegistry]:
    """Swap the process-wide registry (tests); returns the previous."""
    global FLEET
    prev, FLEET = FLEET, reg
    return prev
