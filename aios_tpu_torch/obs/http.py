"""Stdlib /metrics + /healthz + /debug endpoint for every service.

Each service's ``serve()`` can start one next to its gRPC port — either
by passing ``metrics_port`` explicitly or via the per-service env var
``AIOS_<SERVICE>_METRICS_PORT`` (0 = ephemeral port, useful in tests);
``AIOS_METRICS_HOST`` widens the bind beyond the 127.0.0.1 default for
external scrapers.

Routes:
  * ``/metrics``   — Prometheus text exposition of the process registry;
  * ``/livez``     — pure liveness: always 200 while the process
    answers (point restart-on-failure probes here);
  * ``/healthz``   — JSON readiness/health probe (service-supplied
    ``health_fn`` merged in; the runtime's health_fn folds the SLO view
    in via ``slo.annotate_health``). Returns **503** whenever the
    payload's status is not ``ok`` — a degraded service or an SLO
    breach takes the replica out of LB rotation, without the process
    kill a liveness probe would cause;
  * ``/metrics/fleet`` — federation: the union of every live fleet
    member's /metrics with a ``host`` label injected (404 until
    obs/fleet.py is armed);
  * ``/fleet/members`` — the fleet membership table + transition
    journal (JSON; what fleetctl renders);
  * ``/fleet/announce`` — POST: one member's heartbeat descriptor in,
    ours + known peers back (the membership gossip hop);
  * ``/fleet/drain`` — POST: start this host's graceful drain
    (fleet/drain.py; 202 + current phase, ``?timeout=S`` bounds the
    in-flight wait; ``fleetctl drain`` drives it);
  * ``/debug/requests``  — recent flight-recorder timelines (JSON;
    ``?model=&limit=&events=0&trace=<id>``);
  * ``/debug/trace``     — the same timelines as Chrome trace-event /
    Perfetto JSON (``?model=&limit=``, or ``?snapshot=<id>`` to render a
    frozen anomaly snapshot);
  * ``/debug/trace/fleet`` — one trace id stitched ACROSS the fleet:
    matching timelines fetched from every live peer's recorder, merged
    into per-host Chrome-trace lanes (``?trace=<id>``);
  * ``/debug/spans``     — the finished-span ring (``?name=&limit=``);
  * ``/debug/slo``       — per-model objective evaluation + per-tenant
    breakdown;
  * ``/debug/snapshots`` — frozen anomaly snapshots (``?id=`` for one,
    metadata list otherwise);
  * ``/debug/devprof``   — the device-time attribution ledgers (per
    model/graph dispatches, device-seconds, MFU/HBM utilization) +
    capture status (``?model=``);
  * ``/debug/profile``   — start a bounded on-demand ``torch.profiler``
    capture (``?secs=N``, capped, one at a time → 409 while busy,
    403 unless ``AIOS_TPU_DEVPROF_DUMP_DIR`` is set);
  * ``/debug/tsdb``      — the black-box time-series ring
    (``?name=&verb=&window=&match=k:v``; stats when no name; 404
    until ``AIOS_TPU_TSDB`` arms obs/tsdb.py);
  * ``/debug/tsdb/fleet`` — the same query answered by every live
    fleet member, keyed by host (404 until fleet is armed);
  * ``/debug/incidents`` — frozen incident bundles (``?id=`` for one
    full bundle, metadata list otherwise; 404 until obs/incidents.py
    is armed);
  * ``/debug``           — the machine-readable route index: every row
    of :data:`ROUTES` (tests pin the table complete).
"""

from __future__ import annotations

import json
import logging
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from .metrics import REGISTRY, MetricsRegistry

log = logging.getLogger("aios.obs")

# THE route index — every path the handler serves, one (method, route,
# one-line help) row per route. ``GET /debug`` renders this table, and
# tests/test_obs_lint.py pins it complete against the handler source: a
# new route without its row here fails CI, so the index can never rot
# into a partial map of the endpoint.
ROUTES = (
    ("GET", "/metrics",
     "Prometheus text exposition of the process registry"),
    ("GET", "/metrics/fleet",
     "federation: every live member's /metrics with a host label"),
    ("GET", "/livez",
     "pure liveness: 200 while the process answers"),
    ("GET", "/healthz",
     "JSON readiness probe; 503 when degraded or SLO-breached"),
    ("GET", "/fleet/members",
     "fleet membership table + transition journal"),
    ("POST", "/fleet/announce",
     "one member's heartbeat descriptor in, ours + known peers back"),
    ("POST", "/fleet/drain",
     "start this host's graceful drain (202 + phase, ?timeout=S)"),
    ("GET", "/debug",
     "this route index"),
    ("GET", "/debug/requests",
     "recent flight-recorder timelines (?model=&limit=&trace=)"),
    ("GET", "/debug/trace",
     "timelines as Chrome-trace JSON (?model=&limit=&snapshot=)"),
    ("GET", "/debug/trace/fleet",
     "one trace id stitched across the fleet (?trace=<id>)"),
    ("GET", "/debug/spans",
     "the finished-span ring (?name=&limit=)"),
    ("GET", "/debug/slo",
     "per-model objective evaluation + per-tenant breakdown"),
    ("GET", "/debug/snapshots",
     "frozen anomaly snapshots (?id= for one, metadata otherwise)"),
    ("GET", "/debug/devprof",
     "device-time attribution ledgers + capture status (?model=)"),
    ("GET", "/debug/profile",
     "bounded on-demand profiler capture (?secs=N; 403/409 gated)"),
    ("GET", "/debug/tsdb",
     "time-series query (?name=&verb=&window=&match=k:v; stats bare)"),
    ("GET", "/debug/tsdb/fleet",
     "the same tsdb query answered by every live member, per host"),
    ("GET", "/debug/incidents",
     "frozen incident bundles (?id= for one, metadata otherwise)"),
)


def _debug_response(
    path: str, query: dict,
) -> Optional[Tuple[bytes, str, int]]:
    """Render one /debug/* route -> (body, content_type, status), or
    None for an unknown path. flightrec/slo/devprof import at call time
    because the obs package __init__ imports THIS module before them
    (they are package-level imports everywhere else — every process
    importing aios_tpu_torch.obs has them loaded)."""
    from . import devprof, fleet, flightrec, incidents, slo, tracing
    from . import tsdb as tsdb_mod

    def q(name: str, default: str = "") -> str:
        return query.get(name, [default])[0]

    def qint(name: str, default: int) -> int:
        try:
            return int(q(name, str(default)))
        except ValueError:
            return default

    status = 200
    if path == "/debug":
        # the machine-readable index — one row per served route, straight
        # from the ROUTES table the handler itself is pinned against
        body = json.dumps({
            "routes": [
                {"method": m, "route": r, "help": h} for m, r, h in ROUTES
            ],
        })
    elif path == "/debug/tsdb/fleet":
        if fleet.FLEET is None:
            body = json.dumps({"error": "fleet telemetry not armed"})
            status = 404
        else:
            body = json.dumps(fleet.FLEET.federate_tsdb(query))
    elif path == "/debug/tsdb":
        payload, status = tsdb_mod.handle_query(query)
        body = json.dumps(payload)
    elif path == "/debug/incidents":
        if incidents.STORE is None:
            body = json.dumps({
                "error": "incident store not armed "
                         "(set AIOS_TPU_INCIDENTS=1 or AIOS_TPU_TSDB=1)",
            })
            status = 404
        else:
            incs = incidents.STORE.incidents()
            inc_id = qint("id", 0)
            if inc_id:
                match = [b for b in incs if b["id"] == inc_id]
                if match:
                    body = json.dumps(match[0])
                else:
                    body = json.dumps({"error": "no such incident"})
                    status = 404
            else:
                body = json.dumps({
                    "incidents": [
                        {k: b[k] for k in
                         ("id", "model", "cause", "at", "fields")}
                        | {"tsdb_series": len(b["tsdb"]["series"]),
                           "snapshot_id":
                               b["flightrec"].get("snapshot_id")}
                        for b in incs
                    ],
                })
    elif path == "/debug/requests":
        trace = q("trace")
        limit = qint("limit", 64)
        tls = flightrec.RECORDER.recent(
            model=q("model"), limit=limit * 4 if trace else limit
        )
        if trace:
            # trace filter: the fleet stitcher (and humans chasing one
            # request) want exactly the timelines sharing a traceparent
            tls = [t for t in tls if t.trace_id == trace][-limit:]
        body = json.dumps({
            "requests": [
                t.to_dict(events=q("events", "1") not in ("0", "false"))
                for t in tls
            ],
        })
    elif path == "/debug/trace/fleet":
        if fleet.FLEET is None:
            body = json.dumps({"error": "fleet telemetry not armed"})
            status = 404
        elif not q("trace"):
            body = json.dumps({"error": "trace id required (?trace=<id>)"})
            status = 400
        else:
            body = json.dumps(fleet.FLEET.stitch(
                q("trace"), limit=qint("limit", 64)
            ))
    elif path == "/debug/trace":
        snap_id = qint("snapshot", 0)
        if snap_id:
            snaps = [
                s for s in flightrec.RECORDER.snapshots()
                if s["id"] == snap_id
            ]
            if not snaps:
                # 404, not a 200-with-error body: `curl -f` scripts must
                # not archive the miss as a valid trace capture
                body = json.dumps({"error": "no such snapshot"})
                status = 404
            else:
                # same renderer as the live path — a snapshot keeps its
                # durations and engine-lane events through the freeze
                body = json.dumps(flightrec.snapshot_trace(snaps[0]))
        else:
            model = q("model")
            body = json.dumps(flightrec.chrome_trace(
                flightrec.RECORDER.recent(
                    model=model, limit=qint("limit", 64)
                ),
                flightrec.RECORDER.model_events(model),
            ))
    elif path == "/debug/spans":
        spans = tracing.recent_spans(
            name=q("name"), limit=qint("limit", 200)
        )
        body = json.dumps({
            "spans": [
                {
                    "name": s.name, "trace_id": s.trace_id,
                    "span_id": s.span_id, "parent_id": s.parent_id,
                    "start": s.start, "duration_ms":
                        round(s.duration_s * 1e3, 3),
                    "status": s.status,
                    "attributes": {
                        k: repr(v) if not isinstance(
                            v, (str, int, float, bool, type(None))
                        ) else v
                        for k, v in s.attributes.items()
                    },
                }
                for s in spans
            ],
        })
    elif path == "/debug/slo":
        body = json.dumps({
            "config": vars(slo.ENGINE.cfg),
            "models": {
                m: {
                    "objectives": slo.ENGINE.evaluate(m),
                    "tenants": slo.ENGINE.tenants(m),
                }
                for m in slo.ENGINE.models()
            },
        })
    elif path == "/debug/snapshots":
        snap_id = qint("id", 0)
        snaps = flightrec.RECORDER.snapshots()
        if snap_id:
            match = [s for s in snaps if s["id"] == snap_id]
            if match:
                body = json.dumps(match[0])
            else:
                body = json.dumps({"error": "no such snapshot"})
                status = 404
        else:
            body = json.dumps({
                "snapshots": [
                    {k: s[k] for k in ("id", "model", "cause", "at")}
                    | {"timelines": len(s["timelines"])}
                    for s in snaps
                ],
            })
    elif path == "/debug/devprof":
        body = json.dumps(devprof.snapshot_all(model=q("model")))
    elif path == "/debug/profile":
        try:
            secs = float(q("secs", "2") or 2)
        except ValueError:
            secs = 2.0
        try:
            body = json.dumps(devprof.start_capture(secs))
        except devprof.CaptureDisabled as exc:
            # 403, not 404: the route exists, the deployment opted out
            # (no dump dir); a curl -f script reads the distinction
            body = json.dumps({"error": str(exc)})
            status = 403
        except devprof.CaptureBusy as exc:
            # one capture at a time — a second request must not stack a
            # profiler session on the live plane
            body = json.dumps({"error": str(exc)})
            status = 409
    else:
        return None
    return body.encode("utf-8"), "application/json", status


def start_metrics_server(
    port: int = 0,
    host: str = "127.0.0.1",
    registry: Optional[MetricsRegistry] = None,
    health_fn: Optional[Callable[[], dict]] = None,
) -> Tuple[ThreadingHTTPServer, int]:
    """Start the exposition endpoint on a daemon thread; returns
    (server, bound_port). ``server.shutdown()`` stops it."""
    reg = registry or REGISTRY

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
            parsed = urlparse(self.path)
            path = parsed.path
            status = 200
            if path == "/metrics":
                body = reg.render().encode("utf-8")
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif path == "/metrics/fleet":
                from . import fleet

                if fleet.FLEET is None:
                    body = b'{"error":"fleet telemetry not armed"}'
                    ctype = "application/json"
                    status = 404
                else:
                    body = fleet.FLEET.federate().encode("utf-8")
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif path == "/fleet/members":
                from . import fleet

                if fleet.FLEET is None:
                    body = b'{"error":"fleet telemetry not armed"}'
                    status = 404
                else:
                    body = json.dumps({
                        "self": fleet.FLEET.identity,
                        "members": fleet.FLEET.members(),
                        "journal": fleet.FLEET.journal(),
                        "summary": fleet.FLEET.health_summary(),
                    }).encode("utf-8")
                ctype = "application/json"
            elif path == "/livez":
                # pure liveness: always 200 while the process answers.
                # Point k8s livenessProbe HERE — /healthz 503s on SLO
                # breach, and a liveness probe acting on that would kill
                # the process (losing AOT warmup + KV caches) in a
                # restart loop exactly when the plane is overloaded;
                # /healthz is for readiness / LB rotation decisions.
                body = b'{"status":"alive"}'
                ctype = "application/json"
            elif path == "/healthz":
                # the ACTUAL bound port rides every probe: with
                # AIOS_<SVC>_METRICS_PORT=0 the ephemeral port was
                # otherwise only in serve()'s return value — fleet
                # peers and tests discover it here
                payload = {
                    "status": "ok",
                    "metrics_port": self.server.server_address[1],
                }
                if health_fn is not None:
                    try:
                        payload.update(health_fn())
                    except Exception as exc:  # noqa: BLE001
                        payload = {"status": "degraded",
                                   "error": repr(exc)[:200],
                                   "metrics_port":
                                       self.server.server_address[1]}
                # degraded/SLO-breach is a PROBE FAILURE, not prose: load
                # balancers and k8s probes act on the status code, so a
                # body saying "degraded" under HTTP 200 kept sick
                # replicas in rotation. A
                # health_fn wanting SLO degradation folds it in via
                # slo.annotate_health (the runtime service does).
                if payload.get("status", "ok") != "ok":
                    status = 503
                body = json.dumps(payload).encode("utf-8")
                ctype = "application/json"
            elif path == "/debug" or path.startswith("/debug/"):
                try:
                    rendered = _debug_response(path, parse_qs(parsed.query))
                except Exception as exc:  # noqa: BLE001 - debug routes
                    # must never take down the exposition endpoint
                    rendered = (
                        json.dumps({"error": repr(exc)[:200]}).encode(
                            "utf-8"
                        ),
                        "application/json",
                        500,
                    )
                if rendered is None:
                    self.send_error(404)
                    return
                body, ctype, status = rendered
            else:
                self.send_error(404)
                return
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):  # noqa: N802 - BaseHTTPRequestHandler API
            from . import fleet

            parsed = urlparse(self.path)
            if parsed.path == "/fleet/drain":
                # graceful drain trigger (fleet/drain.py; fleetctl drain
                # drives it): 202 — the protocol runs on a worker thread
                from ..fleet import drain

                if drain.COORD is None:
                    self.send_error(
                        404, "drain coordinator not armed on this host"
                    )
                    return
                q = parse_qs(parsed.query)
                try:
                    timeout_s = float(q["timeout"][0]) if "timeout" in q \
                        else None
                except ValueError:
                    timeout_s = None
                phase = drain.request_drain(timeout_s)
                body = json.dumps({
                    "phase": phase,
                    "host": fleet.FLEET.identity["host"]
                    if fleet.FLEET is not None else "",
                }).encode("utf-8")
                self.send_response(202)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if parsed.path != "/fleet/announce":
                self.send_error(404)
                return
            if fleet.FLEET is None:
                self.send_error(404, "fleet telemetry not armed")
                return
            try:
                n = min(int(self.headers.get("Content-Length", 0)),
                        4 << 20)
                desc = json.loads(self.rfile.read(n).decode("utf-8"))
                if not isinstance(desc, dict):
                    raise ValueError("announce body must be an object")
                # the server side of a seeded per-edge partition
                # (faults/net.py): the REPLY travels the self->announcer
                # edge — a fired one-way partition still folds the
                # peer's descriptor (their bytes reached us) but
                # withholds the reply; a full partition refuses both
                from ..faults import net

                fold, reply = net.gate_announce(str(desc.get("host", "")))
                if not fold:
                    self.send_error(503, "announce refused: partitioned")
                    return
                reply_body = fleet.FLEET.receive(desc)
                if not reply:
                    self.send_error(503, "announce reply withheld")
                    return
                body = json.dumps(reply_body).encode("utf-8")
                status = 200
            except Exception as exc:  # noqa: BLE001 - a malformed
                # announce must not take down the exposition endpoint
                body = json.dumps({"error": repr(exc)[:200]}).encode("utf-8")
                status = 400
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # scrapes must not spam stderr
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    server.daemon_threads = True
    thread = threading.Thread(
        target=server.serve_forever, name="obs-metrics-http", daemon=True
    )
    thread.start()
    bound = server.server_address[1]
    log.info("metrics endpoint on http://%s:%d/metrics", host, bound)
    return server, bound


def maybe_start_metrics_server(
    service_name: str,
    metrics_port: Optional[int] = None,
    health_fn: Optional[Callable[[], dict]] = None,
) -> Tuple[Optional[ThreadingHTTPServer], Optional[int]]:
    """serve()-helper: start the endpoint when asked for explicitly or via
    ``AIOS_<SERVICE>_METRICS_PORT``; (None, None) otherwise."""
    host = os.environ.get("AIOS_METRICS_HOST", "127.0.0.1")
    if metrics_port is None:
        env = os.environ.get(f"AIOS_{service_name.upper()}_METRICS_PORT")
        if env is None or env == "":
            return None, None
        try:
            metrics_port = int(env)
        except ValueError:
            log.warning(
                "AIOS_%s_METRICS_PORT=%r is not an integer; metrics "
                "endpoint disabled", service_name.upper(), env,
            )
            return None, None
    # a port that was asked for and cannot be bound (taken, > 65535)
    # raises: a deployment that expects its endpoint must not run without
    server, bound = start_metrics_server(
        port=metrics_port, host=host, health_fn=health_fn
    )
    # the service name + ACTUAL port in one startup line: with
    # AIOS_<SVC>_METRICS_PORT=0 this log (plus /healthz and the
    # fleet announce) is how anything finds the endpoint
    log.info("%s metrics endpoint bound on port %d", service_name,
             bound)
    from . import fleet, incidents, tsdb

    fleet.maybe_start(service_name, bound, host=host)
    # the history planes ride the same arming pass: every real
    # serving process comes through here, and both are env-gated
    # no-ops (module global stays None) unless asked for
    tsdb.maybe_start()
    incidents.maybe_start()
    return server, bound
