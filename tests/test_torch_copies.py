"""The port's service plane and its observability plane are copies of the
JAX package's.

Each module below equals its ``aios_tpu`` source after one fixed rewrite,
``aios_tpu`` -> ``aios_tpu_torch`` wherever it stands as a whole word (the
imports, ``python -m`` module names, paths into the package), except the
hunks listed in ``HUNKS``, each with its reason. An edit to either side that
is not carried to the other fails here instead of drifting silently.
"""

import difflib
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX = ROOT / "aios_tpu"
PORT = ROOT / "aios_tpu_torch"
SUBPACKAGES = ("memory", "tools", "gateway", "orchestrator", "agents", "boot", "native",
               "loadgen")
# the observability plane's host modules, the autoscaler, the fault points,
# the gRPC plumbing and the analyzer's AST substrate (obs/devprof.py is
# redesigned for the card, not copied; obs/metrics.py and obs/instruments.py
# carry the port's own catalog; the analyzer's registry and rules are the
# port's own, held to the JAX analyzer by tests/test_torch_analysis.py)
MODULES = ("rpc.py", "faults/inject.py", "obs/tracing.py", "obs/interceptors.py",
           "obs/flightrec.py", "obs/slo.py", "obs/tsdb.py", "obs/incidents.py",
           "obs/http.py", "serving/autoscale.py", "analysis/core.py")
# proto stubs and the C++ source: byte for byte, no rewrite
IDENTICAL = tuple(f"proto_gen/{n}_pb2.py" for n in (
    "common", "runtime", "agent", "api_gateway", "memory", "orchestrator", "tools",
)) + ("native/src/aios_native.cpp",)

_WORD = re.compile(r"\baios_tpu\b")

# the port's dev scripts share the tools/ directory; they are not copies
PORT_ONLY = {"tools/dense_compare.py", "tools/graph_probe.py", "tools/issue_cost.py",
             "tools/split_sweep.py", "tools/storm_probe.py", "tools/unicode_classes.py"}

FLEET_REASON = ("the fleet plane (obs/fleet.py) is not ported: /healthz carries no fleet "
                "rollup until it is")
NET_REASON = ("the per-edge network-fault interceptor (faults/net.py) belongs to the fleet "
              "plane, which is not ported")
FLEET_ROUTES = ("the fleet plane (obs/fleet.py, fleet/drain.py, faults/net.py) is not ported: "
                "its routes keep their rows in ROUTES and answer 404 not armed, as the JAX "
                "endpoint does while the plane is off")
PROFILER_REASON = "the port's on-demand capture runs torch.profiler (obs/devprof.py)"
BIND_REASON = ("a metrics port that was asked for and cannot be bound raises rather than "
               "warn, so no endpoint a deployment expects goes missing silently; the "
               "process-info gauge is stamped here, since obs/fleet.py, which stamps it in "
               "the JAX package, is not ported")

NUMBERS_REASON = ("the port's sources name no pull request or issue of the project's history; "
                  "the sentence keeps its point without the number")

ACCEL_REASON = ("device probe: the port reports the CUDA devices through torch, imported "
                "inside the function as JAX imports jax there; no key goes missing")

HUNKS = {
    "analysis/core.py": [
        ("Every rule (and the migrated source checks in ``tests/test_obs_lint.py``)\n"
         "works from the same three primitives so there is ONE way to read the\n"
         "tree:\n",
         "Every rule works from the same three primitives so there is ONE way to\n"
         "read the tree:\n",
         "the port has no migrated lint tests: its rules are the substrate's only users"),
    ],
    "obs/flightrec.py": [
        ("dispatch counts are identical recorder ON vs OFF (the PR 6/7 invariant,\n"
         "extended to observability).\n",
         "dispatch counts are identical recorder ON vs OFF (the engine's\n"
         "dispatch invariant, extended to observability).\n",
         NUMBERS_REASON),
    ],
    "obs/tsdb.py": [
        ("injected (the PR 16 exposition-merge discipline). Incident bundles\n",
         "injected (the exposition-merge discipline). Incident bundles\n",
         NUMBERS_REASON),
    ],
    "obs/slo.py": [
        (('    downgrades ``status`` to ``degraded`` on any active breach. When the\n'
          '    fleet telemetry plane is armed (obs/fleet.py), the fleet rollup —\n'
          '    member counts by state, worst-burn host, per-objective fleet\n'
          '    attainment — rides the same probe as a ``fleet`` section."""\n'
          '    from . import fleet\n'
          '\n'
          '    if fleet.FLEET is not None:\n'
          '        payload.setdefault("fleet", fleet.FLEET.health_summary())\n'),
         '    downgrades ``status`` to ``degraded`` on any active breach."""\n',
         FLEET_REASON),
    ],
    "rpc.py": [
        (('class _NetFaultClientInterceptor(\n'
          '    grpc.UnaryUnaryClientInterceptor,\n'
          '    grpc.UnaryStreamClientInterceptor,\n'
          '    grpc.StreamUnaryClientInterceptor,\n'
          '    grpc.StreamStreamClientInterceptor,\n'
          '):\n'
          '    """Chaos hook (docs/FAULTS.md "Per-edge network faults"): every\n'
          '    channel this module builds carries one of these, so KVX, Handoff,\n'
          '    and every other cross-host RPC traverse the same seeded per-edge\n'
          '    fault surface as the fleet HTTP helpers. A fired partition raises\n'
          '    :class:`aios_tpu_torch.faults.net.NetFaultRefused` (an UNAVAILABLE-coded\n'
          '    grpc.RpcError) before the wire; a fired ``net.drop_after`` lets a\n'
          '    unary-stream call start and severs it after ``after_msgs``\n'
          '    messages. A no-op — one global None check — unless a fault schedule\n'
          '    is armed."""\n'
          '\n'
          '    def __init__(self, address: str) -> None:\n'
          '        self._address = address\n'
          '\n'
          '    def intercept_unary_unary(self, continuation, client_call_details,\n'
          '                              request):\n'
          '        from . import faults\n'
          '\n'
          '        if faults.active():\n'
          '            from .faults import net\n'
          '\n'
          '            net.check_send(self._address, "rpc")\n'
          '        return continuation(client_call_details, request)\n'
          '\n'
          '    def intercept_unary_stream(self, continuation, client_call_details,\n'
          '                               request):\n'
          '        from . import faults\n'
          '\n'
          '        if not faults.active():\n'
          '            return continuation(client_call_details, request)\n'
          '        from .faults import net\n'
          '\n'
          '        net.check_send(self._address, "rpc")\n'
          '        return net.sever_stream(\n'
          '            self._address, continuation(client_call_details, request)\n'
          '        )\n'
          '\n'
          '    def intercept_stream_unary(self, continuation, client_call_details,\n'
          '                               request_iterator):\n'
          '        from . import faults\n'
          '\n'
          '        if faults.active():\n'
          '            from .faults import net\n'
          '\n'
          '            net.check_send(self._address, "rpc")\n'
          '        return continuation(client_call_details, request_iterator)\n'
          '\n'
          '    def intercept_stream_stream(self, continuation, client_call_details,\n'
          '                                request_iterator):\n'
          '        from . import faults\n'
          '\n'
          '        if not faults.active():\n'
          '            return continuation(client_call_details, request_iterator)\n'
          '        from .faults import net\n'
          '\n'
          '        net.check_send(self._address, "rpc")\n'
          '        return net.sever_stream(\n'
          '            self._address,\n'
          '            continuation(client_call_details, request_iterator),\n'
          '        )\n'
          '\n'
          '\n'),
         '',
         NET_REASON),
        (('    # the net-fault interceptor goes OUTERMOST: a refused send never\n'
          '    # happened, so it must not count on the client rpc_* metrics — the\n'
          "    # caller's recovery path (and the faults journal) carry the evidence\n"
          '    return grpc.intercept_channel(\n'
          '        channel, _NetFaultClientInterceptor(address)\n'
          '    )\n'),
         '    return channel\n',
         NET_REASON),
    ],
    "obs/http.py": [
        ("                # replicas in rotation (the ISSUE 8 satellite fix). A\n",
         "                # replicas in rotation. A\n",
         NUMBERS_REASON),
        (('  * ``/metrics/fleet`` — federation: the union of every live fleet\n'
          "    member's /metrics with a ``host`` label injected (404 until\n"
          '    obs/fleet.py is armed);\n'
          '  * ``/fleet/members`` — the fleet membership table + transition\n'
          '    journal (JSON; what fleetctl renders);\n'
          "  * ``/fleet/announce`` — POST: one member's heartbeat descriptor in,\n"
          '    ours + known peers back (the membership gossip hop);\n'
          "  * ``/fleet/drain`` — POST: start this host's graceful drain\n"
          '    (fleet/drain.py; 202 + current phase, ``?timeout=S`` bounds the\n'
          '    in-flight wait; ``fleetctl drain`` drives it);\n'),
         ('  * ``/metrics/fleet``, ``/fleet/members``, ``/fleet/announce``,\n'
          '    ``/fleet/drain``, ``/debug/trace/fleet`` and ``/debug/tsdb/fleet``\n'
          "    — the fleet plane's routes, which the port does not carry yet: each\n"
          '    answers 404 as the JAX endpoint does while the fleet plane is not\n'
          '    armed;\n'),
         FLEET_ROUTES),
        (('  * ``/debug/trace/fleet`` — one trace id stitched ACROSS the fleet:\n'
          "    matching timelines fetched from every live peer's recorder, merged\n"
          '    into per-host Chrome-trace lanes (``?trace=<id>``);\n'),
         '',
         FLEET_ROUTES),
        ('  * ``/debug/profile``   — start a bounded on-demand ``jax.profiler``\n',
         '  * ``/debug/profile``   — start a bounded on-demand ``torch.profiler``\n',
         PROFILER_REASON),
        (('  * ``/debug/tsdb/fleet`` — the same query answered by every live\n'
          '    fleet member, keyed by host (404 until fleet is armed);\n'),
         '',
         FLEET_ROUTES),
        ('    from . import devprof, fleet, flightrec, incidents, slo, tracing\n',
         '    from . import devprof, flightrec, incidents, slo, tracing\n',
         FLEET_ROUTES),
        (('        if fleet.FLEET is None:\n'
          '            body = json.dumps({"error": "fleet telemetry not armed"})\n'
          '            status = 404\n'
          '        else:\n'
          '            body = json.dumps(fleet.FLEET.federate_tsdb(query))\n'),
         ('        body = json.dumps({"error": "fleet telemetry not armed"})\n'
          '        status = 404\n'),
         FLEET_ROUTES),
        (('        if fleet.FLEET is None:\n'
          '            body = json.dumps({"error": "fleet telemetry not armed"})\n'
          '            status = 404\n'
          '        elif not q("trace"):\n'
          '            body = json.dumps({"error": "trace id required (?trace=<id>)"})\n'
          '            status = 400\n'
          '        else:\n'
          '            body = json.dumps(fleet.FLEET.stitch(\n'
          '                q("trace"), limit=qint("limit", 64)\n'
          '            ))\n'),
         ('        body = json.dumps({"error": "fleet telemetry not armed"})\n'
          '        status = 404\n'),
         FLEET_ROUTES),
        (('            elif path == "/metrics/fleet":\n'
          '                from . import fleet\n'
          '\n'
          '                if fleet.FLEET is None:\n'
          '                    body = b\'{"error":"fleet telemetry not armed"}\'\n'
          '                    ctype = "application/json"\n'
          '                    status = 404\n'
          '                else:\n'
          '                    body = fleet.FLEET.federate().encode("utf-8")\n'
          '                    ctype = "text/plain; version=0.0.4; charset=utf-8"\n'
          '            elif path == "/fleet/members":\n'
          '                from . import fleet\n'
          '\n'
          '                if fleet.FLEET is None:\n'
          '                    body = b\'{"error":"fleet telemetry not armed"}\'\n'
          '                    status = 404\n'
          '                else:\n'
          '                    body = json.dumps({\n'
          '                        "self": fleet.FLEET.identity,\n'
          '                        "members": fleet.FLEET.members(),\n'
          '                        "journal": fleet.FLEET.journal(),\n'
          '                        "summary": fleet.FLEET.health_summary(),\n'
          '                    }).encode("utf-8")\n'),
         ('            elif path in ("/metrics/fleet", "/fleet/members"):\n'
          '                body = b\'{"error":"fleet telemetry not armed"}\'\n'),
         FLEET_ROUTES),
        (('                ctype = "application/json"\n'
          '            elif path == "/livez":\n'),
         ('                ctype = "application/json"\n'
          '                status = 404\n'
          '            elif path == "/livez":\n'),
         FLEET_ROUTES),
        (('        def do_POST(self):  # noqa: N802 - BaseHTTPRequestHandler API\n'
          '            from . import fleet\n'
          '\n'
          '            parsed = urlparse(self.path)\n'),
         ('        def do_POST(self):  # noqa: N802 - BaseHTTPRequestHandler API\n'
          '            parsed = urlparse(self.path)\n'),
         FLEET_ROUTES),
        (('                # graceful drain trigger (fleet/drain.py; fleetctl drain\n'
          '                # drives it): 202 — the protocol runs on a worker thread\n'
          '                from ..fleet import drain\n'
          '\n'
          '                if drain.COORD is None:\n'
          '                    self.send_error(\n'
          '                        404, "drain coordinator not armed on this host"\n'
          '                    )\n'
          '                    return\n'
          '                q = parse_qs(parsed.query)\n'
          '                try:\n'
          '                    timeout_s = float(q["timeout"][0]) if "timeout" in q \\\n'
          '                        else None\n'
          '                except ValueError:\n'
          '                    timeout_s = None\n'
          '                phase = drain.request_drain(timeout_s)\n'
          '                body = json.dumps({\n'
          '                    "phase": phase,\n'
          '                    "host": fleet.FLEET.identity["host"]\n'
          '                    if fleet.FLEET is not None else "",\n'
          '                }).encode("utf-8")\n'
          '                self.send_response(202)\n'
          '                self.send_header("Content-Type", "application/json")\n'
          '                self.send_header("Content-Length", str(len(body)))\n'
          '                self.end_headers()\n'
          '                self.wfile.write(body)\n'),
         ('                self.send_error(\n'
          '                    404, "drain coordinator not armed on this host"\n'
          '                )\n'),
         FLEET_ROUTES),
        (('            if fleet.FLEET is None:\n'
          '                self.send_error(404, "fleet telemetry not armed")\n'
          '                return\n'
          '            try:\n'
          '                n = min(int(self.headers.get("Content-Length", 0)),\n'
          '                        4 << 20)\n'
          '                desc = json.loads(self.rfile.read(n).decode("utf-8"))\n'
          '                if not isinstance(desc, dict):\n'
          '                    raise ValueError("announce body must be an object")\n'
          '                # the server side of a seeded per-edge partition\n'
          '                # (faults/net.py): the REPLY travels the self->announcer\n'
          '                # edge — a fired one-way partition still folds the\n'
          "                # peer's descriptor (their bytes reached us) but\n"
          '                # withholds the reply; a full partition refuses both\n'
          '                from ..faults import net\n'
          '\n'
          '                fold, reply = net.gate_announce(str(desc.get("host", "")))\n'
          '                if not fold:\n'
          '                    self.send_error(503, "announce refused: partitioned")\n'
          '                    return\n'
          '                reply_body = fleet.FLEET.receive(desc)\n'
          '                if not reply:\n'
          '                    self.send_error(503, "announce reply withheld")\n'
          '                    return\n'
          '                body = json.dumps(reply_body).encode("utf-8")\n'
          '                status = 200\n'
          '            except Exception as exc:  # noqa: BLE001 - a malformed\n'
          '                # announce must not take down the exposition endpoint\n'
          '                body = json.dumps({"error": repr(exc)[:200]}).encode("utf-8")\n'
          '                status = 400\n'
          '            self.send_response(status)\n'
          '            self.send_header("Content-Type", "application/json")\n'
          '            self.send_header("Content-Length", str(len(body)))\n'
          '            self.end_headers()\n'
          '            self.wfile.write(body)\n'),
         '            self.send_error(404, "fleet telemetry not armed")\n',
         FLEET_ROUTES),
        (('    try:\n'
          '        server, bound = start_metrics_server(\n'
          '            port=metrics_port, host=host, health_fn=health_fn\n'
          '        )\n'
          '        # the service name + ACTUAL port in one startup line: with\n'
          '        # AIOS_<SVC>_METRICS_PORT=0 this log (plus /healthz and the\n'
          '        # fleet announce) is how anything finds the endpoint\n'
          '        log.info("%s metrics endpoint bound on port %d", service_name,\n'
          '                 bound)\n'
          '        from . import fleet, incidents, tsdb\n'),
         ('    # a port that was asked for and cannot be bound (taken, > 65535)\n'
          '    # raises: a deployment that expects its endpoint must not run without\n'
          '    server, bound = start_metrics_server(\n'
          '        port=metrics_port, host=host, health_fn=health_fn\n'
          '    )\n'
          '    # the service name + ACTUAL port in one startup line: with\n'
          '    # AIOS_<SVC>_METRICS_PORT=0 this log (plus /healthz) is how anything\n'
          '    # finds the endpoint\n'
          '    log.info("%s metrics endpoint bound on port %d", service_name,\n'
          '             bound)\n'
          '    from . import incidents, tsdb\n'),
         BIND_REASON),
        (('        fleet.maybe_start(service_name, bound, host=host)\n'
          '        # the history planes ride the same arming pass: every real\n'
          '        # serving process comes through here, and both are env-gated\n'
          '        # no-ops (module global stays None) unless asked for\n'
          '        tsdb.maybe_start()\n'
          '        incidents.maybe_start()\n'
          '        return server, bound\n'
          '    except (OSError, OverflowError) as exc:  # taken port / port > 65535\n'
          '        # the endpoint is optional: a taken/invalid port must not crash a\n'
          '        # serve() whose gRPC server is already up\n'
          '        log.warning(\n'
          '            "%s metrics endpoint on port %s failed (%s); continuing "\n'
          '            "without it", service_name, metrics_port, exc,\n'
          '        )\n'
          '        return None, None\n'),
         ('    stamp_process_info(service_name)\n'
          '    # the history planes ride the same arming pass: every real\n'
          '    # serving process comes through here, and both are env-gated\n'
          '    # no-ops (module global stays None) unless asked for\n'
          '    tsdb.maybe_start()\n'
          '    incidents.maybe_start()\n'
          '    return server, bound\n'
          '\n'
          '\n'
          'def process_identity(role: str = "") -> dict:\n'
          '    """The process\'s identity on the ``aios_tpu_process_info`` gauge: host\n'
          '    id (AIOS_TPU_FLEET_HOST, else hostname:pid), role (AIOS_TPU_FLEET_ROLE,\n'
          '    else the service name), rank 0 (one process per host until the fleet\n'
          '    plane is ported) and the package version."""\n'
          '    import socket\n'
          '\n'
          '    from .. import __version__\n'
          '\n'
          '    return {\n'
          '        "host": os.environ.get("AIOS_TPU_FLEET_HOST", "")\n'
          '        or f"{socket.gethostname()}:{os.getpid()}",\n'
          '        "role": os.environ.get("AIOS_TPU_FLEET_ROLE", "") or role or "service",\n'
          '        "rank": "0",\n'
          '        "version": __version__,\n'
          '    }\n'
          '\n'
          '\n'
          'def stamp_process_info(role: str = "") -> dict:\n'
          '    """Set the ``aios_tpu_process_info`` info-gauge (value 1, identity in\n'
          '    labels) and return the identity."""\n'
          '    from . import instruments\n'
          '\n'
          '    ident = process_identity(role)\n'
          '    instruments.PROCESS_INFO.labels(**ident).set(1.0)\n'
          '    return ident\n'),
         BIND_REASON),
    ],
    "services.py": [
        ("`aios_tpu_torch/protos/` exactly (which in turn are wire-compatible with the\n"
         "reference's agent-core/proto).\n",
         "`aios_tpu/protos/` exactly (which in turn are wire-compatible with the\n"
         "reference's agent-core/proto). The fleet plane's aios.fleet.KvTransfer is not\n"
         "ported yet.\n",
         "the protos live in the JAX package; the fleet plane is not ported"),
        ("    fleet_pb2,\n", "", "the fleet plane (aios.fleet.KvTransfer) is not ported"),
        ('# ---------------------------------------------------------------------------\n'
         '# aios.fleet.KvTransfer — the fleet data plane (aios_tpu_torch/fleet/): cross-host\n'
         '# HostPageStore transfer (pull-on-miss Fetch, push-on-prefill Push) and the\n'
         '# disaggregated prefill->decode Handoff stream. No reference counterpart.\n'
         '# ---------------------------------------------------------------------------\n'
         '\n'
         'KVTRANSFER = ServiceSpec(\n'
         '    "aios.fleet.KvTransfer",\n'
         '    {\n'
         '        "Fetch": Method(\n'
         '            fleet_pb2.FetchRequest, fleet_pb2.PageChunk,\n'
         '            server_streaming=True,\n'
         '        ),\n'
         '        "Push": Method(\n'
         '            fleet_pb2.PageChunk, fleet_pb2.PushAck, client_streaming=True,\n'
         '        ),\n'
         '        "Handoff": Method(\n'
         '            fleet_pb2.HandoffRequest, fleet_pb2.HandoffChunk,\n'
         '            server_streaming=True,\n'
         '        ),\n'
         '    },\n'
         ')\n'
         '\n', "", "the fleet plane (aios.fleet.KvTransfer) is not ported"),
        ('    "kvtransfer": KVTRANSFER,\n', "", "the fleet plane is not ported"),
        ("KvTransferStub = make_stub(KVTRANSFER)\n"
         "KvTransferServicer = make_servicer(KVTRANSFER)\n", "",
         "the fleet plane is not ported"),
    ],
    "boot/hardware.py": [
        ("/proc and /sys. TPU-specific addition: detects attached TPU chips through\n"
         "JAX (deferred import so boot works on hosts without accelerators) — the\n"
         "reference's GPU detection has no TPU notion at all.\n",
         "/proc and /sys. Accelerator addition: detects attached CUDA devices through\n"
         "torch (deferred import so boot works on hosts without accelerators); the\n"
         "fields keep the JAX package's ``tpu_`` names, so the two report alike.\n",
         ACCEL_REASON),
        ("            import jax\n"
         "\n"
         "            info.tpu_devices = [str(d) for d in jax.devices()]\n"
         "            info.tpu_backend = jax.default_backend()\n"
         "        except Exception:  # no accelerator / no jax — boot proceeds\n",
         "            import torch\n"
         "\n"
         "            info.tpu_devices = [\n"
         '                f"cuda:{i} {torch.cuda.get_device_name(i)}"\n'
         "                for i in range(torch.cuda.device_count())\n"
         "            ]\n"
         '            info.tpu_backend = "cuda" if info.tpu_devices else "cpu"\n'
         "        except Exception:  # no accelerator / no torch — boot proceeds\n",
         ACCEL_REASON),
    ],
    "tools/handlers/system.py": [
        ("    # TPU presence (the reference detects GPUs; we detect the TPU chip)\n"
         "    try:\n"
         "        import jax\n"
         "\n"
         '        info["accelerators"] = [str(d) for d in jax.devices()]\n'
         '        info["accelerator_backend"] = jax.default_backend()\n',
         "    # accelerator presence: the port serves on CUDA devices\n"
         "    try:\n"
         "        import torch\n"
         "\n"
         '        info["accelerators"] = [\n'
         '            f"cuda:{i} {torch.cuda.get_device_name(i)}"\n'
         "            for i in range(torch.cuda.device_count())\n"
         "        ]\n"
         '        info["accelerator_backend"] = "cuda" if info["accelerators"] else "cpu"\n',
         ACCEL_REASON),
    ],
    "boot/supervisor.py": [
        ("    env: Dict[str, str] = field(default_factory=dict)\n",
         "    env: Dict[str, str] = field(default_factory=dict)\n"
         "    args: List[str] = field(default_factory=list)  # after -m <module>\n",
         "the runtime child's device argument: `python -m aios_tpu_torch.runtime.service` "
         "serves on the card and raises without one, so a CPU boot passes --device cpu"),
        ('            [sys.executable, "-m", d.module],\n',
         '            [sys.executable, "-m", d.module, *d.args],\n',
         "the runtime child's device argument"),
    ],
    "native/__init__.py": [
        ("from pathlib import Path\n", "",
         "the library is built outside the package tree (native/build.py's OUT)"),
        ('_LIB_PATH = Path(__file__).parent / "libaios_native.so"\n',
         "from .build import OUT as _LIB_PATH\n\n",
         "the library is built outside the package tree (native/build.py's OUT)"),
    ],
    "native/build.py": [
        ('OUT = HERE / "libaios_native.so"\n'
         'LOCK = HERE / ".build.lock"\n',
         "# the checkout's git-ignored build/, never the package tree\n"
         'OUT_DIR = HERE.resolve().parents[1] / "build" / "native"\n'
         'OUT = OUT_DIR / "libaios_native.so"\n'
         'LOCK = OUT_DIR / ".build.lock"\n',
         "g++ writes into the checkout's git-ignored build/native/, never beside the source"),
        ('    with open(LOCK, "w") as lock_fh:\n',
         "    OUT_DIR.mkdir(parents=True, exist_ok=True)\n"
         '    with open(LOCK, "w") as lock_fh:\n',
         "the build directory is made at first use"),
    ],
    "tools/service.py": [
        ("    serve(\n"
         "        executor=ToolExecutor(\n"
         '            audit_path=os.environ.get("AIOS_AUDIT_DB", "/tmp/aios/audit.db")\n'
         "        )\n"
         "    )\n",
         "    # under AIOS_DATA_DIR, the tree a boot gives its services, when set\n"
         '    data_dir = os.environ.get("AIOS_DATA_DIR")\n'
         '    dirs = {"backup_dir": os.path.join(data_dir, "backups"),\n'
         '            "plugin_dir": os.path.join(data_dir, "plugins")} if data_dir else {}\n'
         "    serve(\n"
         "        executor=ToolExecutor(\n"
         '            audit_path=os.environ.get("AIOS_AUDIT_DB", "/tmp/aios/audit.db"),\n'
         "            **dirs,\n"
         "        )\n"
         "    )\n",
         "a booted tools child keeps its backups and plugins under the data directory it "
         "is given (the memory and orchestrator children already do), so a boot writes "
         "nothing outside it"),
    ],
}


def _copied():
    rels = ["_compat.py", "services.py", *MODULES]
    for sub in SUBPACKAGES:
        rels += sorted(str(p.relative_to(JAX)) for p in (JAX / sub).rglob("*.py"))
    return rels


COPIED = _copied()


def _expected(rel: str) -> str:
    src = _WORD.sub("aios_tpu_torch", (JAX / rel).read_text())
    for old, new, reason in HUNKS.get(rel, ()):
        assert src.count(old) == 1, (
            f"{rel}: the listed hunk ({reason}) no longer matches the JAX source once")
        src = src.replace(old, new)
    return src


@pytest.mark.parametrize("rel", COPIED)
def test_copy_equals_the_reference_but_its_listed_hunks(rel):
    port = PORT / rel
    assert port.exists(), f"{rel} is not in the port"
    want, have = _expected(rel), port.read_text()
    if have != want:
        diff = "".join(difflib.unified_diff(
            want.splitlines(True), have.splitlines(True),
            f"aios_tpu/{rel} (rewritten, listed hunks applied)", f"aios_tpu_torch/{rel}"))
        pytest.fail(f"{rel} drifted from its reference:\n{diff}")


@pytest.mark.parametrize("rel", IDENTICAL)
def test_byte_identical_copies(rel):
    assert (PORT / rel).read_bytes() == (JAX / rel).read_bytes(), rel


def test_every_hunk_names_a_copied_module_and_a_reason():
    for rel, hunks in HUNKS.items():
        assert rel in COPIED, rel
        for old, new, reason in hunks:
            assert old != new and len(reason) > 20, (rel, reason)


def test_the_port_holds_no_module_the_reference_lacks():
    extra = []
    for sub in SUBPACKAGES:
        for p in (PORT / sub).rglob("*.py"):
            rel = str(p.relative_to(PORT))
            if rel not in COPIED and rel not in PORT_ONLY:
                extra.append(rel)
    assert not extra, f"modules in the port's copied subpackages with no reference: {extra}"
