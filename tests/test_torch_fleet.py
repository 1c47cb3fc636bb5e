"""The port's fleet telemetry plane (``aios_tpu_torch/obs/fleet.py``) held to
the JAX package's: the same script of announces and detector ticks under one
fake clock gives both registries the same member tables and transition
journals; gossip, the fleet rollup, exposition relabeling and federation,
trace stitching and the tsdb fan-out answer alike; the HTTP routes answer
alike, and ``scripts/fleetctl.py`` (standard library only) reads the port's
endpoint as it reads the JAX one. Every server binds 127.0.0.1:0, every
registry and provider a test installs is put back."""

import http.server
import importlib
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("aios_tpu", "aios_tpu_torch")


def both(module: str):
    return tuple(importlib.import_module(f"{p}.{module}") for p in PKGS)


def _clear_heartbeat_state(fleets):
    # the providers and the transfer address any earlier serve() in this
    # process registered (each package's own), so that both packages'
    # descriptors start alike
    for f in fleets:
        f.clear_stats_providers()
        f.clear_digest_providers()
        f.set_transfer_addr("")


@pytest.fixture(autouse=True)
def isolated():
    """Each package's process-wide fleet state starts clean and is put back
    after the test: the installed registry, providers, the transfer
    address, the edge namer and the breaker board."""
    fleets = both("obs.fleet")
    prev = [f.FLEET for f in fleets]
    _clear_heartbeat_state(fleets)
    yield
    for f, p in zip(fleets, prev):
        if f.FLEET is not None and f.FLEET is not p:
            f.FLEET.stop()
        f.install(p)
    _clear_heartbeat_state(fleets)
    for net in both("faults.net"):
        net._reset()
    for breaker in both("fleet.breaker"):
        breaker.reset()


class _Reg:
    """A stand-in metrics registry whose exposition is fixed text."""

    def __init__(self, text: str) -> None:
        self.text = text

    def render(self) -> str:
        return self.text


def _registry(fleet, now, text="", **cfg):
    c = fleet.FleetConfig()
    c.suspect_secs = cfg.get("suspect_secs", 5.0)
    c.dead_secs = cfg.get("dead_secs", 10.0)
    c.peers = ()
    return fleet.FleetRegistry(
        {"host": "hostA", "role": "runtime", "rank": "0", "version": "t"},
        "127.0.0.1:9100", cfg=c, registry=_Reg(text) if text else None,
        clock=lambda: now[0])


def _desc(host, addr="127.0.0.1:9101", **extra):
    return {"host": host, "role": "runtime", "rank": "1", "version": "t",
            "metrics_addr": addr, **extra}


def _pinned(monkeypatch):
    """The live SLO and devprof views out of the descriptors: their state
    belongs to whatever ran before in this process."""
    for f in both("obs.fleet"):
        monkeypatch.setattr(f, "_self_slo", lambda: {})
        monkeypatch.setattr(f, "_self_capacity", lambda: {})


def _journal(reg):
    return [{k: v for k, v in e.items() if k != "at"} for e in reg.journal()]


def _members(reg):
    return [{k: v for k, v in m.items() if k != "pid"} for m in reg.members()]


# -- config and identity ------------------------------------------------------------


@pytest.mark.parametrize("env", [
    {},
    {"AIOS_TPU_FLEET": "1"},
    {"AIOS_TPU_FLEET_PEERS": "10.0.0.1:9100, 10.0.0.2:9100",
     "AIOS_TPU_FLEET_INTERVAL_SECS": "0.5", "AIOS_TPU_FLEET_SUSPECT_SECS": "2",
     "AIOS_TPU_FLEET_DEAD_SECS": "4", "AIOS_TPU_FLEET_SCRAPE_TIMEOUT": "x"},
])
def test_config_reads_the_environment_alike(monkeypatch, env):
    for k in ("AIOS_TPU_FLEET", "AIOS_TPU_FLEET_PEERS", "AIOS_TPU_COORDINATOR",
              "AIOS_TPU_MULTIHOST"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jf, pf = both("obs.fleet")
    j, p = jf.FleetConfig(), pf.FleetConfig()
    assert vars(j) == vars(p)
    assert (j.active(), j.seed_peers()) == (p.active(), p.seed_peers())


def test_no_coordinator_seeds_the_port(monkeypatch):
    """The listed hunk: parallel/ is not ported, so the multihost
    coordinator seeds the JAX registry and not the port's."""
    monkeypatch.delenv("AIOS_TPU_FLEET_PEERS", raising=False)
    monkeypatch.setenv("AIOS_TPU_COORDINATOR", "10.1.2.3:8476")
    monkeypatch.setenv("AIOS_TPU_NUM_PROCESSES", "2")
    monkeypatch.setenv("AIOS_TPU_PROCESS_ID", "1")
    monkeypatch.setenv("AIOS_TPU_FLEET_SEED_PORT", "9200")
    jf, pf = both("obs.fleet")
    assert jf.FleetConfig().seed_peers() == ("10.1.2.3:9200",)
    assert pf.FleetConfig().seed_peers() == ()
    assert jf.process_identity("runtime")["rank"] == "1"
    assert pf.process_identity("runtime")["rank"] == "0"


def test_process_identity_and_its_gauge_alike(monkeypatch):
    for k in ("AIOS_TPU_FLEET_HOST", "AIOS_TPU_FLEET_ROLE", "AIOS_TPU_COORDINATOR",
              "AIOS_TPU_MULTIHOST"):
        monkeypatch.delenv(k, raising=False)
    jf, pf = both("obs.fleet")
    assert jf.process_identity("runtime") == pf.process_identity("runtime")
    monkeypatch.setenv("AIOS_TPU_FLEET_HOST", "hostX")
    monkeypatch.setenv("AIOS_TPU_FLEET_ROLE", "decode")
    ident = pf.stamp_process_info("runtime")
    assert ident == jf.process_identity("runtime")
    assert ident["host"] == "hostX" and ident["role"] == "decode"
    from aios_tpu_torch.obs import instruments

    assert instruments.PROCESS_INFO.labels(**ident).value == 1.0


# -- the membership state machine -----------------------------------------------------


def _lifecycle(fleet):
    now = [100.0]
    reg = _registry(fleet, now)
    out = [reg.receive(_desc("hostB"))["peers"]]
    out.append(_members(reg))
    for t in (104.0, 106.0, 106.5, 111.0, 200.0):
        out.append(reg.tick(now=t))
    now[0] = 200.0
    reg.receive(_desc("hostB"))
    reg.receive(_desc("hostC", addr="127.0.0.1:9102"))
    out.append(_members(reg))
    out.append(reg._scrape_targets())
    out.append(reg.tick(now=209.0))
    out.append(reg._scrape_targets())
    out.append(_journal(reg))
    out.append(reg.health_summary())
    return out


def test_lifecycle_journal_and_tables_equal_jax(monkeypatch):
    _pinned(monkeypatch)
    jax_out, port_out = (_lifecycle(f) for f in both("obs.fleet"))
    assert port_out == jax_out
    journal = port_out[-2]
    assert [(e["host"], e["from"], e["to"]) for e in journal] == [
        ("hostA", "", "up"), ("hostB", "", "up"), ("hostB", "up", "suspect"),
        ("hostB", "suspect", "dead"), ("hostB", "dead", "up"), ("hostC", "", "up"),
        ("hostB", "up", "suspect"), ("hostC", "up", "suspect")]


def test_journal_is_bounded_alike(monkeypatch):
    _pinned(monkeypatch)
    out = []
    for f in both("obs.fleet"):
        now = [0.0]
        reg = _registry(f, now)
        for i in range(300):
            now[0] = i * 100.0
            reg.receive(_desc("hostB"))
            reg.tick(now=now[0] + 50.0)
            reg.tick(now=now[0] + 99.0)
        assert len(reg.journal()) == f._MAX_JOURNAL
        out.append(_journal(reg))
    assert out[0] == out[1]


def test_gossip_and_rollup_equal_jax(monkeypatch):
    _pinned(monkeypatch)
    out = []
    for f in both("obs.fleet"):
        now = [0.0]
        reg = _registry(f, now)
        reg.receive(_desc("hostB", slo={"worst_burn": 3.5,
                                        "attainment": {"m": {"ttft": 0.91, "tpot": 0.99}}}))
        reply = reg.receive(_desc("hostC", addr="127.0.0.1:9102", slo={
            "worst_burn": 0.2, "attainment": {"m": {"ttft": 0.99, "tpot": 0.97}}}))
        out.append((reply["peers"], reply["member"]["host"], reg.health_summary()))
    assert out[0] == out[1]
    assert out[1][0] == ["127.0.0.1:9101", "127.0.0.1:9102"]
    assert out[1][2]["worst_burn"] == {"host": "hostB", "burn": 3.5}
    assert out[1][2]["attainment"] == {"ttft": 0.91, "tpot": 0.97}


def test_heartbeat_carries_pools_digest_and_transfer_address(monkeypatch):
    _pinned(monkeypatch)
    out = []
    digest = {"m": {"page": 128, "tails": {"ab12cd34ef567890": 3}}}
    level = {"v": 0}
    for f in both("obs.fleet"):
        f.add_stats_provider(lambda: {"m": {"degrade_level": level["v"]}})
        f.add_stats_provider(lambda: 1 / 0)
        f.add_digest_provider(lambda: digest)
        f.set_transfer_addr("1.2.3.4:9400")
        now = [100.0]
        reg = _registry(f, now)
        level["v"] = 2
        desc = reg.self_descriptor()
        out.append(({k: v for k, v in desc.items() if k != "pid"}, _members(reg)))
        level["v"] = 0
    assert out[0] == out[1]
    desc, rows = out[1]
    assert desc["kvx_addr"] == "1.2.3.4:9400" and desc["gprefix"] == digest
    assert desc["pools"]["m"] == {"degrade_level": 2} and "provider" in desc["pools"]["_error"]
    assert desc["phase"] == "serving" and rows[0]["pools"]["m"]["degrade_level"] == 2


# -- federation and stitching ---------------------------------------------------------

EXPO = """\
# HELP aios_tpu_rpc_requests_total RPCs
# TYPE aios_tpu_rpc_requests_total counter
aios_tpu_rpc_requests_total{service="runtime"} 4
# HELP aios_tpu_queue_wait_seconds waits
# TYPE aios_tpu_queue_wait_seconds histogram
aios_tpu_queue_wait_seconds_bucket{le="1"} 2
aios_tpu_queue_wait_seconds_bucket{le="+Inf"} 3
aios_tpu_queue_wait_seconds_sum 1.5
aios_tpu_queue_wait_seconds_count 3
up 1
"""
PEER_EXPO = """\
# HELP aios_tpu_rpc_requests_total RPCs from B
# TYPE aios_tpu_rpc_requests_total counter
aios_tpu_rpc_requests_total{service="runtime"} 9
aios_tpu_already{host="elsewhere",x="1"} 2
"""


def _timeline(model, request_id, trace_id, t=100.0):
    return {"model": model, "request_id": request_id, "tenant": "t", "state": "completed",
            "submitted_at": t, "duration_ms": 5.0, "queue_wait_ms": 1.0,
            "trace_id": trace_id, "events": [{"t_ms": 0.0, "kind": "admission"}]}


def test_relabel_and_merge_equal_jax():
    jf, pf = both("obs.fleet")
    for host in ("h1", "h2"):
        for text in (EXPO, PEER_EXPO, ""):
            assert pf.relabel_exposition(text, host) == jf.relabel_exposition(text, host)
    sources = [("h1", EXPO), ("h2", PEER_EXPO)]
    assert pf.merge_expositions(sources) == jf.merge_expositions(sources)


def test_stitch_chrome_traces_equal_jax():
    jf, pf = both("obs.fleet")
    tls = {"hostA": [_timeline("m", "r1", "T")],
           "hostB": [_timeline("m", "r2", "T", 100.002), _timeline("n", "r3", "T", 99.0)]}
    merged = pf.stitch_chrome_traces(tls)
    assert merged == jf.stitch_chrome_traces(tls)
    names = {e["args"]["name"] for e in merged["traceEvents"] if e.get("name") == "process_name"}
    assert names == {"host:hostA model:m", "host:hostB model:m", "host:hostB model:n"}


class _Peer:
    """A member's HTTP endpoint stand-in on 127.0.0.1:0: fixed /metrics,
    /debug/requests and /debug/tsdb answers; ``fail`` makes every GET 500."""

    def __init__(self):
        peer = self
        self.fail = False
        self.paths = []

        class H(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
                peer.paths.append(self.path)
                if peer.fail:
                    self.send_error(500)
                    return
                if self.path == "/metrics":
                    body, ctype = PEER_EXPO.encode(), "text/plain"
                elif self.path.startswith("/debug/requests"):
                    tls = [_timeline("m", "r2", "T")] if "trace=T&" in self.path else []
                    body = json.dumps({"requests": tls}).encode()
                    ctype = "application/json"
                else:
                    body = json.dumps({"series": [{"points": [[1.0, 2.0]]}]}).encode()
                    ctype = "application/json"
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.addr = f"127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.fixture
def peer():
    p = _Peer()
    yield p
    p.close()


def _federation(fleet, breaker, peer):
    now = [0.0]
    reg = _registry(fleet, now, text=EXPO)
    reg.receive(_desc("hostB", addr=peer.addr))
    out = [reg.federate(), reg.stitch("T"), reg.stitch("nobody-has-this"),
           reg.federate_tsdb({"metric": ["aios_tpu_x"]})]
    peer.fail = True
    out.append(reg.federate())
    out.append(breaker.BOARD.snapshot()["hostB"]["state"])
    peer.fail = False
    return out


def test_federation_stitch_and_tsdb_fan_out_equal_jax(monkeypatch, peer):
    _pinned(monkeypatch)
    out = []
    for f, b, tsdb in zip(both("obs.fleet"), both("fleet.breaker"), both("obs.tsdb")):
        b.reset()
        monkeypatch.setattr(tsdb, "handle_query", lambda q: ({"local": sorted(q)}, 200))
        out.append(_federation(f, b, peer))
    assert out[0] == out[1]
    fed, stitched, empty, hosts, failed, state = out[1]
    assert 'aios_tpu_rpc_requests_total{host="hostB",service="runtime"} 9' in fed
    assert 'aios_tpu_rpc_requests_total{host="hostA",service="runtime"} 4' in fed
    assert {e["args"]["name"] for e in stitched["traceEvents"]
            if e.get("name") == "process_name"} == {"host:hostB model:m"}
    assert empty == {"traceEvents": [], "displayTimeUnit": "ms"}
    assert sorted(hosts["hosts"]) == ["hostA", "hostB"]
    assert 'host="hostB"' not in failed and state == "closed"


def test_announce_rounds_over_http_converge_alike(monkeypatch):
    """Two registries of one package on real endpoints: B seeded with A
    announces, A learns B and announces back; the tables agree with the
    JAX package's pair run the same way."""
    _pinned(monkeypatch)
    out = []
    for pkg in PKGS:
        fleet = importlib.import_module(f"{pkg}.obs.fleet")
        http_mod = importlib.import_module(f"{pkg}.obs.http")
        servers, regs = [], []
        now = [0.0]
        try:
            for host in ("hostA", "hostB"):
                server, port = http_mod.start_metrics_server(port=0)
                servers.append(server)
                c = fleet.FleetConfig()
                c.peers = ()
                regs.append(fleet.FleetRegistry(
                    {"host": host, "role": "runtime", "rank": "0", "version": "t"},
                    f"127.0.0.1:{port}", cfg=c, registry=_Reg(EXPO), clock=lambda: now[0]))
            a, b = regs
            b._add_peer(a.metrics_addr)
            fleet.install(a)  # the endpoint routes to the installed registry
            b.announce_once()
            fleet.install(b)
            a.announce_once()
            rows = [[(m["host"], m["state"], m["self"]) for m in r.members()] for r in regs]
            out.append((rows, [[(e["host"], e["to"]) for e in r.journal()] for r in regs]))
        finally:
            fleet.install(None)
            for s in servers:
                s.shutdown()
                s.server_close()
    assert out[0] == out[1]
    assert out[1][0] == [[("hostA", "up", True), ("hostB", "up", False)],
                         [("hostA", "up", False), ("hostB", "up", True)]]


# -- the HTTP routes ------------------------------------------------------------------


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _post(url, body: bytes):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": "application/json"})
    return _get(req)


def _routes(pkg, monkeypatch):
    fleet = importlib.import_module(f"{pkg}.obs.fleet")
    http_mod = importlib.import_module(f"{pkg}.obs.http")
    drain = importlib.import_module(f"{pkg}.fleet.drain")
    admission = importlib.import_module(f"{pkg}.serving.admission")
    slo = importlib.import_module(f"{pkg}.obs.slo")

    class Mgr:
        def ready_models(self):
            return []

    now = [0.0]
    server, port = http_mod.start_metrics_server(
        port=0, health_fn=lambda: slo.annotate_health({"status": "ok"}))
    url = f"http://127.0.0.1:{port}"
    out = []
    exits = []
    try:
        out.append(_get(url + "/fleet/members")[0])
        out.append(_post(url + "/fleet/drain", b"")[0])
        reg = _registry(fleet, now, text=EXPO)
        fleet.install(reg)
        status, body = _post(url + "/fleet/announce", json.dumps(_desc("httpB")).encode())
        out.append((status, json.loads(body)["member"]["host"], json.loads(body)["peers"]))
        out.append(_post(url + "/fleet/announce", b"[1,2]")[0])
        status, body = _get(url + "/fleet/members")
        data = json.loads(body)
        out.append((status, data["self"], [(m["host"], m["state"]) for m in data["members"]],
                    [(e["host"], e["to"]) for e in data["journal"]], data["summary"]))
        status, body = _get(url + "/metrics/fleet")
        out.append((status, body))
        out.append(_get(url + "/debug/trace/fleet")[0])
        # the rollup only: the status also reads the process's SLO engine,
        # whose breaches belong to whatever ran before in this process
        out.append(json.loads(_get(url + "/healthz")[1])["fleet"])
        coord = drain.arm(Mgr(), exit_fn=exits.append)
        status, body = _post(url + "/fleet/drain?timeout=0.05", b"")
        out.append((status, json.loads(body)))
        coord._thread.join(timeout=30)
        assert not coord._thread.is_alive()
        out.append((drain.phase(), exits, reg.members()[0]["phase"]))
    finally:
        drain.disarm()
        admission.set_host_draining(False)
        fleet.install(None)
        server.shutdown()
        server.server_close()
    return out


def test_fleet_routes_answer_alike(monkeypatch):
    _pinned(monkeypatch)
    jax_out, port_out = (_routes(p, monkeypatch) for p in PKGS)
    assert port_out == jax_out
    assert port_out[0] == 404 and port_out[1] == 404
    assert port_out[2] == (200, "hostA", ["127.0.0.1:9101"])
    assert port_out[3] == 400 and port_out[6] == 400
    assert port_out[8] == (202, {"phase": "draining", "host": "hostA"})
    assert port_out[9] == ("leaving", [0], "leaving")


def _fleetctl(port, *args):
    r = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "fleetctl.py"), *args,
                        "--target", f"127.0.0.1:{port}"], capture_output=True, text=True,
                       timeout=60, env={**os.environ, "OMP_NUM_THREADS": "1"})
    return r.returncode, json.loads(r.stdout.strip().splitlines()[-1])


def test_fleetctl_reads_the_port_as_it_reads_jax(monkeypatch):
    _pinned(monkeypatch)
    out = []
    for pkg in PKGS:
        fleet = importlib.import_module(f"{pkg}.obs.fleet")
        http_mod = importlib.import_module(f"{pkg}.obs.http")
        now = [0.0]
        reg = _registry(fleet, now)
        reg.receive(_desc("hostB", pools={"m": {"waiting": 1, "batch_occupancy": 0.5,
                                                "degrade_level": 2}},
                          slo={"worst_burn": 1.5}))
        reg.receive(_desc("hostC", addr="127.0.0.1:9102"))
        reg.tick(now=6.0)
        reg.receive(_desc("hostB"))
        fleet.install(reg)
        server, port = http_mod.start_metrics_server(port=0)
        try:
            got = []
            for args in (("status", "--json"), ("top", "--json"), ("status",),
                         ("drain-check", "--host", "hostC")):
                rc, body = _fleetctl(port, *args)
                for row in body.get("members", ()):
                    row.pop("pid", None)
                    row.pop("age_secs", None)
                for e in body.get("journal", ()):
                    e.pop("at", None)
                got.append((rc, body))
            out.append(got)
        finally:
            fleet.install(None)
            server.shutdown()
            server.server_close()
    assert out[0] == out[1]
    (rc, status), (rc_top, top) = out[1][:2]
    assert rc == 1 and rc_top == 1 and status["size"] == 3
    assert {m["host"]: m["state"] for m in status["members"]} == {
        "hostA": "up", "hostB": "up", "hostC": "suspect"}
    assert out[1][2][0] == 1 and out[1][3][0] == 0


def test_maybe_start_arms_only_when_configured(monkeypatch):
    _pinned(monkeypatch)
    _, pf = both("obs.fleet")
    for k in ("AIOS_TPU_FLEET", "AIOS_TPU_FLEET_PEERS"):
        monkeypatch.delenv(k, raising=False)
    pf.install(None)
    assert pf.maybe_start("runtime", 9999) is None and pf.FLEET is None
    monkeypatch.setenv("AIOS_TPU_FLEET", "1")
    monkeypatch.setenv("AIOS_TPU_FLEET_HOST", "armed")
    monkeypatch.setenv("AIOS_TPU_FLEET_INTERVAL_SECS", "60")
    reg = pf.maybe_start("runtime", 9999, host="0.0.0.0")
    assert reg is pf.FLEET and reg.metrics_addr == "127.0.0.1:9999"
    assert pf.maybe_start("runtime", 1) is reg  # idempotent
    assert reg.identity["host"] == "armed" and reg._thread is not None
    reg.stop()
    assert reg._thread is None


# -- three worker processes (slow tier) -------------------------------------------------


@pytest.mark.slow
def test_three_worker_processes_serve_the_disaggregated_round(tmp_path):
    """The twin of ``scripts/disagg_smoke.py`` on the port, through the card
    phase's own round on the CPU (``chip_smoke.fleet_round``): three
    ``python -m aios_tpu_torch.fleet.worker --device cpu`` processes; the
    stream handed to B, killed there (exit 17) and resumed on C equals the
    single-host reference token for token; exact route counts, whole
    pushes, C's restore and digest, federation, one trace stitched across A
    and C, and C's drain shedding with ``draining`` and ``draining_host``.
    Every child is reaped."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    out = chip_smoke.fleet_round(str(tmp_path), device="cpu", source="synthetic://tiny-test",
                                 context=1024, prompt_tokens=300, max_tokens=16,
                                 short_tokens=100, drain_tokens=600)
    assert out["first_difference"] is None and out["agreement"] == 1.0
    assert out["ref"]["ids"] == out["disagg"]["ids"] and len(out["ref"]["ids"]) == 16
    assert (out["b_status"], out["c_status"], out["a_status"]) == (17, 0, 0)
    assert out["routes"]["handoff_resume"] == 1.0 and out["pushed_pages"] == 4.0
    assert out["stitched_lanes"] == ["host:hostA", "host:hostC"]
    assert out["hosts"]["hostB"] is None and out["hosts"]["hostC"]["code"] == 0
