"""The port's fleet fault domains held to the JAX package's: per-edge network
faults (``faults/net.py``) fire on the same sends under one seeded schedule,
the gRPC interceptor refuses and severs the same calls, the per-peer
breakers (``fleet/breaker.py``) walk the same transitions under one fake
clock, and the graceful drain (``fleet/drain.py``) walks the same phases,
sheds with the same causes and pushes the same hot pages."""

import importlib
import random
import threading

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

PKGS = ("aios_tpu", "aios_tpu_torch")
MODEL = "fleet-faults-test"


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def both(name: str):
    return tuple(mod(p, name) for p in PKGS)


@pytest.fixture(autouse=True)
def isolated(monkeypatch):
    """Each test runs as fleet host "hostA" with no schedule armed, a fresh
    edge namer, and both packages' boards, drains and admission gates put
    back after."""
    monkeypatch.setenv("AIOS_TPU_FLEET_HOST", "hostA")
    for pkg in PKGS:
        mod(pkg, "faults.inject").deactivate()
        mod(pkg, "faults.net")._reset()
    yield
    for pkg in PKGS:
        mod(pkg, "faults.inject").deactivate()
        mod(pkg, "faults.net")._reset()
        mod(pkg, "fleet.breaker").reset()
        mod(pkg, "fleet.drain").disarm()
        mod(pkg, "serving.admission").set_host_draining(False)


# -- per-edge network faults ------------------------------------------------------------

SCHEDULES = [
    "net.partition=nth:2,dst=hostB",
    "net.partition=nth:2,until=4,dst=hostB",
    "net.partition_oneway=nth:1,until=3,dst=hostC,surface=http",
    "seed=7;net.partition=prob:0.3;net.delay=prob:0.5,delay_ms=1",
    "seed=3;net.drop_after=nth:2,dst=hostB,after_msgs=1;net.partition=prob:0.2,dst=hostC",
    "net.drop_after=nth:1,dst=hostB,surface=rpc,after_msgs=2",
]


def _edge_script(pkg, spec):
    """One seeded schedule driven through every gate, in one fixed order of
    sends across three peers and both surfaces: what fired, where, at
    which hit."""
    net = mod(pkg, "faults.net")
    mod(pkg, "faults.inject").activate(spec)
    net.map_addr("10.0.0.2:9100", "hostB")
    rng = random.Random(11)
    out = []
    for _ in range(60):
        dst = rng.choice(["hostB", "hostC", "10.0.0.2:9100", "http://10.0.0.2:9100/x"])
        gate = rng.choice(["send_rpc", "send_http", "drop_http", "sever", "announce"])
        try:
            if gate == "send_rpc":
                net.check_send(dst, "rpc")
                got = "ok"
            elif gate == "send_http":
                net.check_send(dst, "http")
                got = "ok"
            elif gate == "drop_http":
                net.check_drop_response(dst)
                got = "ok"
            elif gate == "sever":
                got = list(net.sever_stream(dst, iter(range(4))))
            else:
                got = net.gate_announce(net.host_of(dst))
        except net.NetFault as e:
            got = (type(e).__name__, e.point, e.edge, e.hit, e.code().name)
        out.append((dst, gate, got))
    out.append(net.active_points())
    mod(pkg, "faults.inject").deactivate()
    return out


@pytest.mark.parametrize("spec", SCHEDULES)
def test_edge_schedule_fires_as_jax(spec):
    jax_out, port_out = (_edge_script(p, spec) for p in PKGS)
    assert port_out == jax_out
    # a refusal or a sever is a 5-tuple, a withheld announce a gate other
    # than (True, True)
    assert any(isinstance(g, tuple) and g != (True, True) for _, _, g in port_out[:-1]), (
        "nothing fired")


def test_net_points_are_the_jax_catalog():
    jn, pn = both("faults.net")
    ji, pi = both("faults.inject")
    assert pn.NET_POINTS == jn.NET_POINTS and pn.SURFACES == jn.SURFACES
    assert set(pn.NET_POINTS) <= set(pi.POINTS) and pi.POINTS == ji.POINTS


def test_solo_gates_are_no_ops():
    for net in both("faults.net"):
        net.check_send("hostB", "rpc")
        net.check_drop_response("hostB")
        stream = iter(range(3))
        assert net.sever_stream("hostB", stream) is stream
        assert net.gate_announce("hostB") == (True, True)
        assert net.active_points() == ()


class _Engine:
    """A transfer source: ``export_hashes`` answers seeded pages."""

    host_store = None

    def export_hashes(self, hashes, max_pages=0):
        out = []
        for i, h in enumerate(hashes):
            rng = np.random.default_rng(i)
            out.append((h, {"k": rng.standard_normal((2, 4, 32, 8)).astype(np.float32),
                            "v": rng.standard_normal((2, 4, 32, 8)).astype(np.float32)}))
        return out


class _Mgr:
    def __init__(self):
        self.engine = _Engine()

    def get(self, name):
        return self

    def ready_models(self):
        return []


def _interceptor_script(pkg, monkeypatch):
    """A KvTransfer server of ``pkg`` on 127.0.0.1:0 and fetches through
    ``pkg``'s client channel under schedules that refuse and sever."""
    rpc, services, kvx = mod(pkg, "rpc"), mod(pkg, "services"), mod(pkg, "fleet.kvx")
    inject = mod(pkg, "faults.inject")
    instruments = mod(pkg, "obs.instruments")
    monkeypatch.setenv("AIOS_TPU_FLEET_KVX_CHUNK_BYTES", "1")  # a message a page
    server = rpc.create_server(max_workers=4)
    rpc.add_to_server(services.KVTRANSFER, kvx.KvxService(_Mgr()), server)
    addr = f"127.0.0.1:{server.add_insecure_port('127.0.0.1:0')}"
    server.start()
    mod(pkg, "faults.net").map_addr(addr, "hostB")
    hashes = [bytes([i]) * 32 for i in range(1, 5)]
    causes = ("unavailable", "empty")
    out = []
    try:
        for spec in ("", "net.drop_after=nth:1,dst=hostB,after_msgs=2",
                     "net.partition=nth:1,dst=hostB,surface=rpc",
                     "net.partition=nth:1,dst=hostC"):
            if spec:
                inject.activate(spec)
            before = [instruments.FLEET_KVX_FAILURES.labels(model=MODEL, cause=c).value
                      for c in causes]
            got = kvx.fetch_chain(addr, MODEL, hashes)
            inject.deactivate()
            out.append(([h for h, _ in got],
                        [instruments.FLEET_KVX_FAILURES.labels(model=MODEL, cause=c).value - b
                         for c, b in zip(causes, before)]))
    finally:
        kvx.reset_channels()
        server.stop(grace=None)
    return out


def test_interceptor_refuses_and_severs_as_jax(monkeypatch):
    jax_out, port_out = (_interceptor_script(p, monkeypatch) for p in PKGS)
    assert port_out == jax_out
    whole = [bytes([i]) * 32 for i in range(1, 5)]
    assert port_out == [(whole, [0.0, 0.0]), (whole[:2], [1.0, 0.0]), ([], [1.0, 0.0]),
                        (whole, [0.0, 0.0])]


def test_asymmetric_partition_diverges_the_views_alike():
    out = []
    for pkg in PKGS:
        fleet = mod(pkg, "obs.fleet")
        now = [100.0]

        def registry(host):
            cfg = fleet.FleetConfig()
            cfg.suspect_secs, cfg.dead_secs, cfg.peers = 5.0, 10.0, ()
            return fleet.FleetRegistry({"host": host, "role": "runtime", "rank": "0",
                                        "version": "t"}, "127.0.0.1:9100", cfg=cfg,
                                       clock=lambda: now[0])

        a, b = registry("hostA"), registry("hostB")
        desc_b = {"host": "hostB", "role": "runtime", "rank": "1", "version": "t",
                  "metrics_addr": "127.0.0.1:9101"}
        desc_a = {"host": "hostA", "role": "runtime", "rank": "0", "version": "t",
                  "metrics_addr": "127.0.0.1:9100"}
        a.receive(desc_b)
        b.receive(desc_a)
        mod(pkg, "faults.inject").activate(
            "net.partition_oneway=nth:1,until=100,dst=hostB,surface=http")
        views = []
        for t in (103.0, 106.0, 109.0, 112.0):
            now[0] = t
            fold, reply = mod(pkg, "faults.net").gate_announce("hostB")
            if fold:
                a.receive(desc_b)
            if reply:
                b.receive(desc_a)
            a.tick(now=t)
            b.tick(now=t)
            views.append(({m["host"]: m["state"] for m in a.members()},
                          {m["host"]: m["state"] for m in b.members()}))
        mod(pkg, "faults.inject").deactivate()
        out.append(views)
    assert out[0] == out[1]
    assert out[1][-1] == ({"hostA": "up", "hostB": "up"}, {"hostA": "dead", "hostB": "up"})


# -- the breakers ------------------------------------------------------------------------


def _cfg(breaker, **over):
    cfg = breaker.BreakerConfig()
    cfg.threshold = over.get("threshold", 2.0)
    cfg.cooldown_secs = over.get("cooldown_secs", 5.0)
    cfg.max_cooldown_secs = over.get("max_cooldown_secs", 60.0)
    cfg.probes = over.get("probes", 2)
    cfg.lat_floor_secs = over.get("lat_floor_secs", 0.0)
    return cfg


def _breaker_script(pkg, seed, **over):
    """A seeded run of calls on three peers under one fake clock: every
    allow/record and the states, snapshots and gauge values after each."""
    breaker = mod(pkg, "fleet.breaker")
    instruments = mod(pkg, "obs.instruments")
    now = [0.0]
    board = breaker.BreakerBoard(cfg=_cfg(breaker, **over), clock=lambda: now[0])
    for p in ("hostB", "hostC", "hostD"):  # the gauge as no earlier test left it
        instruments.FLEET_PEER_BREAKER.labels(host="hostA", peer=p).set(0.0)
    rng = random.Random(seed)
    out = []
    for _ in range(200):
        now[0] += rng.choice([0.0, 0.5, 1.0, 3.0, 7.0])
        peer = rng.choice(["hostB", "hostC", "hostD", ""])
        op = rng.random()
        if op < 0.35:
            out.append(("allow", peer, board.allow(peer)))
        elif op < 0.7:
            cause = rng.choice(["crc_mismatch", "timeout", "unavailable", "decode_error",
                                "gray_latency", "other"])
            board.record_failure(peer, cause)
            out.append(("fail", peer, cause))
        else:
            lat = rng.choice([0.001, 0.02, 2.0])
            board.record_ok(peer, lat)
            out.append(("ok", peer, lat))
        out.append((board.state(peer), board.quarantined(peer)))
    out.append(board.snapshot())
    out.append({p: instruments.FLEET_PEER_BREAKER.labels(host="hostA", peer=p).value
                for p in ("hostB", "hostC", "hostD")})
    return out


@pytest.mark.parametrize("seed,over", [(1, {}), (2, {"threshold": 3.0, "probes": 1}),
                                       (3, {"lat_floor_secs": 0.01}),
                                       (4, {"cooldown_secs": 2.0, "max_cooldown_secs": 4.0})])
def test_breaker_transitions_equal_jax(seed, over):
    jax_out, port_out = (_breaker_script(p, seed, **over) for p in PKGS)
    assert port_out == jax_out
    states = {o[0] for o in port_out if isinstance(o, tuple) and len(o) == 2}
    assert {"closed", "open", "half_open"} <= states


def test_breaker_reads_its_knobs_alike(monkeypatch):
    for k, v in (("AIOS_TPU_FLEET_BREAKER_THRESHOLD", "4"),
                 ("AIOS_TPU_FLEET_BREAKER_COOLDOWN_SECS", "2.5"),
                 ("AIOS_TPU_FLEET_BREAKER_MAX_COOLDOWN_SECS", "x"),
                 ("AIOS_TPU_FLEET_BREAKER_PROBES", "5"),
                 ("AIOS_TPU_FLEET_BREAKER_LAT_SECS", "0.2")):
        monkeypatch.setenv(k, v)
    jb, pb = both("fleet.breaker")
    assert vars(pb.BreakerConfig()) == vars(jb.BreakerConfig()) == {
        "threshold": 4.0, "cooldown_secs": 2.5, "max_cooldown_secs": 60.0, "probes": 5,
        "lat_floor_secs": 0.2}


# -- the graceful drain ------------------------------------------------------------------


class _Pool:
    def __init__(self, log):
        self.log = log

    def drain(self, timeout):
        self.log.append(("drain", round(timeout, 1) if timeout > 1 else "short"))
        return True


class _Index:
    def __init__(self, hashes):
        self.hashes = hashes

    def digest(self, limit):
        return [(h, i + 1) for i, h in enumerate(self.hashes[:limit])]


class _HotEngine:
    """Two pool-resident pages and a host tier of three more (one of
    them also resident)."""

    def __init__(self, paged):
        self.prefix_index = _Index([bytes([1]) * 32, bytes([2]) * 32])
        self.host_store = paged.HostPageStore(1 << 20)
        for i in (2, 3, 4):
            self.host_store.put(bytes([i]) * 32, self._entry(i))

    @staticmethod
    def _entry(i):
        rng = np.random.default_rng(i)
        return {"k": rng.standard_normal((2, 4, 32, 8)).astype(np.float32),
                "v": rng.standard_normal((2, 4, 32, 8)).astype(np.float32)}

    def export_hashes(self, hashes, max_pages=0):
        return [(h, self._entry(h[0])) for h in hashes[:max_pages or None]]


class _Model:
    def __init__(self, name, log, paged):
        self.name, self.pool, self.engine = name, _Pool(log), _HotEngine(paged)


class _Manager:
    def __init__(self, models):
        self.models = models

    def ready_models(self):
        return list(self.models)


def _drain_script(pkg, monkeypatch):
    drain, disagg, kvx = (mod(pkg, f"fleet.{n}") for n in ("drain", "disagg", "kvx"))
    admission = mod(pkg, "serving.admission")
    paged = mod(pkg, "engine.paged")
    log, pushes = [], []
    monkeypatch.setattr(kvx, "push_chain", lambda addr, model, pairs, peer="": pushes.append(
        (addr, model, [(h, {k: v.tobytes() for k, v in e.items()}) for h, e in pairs], peer))
        or len(pairs))
    manager = _Manager([_Model("m1", log, paged), _Model("m2", log, paged)])
    plane = disagg.arm(manager)
    plane._members = lambda: [{"host": "hostC", "role": "decode", "state": "up",
                               "kvx_addr": "c:1", "pools": {}}]
    exits = []
    coord = drain.arm(manager, exit_fn=exits.append)
    out = [drain.phase(), drain.draining()]
    entered = threading.Event()
    release = threading.Event()

    def held_drain(timeout):
        entered.set()
        release.wait(10)
        log.append(("drain", "held"))
        return True

    manager.models[0].pool.drain = held_drain
    monkeypatch.setenv("AIOS_TPU_FLEET_DRAIN_PUSH_BYTES", str(3 * 16384))  # three pages
    out.append(drain.request_drain(30.0))
    assert entered.wait(10), "the drain never reached the first pool"
    out.append((drain.phase(), admission.host_draining(), drain.request_drain()))
    adm = admission.AdmissionController(mod(pkg, "serving.config").ServingConfig(), "m2")
    try:
        adm.check_host_drain()
        out.append("admitted")
    except admission.AdmissionError as e:
        out.append((e.cause, e.retriable, e.retry_after_ms))
    release.set()
    coord._thread.join(timeout=30)
    assert not coord._thread.is_alive()
    out += [drain.phase(), exits, log, pushes, drain.request_drain()]
    return out


def test_drain_walks_the_same_phases_and_pushes_as_jax(monkeypatch):
    jax_out, port_out = (_drain_script(p, monkeypatch) for p in PKGS)
    assert port_out == jax_out
    assert port_out[:3] == ["serving", False, "draining"]
    assert port_out[3] == ("draining", True, "draining")
    assert port_out[4][:2] == ("draining_host", True)
    assert port_out[5:7] == ["leaving", [0]]
    assert port_out[7] == [("drain", "held"), ("drain", 30.0)]
    assert [(a, m, [h[0] for h, _ in pairs], peer) for a, m, pairs, peer in port_out[8]] == [
        ("c:1", "m1", [1, 2, 4], "hostC"), ("c:1", "m2", [1, 2, 4], "hostC")]


def test_drain_knobs_and_unarmed_surface_alike(monkeypatch):
    monkeypatch.setenv("AIOS_TPU_FLEET_DRAIN_TIMEOUT_SECS", "-3")
    monkeypatch.setenv("AIOS_TPU_FLEET_DRAIN_PUSH_BYTES", "1e6")
    jd, pd = both("fleet.drain")
    assert (pd.drain_timeout_secs(), pd.drain_push_bytes()) == (
        jd.drain_timeout_secs(), jd.drain_push_bytes()) == (0.0, 1000000)
    for d in (jd, pd):
        d.disarm()
        assert (d.phase(), d.draining(), d.request_drain()) == ("serving", False, "serving")
    assert pd.DRAIN_PHASES == jd.DRAIN_PHASES
