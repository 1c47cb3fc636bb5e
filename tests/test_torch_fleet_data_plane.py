"""The port's fleet data plane (``aios_tpu_torch/fleet/``) held to the JAX
package's on the same seeded inputs.

The KVX1 wire first: a page's packed payload, its crc32 and the
``PageChunk`` messages a push sends are byte for byte the JAX package's,
and each side's server takes the other's pages. Then gossip scoring and
decode-host picking on the same membership rows. Then the three-host rig
of ``tests/test_fleet_data_plane.py``, built once from each package in one
process (prefill host A, decode hosts B and C: a 1-replica pool each over
``tiny-test`` weights in f32, the port's carried over from the JAX ones, B
and C behind real KvTransfer gRPC servers on 127.0.0.1:0): the greedy
streams of a handoff, a seeded decode-host kill and resume, a failed push
and pull, no decode peer and a disarmed ``route_submit`` equal the JAX
package's token for token, with the same route and transfer counts.
"""

import importlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aios_tpu.engine import model as jm
from aios_tpu_torch.engine.weights import params_from_jax

torch.set_num_threads(1)

PKGS = ("aios_tpu", "aios_tpu_torch")
MODEL = "fleet-dp-test"
PAGE = 32


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def both(name: str):
    return tuple(mod(p, name) for p in PKGS)


def _entry(seed=0, dtype=np.float32, scales=False):
    rng = np.random.default_rng(seed)
    if dtype == np.int8:
        e = {"k": rng.integers(-128, 127, (2, 4, PAGE, 8), dtype=np.int8),
             "v": rng.integers(-128, 127, (2, 4, PAGE, 8), dtype=np.int8)}
    else:
        e = {"k": rng.standard_normal((2, 4, PAGE, 8)).astype(dtype),
             "v": rng.standard_normal((2, 4, PAGE, 8)).astype(dtype)}
    if scales:
        e["k_s"] = rng.standard_normal((2, 4, PAGE)).astype(np.float32)
        e["v_s"] = rng.standard_normal((2, 4, PAGE)).astype(np.float32)
    return e


def _h(i):
    return bytes([i]) * 32


# -- the KVX1 wire ---------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["f32", "int8_scales"])
def test_page_payload_and_crc_equal_jax(kind):
    e = _entry(7, np.int8, True) if kind == "int8_scales" else _entry(7)
    (jp, jk), (pp, pk) = ((mod(p, "engine.paged"), mod(p, "fleet.kvx")) for p in PKGS)
    payload = pp.pack_entry(e)
    assert payload == jp.pack_entry(e) and payload[:4] == b"KVX1"
    assert pp.HostPageStore._entry_crc(e) == jp.HostPageStore._entry_crc(e)
    triples = [(_h(i), pp.HostPageStore._entry_crc(x), pp.pack_entry(x))
               for i, x in ((1, e), (2, _entry(8)), (3, _entry(9)))]
    jchunks = [c.SerializeToString() for c in jk.entries_to_chunks(MODEL, triples)]
    pchunks = [c.SerializeToString() for c in pk.entries_to_chunks(MODEL, triples)]
    assert pchunks == jchunks


def test_chunk_budget_splits_alike(monkeypatch):
    monkeypatch.setenv("AIOS_TPU_FLEET_KVX_CHUNK_BYTES", str(70000))
    jk, pk = both("fleet.kvx")
    _, pp = both("engine.paged")
    triples = [(_h(i), pp.HostPageStore._entry_crc(_entry(i)), pp.pack_entry(_entry(i)))
               for i in range(1, 6)]
    sizes = [[len(e.payload) for e in c.entries] for c in pk.entries_to_chunks(MODEL, triples)]
    assert sizes == [[len(e.payload) for e in c.entries]
                     for c in jk.entries_to_chunks(MODEL, triples)]
    assert len(sizes) > 1


def test_receiving_end_catches_tampering_alike():
    from aios_tpu_torch.proto_gen import fleet_pb2

    _, pp = both("engine.paged")
    e = _entry(4)
    payload = pp.pack_entry(e)
    crc = pp.HostPageStore._entry_crc(e)
    tampered = payload[:-1] + bytes([payload[-1] ^ 0xFF])
    for kvx in both("fleet.kvx"):
        good = kvx.verify_entry(fleet_pb2.PageEntry(hash=_h(1), crc32=crc, payload=payload))
        assert all(np.array_equal(good[k], e[k]) for k in e)
        with pytest.raises(kvx.CrcMismatch):
            kvx.verify_entry(fleet_pb2.PageEntry(hash=_h(1), crc32=crc, payload=tampered))
        with pytest.raises(ValueError):
            kvx.verify_entry(fleet_pb2.PageEntry(hash=_h(1), crc32=crc,
                                                 payload=b"XXXX" + payload[4:]))


# -- gossip scoring and picking -------------------------------------------------------


def _digest_for(gprefix, hashes, page=PAGE, depth_from=1):
    return {"page": page,
            "tails": {gprefix.tail(h): depth_from + i for i, h in enumerate(hashes)}}


def _scores(pkg):
    g = mod(pkg, "fleet.gprefix")
    chain = [_h(i) for i in range(1, 6)]
    full = {MODEL: _digest_for(g, chain)}
    holed = {MODEL: _digest_for(g, [chain[0], chain[2], chain[3]])}
    out = [g.tail(chain[0]), g.score_tails(full[MODEL], chain),
           g.score_tails(holed[MODEL], chain), g.score_tails({}, chain),
           g.score_tails({"page": 0, "tails": {"ab": 1}}, chain)]
    peers = [
        {"host": "dead", "state": "dead", "kvx_addr": "a:1", "gprefix": full},
        {"host": "me", "state": "up", "self": True, "kvx_addr": "a:2", "gprefix": full},
        {"host": "mute", "state": "up", "kvx_addr": "", "gprefix": full},
        {"host": "leaving", "state": "up", "kvx_addr": "a:5", "gprefix": full,
         "phase": "leaving"},
        {"host": "shallow", "state": "up", "kvx_addr": "a:3", "gprefix": holed},
        {"host": "deep", "state": "up", "kvx_addr": "a:4", "gprefix": full},
    ]
    for rows in (peers, peers[:4], peers[:5]):
        p, r = g.best_peer(rows, MODEL, chain)
        out.append((p["host"] if p else None, r))
    mod(pkg, "fleet.breaker").reset()
    mod(pkg, "fleet.breaker").BOARD.record_failure("deep", "crc_mismatch")
    mod(pkg, "fleet.breaker").BOARD.record_failure("deep", "crc_mismatch")
    p, r = g.best_peer(peers, MODEL, chain)
    out.append((p["host"] if p else None, r))
    mod(pkg, "fleet.breaker").reset()
    return out


def test_gprefix_scores_and_best_peer_equal_jax(monkeypatch):
    monkeypatch.delenv("AIOS_TPU_FLEET_BREAKER_THRESHOLD", raising=False)
    out = [_scores(p) for p in PKGS]
    assert out[0] == out[1]
    assert out[1][1:5] == [5 * PAGE, PAGE, 0, 0]
    assert out[1][5:] == [("deep", 5 * PAGE), (None, 0), ("shallow", PAGE),
                          ("shallow", PAGE)]


def _picks(pkg):
    disagg = mod(pkg, "fleet.disagg")
    plane = disagg.DisaggPlane(None)
    rows = [
        {"host": "hostB", "role": "decode", "state": "up", "kvx_addr": "b:1",
         "pools": {MODEL: {"occupancy": 0.9, "waiting": 3}}},
        {"host": "hostC", "role": "decode", "state": "up", "kvx_addr": "c:1", "pools": {}},
        {"host": "hostD", "role": "mixed", "state": "up", "kvx_addr": "d:1", "pools": {}},
        {"host": "hostE", "role": "decode", "state": "suspect", "kvx_addr": "e:1"},
        {"host": "hostF", "role": "decode", "state": "up", "kvx_addr": "f:1",
         "phase": "draining"},
        {"host": "hostA", "role": "prefill", "state": "up", "kvx_addr": "a:1", "self": True},
    ]
    plane._members = lambda: rows
    return [plane.pick_decode(MODEL), plane.pick_decode(MODEL, exclude=["hostC"]),
            plane.pick_decode(MODEL, exclude=["hostB", "hostC"]),
            plane.pick_decode(MODEL, exclude=["hostB", "hostC", "hostD"])]


def test_pick_decode_equal_jax():
    out = [_picks(p) for p in PKGS]
    assert out[0] == out[1] == [("hostC", "c:1"), ("hostB", "b:1"), ("hostD", "d:1"), None]


# -- the three-host rig ---------------------------------------------------------------


class _MM:
    """ManagedModel stand-in: exactly the surface the fleet plane uses."""

    def __init__(self, name, engine, pool):
        self.name, self.engine, self.pool = name, engine, pool

    def submit(self, req, tenant="anonymous", deadline_s=None):
        return self.pool.submit(req, tenant=tenant, deadline_s=deadline_s)


class _Mgr:
    def __init__(self, models):
        self._models = models

    def get(self, name):
        return self._models.get(name)

    def ready_models(self):
        return list(self._models.values())


class Rig:
    """Prefill host A and decode hosts B and C of one package in this
    process: a 1-replica pool each over the same weights, B and C behind
    real KvTransfer servers on 127.0.0.1:0."""

    def __init__(self, pkg: str, jax_params):
        self.pkg = pkg
        rpc, services = mod(pkg, "rpc"), mod(pkg, "services")
        disagg, kvx, router = (mod(pkg, f"fleet.{n}") for n in ("disagg", "kvx", "router"))
        ContinuousBatcher = mod(pkg, "engine.batching").ContinuousBatcher
        serving = mod(pkg, "serving")
        cfg = mod(pkg, "engine.config").TINY_TEST.scaled(name=MODEL, max_context=256)
        if pkg == "aios_tpu":
            Engine = mod(pkg, "engine.engine").TPUEngine
            params, extra = jax_params, dict(cache_dtype=jnp.float32)
        else:
            Engine = mod(pkg, "engine.engine").TorchEngine
            params = params_from_jax(jax.tree.map(np.asarray, jax_params))
            extra = dict(cache_dtype=torch.float32, device="cpu")
        self.mms, self.servers, self.addrs = {}, [], {}
        try:
            for host in ("hostA", "hostB", "hostC"):
                engine = Engine(cfg, params, num_slots=2, max_context=256,
                                paged_pool_rows=256, page_size=PAGE,
                                prefix_host_bytes=32 << 20, **extra)
                pool = serving.ReplicaPool(
                    MODEL, [engine],
                    lambda e: ContinuousBatcher(e, chunk_steps=2, admit_chunk_steps=2),
                    serving.ServingConfig(replicas=1, failover_retries=2))
                mm = self.mms[host] = _MM(MODEL, engine, pool)
                if host != "hostA":
                    server = rpc.create_server(max_workers=8)
                    rpc.add_to_server(services.KVTRANSFER,
                                      disagg.DisaggService(_Mgr({MODEL: mm})), server)
                    port = server.add_insecure_port("127.0.0.1:0")
                    server.start()
                    self.servers.append(server)
                    self.addrs[host] = f"127.0.0.1:{port}"
        except BaseException:
            self.shutdown()
            raise
        kvx.register_kvx_metrics(MODEL)
        router.register_route_metrics(MODEL)
        self.plane = disagg.DisaggPlane(_Mgr({MODEL: self.mms["hostA"]}))
        self.plane._members = self.members

    def members(self, hosts=("hostB", "hostC")):
        return [{"host": h, "role": "decode", "state": "up", "self": False,
                 "kvx_addr": self.addrs[h], "pools": {}, "gprefix": {}} for h in hosts]

    def m(self, name):
        return mod(self.pkg, name)

    def counter(self, family, **labels):
        return getattr(self.m("obs.instruments"), family).labels(**labels).value

    def req(self, seed, rid, max_tokens=24, n=100):
        Request = self.m("engine.batching").Request
        return Request(prompt_ids=[(seed * 131 + i * 7) % 500 + 1 for i in range(n)],
                       max_tokens=max_tokens, temperature=0.0, request_id=rid)

    def ref(self, seed, rid, max_tokens=24):
        h = self.mms["hostA"].submit(self.req(seed, rid, max_tokens))
        toks = h.tokens()
        assert not h.aborted and len(toks) == max_tokens
        return toks

    def handoff(self, seed, rid, max_tokens=24):
        handle = self.m("fleet.disagg").HandoffHandle(
            self.plane, self.mms["hostA"], self.req(seed, rid, max_tokens), "t", None)
        return handle, handle.tokens()

    def shutdown(self):
        self.m("fleet.kvx").reset_channels()
        for s in self.servers:
            s.stop(grace=0.2)
        for mm in self.mms.values():
            mm.pool.shutdown()


@pytest.fixture(scope="module")
def jax_params():
    return jm.init_params(mod("aios_tpu", "engine.config").TINY_TEST.scaled(
        name=MODEL, max_context=256), jax.random.PRNGKey(0), dtype=jnp.float32)


@pytest.fixture(scope="module")
def rigs(jax_params):
    built = []
    try:
        for pkg in PKGS:
            built.append(Rig(pkg, jax_params))
        yield dict(zip(PKGS, built))
    finally:
        for r in built:
            r.shutdown()


@pytest.fixture(autouse=True)
def clean_plane():
    """Faults, the transfer address and the breaker boards of both packages
    put back after each test."""
    yield
    for pkg in PKGS:
        mod(pkg, "faults.inject").deactivate()
        mod(pkg, "obs.fleet").set_transfer_addr("")
        mod(pkg, "fleet.breaker").reset()
        mod(pkg, "fleet.disagg").disarm()


def _each(rigs, fn):
    """fn(rig) on the JAX rig, then on the port's; both results."""
    return fn(rigs["aios_tpu"]), fn(rigs["aios_tpu_torch"])


def test_bytes_per_row_and_exports_equal_jax(rigs):
    def run(rig):
        eng = rig.mms["hostA"].engine
        rig.ref(70, "dp-export-ref")
        ids = rig.req(70, "x").prompt_ids
        pairs = eng.export_prefix(ids)
        return (rig.m("fleet.router")._bytes_per_row(eng), eng.prefix_hashes(ids),
                [(h, {k: np.asarray(v) for k, v in e.items()}) for h, e in pairs],
                eng.prefix_digest(8))

    (jb, jh, jpairs, jd), (pb, ph, ppairs, pd) = _each(rigs, run)
    assert pb == jb and ph == jh and pd == jd
    assert [h for h, _ in ppairs] == [h for h, _ in jpairs] == jh
    for (_, je), (_, pe) in zip(jpairs, ppairs):
        assert sorted(pe) == sorted(je)
        for k in je:
            np.testing.assert_allclose(pe[k], je[k], rtol=1e-5, atol=1e-5)


def test_router_gates_equal_jax(rigs):
    def run(rig):
        mm = rig.mms["hostA"]
        route_ids = rig.req(90, "x").prompt_ids
        chain = mm.engine.prefix_hashes(route_ids)
        router = rig.plane.router
        rows = rig.members(("hostB",))
        rows[0]["gprefix"] = {MODEL: _digest_for(rig.m("fleet.gprefix"), chain)}
        router._peers = lambda: rows
        try:
            reason, detail = router.decide_pull(mm, route_ids)
            detail = {k: v for k, v in detail.items() if k != "addr"}
            router._peers = lambda: rig.members(("hostB",))
            return reason, detail, router.decide_pull(mm, route_ids)[0], len(chain)
        finally:
            del router._peers

    jax_out, port_out = _each(rigs, run)
    assert port_out == jax_out
    assert port_out[0] == "remote_pull" and port_out[2] == "no_peer" and port_out[3] == 3


def test_push_then_fetch_round_trip_equal_jax(rigs):
    def run(rig):
        kvx = rig.m("fleet.kvx")
        store_b = rig.mms["hostB"].engine.host_store
        chain = [_h(0x21), _h(0x22), _h(0x23)]
        pairs = [(h, _entry(i + 10)) for i, h in enumerate(chain)]
        before = rig.counter("FLEET_KVX_PAGES", model=MODEL, direction="push")
        accepted = kvx.push_chain(rig.addrs["hostB"], MODEL, pairs)
        pushed = rig.counter("FLEET_KVX_PAGES", model=MODEL, direction="push") - before
        got = kvx.fetch_chain(rig.addrs["hostB"], MODEL, chain)
        store_b.discard(chain)
        return accepted, pushed, [(h, {k: v.tobytes() for k, v in e.items()}) for h, e in got]

    jax_out, port_out = _each(rigs, run)
    assert port_out == jax_out and port_out[:2] == (3, 3) and len(port_out[2]) == 3


def test_each_side_takes_the_others_pages(rigs):
    """The wire is one protocol: the JAX client's push lands in the port's
    decode host and the port's fetch reads it back, and the other way
    round."""
    chain = [_h(0x51), _h(0x52)]
    pairs = [(h, _entry(i + 20)) for i, h in enumerate(chain)]
    jk, pk = both("fleet.kvx")
    for client, fetcher, server_rig in ((jk, pk, rigs["aios_tpu_torch"]),
                                        (pk, jk, rigs["aios_tpu"])):
        addr = server_rig.addrs["hostC"]
        assert client.push_chain(addr, MODEL, pairs) == 2
        got = fetcher.fetch_chain(addr, MODEL, chain)
        assert [h for h, _ in got] == chain
        for (_, e), (_, sent) in zip(got, pairs):
            assert all(e[k].tobytes() == sent[k].tobytes() for k in sent)
        server_rig.mms["hostC"].engine.host_store.discard(chain)


def test_transfer_failure_causes_equal_jax(rigs):
    def run(rig):
        kvx = rig.m("fleet.kvx")
        _, pp = both("engine.paged")
        e = _entry(30)
        payload = pp.pack_entry(e)
        tampered = payload[:-1] + bytes([payload[-1] ^ 0xFF])
        causes = ("crc_mismatch", "empty", "unavailable", "breaker_open")
        before = [rig.counter("FLEET_KVX_FAILURES", model=MODEL, cause=c) for c in causes]
        ack = kvx._stub(rig.addrs["hostB"]).Push(kvx.entries_to_chunks(
            MODEL, [(_h(0x31), pp.HostPageStore._entry_crc(e), tampered)]))
        out = [(ack.accepted, ack.rejected),
               rig.mms["hostB"].engine.host_store.peek_chain([_h(0x31)]),
               kvx.fetch_chain(rig.addrs["hostB"], MODEL, [_h(0x41)]),
               kvx.fetch_chain("127.0.0.1:1", MODEL, [_h(0x42)])]
        board = rig.m("fleet.breaker").BOARD
        for _ in range(3):
            board.record_failure("deadpeer", "unavailable")
        out.append(kvx.push_chain("127.0.0.1:1", MODEL, [(_h(0x43), e)], peer="deadpeer"))
        out.append([rig.counter("FLEET_KVX_FAILURES", model=MODEL, cause=c) - b
                    for c, b in zip(causes, before)])
        return out

    jax_out, port_out = _each(rigs, run)
    assert port_out == jax_out
    assert port_out == [(0, 1), 0, [], [], 0, [1.0, 1.0, 1.0, 1.0]]


# -- the streams -----------------------------------------------------------------------


def test_handoff_stream_equals_jax_and_the_reference(rigs):
    def run(rig):
        ref = rig.ref(50, "dp-ref-0")
        pushed = rig.counter("FLEET_KVX_PAGES", model=MODEL, direction="push")
        handoffs = rig.counter("FLEET_ROUTE", model=MODEL, reason="handoff")
        handle, out = rig.handoff(50, "dp-handoff-0")
        assert not handle.aborted and handle.ttft_ms > 0.0
        return (ref, out, rig.counter("FLEET_ROUTE", model=MODEL, reason="handoff") - handoffs,
                rig.counter("FLEET_KVX_PAGES", model=MODEL, direction="push") - pushed)

    jax_out, port_out = _each(rigs, run)
    assert port_out == jax_out
    ref, out, handoffs, pushed = port_out
    assert out == ref and handoffs == 1 and pushed == (100 - 1) // PAGE


def test_kill_and_resume_stream_equals_jax(rigs):
    """``fleet.host_kill=nth:3`` aborts decode host B at its third token; A
    re-hands prompt and every emitted token to C."""
    def run(rig):
        ref = rig.ref(51, "dp-ref-kill")
        resumed = rig.counter("FLEET_ROUTE", model=MODEL, reason="handoff_resume")
        rig.m("faults.inject").activate("seed=1;fleet.host_kill=nth:3")
        try:
            handle, out = rig.handoff(51, "dp-kill-0")
        finally:
            rig.m("faults.inject").deactivate()
        assert not handle.aborted
        return ref, out, rig.counter("FLEET_ROUTE", model=MODEL,
                                     reason="handoff_resume") - resumed

    jax_out, port_out = _each(rigs, run)
    assert port_out == jax_out
    assert port_out[1] == port_out[0] and port_out[2] == 1


def test_failed_push_and_pull_stream_equals_jax(rigs, monkeypatch):
    def run(rig):
        ref = rig.ref(52, "dp-ref-fb")
        kvx = rig.m("fleet.kvx")
        monkeypatch.setattr(kvx, "push_chain", lambda *a, **k: 0)
        rig.m("obs.fleet").set_transfer_addr("127.0.0.1:1")  # a dead source to pull from
        before = rig.counter("FLEET_KVX_FAILURES", model=MODEL, cause="unavailable")
        try:
            handle, out = rig.handoff(52, "dp-fb-0")
        finally:
            rig.m("obs.fleet").set_transfer_addr("")
            monkeypatch.undo()
        assert not handle.aborted
        return ref, out, rig.counter("FLEET_KVX_FAILURES", model=MODEL,
                                     cause="unavailable") - before

    jax_out, port_out = _each(rigs, run)
    assert port_out == jax_out
    assert port_out[1] == port_out[0] and port_out[2] >= 1


def test_no_decode_peer_stream_equals_jax(rigs):
    def run(rig):
        ref = rig.ref(53, "dp-ref-solo")
        fb = rig.counter("FLEET_ROUTE", model=MODEL, reason="fallback_local")
        rig.plane._members = lambda: []
        try:
            handle, out = rig.handoff(53, "dp-solo-0")
        finally:
            rig.plane._members = rig.members
        assert not handle.aborted
        return ref, out, rig.counter("FLEET_ROUTE", model=MODEL, reason="fallback_local") - fb

    jax_out, port_out = _each(rigs, run)
    assert port_out == jax_out
    assert port_out[1] == port_out[0] and port_out[2] == 1


def test_disarmed_route_submit_is_the_plain_submit(rigs):
    def run(rig):
        disagg = rig.m("fleet.disagg")
        assert disagg.PLANE is None
        out = disagg.route_submit(rig.mms["hostA"], rig.req(54, "dp-plain-0")).tokens()
        return out, rig.ref(54, "dp-plain-ref")

    jax_out, port_out = _each(rigs, run)
    assert port_out == jax_out and port_out[0] == port_out[1]


def test_armed_route_submit_by_role_equals_jax(rigs, monkeypatch):
    """Armed, a prefill host's route_submit hands off (or counts no_peer and
    serves locally); a decode host's is a plain submit."""
    def run(rig):
        disagg = rig.m("fleet.disagg")
        plane = disagg.arm(_Mgr({MODEL: rig.mms["hostA"]}))
        plane._members = rig.members
        out = []
        try:
            monkeypatch.setenv("AIOS_TPU_FLEET_ROLE", "prefill")
            h = disagg.route_submit(rig.mms["hostA"], rig.req(55, "dp-armed-0"))
            out.append((type(h).__name__, h.tokens()))
            plane._members = lambda: []
            before = rig.counter("FLEET_ROUTE", model=MODEL, reason="no_peer")
            h = disagg.route_submit(rig.mms["hostA"], rig.req(55, "dp-armed-1"))
            out.append((type(h).__name__ == "HandoffHandle", h.tokens(),
                        rig.counter("FLEET_ROUTE", model=MODEL, reason="no_peer") - before))
            monkeypatch.setenv("AIOS_TPU_FLEET_ROLE", "decode")
            h = disagg.route_submit(rig.mms["hostA"], rig.req(55, "dp-armed-2"))
            out.append((type(h).__name__ == "HandoffHandle", h.tokens()))
        finally:
            disagg.disarm()
            monkeypatch.delenv("AIOS_TPU_FLEET_ROLE")
        return out

    jax_out, port_out = _each(rigs, run)
    assert port_out == jax_out
    assert port_out[0][0] == "HandoffHandle" and port_out[1][2] == 1
    assert port_out[0][1] == port_out[1][1] == port_out[2][1]


def test_concurrent_handoffs_equal_jax(rigs):
    def run(rig):
        seeds = (60, 61, 62)
        refs = [rig.ref(s, f"dp-ref-c{s}", max_tokens=16) for s in seeds]
        handles = [rig.m("fleet.disagg").HandoffHandle(
            rig.plane, rig.mms["hostA"], rig.req(s, f"dp-conc-{s}", max_tokens=16), "t", None)
            for s in seeds]
        out = {}
        threads = [threading.Thread(target=lambda i=i, h=h: out.__setitem__(i, h.tokens()),
                                    daemon=True) for i, h in enumerate(handles)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive(), "a disaggregated stream did not end within 60 s"
        return refs, [out[i] for i in range(len(seeds))]

    jax_out, port_out = _each(rigs, run)
    assert port_out == jax_out and port_out[0] == port_out[1]


def test_prefill_rate_and_the_cost_gate_equal_jax(rigs, monkeypatch):
    """The router prices a pull off devprof's sampled prefill time (the
    port's ledger keeps the JAX ledger's ``mean_s("prefill")``): with
    recomputing cheap and the wire slow, a peer's deeper chain is declined
    as ``local``."""
    from types import SimpleNamespace

    monkeypatch.setenv("AIOS_TPU_FLEET_KVX_GBPS", "0.001")

    def run(rig):
        router, devprof = rig.m("fleet.router"), rig.m("obs.devprof")
        mm = rig.mms["hostA"]
        pool = SimpleNamespace(name="dp-rate", replicas=[
            SimpleNamespace(engine=SimpleNamespace(buckets=(128, 256)))])
        out = [router._prefill_rate(pool)]
        ledger = devprof.DevprofLedger(MODEL)  # held: the registry keeps it weakly
        for secs in (1e-5, 2e-5, 3e-5):
            ledger.sample("prefill", 128, secs)
        rate = router._prefill_rate(mm.pool)
        route_ids = rig.req(91, "x").prompt_ids
        chain = mm.engine.prefix_hashes(route_ids)
        rows = rig.members(("hostB",))
        rows[0]["gprefix"] = {MODEL: _digest_for(rig.m("fleet.gprefix"), chain)}
        rig.plane.router._peers = lambda: rows
        try:
            out += [rate, rig.plane.router.decide_pull(mm, route_ids)[0],
                    mm.engine.buckets[0]]
        finally:
            del rig.plane.router._peers
        del ledger
        return out

    jax_out, port_out = _each(rigs, run)
    assert port_out == jax_out
    # one prefill fills the smallest bucket, at the samples' mean of 2e-5 s
    assert port_out[0] == 0.0 and port_out[1] == pytest.approx(port_out[3] / 2e-5)
    assert port_out[2] == "local"
