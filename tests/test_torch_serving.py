"""The port's serving plane (``aios_tpu_torch/serving``) against the JAX
package's (``aios_tpu/serving``), on the CPU.

Policy: one scripted set of stub replicas (prefix overlap, outstanding
tokens, queue depth, decode rate) fed to both packages' ``Router``,
``AdmissionController`` and ``ReplicaPool`` with the same prompts, task ids,
tenants, deadlines and priorities, and one fake clock shared by both token
buckets: every route (reason and replica), every shed (cause, retry-after,
whether it is retriable), every quota debit and the pools' tallies equal.
Then real 2-replica pools over ``synthetic://tiny-test`` weights, the JAX
pool's carried across by ``params_from_jax``: route decisions and greedy
streams equal, and the port's replicas share one copy of the weights. Then
the port's gRPC service: RESOURCE_EXHAUSTED / INVALID_ARGUMENT /
UNAVAILABLE with their ``retry-after-ms``, ``tenant_by=task_prefix``,
HealthCheck's pool stats, hot swaps and drains (the cases of
tests/test_serving.py that need no JAX internals).

Tolerances: every decision, number and token exactly."""

import dataclasses
import threading
import time
import types

import grpc
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aios_tpu.engine import model as jm
from aios_tpu.engine.batching import ContinuousBatcher as JaxBatcher
from aios_tpu.engine.batching import Request as JaxRequest
from aios_tpu.engine.config import TINY_TEST as JAX_TINY
from aios_tpu.engine.engine import TPUEngine
from aios_tpu.serving import admission as jadm
from aios_tpu.serving import pool as jpool
from aios_tpu.serving import router as jrouter
from aios_tpu.serving.config import ServingConfig as JaxServingConfig
from aios_tpu_torch import rpc, services
from aios_tpu_torch.engine import model as tmodel
from aios_tpu_torch.engine.batching import ContinuousBatcher, Request
from aios_tpu_torch.engine.config import TINY_TEST
from aios_tpu_torch.engine.engine import TorchEngine
from aios_tpu_torch.engine.weights import params_from_jax
from aios_tpu_torch.proto_gen import common_pb2, runtime_pb2
from aios_tpu_torch.runtime.model_manager import ModelManager
from aios_tpu_torch.runtime.service import serve
from aios_tpu_torch.serving import admission as tadm
from aios_tpu_torch.serving import pool as tpool
from aios_tpu_torch.serving import router as trouter
from aios_tpu_torch.serving.config import ServingConfig

# The shapes here are tiny: one intra-op thread is faster and leaves the
# cores to the other test workers.
torch.set_num_threads(1)

PACKAGES = {"jax": (jadm, jpool, jrouter, JaxServingConfig, JaxRequest),
            "port": (tadm, tpool, trouter, ServingConfig, Request)}


# -- the policy: stub replicas through both packages ---------------------------


class StubEngine:
    """What the pool reads of an engine, set by the script."""

    def __init__(self, max_context: int = 256, num_slots: int = 2) -> None:
        self.max_context, self.num_slots = max_context, num_slots
        self.active = np.zeros(num_slots, dtype=bool)
        self.overlap = 0
        self.mega_ticks = 0
        self.closed = False

    def prefix_hashes(self, ids):
        return []

    def prefix_overlap_rows(self, ids, hashes=None):
        return self.overlap

    def stats(self):
        return {"decode_steps": 3, "batch_occupancy": float(self.active.mean())}

    def close(self):
        self.closed = True


class StubBatcher:
    """What the pool reads of a batcher, set by the script; ``submitted``
    lists the request ids that reached it."""

    def __init__(self, engine: StubEngine) -> None:
        self.engine = engine
        self.outstanding = self.queue = 0
        self.tps = 0.0
        self.submitted = []
        self._closed = False
        self.last_error = None
        self._thread = types.SimpleNamespace(is_alive=lambda: True)
        self.active_count = self.completed = self.cancellations = self.pool_evictions = 0
        self.degrade_spec = self.degrade_jump = False
        self.queue_wait_obs = None

    def outstanding_tokens(self):
        return self.outstanding

    def queue_depth(self):
        return self.queue

    def tokens_per_second(self):
        return self.tps

    def submit(self, req):
        self.submitted.append(req.request_id)
        return types.SimpleNamespace(cancel=lambda: None)

    def shutdown(self):
        self._closed = True


class FakeClock:
    def __init__(self) -> None:
        self.t = 1000.0

    def monotonic(self) -> float:
        return self.t


@pytest.fixture()
def clock(monkeypatch):
    """One fake monotonic clock for both packages' token buckets."""
    c = FakeClock()
    for adm in (jadm, tadm):
        monkeypatch.setattr(adm, "time", c)
    return c


def _script(seed: int, n: int = 80):
    """A seeded sequence of steps: each replica's live numbers, a request
    (prompt, budget, task id, tenant, deadline, priority), the clock's
    advance, and now and then a crash or a degrade-ladder move."""
    rng = np.random.default_rng(seed)
    steps = []
    for i in range(n):
        steps.append(dict(
            replicas=[dict(overlap=int(rng.choice([0, 0, 32, 96, 200])),
                           outstanding=int(rng.integers(0, 600)),
                           queue=int(rng.integers(0, 5)),
                           tps=float(rng.choice([0.0, 5.0, 40.0, 400.0])))
                      for _ in range(3)],
            prompt=[int(t) for t in rng.integers(1, 200, int(rng.integers(4, 400)))],
            max_tokens=int(rng.choice([1, 16, 64, 300, 50_000])),
            task=str(rng.choice(["", "", "t1", "t2", "agent7-3", "t1"])),
            tenant=str(rng.choice(["alpha", "beta", "gamma"])),
            deadline=[None, 0.2, 2.0, 30.0][int(rng.integers(0, 4))],
            priority=int(rng.integers(0, 2)),
            advance=float(rng.uniform(0.0, 3.0)),
            crash=int(rng.integers(0, 3)) if rng.random() < 0.05 else None,
            degrade=int(rng.integers(0, 4)) if rng.random() < 0.08 else None,
        ))
    return steps


def _pool(pkg: str, cfg_kw: dict):
    _, pool_mod, _, Cfg, _ = PACKAGES[pkg]
    engines = [StubEngine() for _ in range(3)]
    return pool_mod.ReplicaPool(f"stub-{pkg}", engines, StubBatcher, Cfg(**cfg_kw))


def _run_script(pkg: str, steps, clock, cfg_kw: dict):
    """Each step's decision on ``pkg``'s pool: ("admit", replica, reason) or
    ("shed", cause, retry_after_ms, retriable), with the buckets after it."""
    adm_mod, _, _, _, Req = PACKAGES[pkg]
    pool = _pool(pkg, cfg_kw)
    clock.t = 1000.0
    out = []
    for i, st in enumerate(steps):
        clock.t += st["advance"]
        if st["degrade"] is not None:
            pool.set_degrade_level(st["degrade"])
        for r, live in zip(pool.replicas, st["replicas"]):
            r.engine.overlap = live["overlap"]
            r.batcher.outstanding = live["outstanding"]
            r.batcher.queue = live["queue"]
            r.batcher.tps = live["tps"]
        if st["crash"] is not None:
            pool.replicas[st["crash"]].batcher.last_error = RuntimeError("scripted crash")
        before = [len(r.batcher.submitted) for r in pool.replicas]
        req = Req(prompt_ids=list(st["prompt"]), max_tokens=st["max_tokens"],
                  request_id=st["task"], priority=st["priority"])
        try:
            pool.submit(req, tenant=st["tenant"], deadline_s=st["deadline"])
        except adm_mod.AdmissionError as e:
            decision = ("shed", e.cause, e.retry_after_ms, e.retriable)
        else:
            got = [j for j, r in enumerate(pool.replicas) if len(r.batcher.submitted) > before[j]]
            decision = ("admit", got, req.rec.route_reason)
        buckets = {t: round(b.tokens, 9) for t, b in sorted(pool.admission._buckets.items())}
        out.append((i, decision, buckets, pool.restarts, pool.degrade_level))
    return out, dict(pool._routed), dict(pool._shed), pool.stats()


POLICIES = {
    "quota+queue": dict(replicas=3, tenant_tokens_per_sec=60.0, tenant_burst_tokens=900.0,
                        max_queue=3, overlap_min_ratio=0.25),
    "deadline": dict(replicas=3, max_queue=0, assumed_tokens_per_sec=30.0,
                     overlap_min_ratio=0.5),
    "tight": dict(replicas=3, tenant_tokens_per_sec=5.0, tenant_burst_tokens=250.0,
                  max_queue=1, assumed_tokens_per_sec=100.0, overlap_min_ratio=0.1,
                  failover_retries=0),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_pool_decisions_match_jax(clock, policy, seed):
    """Routes (sticky, prefix, least_loaded, spill), sheds (quota with its
    refill-derived retry-after and the permanent over-burst case, deadline,
    queue_full, degraded), the buckets after every step, crash respawns,
    the routing and shed tallies and ``stats()``: equal step for step."""
    steps = _script(seed + 10 * sorted(POLICIES).index(policy))
    want = _run_script("jax", steps, clock, POLICIES[policy])
    got = _run_script("port", steps, clock, POLICIES[policy])
    for g, w in zip(got[0], want[0]):
        assert g == w
    assert got[1:] == want[1:]
    kinds = {d[1][0] if d[1][0] == "admit" else d[1][1] for d in got[0]}
    assert "admit" in kinds and len(kinds) >= 2, kinds


def test_router_matches_jax_on_fakes():
    """Router.select / least_loaded / note_routed on fakes, scripted."""
    rng = np.random.default_rng(5)
    routers = {"jax": jrouter.Router(0.3), "port": trouter.Router(0.3)}
    for _ in range(300):
        fakes = [types.SimpleNamespace(
            overlap_rows=(lambda ids, hashes=None, o=int(rng.integers(0, 200)): o),
            outstanding_tokens=(lambda o=int(rng.integers(0, 500)): o))
            for _ in range(int(rng.integers(1, 4)))]
        ids = list(range(int(rng.integers(1, 300))))
        task = str(rng.choice(["", "a", "b", "c"]))
        detail = {k: {} for k in routers}
        res = {k: r.select(fakes, ids, task, detail=detail[k]) for k, r in routers.items()}
        assert res["jax"] == res["port"] and detail["jax"] == detail["port"]
        for r in routers.values():
            r.note_routed(task, res["jax"][0])
    assert trouter.ROUTE_REASONS == jpool.ROUTE_REASONS


def test_draining_and_host_drain_shed_like_jax(clock):
    for pkg in PACKAGES:
        pool = _pool(pkg, dict(replicas=3))
        adm_mod, _, _, _, Req = PACKAGES[pkg]
        adm_mod.set_host_draining(True)
        try:
            with pytest.raises(adm_mod.AdmissionError) as e:
                pool.submit(Req(prompt_ids=[1, 2]))
            assert (e.value.cause, e.value.retry_after_ms) == ("draining_host", 2000)
        finally:
            adm_mod.set_host_draining(False)
        pool.drain(timeout=0.1)
        with pytest.raises(adm_mod.AdmissionError) as e:
            pool.submit(Req(prompt_ids=[1, 2]))
        assert (e.value.cause, e.value.retry_after_ms) == ("draining", 2000)
        assert pool._shed["draining"] == pool._shed["draining_host"] == 1


TENANT_CASES = [
    dict(requesting_agent="planner", task_id="exec-3"),
    dict(requesting_agent="", task_id="exec-3"),
    dict(requesting_agent="", task_id="exec:3"),
    dict(requesting_agent="", task_id="a/b-c"),
    dict(requesting_agent="", task_id="plain"),
    dict(requesting_agent="solo", task_id=""),
    dict(requesting_agent="", task_id=""),
]


@pytest.mark.parametrize("mode", ["agent", "task_prefix"])
@pytest.mark.parametrize("case", range(len(TENANT_CASES)))
def test_tenant_of_matches_jax(case, mode):
    req = runtime_pb2.InferRequest(**TENANT_CASES[case])
    assert tadm.tenant_of(req, mode) == jadm.tenant_of(req, mode)


ENVS = [
    {},
    {"AIOS_TPU_REPLICAS": "2", "AIOS_TPU_TENANT_TOKENS_PER_SEC": "50"},
    {"AIOS_TPU_TENANT_TOKENS_PER_SEC": "5", "AIOS_TPU_TENANT_BURST_TOKENS": "9",
     "AIOS_TPU_TENANT_BY": "TASK_PREFIX", "AIOS_TPU_MAX_QUEUE": "1"},
    {"AIOS_TPU_REPLICAS": "0", "AIOS_TPU_MAX_QUEUE": "-3", "AIOS_TPU_TENANT_BY": "nobody",
     "AIOS_TPU_ROUTE_OVERLAP_MIN": "x", "AIOS_TPU_ASSUMED_TPS": "12.5"},
    {"AIOS_TPU_FAILOVER_RETRIES": "0", "AIOS_TPU_FAILOVER_BACKOFF_MS": "5",
     "AIOS_TPU_DRAFT_MODEL": " tinyllama "},
]


@pytest.mark.parametrize("env", range(len(ENVS)))
def test_serving_config_from_env_matches_jax(monkeypatch, env):
    for k in ("AIOS_TPU_REPLICAS", "AIOS_TPU_TENANT_TOKENS_PER_SEC", "AIOS_TPU_MAX_QUEUE",
              "AIOS_TPU_TENANT_BURST_TOKENS", "AIOS_TPU_TENANT_BY", "AIOS_TPU_ASSUMED_TPS",
              "AIOS_TPU_ROUTE_OVERLAP_MIN", "AIOS_TPU_FAILOVER_RETRIES",
              "AIOS_TPU_FAILOVER_BACKOFF_MS", "AIOS_TPU_DRAFT_MODEL"):
        monkeypatch.delenv(k, raising=False)
    for k, v in ENVS[env].items():
        monkeypatch.setenv(k, v)
    for default in (1, 3):
        got = dataclasses.asdict(ServingConfig.from_env(default))
        assert got == dataclasses.asdict(JaxServingConfig.from_env(default))


def test_quota_debits_and_retry_hint_match_jax(clock):
    """TokenBucket refill, the retry-after of a deficit, the permanent
    over-burst shed and the tenant-table bound, both packages."""
    for pkg in PACKAGES:
        adm_mod, _, _, Cfg, _ = PACKAGES[pkg]
        clock.t = 0.0
        adm = adm_mod.AdmissionController(Cfg(tenant_tokens_per_sec=10.0), f"q-{pkg}")
        adm.check_quota("t", 30.0)
        with pytest.raises(adm_mod.AdmissionError) as e:
            adm.check_quota("t", 20.0)
        assert (e.value.cause, e.value.retry_after_ms, e.value.retriable) == ("quota", 1000, True)
        clock.t += 1.0
        adm.check_quota("t", 20.0)
        with pytest.raises(adm_mod.AdmissionError) as e:
            adm.check_quota("t", 41.0)  # the burst is 4 s of refill: 40
        assert (e.value.retry_after_ms, e.value.retriable) == (30_000, False)


# -- real 2-replica pools over tiny engines --------------------------------------

CTX = 256


@pytest.fixture(scope="module")
def jax_params():
    return jm.init_params(JAX_TINY, jax.random.PRNGKey(3), dtype=jnp.float32)


@pytest.fixture(scope="module")
def torch_params(jax_params):
    return params_from_jax(jax.tree.map(np.asarray, jax_params))


ENGINE_KW = dict(num_slots=2, max_context=CTX, paged_pool_rows=4 * CTX, page_size=32)


def _port_pool(torch_params, cfg: ServingConfig, name: str = "par", factory=None):
    e0 = TorchEngine(TINY_TEST, torch_params, cache_dtype=torch.float32, device="cpu",
                     **ENGINE_KW)
    e1 = TorchEngine(TINY_TEST, e0.params, cache_dtype=torch.float32, device="cpu",
                     **ENGINE_KW)
    return tpool.ReplicaPool(name, [e0, e1], factory or ContinuousBatcher, cfg)


def _jax_pool(jax_params, cfg: JaxServingConfig, name: str = "par"):
    engines = [TPUEngine(JAX_TINY, jax_params, cache_dtype=jnp.float32, **ENGINE_KW)
               for _ in range(2)]
    return jpool.ReplicaPool(name, engines, JaxBatcher, cfg)


PREAMBLE = [int(t) for t in np.random.default_rng(21).integers(1, 250, 130)]


def _traffic(pool, Req, submit_kw=None):
    """A long request held in flight while a second one routes (least
    loaded to the idle replica), then shared-preamble continuations and a
    sticky task, each drained in turn: (replica, reason, tokens) each."""
    out = []
    a = pool.submit(Req(prompt_ids=PREAMBLE + [7], max_tokens=40, temperature=0.0,
                        request_id="long-a"), tenant="a")
    b = pool.submit(Req(prompt_ids=[5, 6, 7, 8], max_tokens=6, temperature=0.0,
                        request_id="short-b"), tenant="b")
    for h, r in ((a, "long-a"), (b, "short-b")):
        out.append((r, h.tokens()))
    for i in range(4):
        req = Req(prompt_ids=PREAMBLE + [9 + i, 3], max_tokens=8, temperature=0.0,
                  request_id=f"cont-{i}")
        out.append((req.request_id, pool.submit(req, tenant="a").tokens(),
                    req.rec.replica, req.rec.route_reason))
    req = Req(prompt_ids=[5, 6, 7, 8, 9], max_tokens=5, temperature=0.0, request_id="short-b")
    out.append(("sticky", pool.submit(req, tenant="b").tokens(), req.rec.replica,
                req.rec.route_reason))
    return out


def test_two_replica_pool_matches_jax(jax_params, torch_params):
    """The same traffic through both packages' 2-replica pools: the same
    routes (least_loaded, prefix to the replica holding the preamble,
    sticky) and token-identical greedy streams; the port's replicas share
    every weight tensor."""
    jp = _jax_pool(jax_params, JaxServingConfig(replicas=2))
    try:
        want = _traffic(jp, JaxRequest)
        want_routed = dict(jp._routed)
    finally:
        jp.shutdown()
    tp = _port_pool(torch_params, ServingConfig(replicas=2))
    try:
        e0, e1 = (r.engine for r in tp.replicas)
        for key, t in e0.params["layers"].items():
            assert e1.params["layers"][key].data_ptr() == t.data_ptr(), key
        got = _traffic(tp, Request)
        assert dict(tp._routed) == want_routed
        # the continuations' shared preamble admitted as prefix hits
        assert sum(r.engine.prefix_rows_reused for r in tp.replicas) > 0
    finally:
        tp.shutdown()
    assert got == want
    assert want_routed["prefix"] >= 3 and want_routed["sticky"] == 1
    assert [g[2] for g in got[2:6]] == [got[2][2]] * 4


def test_manager_replicas_share_weights(monkeypatch):
    monkeypatch.setenv("AIOS_TPU_REPLICAS", "2")
    manager = ModelManager(num_slots=2, device="cpu")
    try:
        m = manager.load_model("shared", "synthetic://tiny-test", context_length=CTX)
        reps = m.pool.replicas
        assert len(reps) == 2 and m.engine is reps[0].engine and m.batcher is reps[0].batcher
        assert reps[0].engine is not reps[1].engine
        for key, t in reps[0].engine.params["layers"].items():
            assert reps[1].engine.params["layers"][key].data_ptr() == t.data_ptr()
        assert reps[0].engine.k_pool.data_ptr() != reps[1].engine.k_pool.data_ptr()
        assert reps[0].engine.prefix_index is not reps[1].engine.prefix_index
        # the JAX estimate with the weights counted once: dense leaves on the
        # CPU, a bf16 pool of (slots + 1) x context rows a replica, no graphs
        cfg = m.config
        kv = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim * 2 * (2 + 1) * CTX
        weights = tmodel.serving_weight_bytes(reps[0].engine.params)
        assert m.hbm_chip_bytes == weights + 2 * kv
        h = m.submit(Request(prompt_ids=[1, 2, 3], max_tokens=3, temperature=0.0),
                     tenant="x")
        assert len(h.tokens()) == 3
    finally:
        manager.close()


def test_replica_crash_restart_counted(torch_params):
    """A replica whose scheduler recorded a fatal error gets a fresh
    batcher on the next submit, counted; the manager's snapshot follows."""
    tp = _port_pool(torch_params, ServingConfig(replicas=2))
    seen = []
    tp.on_respawn = lambda idx, b: seen.append((idx, b))
    try:
        victim = tp.replicas[0]
        old = victim.batcher
        old.last_error = RuntimeError("synthetic scheduler crash")
        h = tp.submit(Request(prompt_ids=[5, 6], max_tokens=2, temperature=0.0))
        assert len(h.tokens()) == 2
        assert tp.restarts == 1 and victim.batcher is not old
        assert victim.batcher.last_error is None and seen == [(0, victim.batcher)]
        assert tp.stats()["replica_restarts"] == 1
    finally:
        tp.shutdown()


def test_admission_gate_order_quota_debits_last(torch_params):
    tp = _port_pool(torch_params, ServingConfig(replicas=2))
    calls = []
    adm = tp.admission
    for gate in ("check_queue", "check_deadline", "check_quota"):
        orig = getattr(adm, gate)
        setattr(adm, gate, lambda *a, _g=gate, _o=orig, **kw: calls.append(_g) or _o(*a, **kw))
    try:
        tp.submit(Request(prompt_ids=[1, 2], max_tokens=2, temperature=0.0)).tokens()
    finally:
        tp.shutdown()
    assert calls == ["check_queue", "check_deadline", "check_quota"]


def test_deadline_cost_capped_by_cache_room(torch_params):
    """A prompt of 250 ids leaves 6 decodable rows of the 256: feasible in
    5 s at 10 tok/s whatever max_tokens says."""
    tp = _port_pool(torch_params, ServingConfig(replicas=2, assumed_tokens_per_sec=10.0))
    try:
        h = tp.submit(Request(prompt_ids=list(range(1, 251)), max_tokens=50_000,
                              temperature=0.0), deadline_s=5.0)
        assert len(h.tokens()) > 0
        with pytest.raises(tadm.AdmissionError) as e:
            tp.submit(Request(prompt_ids=[1, 2], max_tokens=200), deadline_s=5.0)
        assert e.value.cause == "deadline"
    finally:
        tp.shutdown()


def test_add_and_remove_replica(torch_params):
    """Scale up over the same weights (the new replica starts cold and takes
    the overflow), scale down draining the last replica; never below one."""
    tp = _port_pool(torch_params, ServingConfig(replicas=2))
    try:
        e2 = TorchEngine(TINY_TEST, tp.replicas[0].engine.params, cache_dtype=torch.float32,
                         device="cpu", **ENGINE_KW)
        assert tp.add_replica(e2) == 2 and len(tp.replicas) == 3
        assert tp.stats()["replicas"] == 3 and tp.stats()["num_slots"] == 6
        hs = [tp.submit(Request(prompt_ids=[3, 4, i], max_tokens=12, temperature=0.0))
              for i in range(3)]
        assert [len(h.tokens()) for h in hs] == [12] * 3
        assert tp.replicas[2].batcher.completed == 1
        victim = tp.remove_replica(drain_timeout=10.0)
        assert victim.engine is e2 and victim.batcher._closed and len(tp.replicas) == 2
        assert tp.remove_replica() is not None and tp.remove_replica() is None
        assert len(tp.replicas) == 1
        assert len(tp.submit(Request(prompt_ids=[1], max_tokens=2)).tokens()) == 2
    finally:
        tp.shutdown()


def test_drain_waits_for_inflight(torch_params):
    tp = _port_pool(torch_params, ServingConfig(replicas=2))
    try:
        h = tp.submit(Request(prompt_ids=[1, 2], max_tokens=12, temperature=0.0))
        out = {}
        t = threading.Thread(target=lambda: out.setdefault("tokens", h.tokens()))
        t.start()
        assert tp.drain(timeout=60.0)
        t.join(timeout=10)
        assert not t.is_alive() and len(out["tokens"]) == 12
        with pytest.raises(tadm.AdmissionError) as err:
            tp.submit(Request(prompt_ids=[3], max_tokens=2))
        assert err.value.cause == "draining"
    finally:
        tp.shutdown()
    assert all(r.batcher._closed and r.engine.params is None for r in tp.replicas)


def test_pool_eviction_marks_victim_aborted(torch_params):
    """A pool-exhaustion eviction aborts its victim (not a silent
    truncation), and the abort is not retryable on one engine."""
    eng = TorchEngine(TINY_TEST, torch_params, num_slots=3, max_context=128,
                      cache_dtype=torch.float32, paged_pool_rows=96, page_size=32,
                      prefix_cache=False, device="cpu")
    b = ContinuousBatcher(eng)
    try:
        hs = [b.submit(Request(prompt_ids=[s + 1, 2, 3], max_tokens=80, temperature=0.0))
              for s in range(3)]
        outs = [h.tokens() for h in hs]
        assert b.pool_evictions >= 1
        evicted = [h for h in hs if h.aborted]
        assert evicted and all("evicted" in h.abort_reason for h in evicted)
        assert all(h.retry_after_ms == 1000 for h in evicted)
        assert any(not h.aborted and len(o) == 80 for h, o in zip(hs, outs))
    finally:
        b.shutdown()
        eng.close()


def test_outstanding_tokens_cap_budgets_at_the_cache(torch_params):
    """A waiting request counts prompt + budget, a live one its remaining
    budget, each capped at what the 256-row cache can hold."""
    from aios_tpu_torch.engine.batching import _Live

    eng = TorchEngine(TINY_TEST, torch_params, cache_dtype=torch.float32, device="cpu",
                      **ENGINE_KW)
    b = ContinuousBatcher(eng)
    b.shutdown()  # no scheduler: the queue below stays as it is set
    try:
        assert (b.outstanding_tokens(), b.tokens_per_second(), b.active_count) == (0, 0.0, 0)
        b._waiting.extend([_Live(req=Request(prompt_ids=[1] * 300, max_tokens=50_000), slot=-1),
                           _Live(req=Request(prompt_ids=[1] * 10, max_tokens=7), slot=-1)])
        b._live[1] = _Live(req=Request(prompt_ids=[1] * 5, max_tokens=100), slot=1,
                           produced=40)
        eng._host_lengths[1] = 200
        # 255 prompt rows + 1 row of budget; 10 + 7; min(100 - 40, 256 - 200)
        assert b.outstanding_tokens() == 256 + 17 + 56
        assert b.active_count == 1 and b.queue_depth() == 2
    finally:
        eng.close()


# -- the gRPC service ---------------------------------------------------------------


def _serve(mp, env: dict, replicas: int = 1, ctx: int = 128):
    mp.setenv("AIOS_TPU_REPLICAS", str(replicas))
    for k, v in env.items():
        mp.setenv(k, v)
    manager = ModelManager(num_slots=2, device="cpu")
    manager.load_model("tiny", "synthetic://tiny-test", context_length=ctx)
    server, service, port = serve(address="127.0.0.1:0", manager=manager, block=False)
    channel = rpc.insecure_channel(f"127.0.0.1:{port}")
    return manager, server, channel, services.AIRuntimeStub(channel)


@pytest.fixture()
def served(monkeypatch):
    opened = []

    def start(env=None, **kw):
        opened.append(_serve(monkeypatch, env or {}, **kw))
        return opened[-1]

    yield start
    for manager, server, channel, _ in opened:
        channel.close()
        server.stop(grace=None)
        manager.close()


def test_quota_shed_is_resource_exhausted_with_retry_after(served):
    manager, _, _, stub = served({"AIOS_TPU_TENANT_TOKENS_PER_SEC": "1",
                                  "AIOS_TPU_TENANT_BURST_TOKENS": "100"})
    err = None
    for _ in range(10):
        try:
            stub.Infer(runtime_pb2.InferRequest(prompt="hi", max_tokens=8,
                                                requesting_agent="tenant-a"))
        except grpc.RpcError as e:
            err = e
            break
    assert err is not None and err.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
    assert int(dict(err.trailing_metadata())["retry-after-ms"]) > 0
    assert "quota" in err.details()
    r = stub.Infer(runtime_pb2.InferRequest(prompt="hi", max_tokens=8,
                                            requesting_agent="tenant-b"))
    assert r.tokens_used > 0
    assert manager.get("tiny").pool._shed["quota"] >= 1
    # a cost no refill can ever cover is not retriable
    with pytest.raises(grpc.RpcError) as e:
        stub.Infer(runtime_pb2.InferRequest(prompt="x" * 50, max_tokens=120,
                                            requesting_agent="tenant-c"))
    assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    assert "not admittable (quota)" in e.value.details()


def test_deadline_shed_takes_no_slot(served):
    manager, _, _, stub = served({"AIOS_TPU_ASSUMED_TPS": "5"})
    pool = manager.get("tiny").pool
    with pytest.raises(grpc.RpcError) as err:
        stub.Infer(runtime_pb2.InferRequest(prompt="hi", max_tokens=64), timeout=2.0)
    assert err.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
    assert int(dict(err.value.trailing_metadata())["retry-after-ms"]) > 0
    assert pool._shed["deadline"] == 1
    for r in pool.replicas:
        assert (r.queue_depth(), r.batcher.active_count, r.batcher.completed) == (0, 0, 0)
    assert stub.Infer(runtime_pb2.InferRequest(prompt="hi", max_tokens=4)).tokens_used > 0


def test_tenant_by_task_prefix_through_the_service(served):
    _, _, _, stub = served({"AIOS_TPU_TENANT_TOKENS_PER_SEC": "1",
                            "AIOS_TPU_TENANT_BURST_TOKENS": "100",
                            "AIOS_TPU_TENANT_BY": "task_prefix"})
    err = None
    for i in range(10):
        try:
            stub.Infer(runtime_pb2.InferRequest(prompt="hi", max_tokens=8,
                                                requesting_agent="shared", task_id=f"ta-{i}"))
        except grpc.RpcError as e:
            err = e
            break
    assert err is not None and err.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
    r = stub.Infer(runtime_pb2.InferRequest(prompt="hi", max_tokens=8,
                                            requesting_agent="shared", task_id="tb-0"))
    assert r.tokens_used > 0


def test_queue_full_sheds_a_burst(served):
    manager, _, _, stub = served({"AIOS_TPU_MAX_QUEUE": "1"})
    codes = []

    def call(i):
        try:
            stub.Infer(runtime_pb2.InferRequest(prompt=f"burst {i}", max_tokens=96))
            codes.append("OK")
        except grpc.RpcError as e:
            codes.append(e.code().name)

    # 12 at once on 2 slots: the queue holds one, the rest shed
    threads = [threading.Thread(target=call, args=(i,)) for i in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert "OK" in codes and "RESOURCE_EXHAUSTED" in codes, codes
    assert manager.get("tiny").pool._shed["queue_full"] == codes.count("RESOURCE_EXHAUSTED")


def test_health_check_reports_pool_stats(served):
    manager, _, _, stub = served(replicas=2, ctx=CTX)
    stub.Infer(runtime_pb2.InferRequest(prompt="hello pool", max_tokens=4, task_id="h-1"))
    stub.Infer(runtime_pb2.InferRequest(prompt="hello pool", max_tokens=4, task_id="h-1"))
    details = stub.HealthCheck(common_pb2.Empty()).details["tiny.serving"]
    stats = dict(kv.split("=") for kv in details.split(","))
    assert stats["replicas"] == "2" and stats["replica_restarts"] == "0"
    assert stats["degrade_level"] == "0" and stats["num_slots"] == "4"
    assert int(stats["routed_sticky"]) == 1 and int(stats["completed"]) == 2
    for key in ("routed_prefix", "routed_least_loaded", "shed_quota", "shed_deadline",
                "graph_captures", "graph_replays", "replica0_occupancy", "replica1_occupancy",
                "prefix_hits", "prefill_chunk"):
        assert key in stats, key
    pool_stats = manager.get("tiny").pool.stats()
    for key in ("replicas", "routed_sticky", "completed", "graph_replays"):
        assert stats[key] == str(pool_stats[key]), key


def test_submit_racing_an_unload_is_unavailable(served):
    manager, _, _, stub = served()
    manager.get("tiny").pool.replicas[0].batcher.shutdown()
    with pytest.raises(grpc.RpcError) as err:
        stub.Infer(runtime_pb2.InferRequest(prompt="late", max_tokens=4))
    assert err.value.code() == grpc.StatusCode.UNAVAILABLE
    assert "unloading" in err.value.details()


def test_failed_reload_keeps_serving(served):
    manager, _, _, stub = served()
    m = manager.get("tiny")
    with pytest.raises(FileNotFoundError):
        manager.load_model("tiny", "/nonexistent/model.gguf")
    assert manager.get("tiny") is m and m.state == "ready"
    assert stub.Infer(runtime_pb2.InferRequest(prompt="still", max_tokens=3)).tokens_used > 0


def test_hot_swap_keeps_the_live_stream_whole(served, monkeypatch):
    """A LoadModel of the same name with another context while a stream is
    live: the stream completes on its old engine, the new pool serves the
    next request, the old pool drains and closes, and an identical reload
    is no swap."""
    manager, _, _, stub = served()
    first = manager.get("tiny")
    old_pool = first.pool
    it = stub.StreamInfer(runtime_pb2.InferRequest(prompt="swap me", max_tokens=40,
                                                   temperature=0.5))
    chunks = [next(it)]
    second = manager.load_model("tiny", "synthetic://tiny-test", context_length=256)
    assert second is not first and manager.get("tiny") is second
    assert second.engine.max_context == 256 and first.state == "unloading"
    chunks.extend(it)
    assert chunks[-1].done and not any(c.done for c in chunks[:-1])
    deadline = time.time() + 30
    # shutdown marks the pool closed before it closes the engines
    while not (old_pool._closed and old_pool.replicas[0].engine.params is None) \
            and time.time() < deadline:
        time.sleep(0.02)
    assert old_pool._closed and old_pool.replicas[0].engine.params is None
    assert stub.Infer(runtime_pb2.InferRequest(prompt="new", max_tokens=3)).tokens_used > 0
    with pytest.raises(tadm.AdmissionError):
        old_pool.submit(Request(prompt_ids=[4], max_tokens=2))
    assert manager.load_model("tiny", "synthetic://tiny-test", context_length=256) is second
    # a changed replica count is a swap too
    monkeypatch.setenv("AIOS_TPU_REPLICAS", "2")
    third = manager.load_model("tiny", "synthetic://tiny-test", context_length=256)
    assert third is not second and len(third.pool.replicas) == 2


def test_unload_shuts_the_pool_down(served):
    manager, _, _, stub = served(replicas=2)
    pool = manager.get("tiny").pool
    assert stub.UnloadModel(runtime_pb2.UnloadModelRequest(model_name="tiny")).success
    assert pool._closed and all(r.batcher._closed for r in pool.replicas)
    assert all(r.engine.params is None for r in pool.replicas)


def test_budget_warns_over_the_card(monkeypatch, caplog):
    """AIOS_TPU_HBM_GB sets the card's memory; a model whose KV does not fit
    0.85 of it beside the co-resident models warns and still loads."""
    monkeypatch.setenv("AIOS_TPU_HBM_GB", "0.000001")
    manager = ModelManager(num_slots=2, device="cpu")
    try:
        with caplog.at_level("WARNING", logger="aios.torch.runtime.models"):
            m = manager.load_model("tiny", "synthetic://tiny-test")
        assert m.state == "ready"
        assert any("HBM may overflow" in r.getMessage() for r in caplog.records)
    finally:
        manager.close()
