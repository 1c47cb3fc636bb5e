"""The port's fault injection and transparent failover against the JAX
package, on the CPU: the mirror of tests/test_faults.py for
``aios_tpu_torch/faults`` and ``aios_tpu_torch/serving/failover.py``.

The seeded fault plan fires the same faults for one seed and schedule in
both packages; a ``pool.scheduler_crash`` injected mid-decode on a 2-replica
pool of the port resumes every greedy stream token for token as the JAX
pool's fault-free streams, with a counted respawn and ``failover`` events on
the timelines; a spent retry budget surfaces as a retryable abort with a
backoff hint, over gRPC as UNAVAILABLE with ``retry-after-ms``; constrained
requests are not wrapped; ``allocator.pressure`` raises ``PoolExhausted``;
the degrade ladder's level 2 sheds speculation and jump-ahead on every
batcher, respawned ones included.

Tolerances: fault journals, decisions and tokens exactly."""

import threading
import time

import grpc
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aios_tpu import faults as jfaults
from aios_tpu.engine import model as jm
from aios_tpu.engine.batching import ContinuousBatcher as JaxBatcher
from aios_tpu.engine.batching import Request as JaxRequest
from aios_tpu.engine.config import TINY_TEST as JAX_TINY
from aios_tpu.engine.engine import TPUEngine
from aios_tpu.faults.inject import _parse as jparse
from aios_tpu.serving import ReplicaPool as JaxPool
from aios_tpu.serving import ServingConfig as JaxServingConfig
from aios_tpu_torch import faults, rpc, services
from aios_tpu_torch.engine.batching import ContinuousBatcher, Request, RequestHandle
from aios_tpu_torch.engine.config import TINY_TEST
from aios_tpu_torch.engine.engine import TorchEngine
from aios_tpu_torch.engine.paged import PageAllocator, PoolExhausted
from aios_tpu_torch.engine.tokenizer import ByteTokenizer
from aios_tpu_torch.engine.weights import params_from_jax
from aios_tpu_torch.faults.inject import _parse
from aios_tpu_torch.obs import flightrec
from aios_tpu_torch.obs import instruments as obs
from aios_tpu_torch.proto_gen import common_pb2, runtime_pb2
from aios_tpu_torch.runtime.model_manager import ModelManager
from aios_tpu_torch.runtime.service import serve
from aios_tpu_torch.serving import (AdmissionController, AdmissionError, ReplicaPool,
                                    ServingConfig)
from aios_tpu_torch.serving.failover import FailoverHandle

# The shapes here are tiny: one intra-op thread is faster and leaves the
# cores to the other test workers.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _disarm():
    """No schedule is armed before or after a test, in either package."""
    faults.deactivate()
    jfaults.deactivate()
    yield
    faults.deactivate()
    jfaults.deactivate()


# -- the fault plan against the JAX package's ------------------------------------

SCHEDULES = [
    "seed=42;pool.scheduler_crash=nth:3;dispatch.delay=prob:0.25,delay_ms=20;"
    "admission.clock_skew=after:5,skew_ms=2000",
    "seed=oops;no.such.point=nth:1;pool.scheduler_crash=never:1;"
    "dispatch.delay=nth:x;host_store.corrupt=nth:2,bad=param;rpc.unavailable=nth:1",
    "seed=7;allocator.pressure=prob:0.3;dispatch.delay=prob:0.6;"
    "net.partition=nth:2,until=4,src=a,dst=b",
    "seed=3;pool.scheduler_crash=prob:0.1;admission.clock_skew=nth:4",
]


@pytest.mark.parametrize("spec", range(len(SCHEDULES)))
def test_schedule_parses_as_jax(spec):
    got, got_seed = _parse(SCHEDULES[spec])
    want, want_seed = jparse(SCHEDULES[spec])
    assert got_seed == want_seed
    assert {k: (v.mode, v.arg, v.params, v.strs) for k, v in got.items()} == \
        {k: (v.mode, v.arg, v.params, v.strs) for k, v in want.items()}


@pytest.mark.parametrize("seed", [0, 1, 11, 12])
@pytest.mark.parametrize("spec", range(len(SCHEDULES)))
def test_firings_match_jax(spec, seed):
    """One seed, one schedule, one interleaved call pattern over every
    point: the same fire decisions, actions and journal in both packages."""
    rng = np.random.default_rng(seed)
    pattern = [str(rng.choice(faults.POINTS[:7])) for _ in range(200)]
    runs = {}
    for name, pkg in (("port", faults), ("jax", jfaults)):
        plan = pkg.activate(SCHEDULES[spec], seed=seed)
        acts = []
        for point in pattern:
            a = pkg.point(point, "m", edge=("a", "b") if point == "net.partition" else None)
            acts.append(None if a is None else (a.point, a.mode, a.hit, a.delay_s, a.skew_s,
                                                a.retry_after_ms))
        runs[name] = (acts, plan.journal())
        pkg.deactivate()
    assert runs["port"] == runs["jax"]
    assert faults.POINTS == jfaults.POINTS and faults.MODES == jfaults.MODES


def test_nth_trigger_fires_exactly_once():
    plan = faults.activate("pool.scheduler_crash=nth:3")
    hits = [faults.point("pool.scheduler_crash") for _ in range(6)]
    fired = [a for a in hits if a is not None]
    assert len(fired) == 1 and hits[2] is not None and fired[0].hit == 3
    assert plan.journal() == [{"point": "pool.scheduler_crash", "mode": "nth", "hit": 3,
                               "model": ""}]


def test_prob_trigger_is_a_pure_function_of_seed_and_hit_index():
    def run(seed):
        faults.activate(f"seed={seed};dispatch.delay=prob:0.4")
        return [faults.point("dispatch.delay") is not None for _ in range(64)]

    a, b, other = run(11), run(11), run(12)
    assert a == b and a != other and any(a) and not all(a)


def test_per_point_rngs_are_independent():
    faults.activate("seed=5;dispatch.delay=prob:0.4")
    alone = [faults.point("dispatch.delay") is not None for _ in range(32)]
    faults.activate("seed=5;dispatch.delay=prob:0.4;rpc.unavailable=prob:0.4")
    mixed = []
    for _ in range(32):
        mixed.append(faults.point("dispatch.delay") is not None)
        faults.point("rpc.unavailable")
    assert mixed == alone


def test_after_trigger_gates_on_elapsed_time():
    plan = faults.activate("admission.clock_skew=after:30,skew_ms=500")
    assert faults.point("admission.clock_skew") is None
    plan.activated_at -= 31
    act = faults.point("admission.clock_skew")
    assert act is not None and act.skew_s == 0.5


def test_disabled_point_is_none_with_no_side_effects():
    assert not faults.active()
    assert faults.point("pool.scheduler_crash") is None
    assert faults.fired() == []


def test_fired_fault_counts_metric_and_records_model_event():
    child = obs.FAULTS_INJECTED.labels(point="allocator.pressure", mode="nth")
    before = child.value
    faults.activate("allocator.pressure=nth:1")
    assert faults.point("allocator.pressure", "faultmodel") is not None
    assert child.value == before + 1
    events = [f for _, m, kind, f in flightrec.RECORDER.model_events("faultmodel")
              if kind == "fault"]
    assert events and events[-1]["point"] == "allocator.pressure"


def test_activate_seed_override_and_env_install(monkeypatch):
    assert faults.activate("dispatch.delay=prob:0.5", seed=99).seed == 99
    monkeypatch.setenv("AIOS_TPU_FAULTS", "seed=3;rpc.unavailable=nth:1")
    faults.install_from_env()
    assert faults.active() and faults.point("rpc.unavailable") is not None
    monkeypatch.setenv("AIOS_TPU_FAULTS", "")
    faults.install_from_env()
    assert not faults.active()


def test_allocator_pressure_point_raises_pool_exhausted():
    a = PageAllocator(num_pages=8, page_size=16, num_slots=2, max_blocks=4)
    a.ensure(0, 16)
    faults.activate("allocator.pressure=nth:1")
    with pytest.raises(PoolExhausted):
        a.ensure(1, 16)
    a.ensure(1, 16)  # one-shot: the pool recovers


def test_clock_skew_point_drives_deadline_sheds():
    adm = AdmissionController(ServingConfig(), "skew")
    adm.check_deadline(10.0, outstanding_tokens=100, max_tokens=100, rate_tps=100.0)
    faults.activate("admission.clock_skew=nth:1,skew_ms=9500")
    with pytest.raises(AdmissionError) as e:
        adm.check_deadline(10.0, outstanding_tokens=100, max_tokens=100, rate_tps=100.0)
    assert e.value.cause == "deadline" and e.value.retry_after_ms == 1000


def test_dispatch_delay_point_stalls_the_decode_loop(torch_params):
    """dispatch.delay sleeps before a decode dispatch and changes no token."""
    eng = TorchEngine(TINY_TEST, torch_params, num_slots=2, max_context=128,
                      cache_dtype=torch.float32, device="cpu")
    b = ContinuousBatcher(eng)
    try:
        want = b.generate([4, 5, 6], max_tokens=20, temperature=0.0)
        faults.activate("dispatch.delay=prob:1.0,delay_ms=30")
        t0 = time.monotonic()
        got = b.generate([4, 5, 6], max_tokens=20, temperature=0.0)
        assert got == want and time.monotonic() - t0 >= 0.03
        assert len(faults.fired()) >= 1
    finally:
        b.shutdown()
        eng.close()


# -- the failover acceptance on a 2-replica pool --------------------------------------

MODEL = "failover-port"
CTX = 256
ENGINE_KW = dict(num_slots=2, max_context=CTX, paged_pool_rows=4 * CTX, page_size=32)


@pytest.fixture(scope="module")
def jax_params():
    return jm.init_params(JAX_TINY, jax.random.PRNGKey(0), dtype=jnp.float32)


@pytest.fixture(scope="module")
def torch_params(jax_params):
    return params_from_jax(jax.tree.map(np.asarray, jax_params))


def _prompts(n):
    return [[3 + i, 7, 11] + list(range(20, 60)) for i in range(n)]


def _wave(pool, Req, tag, n=4, max_tokens=24):
    handles = [pool.submit(Req(prompt_ids=p, max_tokens=max_tokens, temperature=0.0,
                               request_id=f"{tag}-{i}"), tenant="chaos")
               for i, p in enumerate(_prompts(n))]
    streams, threads = {}, []
    for i, h in enumerate(handles):
        t = threading.Thread(target=lambda i=i, h=h: streams.__setitem__(i, h.tokens()),
                             daemon=True)
        t.start()
        threads.append(t)
    stuck = 0
    for t in threads:
        t.join(timeout=120)
        stuck += int(t.is_alive())
    return [streams.get(i) for i in range(n)], handles, stuck


@pytest.fixture(scope="module")
def jax_reference(jax_params):
    """The JAX pool's fault-free greedy streams of the wave."""
    engines = [TPUEngine(JAX_TINY, jax_params, cache_dtype=jnp.float32, **ENGINE_KW)
               for _ in range(2)]
    pool = JaxPool("failover-jax", engines,
                   lambda e: JaxBatcher(e, chunk_steps=2, admit_chunk_steps=2),
                   JaxServingConfig(replicas=2, failover_retries=2))
    try:
        ref, _, stuck = _wave(pool, JaxRequest, "jref")
        assert stuck == 0
        return ref
    finally:
        pool.shutdown()


@pytest.fixture(scope="module")
def crash_pool(torch_params):
    e0 = TorchEngine(TINY_TEST, torch_params, cache_dtype=torch.float32, device="cpu",
                     **ENGINE_KW)
    e1 = TorchEngine(TINY_TEST, e0.params, cache_dtype=torch.float32, device="cpu",
                     **ENGINE_KW)
    pool = ReplicaPool(MODEL, [e0, e1], ContinuousBatcher,
                       ServingConfig(replicas=2, failover_retries=2, failover_backoff_ms=5.0))
    yield pool
    pool.shutdown()


def test_failover_crash_mid_decode_streams_identical(crash_pool, jax_reference):
    """A crash injected mid-decode (the 3rd decode tick of the pool) ends
    every greedy stream whole and token for token as the JAX pool's
    fault-free run: no abort, no stuck request, one respawn, ``failover``
    events, tokens accumulated across attempts."""
    pool = crash_pool
    ref, ref_handles, stuck = _wave(pool, Request, "ref")
    assert stuck == 0 and ref == jax_reference and not any(h.aborted for h in ref_handles)
    restarts = pool.restarts
    resumed = obs.SERVING_FAILOVERS.labels(model=MODEL, outcome="resumed")
    resumed0 = resumed.value
    faults.activate("seed=2;pool.scheduler_crash=nth:3")
    try:
        out, handles, stuck = _wave(pool, Request, "crash")
    finally:
        faults.deactivate()
    assert stuck == 0
    assert out == jax_reference, "failover streams must be token-identical"
    assert not any(h.aborted for h in handles)
    assert all(isinstance(h, FailoverHandle) for h in handles)
    assert pool.restarts == restarts + 1 and resumed.value > resumed0
    tls = [t for t in flightrec.RECORDER.recent(model=MODEL, limit=64)
           if t.request_id.startswith("crash-")]
    assert len(tls) == 4 and all(t.state == "retired" for t in tls)
    assert all(t.tokens_out == 24 for t in tls)
    evs = [f for t in tls for _, k, f in t.events if k == "failover"]
    assert evs and evs[0]["cause"] == "scheduler_failed" and evs[0]["attempt"] == 1
    # the resumed prompt's leading blocks were a prefix hit
    assert sum(r.engine.prefix_rows_reused for r in pool.replicas) > 0


def test_failover_budget_exhausts_as_retryable_abort(crash_pool):
    pool = crash_pool
    faults.activate("seed=3;pool.scheduler_crash=prob:1.0")
    try:
        _, handles, stuck = _wave(pool, Request, "exhaust", n=2)
    finally:
        faults.deactivate()
    assert stuck == 0 and all(h.aborted for h in handles)
    assert all(h.retry_after_ms > 0 for h in handles)
    assert all("scheduler" in h.abort_reason for h in handles)
    tls = [t for t in flightrec.RECORDER.recent(model=MODEL, limit=64)
           if t.request_id.startswith("exhaust-")]
    assert len(tls) == 2 and all(t.state == "aborted" for t in tls)
    assert all(t.abort_cause == "scheduler_failed" for t in tls)
    for t in tls:
        assert sum(1 for _, k, _ in t.events if k == "failover") == 2


def test_cancel_after_claimed_abort_finishes_timeline(crash_pool):
    pool = crash_pool
    faults.activate("seed=5;pool.scheduler_crash=prob:1.0")
    try:
        h = pool.submit(Request(prompt_ids=[9, 8, 7], max_tokens=24, temperature=0.0,
                                request_id="orphan-1"), tenant="chaos")
        deadline = time.time() + 60
        while time.time() < deadline and not h._inner._live.abort_reason:
            time.sleep(0.02)
        assert h._inner._live.abort_reason, "the crash never landed"
        h.cancel()
    finally:
        faults.deactivate()
    tls = [t for t in flightrec.RECORDER.recent(model=MODEL, limit=64)
           if t.request_id == "orphan-1"]
    assert tls and tls[0].state == "aborted"


def test_faults_disabled_streams_and_captures_pinned(crash_pool, jax_reference):
    a, _, _ = _wave(crash_pool, Request, "quiet-a")
    b, _, _ = _wave(crash_pool, Request, "quiet-b")
    assert a == b == jax_reference and faults.fired() == []
    assert all(r.engine.stats()["graph_captures"] == 0 for r in crash_pool.replicas)


def test_constrained_requests_are_not_wrapped(crash_pool):
    req = Request(prompt_ids=[5, 6, 7], max_tokens=4, temperature=0.0, json_mode=True,
                  request_id="constrained-1")
    with pytest.raises(ValueError, match="tokenizer"):
        crash_pool.submit(req, tenant="chaos")  # these batchers have no tokenizer
    assert req.failover is None


def test_evicted_not_retryable_on_single_replica_pool():
    class _Pool:
        replicas = [object()]
        name = "one"
        _draining = False
        _closed = False

    fo = FailoverHandle(_Pool(), None, "t", retries=2, backoff_ms=1.0)
    assert fo.claims("scheduler failed: boom")
    assert not fo.claims("evicted: KV pool exhausted")
    assert not fo.claims("model unloading")

    class _Pool2(_Pool):
        replicas = [object(), object()]

    assert FailoverHandle(_Pool2(), None, "t", retries=2, backoff_ms=1.0).claims(
        "evicted: KV pool exhausted")


def test_failover_handle_cancel_stops_retries():
    class _Pool:
        replicas = [object(), object()]
        name = "c"
        _draining = False
        _closed = False

    fo = FailoverHandle(_Pool(), None, "t", retries=2, backoff_ms=1.0)
    fo.cancel()
    assert not fo.claims("scheduler failed: boom")


def test_crash_releases_the_dead_batchers_pages(torch_params):
    """A crash aborts every outstanding request and returns their pages, so
    the respawned batcher finds the pool as the prefix index left it."""
    eng = TorchEngine(TINY_TEST, torch_params, cache_dtype=torch.float32, device="cpu",
                      **ENGINE_KW)
    pool = ReplicaPool("pages", [eng], ContinuousBatcher,
                       ServingConfig(replicas=1, failover_retries=0))
    try:
        faults.activate("pool.scheduler_crash=nth:2")
        hs = [pool.submit(Request(prompt_ids=p, max_tokens=30, temperature=0.0))
              for p in _prompts(2)]
        for h in hs:
            h.tokens()
        faults.deactivate()
        assert all(h.aborted and h.retry_after_ms == 1000 for h in hs)
        assert eng.allocator.pages_in_use() == len(eng.prefix_index.snapshot())
        assert not eng.active.any()
        h = pool.submit(Request(prompt_ids=[1, 2, 3], max_tokens=5, temperature=0.0))
        assert len(h.tokens()) == 5 and pool.restarts == 1
    finally:
        pool.shutdown()


def test_degrade_level_two_sheds_speculation_and_jump_ahead(torch_params):
    """set_degrade_level(2) sets degrade_spec and degrade_jump on every
    batcher, a respawned one included; a schema request then takes masked
    steps only, with the stream of the undegraded pool."""
    tok = ByteTokenizer()
    schema = {"type": "object",
              "properties": {"tool": {"type": "string", "enum": ["read_file", "list_dir"]},
                             "recursive": {"type": "boolean"}},
              "required": ["tool", "recursive"]}
    engines = [TorchEngine(TINY_TEST, torch_params, cache_dtype=torch.float32, device="cpu",
                           **ENGINE_KW)]
    engines.append(TorchEngine(TINY_TEST, engines[0].params, cache_dtype=torch.float32,
                               device="cpu", **ENGINE_KW))
    pool = ReplicaPool("degrade", engines,
                       lambda e: ContinuousBatcher(e, tokenizer=tok, jump_ahead=True),
                       ServingConfig(replicas=2))

    def schema_stream():
        req = Request(prompt_ids=tok.encode("emit json"), max_tokens=48, temperature=0.0,
                      stop_ids=(tok.eos_id,), json_schema=schema, request_id="s")
        return pool.submit(req).tokens()

    try:
        want = schema_stream()
        jumps = sum(e.jump_dispatches for e in engines)
        assert jumps > 0
        assert pool.set_degrade_level(2) == 2
        assert all(r.batcher.degrade_spec and r.batcher.degrade_jump for r in pool.replicas)
        assert pool.admission.min_priority == 0
        pool.replicas[0].batcher.last_error = RuntimeError("crash")
        steps = sum(e.decode_steps for e in engines)
        got = schema_stream()
        assert pool.restarts == 1 and pool.replicas[0].batcher.degrade_jump
        assert got == want
        assert sum(e.jump_dispatches for e in engines) == jumps
        assert sum(e.decode_steps for e in engines) - steps >= len(got) - 1
        assert pool.set_degrade_level(9) == 3 and pool.admission.min_priority == 1
        assert pool.set_degrade_level(0) == 0
        assert not any(r.batcher.degrade_jump for r in pool.replicas)
    finally:
        pool.shutdown()


# -- a CUDA error is not a crash: no respawn, no resume ---------------------------------

CUDA_FAULTS = {
    "accelerator_error": lambda: torch.AcceleratorError(
        "CUDA error: an illegal memory access was encountered"),
    "runtime_error": lambda: RuntimeError(
        "CUDA error: an illegal memory access was encountered"),
}


def _fault_on_live_tick(batcher, exc, nth=3):
    """Make the batcher's ``nth`` tick with work (a live slot or a queued
    request) raise ``exc``, as a kernel launch on a poisoned context would."""
    real, seen = batcher._tick, [0]

    def tick():
        if batcher._live or batcher._waiting:
            seen[0] += 1
            if seen[0] == nth:
                raise exc
        real()

    batcher._tick = tick


@pytest.mark.parametrize("kind", sorted(CUDA_FAULTS))
def test_device_fault_is_neither_respawned_nor_resumed(torch_params, kind):
    """A CUDA error in a scheduler ends its requests as ``device fault``
    with no retry hint; the pool respawns nothing, failover resumes
    nothing, the scheduler thread stops and the pool refuses new work."""
    from aios_tpu_torch.device import DeviceFault

    e0 = TorchEngine(TINY_TEST, torch_params, cache_dtype=torch.float32, device="cpu",
                     **ENGINE_KW)
    e1 = TorchEngine(TINY_TEST, e0.params, cache_dtype=torch.float32, device="cpu",
                     **ENGINE_KW)
    name = f"devfault-{kind}"
    pool = ReplicaPool(name, [e0, e1], ContinuousBatcher,
                       ServingConfig(replicas=2, failover_retries=2, failover_backoff_ms=5.0))
    told = []
    pool.on_device_fault = told.append
    resumed = obs.SERVING_FAILOVERS.labels(model=name, outcome="resumed")
    resumed0 = resumed.value
    exc = CUDA_FAULTS[kind]()
    try:
        for r in pool.replicas:
            _fault_on_live_tick(r.batcher, exc)
        h = pool.submit(Request(prompt_ids=[9, 8, 7], max_tokens=64, temperature=0.0,
                                request_id="devfault-1"), tenant="chaos")
        assert isinstance(h, FailoverHandle)
        toks = h.tokens()
        assert 0 < len(toks) < 64 and h.aborted
        assert h.abort_reason.startswith("device fault") and h.retry_after_ms == 0
        assert pool.device_fault is exc and told == [exc]
        faulted = [r for r in pool.replicas if r.batcher.device_fault is not None]
        assert len(faulted) == 1
        faulted[0].batcher._thread.join(timeout=10)
        assert not faulted[0].batcher._thread.is_alive() and not faulted[0].dead()
        with pytest.raises(DeviceFault, match="device fault"):
            pool.submit(Request(prompt_ids=[1, 2], max_tokens=3, temperature=0.0))
        with pytest.raises(RuntimeError, match="device fault"):
            faulted[0].batcher.submit(Request(prompt_ids=[1, 2], max_tokens=3))
        assert pool.restarts == 0 and resumed.value == resumed0
        tls = [t for t in flightrec.RECORDER.recent(model=name, limit=16)
               if t.request_id == "devfault-1"]
        assert len(tls) == 1 and tls[0].state == "aborted"
        assert not any(k == "failover" for _, k, _ in tls[0].events)
    finally:
        pool.shutdown()


@pytest.mark.parametrize("rpc_name", ["Infer", "StreamInfer"])
def test_device_fault_over_grpc_is_internal_and_takes_the_model_out(monkeypatch, rpc_name):
    monkeypatch.setenv("AIOS_TPU_FAILOVER_RETRIES", "2")
    monkeypatch.setenv("AIOS_TPU_FAILOVER_BACKOFF_MS", "5")
    manager = ModelManager(num_slots=2, device="cpu")
    manager.load_model("faulttiny", "synthetic://tiny-test", context_length=128)
    server, _, port = serve(address="127.0.0.1:0", manager=manager, block=False)
    channel = rpc.insecure_channel(f"127.0.0.1:{port}")
    try:
        stub = services.AIRuntimeStub(channel)
        m = manager.get("faulttiny")
        pool = m.pool
        for r in pool.replicas:
            _fault_on_live_tick(r.batcher, CUDA_FAULTS["accelerator_error"](), nth=1)
        with pytest.raises(grpc.RpcError) as err:
            r = getattr(stub, rpc_name)(runtime_pb2.InferRequest(
                prompt="hello", max_tokens=64, model="faulttiny"))
            if rpc_name == "StreamInfer":
                list(r)
        assert err.value.code() == grpc.StatusCode.INTERNAL
        assert "device fault" in err.value.details()
        assert "retry-after-ms" not in dict(err.value.trailing_metadata() or ())
        assert m.state == "error" and m.error.startswith("device fault")
        assert pool.restarts == 0
        with pytest.raises(grpc.RpcError) as again:
            stub.Infer(runtime_pb2.InferRequest(prompt="after", max_tokens=4,
                                                model="faulttiny"))
        assert again.value.code() == grpc.StatusCode.NOT_FOUND
        health = stub.HealthCheck(common_pb2.Empty())
        assert health.details["faulttiny"] == "error"
        assert "faulttiny.serving" not in health.details
    finally:
        channel.close()
        server.stop(grace=None)
        manager.close()


# -- over gRPC ------------------------------------------------------------------------


@pytest.mark.parametrize("rpc_name", ["Infer", "StreamInfer"])
def test_exhausted_failover_is_unavailable_with_retry_after(monkeypatch, rpc_name):
    monkeypatch.setenv("AIOS_TPU_REPLICAS", "1")
    monkeypatch.setenv("AIOS_TPU_FAILOVER_RETRIES", "1")
    monkeypatch.setenv("AIOS_TPU_FAILOVER_BACKOFF_MS", "5")
    manager = ModelManager(num_slots=2, device="cpu")
    manager.load_model("crashtiny", "synthetic://tiny-test", context_length=128)
    server, _, port = serve(address="127.0.0.1:0", manager=manager, block=False)
    channel = rpc.insecure_channel(f"127.0.0.1:{port}")
    try:
        stub = services.AIRuntimeStub(channel)
        stub.Infer(runtime_pb2.InferRequest(prompt="warm", max_tokens=4))
        faults.activate("seed=4;pool.scheduler_crash=prob:1.0")
        with pytest.raises(grpc.RpcError) as err:
            r = getattr(stub, rpc_name)(runtime_pb2.InferRequest(prompt="hello", max_tokens=64))
            if rpc_name == "StreamInfer":
                list(r)
        faults.deactivate()
        assert err.value.code() == grpc.StatusCode.UNAVAILABLE
        assert int(dict(err.value.trailing_metadata())["retry-after-ms"]) > 0
        assert "scheduler failed" in err.value.details()
        assert stub.Infer(runtime_pb2.InferRequest(prompt="after", max_tokens=4)).tokens_used > 0
        assert manager.get("crashtiny").pool.restarts >= 1
    finally:
        faults.deactivate()
        channel.close()
        server.stop(grace=None)
        manager.close()


def test_plain_handle_without_failover(torch_params):
    """failover_retries 0: the pool hands back the batcher's own handle."""
    eng = TorchEngine(TINY_TEST, torch_params, cache_dtype=torch.float32, device="cpu",
                      **ENGINE_KW)
    pool = ReplicaPool("plain", [eng], ContinuousBatcher,
                       ServingConfig(replicas=1, failover_retries=0))
    try:
        h = pool.submit(Request(prompt_ids=[1, 2], max_tokens=3, temperature=0.0))
        assert isinstance(h, RequestHandle) and len(h.tokens()) == 3
    finally:
        pool.shutdown()
