"""The port's prompt-prefix cache against the JAX package: ``chain_hashes``
bytes, the refcounted allocator and both prefix indexes under one seeded
sequence of matches, registrations, releases and reclaims, prefix-hit
streams against cold streams and the JAX engine's, refcounts that return to
zero, the hit path's first-token logits against a cold chunked admission's,
and the runtime's defaults (radix index on over the pool, chunked
admission) over gRPC on the CPU.

Tolerances: hashes, pages, tables, refcounts and greedy streams exactly;
the hit's logits bit for bit (the same chunks over the same bytes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aios_tpu.engine import model as jm
from aios_tpu.engine import paged as jpaged
from aios_tpu.engine.batching import ContinuousBatcher as JaxBatcher
from aios_tpu.engine.config import TINY_TEST as JAX_TINY
from aios_tpu.engine.engine import TPUEngine
from aios_tpu_torch import rpc, services
from aios_tpu_torch.engine import paged as tpaged
from aios_tpu_torch.engine.batching import ContinuousBatcher
from aios_tpu_torch.engine.config import TINY_TEST
from aios_tpu_torch.engine.engine import TorchEngine
from aios_tpu_torch.engine.weights import params_from_jax
from aios_tpu_torch.proto_gen import common_pb2, runtime_pb2
from aios_tpu_torch.runtime.model_manager import ModelManager
from aios_tpu_torch.runtime.service import serve

# The shapes here are tiny: one intra-op thread is faster and leaves the
# cores to the other test workers.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_params():
    return jm.init_params(JAX_TINY, jax.random.PRNGKey(1), dtype=jnp.float32)


@pytest.fixture(scope="module")
def torch_params(jax_params):
    return params_from_jax(jax.tree.map(np.asarray, jax_params))


# -- hashes --------------------------------------------------------------------


@pytest.mark.parametrize("n,page", [(1, 4), (17, 4), (64, 16), (300, 128), (129, 128)])
def test_chain_hashes_are_the_jax_bytes(n, page):
    ids = [int(t) for t in np.random.default_rng(n).integers(0, 32000, n)]
    blocks = (n - 1) // page
    want = jpaged.chain_hashes(ids, page, blocks)
    got = tpaged.chain_hashes(ids, page, blocks)
    assert got == want and all(isinstance(h, bytes) and len(h) == 32 for h in got)


# -- the allocator and the indexes ----------------------------------------------

PAGE = 4


def _ops(seed: int, n: int = 60):
    """A seeded sequence of (op, args): admissions of prompts drawn from three
    shared preambles with random tails (the slot is freed first), releases
    and pressure reclaims."""
    rng = np.random.default_rng(seed)
    bases = [list(rng.integers(0, 50, 14)) for _ in range(3)]
    out = []
    for _ in range(n):
        r = rng.random()
        slot = int(rng.integers(0, 3))
        if r < 0.6:
            base = bases[int(rng.integers(0, 3))]
            cut = int(rng.integers(0, len(base) + 1))
            tail = list(rng.integers(0, 50, int(rng.integers(1, 10))))
            out.append(("admit", slot, [int(t) for t in base[:cut] + tail]))
        elif r < 0.85:
            out.append(("free", slot, None))
        else:
            out.append(("reclaim", int(rng.integers(1, 5)), None))
    return out


def _drive(mod, index_name: str, ops):
    """Run ``ops`` on ``mod``'s allocator and index as the engines do
    (match, map_shared, ensure, put the prompt's full blocks); returns what
    each op did and the state after it."""
    alloc = mod.PageAllocator(24, PAGE, 3, 8)
    index = getattr(mod, index_name)(alloc, max_pages=10)
    trace = []
    for op, a, ids in ops:
        if op == "admit":
            alloc.free_slot(a)
            full = (len(ids) - 1) // PAGE
            hashes = mod.chain_hashes(ids, PAGE, full) if full > 0 else []
            pages = index.match(hashes) if hashes else []
            if pages:
                alloc.map_shared(a, pages)
            try:
                alloc.ensure(a, len(ids))
                index.put(hashes, [int(alloc.tables[a, b]) for b in range(len(hashes))])
                trace.append(("admit", pages))
            except mod.PoolExhausted:
                alloc.free_slot(a)
                trace.append(("exhausted", pages))
        elif op == "free":
            alloc.free_slot(a)
        else:
            trace.append(("reclaim", index.reclaim(a), index.reclaimable()))
        trace.append((sorted(index.snapshot().items()), alloc.free_pages,
                      alloc.tables.tolist(), alloc.refcounts(range(24)).tolist(),
                      index.hits, index.misses, index.peek(hashes) if op == "admit" else 0))
    return trace, alloc, index


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("index_name", ["PrefixIndex", "RadixPrefixIndex"])
def test_prefix_index_gives_the_jax_pages(index_name, seed):
    ops = _ops(seed)
    want, _, _ = _drive(jpaged, index_name, ops)
    got, alloc, index = _drive(tpaged, index_name, ops)
    assert got == want
    assert any(t[0] == "admit" and t[1] for t in got if len(t) == 2)  # some hit
    for s in range(3):
        alloc.free_slot(s)
    index.clear()
    assert not alloc.refcounts(range(24)).any()
    assert alloc.free_pages == alloc.num_pages - 1


def test_shared_pages_survive_their_first_owner():
    alloc = tpaged.PageAllocator(10, PAGE, 2, 4)
    index = tpaged.RadixPrefixIndex(alloc, max_pages=8)
    ids = list(range(13))
    hashes = tpaged.chain_hashes(ids, PAGE, 3)
    alloc.ensure(0, 13)
    index.put(hashes, [int(p) for p in alloc.tables[0, :3]])
    alloc.free_slot(0)  # the index keeps the three prefix pages
    assert alloc.pages_in_use() == 3 and index.reclaimable() == 3
    pages = index.match(hashes)
    alloc.map_shared(1, pages)
    assert alloc.refcounts(pages).tolist() == [2, 2, 2] and index.reclaimable() == 0
    assert index.reclaim(3) == 0  # a live slot shares them
    alloc.free_slot(1)
    assert index.reclaim(3) == 3 and alloc.pages_in_use() == 0


def test_alloc_pages_and_append_owned_match_jax():
    """Pages allocated outside a slot and appended after a shared prefix (the
    host tier's landing pages), and an allocation the pool cannot back."""
    out = []
    for mod in (jpaged, tpaged):
        alloc = mod.PageAllocator(10, PAGE, 2, 6)
        index = mod.RadixPrefixIndex(alloc, max_pages=8)
        hashes = mod.chain_hashes(list(range(9)), PAGE, 2)
        alloc.ensure(0, 8)
        index.put(hashes, [int(p) for p in alloc.tables[0, :2]])
        alloc.free_slot(0)
        alloc.map_shared(1, index.match(hashes))
        pages = alloc.alloc_pages(3)
        alloc.append_owned(1, pages)
        with pytest.raises(mod.PoolExhausted):
            alloc.alloc_pages(10)
        out.append((pages, alloc.tables.tolist(), alloc.refcounts(range(10)).tolist(),
                    alloc.free_pages))
        alloc.free_slot(1)
        index.clear()
        assert alloc.pages_in_use() == 0
    assert out[0] == out[1]


# -- the engine ---------------------------------------------------------------


def _port(torch_params, **kw):
    kw.setdefault("num_slots", 4)
    kw.setdefault("max_context", 256)
    kw.setdefault("paged_pool_rows", 4 * 256)
    kw.setdefault("page_size", 32)
    kw.setdefault("cache_dtype", torch.float32)
    return TorchEngine(TINY_TEST, torch_params, device="cpu", **kw)


def _jax(jax_params, **kw):
    kw.setdefault("num_slots", 4)
    kw.setdefault("max_context", 256)
    kw.setdefault("paged_pool_rows", 4 * 256)
    kw.setdefault("page_size", 32)
    kw.setdefault("cache_dtype", jnp.float32)
    return TPUEngine(JAX_TINY, jax_params, **kw)


def test_engine_index_defaults(torch_params, monkeypatch):
    assert isinstance(_port(torch_params).prefix_index, tpaged.RadixPrefixIndex)
    assert isinstance(_port(torch_params, prefix_radix=False).prefix_index, tpaged.PrefixIndex)
    assert _port(torch_params, prefix_cache=False).prefix_index is None
    assert _port(torch_params, paged_pool_rows=None).prefix_index is None  # dense
    monkeypatch.setenv("AIOS_TPU_PREFIX_RADIX", "0")
    assert isinstance(_port(torch_params).prefix_index, tpaged.PrefixIndex)
    eng = _port(torch_params)
    assert eng._prefix_chunk == 256 and eng.allocator.reclaimer == eng.prefix_index.reclaim


def test_prefix_chunked_admission_hit(jax_params, torch_params):
    """tests/test_paged.py:597 on the port: a long prompt resubmitted through
    chunked admission maps its prefix and streams the dense engine's tokens,
    and the JAX engine's."""
    prompt = [int(t) for t in np.random.default_rng(11).integers(1, 500, 180)]
    outs = {}
    for paged in (False, True):
        eng = _port(torch_params, **({} if paged else {"paged_pool_rows": None}))
        b = ContinuousBatcher(eng, prefill_chunk=64)
        try:
            outs[paged] = [b.generate(prompt, max_tokens=12, temperature=0.0)
                           for _ in range(2)]
        finally:
            b.shutdown()
        assert b.last_error is None
        if paged:
            st = eng.stats()
            assert st["prefix_rows_reused"] == 160 and st["prefix_hits"] == 1
            assert eng.allocator.pages_in_use() == len(eng.prefix_index.snapshot()) == 5
    jeng = _jax(jax_params)
    jb = JaxBatcher(jeng, prefill_chunk=64)
    try:
        want = [jb.generate(prompt, max_tokens=12, temperature=0.0) for _ in range(2)]
    finally:
        jb.shutdown()
    assert jeng.prefix_rows_reused == 160
    assert outs[True] == outs[False] == want


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_hit_stream_equals_cold_stream_and_jax(jax_params, torch_params, quant):
    """tests/test_paged.py:396 for both caches: a whole-prompt admission
    registers its blocks, the same prompt again admits its tail through the
    chunked path over the shared pages, and both streams are the cold
    stream of the JAX engine; every reference returns once the index is
    cleared."""
    prompt = [int(t) for t in np.random.default_rng(14).integers(1, 500, 150)]
    cd = (torch.int8, jnp.int8) if quant else (torch.float32, jnp.float32)
    eng = _port(torch_params, cache_dtype=cd[0])
    cold = eng.generate(prompt, max_new_tokens=16, temperature=0.0)
    chunks0 = eng.prefill_chunks
    hit = eng.generate(prompt, max_new_tokens=16, temperature=0.0)
    assert eng.prefix_rows_reused == 128 and eng.prefill_chunks == chunks0 + 1
    jeng = _jax(jax_params, cache_dtype=cd[1])
    want = jeng.generate(prompt, max_new_tokens=16, temperature=0.0)
    want_hit = jeng.generate(prompt, max_new_tokens=16, temperature=0.0)
    assert jeng.prefix_rows_reused == 128
    assert cold == hit == want == want_hit
    pages = eng.prefix_index.snapshot().values()
    assert eng.allocator.refcounts(list(pages)).tolist() == [1] * 4
    eng.prefix_index.clear()
    assert not eng.allocator.refcounts(range(eng.allocator.num_pages)).any()
    assert eng.allocator.pages_in_use() == 0


def test_hit_at_a_chunk_boundary_gives_the_cold_logits_bit_for_bit(torch_params):
    """A matched prefix of whole chunks runs the tail's chunks on the same
    bytes as a cold chunked admission of the same prompt: the first-token
    logits are equal bit for bit."""
    rng = np.random.default_rng(3)
    pre = [int(t) for t in rng.integers(1, 500, 128)]
    a = pre + [int(t) for t in rng.integers(1, 500, 40)]
    b = pre + [int(t) for t in rng.integers(1, 500, 50)]
    eng = _port(torch_params)

    def admit(ids):
        pc = eng.start_chunked_prefill(0, ids, temperature=0.0, chunk=64)
        start = pc.pos
        while pc.step() is None:
            pass
        eng.release(0)
        return start, pc.first_logits

    admit(a)
    start, hit = admit(b)
    assert start == 128 and eng.prefix_rows_reused == 128
    eng.prefix_index.clear()
    start, cold = admit(b)
    assert start == 0
    assert torch.equal(hit, cold)


def test_hit_whose_final_bucket_runs_past_the_context(torch_params):
    """A 7-block match (224 rows) of a 255-token prompt leaves a 31-row tail
    whose 32-row bucket ends past the 256-row context: its padding lands on
    the sacrificial page and the stream is the cold one."""
    rng = np.random.default_rng(4)
    pre = [int(t) for t in rng.integers(1, 500, 224)]
    x = pre + [int(t) for t in rng.integers(1, 500, 31)]
    eng = _port(torch_params)
    eng._prefix_chunk = 32  # the tail admits in 32-row buckets from row 224
    cold = eng.generate(x, max_new_tokens=1, temperature=0.0)
    eng.prefix_index.clear()
    eng.generate(pre + [7] * 20, max_new_tokens=1, temperature=0.0)  # registers 7 blocks
    hit = eng.generate(x, max_new_tokens=1, temperature=0.0)
    assert eng.prefix_rows_reused == 224 and hit == cold


def test_prefix_index_reclaims_under_pressure(torch_params):
    """tests/test_paged.py:580 on the port: cold index pages are reclaimed
    instead of raising PoolExhausted."""
    eng = _port(torch_params, paged_pool_rows=256, page_size=32, num_slots=2)
    rng = np.random.default_rng(10)
    for _ in range(3):
        eng.prefill(0, [int(t) for t in rng.integers(1, 500, 70)], temperature=0.0)
        eng.release(0)
    assert eng.allocator.free_pages < 8  # the index holds pages
    first = eng.prefill(0, [int(t) for t in rng.integers(1, 500, 200)], temperature=0.0)
    assert 0 <= first < TINY_TEST.vocab_size


def test_trimmed_admission_registers_nothing(torch_params):
    """A windowed chunked admission that trimmed its leading blocks has no
    chain from block 0 to publish."""
    cfg = TINY_TEST.scaled(sliding_window=16)
    eng = TorchEngine(cfg, torch_params, num_slots=2, max_context=256,
                      cache_dtype=torch.float32, paged_pool_rows=256, page_size=8,
                      device="cpu")
    prompt = [int(t) for t in np.random.default_rng(15).integers(1, 500, 150)]
    pc = eng.start_chunked_prefill(0, prompt, temperature=0.0, chunk=16)
    while pc.step() is None:
        pass
    assert eng.kv_pages_trimmed > 0 and not eng.prefix_index.snapshot()
    eng.release(0)
    assert eng.allocator.pages_in_use() == 0


# -- the runtime ---------------------------------------------------------------


def test_manager_defaults_and_variables(monkeypatch):
    assert ModelManager(num_slots=2, device="cpu").prefix_cache is True
    monkeypatch.setenv("AIOS_TPU_PREFIX_CACHE", "0")
    assert ModelManager(num_slots=2, device="cpu").prefix_cache is False
    assert ModelManager(num_slots=2, device="cpu", prefix_cache=True).prefix_cache is True


def test_runtime_serves_chunked_admission_and_prefix_hits_over_grpc():
    """The default ModelManager over gRPC: a repeated preamble hits the radix
    index and a prompt longer than 512 tokens admits in chunks, both shown
    in HealthCheck."""
    manager = ModelManager(num_slots=2, device="cpu")
    server, _, port = serve(address="127.0.0.1:0", manager=manager, block=False)
    channel = rpc.insecure_channel(f"127.0.0.1:{port}")
    try:
        stub = services.AIRuntimeStub(channel)
        st = stub.LoadModel(runtime_pb2.LoadModelRequest(
            model_name="tiny", model_path="synthetic://tiny-test", context_length=1024))
        assert st.status == "ready"
        m = manager.get("tiny")
        assert isinstance(m.engine.prefix_index, tpaged.RadixPrefixIndex)
        assert m.batcher.prefill_chunk == 512
        preamble = "You are the planner agent. Follow the plan. " * 8
        for tail in ("List the services.", "Restart the failed one."):
            r = stub.Infer(runtime_pb2.InferRequest(prompt=preamble + tail, max_tokens=4))
            assert r.tokens_used > 0
        r = stub.Infer(runtime_pb2.InferRequest(prompt="Explain the alerts. " * 40,
                                                max_tokens=4))
        assert r.tokens_used > 0
        details = stub.HealthCheck(common_pb2.Empty()).details["tiny.serving"]
        serving = dict(kv.split("=") for kv in details.split(","))
        assert int(serving["prefix_hits"]) == 1
        assert int(serving["prefix_rows_reused"]) == 256
        # the hit's tail, then the 800-byte prompt's two chunks
        assert int(serving["prefill_chunks"]) == 3
        assert serving["prefill_chunk"] == "512"
    finally:
        manager.close()
        channel.close()
        server.stop(grace=None)
