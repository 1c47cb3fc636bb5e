"""Window+sink KV compression in the port against the JAX package: the
allocator's ``prune_range``, the sink mask through the paged forwards (K3
and K4's predicate in ``decode_step_paged``, K6 and K7's new one in
``verify_step_paged`` and the chunk forward), the engine's pruning at
decode and mid-admission, the prefix registration of the sink chain, the
host tier under pruning and the speculation guards.

The twin of ``tests/test_longctx.py`` less its three sequence-sharded tests,
which wait for the multi-card port. Both packages run TINY_TEST at a
512-row context on the same f32 weights (``params_from_jax``) over f32 pools
of 32-row pages (int8 where named): greedy streams, live-window starts,
pruned and resident pages and the counters are held equal to the JAX
engine's; the sink predicate's plain twins to the JAX mask at 1e-5 in f32.
"""

import ctypes
import importlib
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aios_tpu.engine import model as jm
from aios_tpu.engine import spec as jspec
from aios_tpu.engine.config import TINY_TEST as JAX_TINY
from aios_tpu.engine.engine import TPUEngine
from aios_tpu.engine.paged import PageAllocator as JaxAllocator
from aios_tpu_torch import ops
from aios_tpu_torch.engine import model as tm
from aios_tpu_torch.engine import spec
from aios_tpu_torch.engine.config import TINY_TEST
from aios_tpu_torch.engine.engine import TorchEngine
from aios_tpu_torch.engine.paged import SACRIFICIAL_PAGE, PageAllocator
from aios_tpu_torch.engine.weights import params_from_jax
from aios_tpu_torch.ops import build

dattn = importlib.import_module("aios_tpu_torch.ops.decode_attention")
split = importlib.import_module("aios_tpu_torch.ops.split")

torch.set_num_threads(1)

CTX = 512
JAX_CFG = JAX_TINY.scaled(name="longctx-test", max_context=CTX)
CFG = TINY_TEST.scaled(name="longctx-test", max_context=CTX)
L, KH, D, V = CFG.num_layers, CFG.num_kv_heads, CFG.head_dim, CFG.vocab_size
TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
ARMED = dict(kv_compress_after=256, kv_sink_pages=1, kv_window_pages=4)


@pytest.fixture(scope="module")
def jax_params():
    return jm.init_params(JAX_CFG, jax.random.PRNGKey(0), dtype=jnp.float32)


@pytest.fixture(scope="module")
def torch_params(jax_params):
    return params_from_jax(jax.tree.map(np.asarray, jax_params))


def _kw(**kw):
    base = dict(num_slots=2, max_context=CTX, paged_pool_rows=1024, page_size=32)
    base.update(kw)
    return base


def port(torch_params, cache=torch.float32, **kw):
    return TorchEngine(CFG, torch_params, cache_dtype=cache, device="cpu", **_kw(**kw))


def jaxe(jax_params, cache=jnp.float32, **kw):
    return TPUEngine(JAX_CFG, jax_params, cache_dtype=cache, **_kw(**kw))


def prompt_of(n, seed=0):
    rng = np.random.default_rng(seed)
    return [int(t) for t in rng.integers(1, 500, n)]


def _same_pool_state(te, je):
    """The allocators agree: tables, reference counts, pruned ranges and
    the free pages."""
    ta, ja = te.allocator, je.allocator
    np.testing.assert_array_equal(ta.tables, ja.tables)
    np.testing.assert_array_equal(ta._rc, ja._rc[0])
    assert ta.free_pages == ja.free_pages
    for s in range(te.num_slots):
        assert ta.pruned_range(s) == (int(ja._pruned_lo[s]), int(ja._pruned_hi[s]))
        assert ta.slot_pages_resident(s) == ja.slot_pages_resident(s)
    np.testing.assert_array_equal(te.win_starts(), je._win_starts)
    assert te.kv_pages_pruned == je.kv_pages_pruned
    assert te.kv_compress_slots == je.kv_compress_slots
    assert te.compressed_resident_pages() == je.compressed_resident_pages()


# -- the allocator -----------------------------------------------------------------


def test_prune_range_accounting():
    """prune_range releases the middle once, maps its entries to the
    sacrificial page, grows only forward, and free_slot neither frees a
    pruned block twice nor leaks the others; step for step the JAX
    allocator's tables, counts and free list."""
    ta = PageAllocator(num_pages=32, page_size=16, num_slots=2, max_blocks=16)
    ja = JaxAllocator(num_pages=32, page_size=16, num_slots=2, max_blocks=16)
    for a in (ta, ja):
        a.ensure(0, 10 * 16)
    free0 = ta.free_pages
    assert ta.prune_range(0, 1, 6) == ja.prune_range(0, 1, 6) == 5
    assert ta.free_pages == free0 + 5 and ta.pruned_blocks(0) == 5
    assert all(int(ta.tables[0, b]) == SACRIFICIAL_PAGE for b in range(1, 6))
    for b in [0] + list(range(6, 10)):
        page = int(ta.tables[0, b])
        assert page != SACRIFICIAL_PAGE and ta.refcount(page) == 1
        assert page not in ta._free
    assert ta.prune_range(0, 1, 6) == ja.prune_range(0, 1, 6) == 0
    assert ta.prune_range(0, 1, 8) == ja.prune_range(0, 1, 8) == 2
    assert ta.slot_pages_resident(0) == ja.slot_pages_resident(0) == 3
    np.testing.assert_array_equal(ta.tables, ja.tables)
    np.testing.assert_array_equal(ta._rc, ja._rc[0])
    for a in (ta, ja):
        a.free_slot(0)
    assert ta.free_pages == 31 and ta.pruned_blocks(0) == 0
    assert sorted(ta._free) == sorted(ja._free[0])


def test_prune_shared_page_survives_under_index_reference():
    """A pruned block whose page the prefix index still holds stays
    resident: its count drops by one, not to zero."""
    alloc = PageAllocator(num_pages=16, page_size=16, num_slots=1, max_blocks=8)
    alloc.ensure(0, 4 * 16)
    shared = int(alloc.tables[0, 1])
    alloc.incref(shared)  # the index's reference
    free0 = alloc.free_pages
    alloc.prune_range(0, 1, 3)
    assert alloc.refcount(shared) == 1 and alloc.free_pages == free0 + 1
    alloc.decref(shared)
    assert alloc.free_pages == free0 + 2


# -- the sink predicate's plain twins (K3/K4, K6/K7) against the JAX mask -----------


def _sink_mask(qpos, C, ws, sink):
    """The JAX verify_step_paged mask with compression: causal staircase
    and cols < sink or cols >= ws."""
    cols = np.arange(C)[None, None, :]
    return (cols <= qpos[..., None]) & ((cols < sink) | (cols >= ws[:, None, None]))


@pytest.mark.parametrize("quant", [False, True], ids=["k6", "k7"])
def test_multiquery_sink_predicate_matches_the_jax_mask(quant):
    """K6's and K7's plain twins with win_starts and sink: slot 0
    uncompressed (start 0), slot 1 pruned [32, 96), slot 2 inactive
    (stride 0) with a stale start; each equals the JAX ``gqa_attention``
    under the JAX mask (the int8 cache dequantized, as its gather_dequant
    does), at 1e-5 in f32."""
    rng = np.random.default_rng(3)
    B, T, H, C, sink = 3, 5, 8, 160, 32
    q = rng.normal(size=(B, T, H, 16)).astype(np.float32)
    k = rng.normal(size=(B, C, 2, 16)).astype(np.float32)
    v = rng.normal(size=(B, C, 2, 16)).astype(np.float32)
    lengths = np.array([40, 130, 0], np.int32)
    strides = np.array([1, 1, 0], np.int32)
    ws = np.array([0, 96, 64], np.int32)
    qpos = lengths[:, None] + np.arange(T)[None, :] * strides[:, None]
    eff_ws = np.where(strides > 0, ws, 0)
    mask = _sink_mask(qpos, C, eff_ws, sink)
    t = [torch.from_numpy(a) for a in (q, lengths, strides, eff_ws)]
    if quant:
        (kq, ks), (vq, vs) = (jm.quantize_kv(jnp.asarray(a)) for a in (k, v))
        want = jm.gqa_attention(jnp.asarray(q), jm.dequantize_kv(kq, ks, jnp.float32),
                                jm.dequantize_kv(vq, vs, jnp.float32), jnp.asarray(mask))
        got = ops.multiquery_decode_attention_int8(
            t[0], *(torch.from_numpy(np.array(a)) for a in (kq, vq, ks, vs)), t[1], t[2],
            win_starts=t[3], sink=sink)
    else:
        want = jm.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(mask))
        got = ops.multiquery_decode_attention(t[0], torch.from_numpy(k), torch.from_numpy(v),
                                              t[1], t[2], win_starts=t[3], sink=sink)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # without win_starts the predicate is off: the pruned rows count again
    plain = ops.multiquery_decode_attention_reference(
        t[0], torch.from_numpy(k), torch.from_numpy(v), t[1], t[2])
    assert not torch.allclose(plain[1], torch.from_numpy(np.asarray(want))[1], atol=1e-3)


def _pools(rng, quant, N=24, P=32):
    shape = (L, N, P, KH, D)
    if quant:
        (kq, ks), (vq, vs) = (tuple(np.array(a) for a in jm.quantize_kv(
            jnp.asarray(rng.normal(size=shape).astype(np.float32)))) for _ in range(2))
        return [kq, vq, ks, vs]
    return [rng.normal(size=shape).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_paged_forwards_with_the_sink_mask_match_jax(jax_params, torch_params, quant):
    """``decode_step_paged`` (K3/K4's predicate), ``verify_step_paged`` (K6
    and K7's) and ``prefill_chunk_paged`` (K6/K7 at B = 1) with
    win_starts and sink rows: the logits and the pools after the forward
    as the JAX functions', the pruned blocks mapping the sacrificial
    page."""
    rng = np.random.default_rng(11)
    P, MB, sink = 32, 8, 32
    state = _pools(rng, quant)
    tables = np.zeros((3, MB), np.int32)
    tables[:, 0] = [1, 2, 3]
    tables[:, 3:] = np.arange(4, 19).reshape(3, 5)  # blocks 1, 2 pruned to page 0
    tables[2, 1:3] = [20, 21]  # slot 2 not pruned
    lengths = np.array([150, 200, 100], np.int32)
    ws = np.array([96, 96, 0], np.int32)
    active = np.array([True, True, True])
    tokens = rng.integers(0, V, (3, 4)).astype(np.int32)

    def scales(s):
        return (s[2], s[3]) if quant else None

    js = [jnp.asarray(a) for a in state]
    ts = [torch.from_numpy(a.copy()) for a in state]
    jd = jm.decode_step_paged(jax_params, JAX_CFG, jnp.asarray(tokens[:, 0]),
                              jnp.asarray(lengths), js[0], js[1], jnp.asarray(tables),
                              cache_scales=scales(js), active=jnp.asarray(active),
                              win_starts=jnp.asarray(ws), sink_rows=sink)
    td = tm.decode_step_paged(torch_params, CFG, torch.from_numpy(tokens[:, 0]).long(),
                              torch.from_numpy(lengths), ts[0], ts[1],
                              torch.from_numpy(tables), active=torch.from_numpy(active),
                              cache_scales=scales(ts), win_starts=torch.from_numpy(ws),
                              sink_rows=sink)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd[0]), **LOGIT_TOL)
    js = [jnp.asarray(a) for a in state]
    ts = [torch.from_numpy(a.copy()) for a in state]
    jv = jm.verify_step_paged(jax_params, JAX_CFG, jnp.asarray(tokens), jnp.asarray(lengths),
                              js[0], js[1], jnp.asarray(tables), cache_scales=scales(js),
                              active=jnp.asarray(active), win_starts=jnp.asarray(ws),
                              sink_rows=sink)
    tv = tm.verify_step_paged(torch_params, CFG, torch.from_numpy(tokens).long(),
                              torch.from_numpy(lengths), ts[0], ts[1],
                              torch.from_numpy(tables), active=torch.from_numpy(active),
                              cache_scales=scales(ts), win_starts=torch.from_numpy(ws),
                              sink_rows=sink)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv[0]), **LOGIT_TOL)
    for got, want in zip(ts[:2], jv[1:3]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    js = [jnp.asarray(a) for a in state]
    ts = [torch.from_numpy(a.copy()) for a in state]
    chunk = rng.integers(0, V, (1, 32)).astype(np.int32)
    jc = jm.prefill_chunk_paged(jax_params, JAX_CFG, jnp.asarray(chunk), jnp.int32(160),
                                js[0], js[1], jnp.asarray(tables[0]), cache_scales=scales(js),
                                win_start=jnp.int32(96), sink_rows=sink)
    tc = tm.prefill_chunk_paged(torch_params, CFG, torch.from_numpy(chunk).long(), 160,
                                ts[0], ts[1], torch.from_numpy(tables[0]),
                                cache_scales=scales(ts),
                                win_start=torch.tensor([96], dtype=torch.int32),
                                sink_rows=sink)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc[0]), **LOGIT_TOL)


def test_sink_entries_take_what_the_wrappers_pass(monkeypatch):
    """K6's and K7's ``_sink`` entry points: what ``launch`` passes, pointer
    for pointer and int for int, is their C parameter list (win_starts
    after strides, the sink rows before the splits), and the launches
    count on K6 and K7; without win_starts the plain entries are called."""
    text = (build.CSRC / "dense_attention.cu").read_text()

    def params_of(symbol):
        sig = text[text.index(f'extern "C" int {symbol}('):]
        kinds = []
        for p in sig[sig.index("(") + 1:sig.index(")")].split(","):
            p = " ".join(p.split())
            kinds.append(ctypes.c_void_p if "*" in p else
                         ctypes.c_float if p.startswith("float") else ctypes.c_int)
        return kinds

    seen = []

    def kernel(name, symbol, argtypes):
        return lambda *args: seen.append((symbol, list(argtypes), args)) or 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(dattn.build, "kernel", kernel)
    monkeypatch.setattr(dattn, "workspace", lambda *a, **k: (4096, 8192))
    monkeypatch.setattr(dattn, "sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream())
    B, T = 3, 5
    q = torch.zeros((B, T, 8, 64), dtype=torch.bfloat16)
    idx = torch.zeros(B, dtype=torch.int32)
    for wrapper, entry, cache, scales in (
            (ops.multiquery_decode_attention, "aios_multiquery_decode_attention",
             torch.bfloat16, ()),
            (ops.multiquery_decode_attention_int8, "aios_multiquery_decode_attention_int8",
             torch.int8, (torch.ones(B, 256, 2),) * 2)):
        k = torch.zeros((B, 256, 2, 64), dtype=cache)
        before = wrapper.launches
        for sink in (False, True):
            extra = (idx, 32) if sink else None
            dattn.launch(wrapper, entry + ("_sink" if sink else ""), q, k, k, scales,
                         (idx, idx) + ((extra[0],) if sink else ()), None, split=True,
                         sink=extra[1] if sink else None)
            symbol, argtypes, args = seen[-1]
            assert symbol == entry + ("_sink" if sink else "")
            assert argtypes == params_of(symbol) and len(args) == len(argtypes)
            if sink:
                assert args[len(argtypes) - 4] == 32  # ..., sink, splits, sm_scale, stream
        assert wrapper.launches == before + 2
    # the kernels' contract, checked before a CUDA launch: a sink of whole
    # 32-row slices and no window
    vattn = importlib.import_module("aios_tpu_torch.ops.verify_attention")
    vattn._check_sink((idx,), 128, None)
    vattn._check_sink((), 24, 64)  # no predicate, no contract
    for sink, window in ((24, None), (32, 64)):
        with pytest.raises(ValueError, match="multiple of 32"):
            vattn._check_sink((idx,), sink, window)


# -- the engine ---------------------------------------------------------------------


def test_below_threshold_token_identity(jax_params, torch_params):
    """Armed but never triggered, compression is the exact path: the
    stream of the plain engine and of the JAX armed engine, no prune, all
    starts 0."""
    plain = port(torch_params)
    armed = port(torch_params, kv_compress_after=320, kv_sink_pages=1, kv_window_pages=4)
    je = jaxe(jax_params, kv_compress_after=320, kv_sink_pages=1, kv_window_pages=4)
    assert armed.kv_compress_armed and je.kv_compress_armed
    try:
        ids = prompt_of(100, seed=3)
        a = plain.generate(ids, max_new_tokens=24, temperature=0.0)
        b = armed.generate(ids, max_new_tokens=24, temperature=0.0)
        c = je.generate(ids, max_new_tokens=24, temperature=0.0)
        assert a == b == c
        assert armed.kv_pages_pruned == armed.kv_compress_slots == 0
        assert int(armed.win_starts().sum()) == 0
        assert "kv_compress_slots" in armed.stats()
    finally:
        for e in (plain, armed, je):
            e.close()


@pytest.fixture(scope="module")
def armed_pair(jax_params, torch_params):
    """Armed engines of both packages, without the prefix index: a hit's
    readmission above the threshold would take the chunked path, another
    (deterministic) attention schedule than the cold prefill."""
    te = port(torch_params, prefix_cache=False, **ARMED)
    je = jaxe(jax_params, prefix_cache=False, **ARMED)
    yield te, je
    te.close()
    je.close()


def test_long_decode_prunes_and_stays_deterministic(armed_pair):
    """A slot crossing the threshold prunes to sink + window and decodes
    on: the JAX stream, pruned pages and counters; the stream repeats; no
    page is at once free and mapped."""
    te, je = armed_pair
    ids = prompt_of(300, seed=4)
    out1 = te.generate(ids, max_new_tokens=48, temperature=0.0)
    want = je.generate(ids, max_new_tokens=48, temperature=0.0)
    assert out1 == want
    assert te.kv_pages_pruned == je.kv_pages_pruned > 0
    assert te.kv_compress_slots == je.kv_compress_slots >= 1
    # the engines stay in step (their free lists too) for the next test
    assert te.generate(ids, max_new_tokens=48, temperature=0.0) == out1
    assert je.generate(ids, max_new_tokens=48, temperature=0.0) == out1
    alloc = te.allocator
    mapped = {int(alloc.tables[s, b]) for s in range(te.num_slots)
              for b in range(int(alloc._blocks_used[s]))} - {SACRIFICIAL_PAGE}
    assert not mapped & set(alloc._free), "page free and mapped at once"


def test_prune_respects_live_window_accounting(armed_pair):
    """Mid-decode the live-window start is page aligned and inside the
    window, resident pages are mapped less pruned, and the starts, tables,
    counts and residency are the JAX engine's; release resets the start."""
    te, je = armed_pair
    ids = prompt_of(300, seed=5)
    assert te.prefill(0, ids, temperature=0.0) == je.prefill(0, ids, temperature=0.0)
    np.testing.assert_array_equal(te.step(32)[:, 0], je.step(32)[:, 0])
    ws = int(te.win_starts()[0])
    P = te.allocator.page_size
    assert ws > 0 and ws % P == 0 and ws <= te.slot_length(0) - te.kv_window_pages * P
    assert te.allocator.slot_pages_resident(0) == (
        int(te.allocator._blocks_used[0]) - te.allocator.pruned_blocks(0))
    # sink, window and its partial block, and the page the dispatch backed
    # ahead of the rows it wrote
    assert te.compressed_resident_pages() <= (te.kv_sink_pages + te.kv_window_pages + 1
                                              + te.allocator.blocks_for(32))
    _same_pool_state(te, je)
    assert te.stats()["kv_compress_resident_pages"] == je.stats()["kv_compress_resident_pages"]
    te.release(0)
    je.release(0)
    assert int(te.win_starts()[0]) == 0
    _same_pool_state(te, je)


@pytest.mark.parametrize("cache", ["f32", "int8"])
def test_chunked_admission_prunes_midflight(jax_params, torch_params, cache):
    """A prompt longer than the pool can back whole admits chunk by chunk:
    pruning frees the middle as chunks land (the later chunks mask it
    through K6/K7's predicate); the first token, the starts, the pruned
    pages and the next tokens are the JAX engine's, over an f32 and an
    int8 pool."""
    tdt, jdt = {"f32": (torch.float32, jnp.float32), "int8": (torch.int8, jnp.int8)}[cache]
    kw = dict(paged_pool_rows=320, kv_compress_after=128, kv_sink_pages=1,
              kv_window_pages=2)
    te, je = port(torch_params, cache=tdt, **kw), jaxe(jax_params, cache=jdt, **kw)
    try:
        ids = prompt_of(400, seed=6)
        assert te.allocator.blocks_for(len(ids)) > te.allocator.capacity_blocks()
        firsts = []
        for eng in (te, je):
            pc = eng.start_chunked_prefill(0, ids, chunk=64)
            first = pc.step()
            while first is None:
                first = pc.step()
            firsts.append(first)
        assert firsts[0] == firsts[1]
        assert int(te.win_starts()[0]) > 0 and te.kv_pages_pruned > 0
        _same_pool_state(te, je)
        # the admitted slot's tokens (an idle slot's columns mean nothing)
        np.testing.assert_array_equal(te.step(8)[:, 0], je.step(8)[:, 0])
        _same_pool_state(te, je)
        te.release(0)
        je.release(0)
    finally:
        te.close()
        je.close()


def test_prefix_registration_keeps_only_the_sink_chain(jax_params, torch_params):
    """A chunked admission that pruned its middle publishes only its sink
    blocks to the prefix index (a chain starts at block 0; the rest map the
    sacrificial page), as the JAX engine does: a readmission of the same
    prompt matches the sink rows only."""
    kw = dict(kv_compress_after=128, kv_sink_pages=1, kv_window_pages=2)
    te, je = port(torch_params, **kw), jaxe(jax_params, **kw)
    try:
        ids = prompt_of(300, seed=14)
        for eng in (te, je):
            pc = eng.start_chunked_prefill(0, ids, chunk=64)
            while pc.step() is None:
                pass
            eng.release(0)
        assert len(te.prefix_index.snapshot()) == len(je.prefix_index.snapshot()) == 1
        assert te.prefix_overlap_rows(ids) == 32
        a = te.generate(ids, max_new_tokens=8, temperature=0.0)
        b = je.generate(ids, max_new_tokens=8, temperature=0.0)
        assert a == b and te.prefix_rows_reused == 32
    finally:
        te.close()
        je.close()


def test_pruned_pages_spill_with_valid_crc_and_restore(jax_params, torch_params):
    """Pages pruned from a slot but still held by the prefix index spill
    through the host tier under pressure with valid checksums and restore
    on a later chain hit; the stream after the round trip is the JAX
    engine's."""
    kw = dict(prefix_host_bytes=64 << 20, **ARMED)
    te, je = port(torch_params, **kw), jaxe(jax_params, **kw)
    try:
        ids = prompt_of(250, seed=7)  # below the threshold: the whole chain registers
        for eng in (te, je):
            eng.prefill(0, ids, temperature=0.0)
            for _ in range(8):
                eng.step(8)
        assert te.kv_pages_pruned == je.kv_pages_pruned > 0
        te.release(0)
        before = te.host_store.spills
        with te._lock:
            assert te.prefix_index.reclaim(4) > 0
        deadline = time.time() + 10
        while te.spill_backlog() and time.time() < deadline:
            time.sleep(0.02)
        assert te.host_store.spills > before and te.host_store.corruptions == 0
        out = te.generate(ids, max_new_tokens=16, temperature=0.0)
        assert len(out) == 16 and te.host_store.corruptions == 0
        assert te.host_store.restores >= 1
        free = set(te.allocator._free)
        assert not set(te.prefix_index.snapshot().values()) & free
        je.release(0)
        assert out == je.generate(ids, max_new_tokens=16, temperature=0.0)
    finally:
        te.close()
        je.close()


# -- the speculation guards -----------------------------------------------------------


def test_propose_ngram_min_pos_clamps_to_live_rows():
    """With min_pos, a match only below the live window proposes nothing,
    one inside it still proposes: the JAX proposer's drafts and counts."""
    S, C = 1, 64
    for seqs, lo in (([5, 6, 7, 8] + [9] * 40 + [5, 6], 16),
                     ([9] * 20 + [5, 6, 7, 8] + [9] * 10 + [5, 6], 16)):
        hist = np.zeros((S, C + spec.HISTORY_PAD), np.int64)
        hist[0, :len(seqs)] = seqs
        lengths = np.array([len(seqs) - 1], np.int32)
        for min_pos in (None, np.array([lo], np.int32)):
            jd, jn = jspec.propose_ngram(jnp.asarray(hist.astype(np.int32)),
                                         jnp.asarray(lengths), 4, 2, C,
                                         min_pos=None if min_pos is None
                                         else jnp.asarray(min_pos))
            td, tn = spec.propose_ngram(torch.from_numpy(hist), torch.from_numpy(lengths), 4,
                                        2, C, min_pos=None if min_pos is None
                                        else torch.from_numpy(min_pos))
            np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
            np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert int(tn[0]) > 0  # the match inside the window proposes


def test_spec_on_pruned_slot_stays_greedy_exact(jax_params, torch_params):
    """n-gram speculation over a pruned slot emits the plain stream of the
    same compressed engine and the JAX engine's: proposals come from live
    rows only and the verify runs under the pruned mask (K6's predicate)."""
    a, b = port(torch_params, **ARMED), port(torch_params, **ARMED)
    je = jaxe(jax_params, **ARMED)
    try:
        ids = prompt_of(280, seed=12) + [5, 6, 7, 8] * 6
        plain = a.generate(ids, max_new_tokens=24, temperature=0.0)
        fast = b.generate(ids, max_new_tokens=24, temperature=0.0, speculative=True,
                          draft_len=4, ngram=2)
        want = je.generate(ids, max_new_tokens=24, temperature=0.0, speculative=True,
                           draft_len=4, ngram=2)
        assert plain == fast == want
        assert b.kv_pages_pruned > 0 and int(b.win_starts().sum()) == 0  # released
    finally:
        for e in (a, b, je):
            e.close()


def test_draft_proposer_skips_pruned_slots(jax_params, torch_params):
    """The draft proposer leaves a pruned slot out (its dense cache mirrors
    the whole history the serving attention no longer sees): plain rounds,
    nothing proposed, the stream of plain decode and of the JAX engine."""
    draft = spec.DraftModel(CFG, torch_params, quantize=None)
    eng = port(torch_params, draft=draft, **ARMED)
    plain = port(torch_params, **ARMED)
    jd = jspec.DraftModel(JAX_CFG, jax_params, quantize=None)
    je = jaxe(jax_params, draft=jd, **ARMED)
    try:
        ids = prompt_of(300, seed=13)
        chains = []
        for e in (eng, je):
            chain = [e.prefill(0, ids, temperature=0.0)]
            chain += [int(t) for t in e.step(16)[:, 0]]
            assert int(np.asarray(e._win_starts)[0]) > 0
            toks, counts, proposed = e.spec_step_draft(4, draft_len=3)
            assert int(proposed[:, 0].sum()) == 0 and (counts[:, 0] == 1).all()
            for r in range(toks.shape[0]):
                chain += [int(t) for t in toks[r, 0, :counts[r, 0]]]
            e.release(0)
            chains.append(chain)
        assert chains[0] == chains[1]
        assert chains[0] == plain.generate(ids, max_new_tokens=len(chains[0]),
                                           temperature=0.0)
    finally:
        for e in (eng, plain, je):
            e.close()


# -- the knob's resolution ------------------------------------------------------------


def test_threshold_raised_to_the_floor_and_disarmed_cases(torch_params, jax_params, caplog):
    """The threshold rises to the sink + window floor with the JAX engine's
    message; an unpaged engine and a sliding-window model leave compression
    disarmed with the JAX warnings."""
    import logging

    with caplog.at_level(logging.INFO):
        te = port(torch_params, kv_compress_after=100, kv_sink_pages=2, kv_window_pages=3)
        je = jaxe(jax_params, kv_compress_after=100, kv_sink_pages=2, kv_window_pages=3)
    assert te.kv_compress_after == je.kv_compress_after == 5 * 32
    assert te._sink_rows == je._sink_rows == 64
    raised = [r.getMessage() for r in caplog.records if "raised to sink+window floor" in
              r.getMessage()]
    assert len(raised) == 2 and raised[0] == raised[1]
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        dense = TorchEngine(CFG, torch_params, cache_dtype=torch.float32, device="cpu",
                            num_slots=2, max_context=CTX, kv_compress_after=256)
        windowed = TorchEngine(CFG.scaled(sliding_window=64), torch_params,
                               cache_dtype=torch.float32, device="cpu",
                               **_kw(kv_compress_after=256))
    assert not dense.kv_compress_armed and not windowed.kv_compress_armed
    msgs = " ".join(r.getMessage() for r in caplog.records)
    assert "needs a paged, unreplicated KV pool" in msgs and "is redundant under" in msgs
    for e in (te, je, dense, windowed):
        e.close()
