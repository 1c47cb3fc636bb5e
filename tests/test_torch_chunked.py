"""Chunked admission in the port against the JAX package: the chunk forwards
``prefill_chunk`` and ``prefill_chunk_paged`` (bf16-role f32 and int8
caches, a window shorter than the context, both paged write branches and a
de-aligned start whose final bucket runs onto the sacrificial page), the
plain versions of K6 and K7 at the chunk shape against the JAX
``blockwise_cache_attention``, chunked greedy streams against whole-prompt
streams and the JAX engine's, the batcher's interleaving, cancellation and
pool exhaustion during an admission, and the split workspace the engine
reserves for a chunk launch.

Tolerances: attention at 1e-5 (f32, sums in another order), logits at 1e-4,
int8 cache and pool bytes equal, f32 rows within 1e-5, greedy streams
identical. The CUDA kernels
themselves run on the card against their plain versions
(``chip_smoke.py``)."""

import importlib
import threading

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
from aios_tpu_torch import ops
from aios_tpu_torch.engine import engine as engine_mod
from aios_tpu_torch.engine import model as tm
from aios_tpu_torch.engine.batching import ContinuousBatcher, Request
from aios_tpu_torch.engine.config import MISTRAL_7B, TINY_TEST, TINYLLAMA_1_1B
from aios_tpu_torch.engine.engine import TorchEngine
from aios_tpu_torch.engine.weights import params_from_jax
from aios_tpu_torch.ops import split

# The shapes here are tiny: one intra-op thread is faster and leaves the
# cores to the other test workers.
torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
C, P = 128, 16
L, KH, D = TINY_TEST.num_layers, TINY_TEST.num_kv_heads, TINY_TEST.head_dim


@pytest.fixture(scope="module")
def jax_params():
    return jm.init_params(JAX_TINY, jax.random.PRNGKey(0), dtype=jnp.float32)


@pytest.fixture(scope="module")
def torch_params(jax_params):
    return params_from_jax(jax.tree.map(np.asarray, jax_params))


def _cfgs(window):
    return JAX_TINY.scaled(sliding_window=window), TINY_TEST.scaled(sliding_window=window)


def _caches(rng, shape, quant: bool):
    """Numpy caches (and int8 scales) filled with the bytes the JAX quantizer
    gives random rows: the state earlier chunks or other slots left."""
    k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    if not quant:
        return [k, v]
    (kq, ks), (vq, vs) = (tuple(np.array(a) for a in jm.quantize_kv(jnp.asarray(x)))
                          for x in (k, v))
    return [kq, vq, ks, vs]


def _run_both(jfn, tfn, state):
    """One chunk through the JAX function (which returns new caches) and the
    port's (which writes its copies in place); returns both logits and both
    caches as numpy."""
    jstate = [jnp.asarray(a) for a in state]
    tstate = [torch.from_numpy(a.copy()) for a in state]
    jout = jfn(jstate)
    jl = jout[0]
    jcaches = list(jout[1:3]) + (list(jout[3]) if len(state) == 4 else [])
    tl = tfn(tstate)
    return (np.asarray(jl), [np.asarray(a) for a in jcaches],
            tl.numpy(), [t.numpy() for t in tstate])


def _assert_same(jl, jc, tl, tc):
    """Logits at 1e-4; int8 caches byte for byte; f32 caches within 1e-5
    (the K/V rows both models compute differ by f32 sums in another order,
    every other row is the same bytes)."""
    np.testing.assert_allclose(tl, jl, **LOGIT_TOL)
    for got, want in zip(tc, jc):
        if want.dtype == np.int8:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, **TOL)


# -- the chunk forwards ---------------------------------------------------------


@pytest.mark.parametrize("window", [None, 24], ids=["full", "window24"])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_prefill_chunk_matches_jax(jax_params, torch_params, quant, window):
    """Three 32-row chunks of slot 1 over a dense cache of two slots: each
    chunk's logits, and the whole cache after it, as the JAX function's."""
    jcfg, tcfg = _cfgs(window)
    rng = np.random.default_rng(1)
    state = _caches(rng, (L, 2, C, KH, D), quant)
    tokens = rng.integers(0, TINY_TEST.vocab_size, (1, 96))
    for start in (0, 32, 64):
        chunk = tokens[:, start:start + 32]

        def jfn(st, start=start, chunk=chunk):
            return jm.prefill_chunk(jax_params, jcfg, jnp.asarray(chunk, jnp.int32),
                                    jnp.int32(1), jnp.int32(start), st[0], st[1],
                                    cache_scales=(st[2], st[3]) if quant else None)

        def tfn(st, start=start, chunk=chunk):
            return tm.prefill_chunk(torch_params, tcfg, torch.from_numpy(chunk), 1, start,
                                    st[0], st[1],
                                    cache_scales=(st[2], st[3]) if quant else None)

        jl, jc, tl, tc = _run_both(jfn, tfn, state)
        _assert_same(jl, jc, tl, tc)
        state = jc


# (chunk rows Tc, starts): whole pages from page-aligned starts, rows inside
# one page, and a de-aligned final bucket (a 7-block prefix match, then 32
# rows) whose padding runs past the slot's 8 blocks onto page 0
PAGED_CASES = {
    "whole-pages": (32, (0, 32, 64)),
    "in-page": (8, (0, 8, 16, 24)),
    "overrun": (32, (112,)),
}


@pytest.mark.parametrize("case", sorted(PAGED_CASES))
@pytest.mark.parametrize("window", [None, 24], ids=["full", "window24"])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_prefill_chunk_paged_matches_jax(jax_params, torch_params, quant, window, case):
    jcfg, tcfg = _cfgs(window)
    Tc, starts = PAGED_CASES[case]
    rng = np.random.default_rng(2)
    N, MB = 20, C // P
    state = _caches(rng, (L, N, P, KH, D), quant)
    table = (rng.permutation(N - 1)[:MB] + 1).astype(np.int32)  # page 0 sacrificial
    tokens = rng.integers(0, TINY_TEST.vocab_size, (1, starts[-1] + Tc))
    for start in starts:
        chunk = tokens[:, start:start + Tc]

        def jfn(st, start=start, chunk=chunk):
            return jm.prefill_chunk_paged(jax_params, jcfg, jnp.asarray(chunk, jnp.int32),
                                          jnp.int32(start), st[0], st[1], jnp.asarray(table),
                                          cache_scales=(st[2], st[3]) if quant else None)

        def tfn(st, start=start, chunk=chunk):
            return tm.prefill_chunk_paged(torch_params, tcfg, torch.from_numpy(chunk), start,
                                          st[0], st[1], torch.from_numpy(table),
                                          cache_scales=(st[2], st[3]) if quant else None)

        jl, jc, tl, tc = _run_both(jfn, tfn, state)
        if case == "overrun":
            # rows past the cache end are saturated queries: unconsumed
            n = C - start
            jl, tl = jl[:, :n], tl[:, :n]
            assert not np.array_equal(jc[0][:, 0], state[0][:, 0])  # page 0 took them
        _assert_same(jl, jc, tl, tc)
        state = jc


def test_chunk_write_rows_pad_the_table_with_the_sacrificial_page():
    table = torch.tensor([5, 6, 7, 8], dtype=torch.int32)
    pages, offs = tm.chunk_write_rows(table, torch.tensor([48]), 32, 16)
    assert pages.tolist() == [8] * 16 + [0] * 16
    assert offs.tolist() == list(range(16)) * 2
    pages, offs = tm.chunk_write_rows(table, torch.tensor([40]), 8, 16)
    assert pages.tolist() == [7] * 8 and offs.tolist() == list(range(8, 16))


# -- K6 and K7's plain versions at the chunk shape ------------------------------


@pytest.mark.parametrize("start,Tc,window", [(0, 32, None), (40, 32, None), (96, 32, 24),
                                             (64, 64, 40), (17, 8, None), (112, 32, None)])
@pytest.mark.parametrize("quant", [False, True], ids=["k6", "k7"])
def test_chunk_attention_references_match_blockwise(quant, start, Tc, window):
    """multiquery_decode_attention(_int8)_reference with B = 1, lengths =
    [start], strides = [1] is JAX's blockwise_cache_attention over the
    slot's rows (int8: over the cache dequantized in f32); the queries of a
    chunk that runs past the cache end are left out."""
    rng = np.random.default_rng(start + Tc)
    H = TINY_TEST.num_heads
    q = rng.normal(size=(1, Tc, H, D)).astype(np.float32)
    caches = _caches(rng, (1, C, KH, D), quant)
    abs_pos = jnp.asarray(start + np.arange(Tc))
    if quant:
        k, v = (jm.dequantize_kv(jnp.asarray(c), jnp.asarray(s), jnp.float32)
                for c, s in zip(caches[:2], caches[2:]))
        ref = ops.multiquery_decode_attention_int8_reference
    else:
        k, v = (jnp.asarray(c) for c in caches)
        ref = ops.multiquery_decode_attention_reference
    want = np.asarray(jm.blockwise_cache_attention(jnp.asarray(q), k, v, abs_pos, window,
                                                   block=32))
    got = ref(torch.from_numpy(q), *(torch.from_numpy(c) for c in caches),
              torch.tensor([start], dtype=torch.int32), torch.ones(1, dtype=torch.int32),
              window=window).numpy()
    n = min(Tc, C - start)
    np.testing.assert_allclose(got[:, :n], want[:, :n], **TOL)


# -- the engine ---------------------------------------------------------------


def _port(torch_params, cfg=TINY_TEST, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_context", C)
    kw.setdefault("cache_dtype", torch.float32)
    return TorchEngine(cfg, torch_params, device="cpu", **kw)


def _jax(jax_params, cfg=JAX_TINY, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_context", C)
    kw.setdefault("cache_dtype", jnp.float32)
    return TPUEngine(cfg, jax_params, **kw)


def _chunked(eng, slot, prompt, chunk):
    pc = eng.start_chunked_prefill(slot, prompt, temperature=0.0, chunk=chunk)
    first, steps = None, 0
    while first is None:
        first = pc.step()
        steps += 1
    return first, steps


def test_chunked_prefill_matches_monolithic_and_jax(jax_params, torch_params):
    """tests/test_engine.py:45 on the port: a 99-token prompt in 32-token
    chunks (4 of them) gives whole-prompt prefill's first token and greedy
    continuation, and the JAX engine's."""
    prompt = (np.arange(1, 100) % 250 + 1).tolist()
    eng = _port(torch_params)
    first_a = eng.prefill(0, prompt, temperature=0.0)
    toks_a = [first_a] + eng.step(8)[:, 0].tolist()
    eng.release(0)
    first_b, steps = _chunked(eng, 1, prompt, 32)
    toks_b = [first_b] + eng.step(8)[:, 1].tolist()
    eng.release(1)
    assert steps == 4  # 32 + 32 + 32 + 3
    assert eng.stats()["prefill_chunks"] == 4 and eng.stats()["prefills"] == 1
    jeng = _jax(jax_params)
    first_j, _ = _chunked(jeng, 1, prompt, 32)
    toks_j = [first_j] + [int(t) for t in jeng.step(8)[:, 1]]
    assert toks_b == toks_a == toks_j


def test_chunked_prefill_int8_cache_matches_monolithic_and_jax(jax_params, torch_params):
    """tests/test_engine.py:67 on the port: over an int8 dense cache, rows
    quantize on write as whole-prompt prefill's do."""
    prompt = (np.arange(1, 80) % 250 + 1).tolist()
    a = _port(torch_params, cache_dtype=torch.int8)
    b = _port(torch_params, cache_dtype=torch.int8)
    first_a = a.prefill(0, prompt, temperature=0.0)
    toks_a = [first_a] + a.step(6)[:, 0].tolist()
    first_b, _ = _chunked(b, 0, prompt, 32)
    toks_b = [first_b] + b.step(6)[:, 0].tolist()
    jeng = _jax(jax_params, cache_dtype=jnp.int8)
    first_j, _ = _chunked(jeng, 0, prompt, 32)
    toks_j = [first_j] + [int(t) for t in jeng.step(6)[:, 0]]
    assert toks_b == toks_a == toks_j
    # the chunks wrote the JAX engine's cache bytes and scales
    n = len(prompt) + 6
    for name, key in (("k_pool", "k"), ("v_pool", "v"), ("k_scales", "k_s"),
                      ("v_scales", "v_s")):
        got = getattr(b, name)[:, 0, :n].numpy()
        want = np.asarray(jeng.state[key])[:, 0, :n]
        if want.dtype == np.int8:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_chunked_prefill_rejects_non_bucket_chunk(torch_params):
    """tests/test_engine.py:87 on the port."""
    eng = _port(torch_params)
    with pytest.raises(ValueError, match="prefill bucket"):
        eng.start_chunked_prefill(0, [1, 2, 3], chunk=48)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_paged_chunked_prefill_matches_monolithic_and_jax(jax_params, torch_params, quant):
    """tests/test_paged.py:217 on the port: a 150-token prompt in 64-token
    chunks through the page tables lands where whole-prompt prefill does,
    with the JAX engine's tokens and pool rows."""
    prompt = [int(t) for t in np.random.default_rng(5).integers(1, 500, 150)]
    kw = dict(paged_pool_rows=4 * 256, page_size=32, prefix_cache=False, max_context=256,
              num_slots=4, cache_dtype=torch.int8 if quant else torch.float32)
    eng = _port(torch_params, **kw)
    mono = [eng.prefill(0, prompt, temperature=0.0)] + eng.step(8)[:, 0].tolist()
    eng.release(0)
    eng = _port(torch_params, **kw)
    first, _ = _chunked(eng, 0, prompt, 64)
    got = [first] + eng.step(8)[:, 0].tolist()
    jeng = _jax(jax_params, paged_pool_rows=4 * 256, page_size=32, prefix_cache=False,
                max_context=256, num_slots=4,
                cache_dtype=jnp.int8 if quant else jnp.float32)
    first_j, _ = _chunked(jeng, 0, prompt, 64)
    want = [first_j] + [int(t) for t in jeng.step(8)[:, 0]]
    assert got == mono == want
    np.testing.assert_array_equal(eng.allocator.tables, jeng.allocator.tables)
    pages = eng.allocator.tables[0, :eng.allocator.blocks_for(len(prompt))]
    n = len(prompt)
    for name, pool in (("k", eng.k_pool), ("v", eng.v_pool)):
        got_rows = pool[:, pages].reshape(L, -1, KH, D)[:, :n].numpy()
        want_rows = np.asarray(jeng.state[name])[:, pages].reshape(L, -1, KH, D)[:, :n]
        if quant:
            np.testing.assert_array_equal(got_rows, want_rows)
        else:
            np.testing.assert_allclose(got_rows, want_rows, **TOL)


def _batcher_streams(batcher, prompts, max_tokens=24):
    hs = [batcher.submit(Request(prompt_ids=p, max_tokens=max_tokens, temperature=0.0))
          for p in prompts]
    return [h.tokens() for h in hs]


def test_paged_chunked_prefill_interleaved_decode(jax_params, torch_params):
    """tests/test_paged.py:237 on the port: a chunked admission with decode
    dispatches between its chunks gives both slots the dense engine's
    streams and the JAX batcher's; decode steps ran between the chunks."""
    long_prompt = [int(t) for t in np.random.default_rng(6).integers(1, 500, 150)]
    prompts = [[1, 2, 3], long_prompt]
    outs = {}
    for paged in (False, True):
        kw = dict(paged_pool_rows=4 * 256, page_size=32) if paged else {}
        eng = _port(torch_params, max_context=256, num_slots=4, **kw)
        trace = []
        chunk_fwd, step = eng._chunk_forward, eng.step
        eng._chunk_forward = lambda *a: (trace.append("C"), chunk_fwd(*a))[1]
        eng.step = lambda n: (trace.append("S"), step(n))[1]
        b = ContinuousBatcher(eng, prefill_chunk=64)
        assert b.prefill_chunk == 64
        try:
            outs[paged] = _batcher_streams(b, prompts)
        finally:
            b.shutdown()
        assert b.last_error is None
        chunks = "".join(trace).strip("S")
        assert chunks.count("C") == 3 and chunks.count("S") >= 2, trace
    jeng = _jax(jax_params, paged_pool_rows=4 * 256, page_size=32, max_context=256,
                num_slots=4)
    jb = JaxBatcher(jeng, prefill_chunk=64)
    try:
        hs = [jb.submit(JaxRequest(prompt_ids=p, max_tokens=24, temperature=0.0))
              for p in prompts]
        want = [h.tokens() for h in hs]
    finally:
        jb.shutdown()
    assert outs[True] == outs[False] == want


def test_chunked_admission_exhaustion_survives(torch_params):
    """tests/test_paged.py:257 on the port: pool exhaustion in the middle of
    an admission never kills the scheduler; every stream ends and every
    page returns."""
    eng = _port(torch_params, paged_pool_rows=128, page_size=32, prefix_cache=False)
    b = ContinuousBatcher(eng, prefill_chunk=64)
    small = b.submit(Request(prompt_ids=[1, 2, 3], max_tokens=60, temperature=0.0))
    big = b.submit(Request(prompt_ids=[2] * 120, max_tokens=8, temperature=0.0))
    small_out, big_out = small.tokens(), big.tokens()
    b.shutdown()
    assert b.last_error is None
    assert len(small_out) > 0 and len(big_out) <= 8
    assert eng.allocator.pages_in_use() == 0


def test_chunked_admission_fails_alone_when_nothing_can_be_evicted(torch_params):
    """With no live stream to evict, an admission the pool cannot finish
    fails by itself (its partial pages return) and the next request is
    served."""
    eng = _port(torch_params, paged_pool_rows=96, page_size=32, prefix_cache=False)
    b = ContinuousBatcher(eng, prefill_chunk=32)
    calls = {"n": 0}
    ensure = eng.allocator.ensure

    def starved(slot, rows):  # the third chunk finds the pool full
        calls["n"] += 1
        if calls["n"] == 3:
            raise engine_mod.paged.PoolExhausted(1, 0)
        return ensure(slot, rows)

    eng.allocator.ensure = starved
    h = b.submit(Request(prompt_ids=[5] * 90, max_tokens=4, temperature=0.0))
    assert h.tokens() == [] and h.abort_reason == "evicted: KV pool exhausted"
    eng.allocator.ensure = ensure
    assert eng.allocator.pages_in_use() == 0
    assert len(b.generate([1, 2, 3], max_tokens=4, temperature=0.0)) == 4
    b.shutdown()
    assert b.last_error is None


def test_cancel_during_chunked_admission_releases_the_reserved_slot(torch_params):
    """A request cancelled between two of its chunks frees its reserved slot
    and its pages at the next scheduler pass; the batcher serves on."""
    eng = _port(torch_params, paged_pool_rows=4 * 256, page_size=32, prefix_cache=False)
    b = ContinuousBatcher(eng, prefill_chunk=32)
    gate, stepped = threading.Event(), threading.Event()
    chunk_fwd = eng._chunk_forward

    def slow(*a):  # hold the scheduler inside the first chunk
        stepped.set()
        gate.wait(10)
        return chunk_fwd(*a)

    eng._chunk_forward = slow
    h = b.submit(Request(prompt_ids=[7] * 100, max_tokens=8, temperature=0.0))
    assert stepped.wait(10)
    assert b.queue_depth() == 1  # the admission in flight counts as waiting
    h.cancel()
    gate.set()
    assert h.tokens() == []
    eng._chunk_forward = chunk_fwd
    assert len(b.generate([1, 2, 3], max_tokens=4, temperature=0.0)) == 4
    b.shutdown()
    assert b.last_error is None and b.cancellations == 1
    assert b._prefilling is None and b._reserved_slot == -1
    assert eng.allocator.pages_in_use() == 0 and not eng.active.any()


def test_windowed_chunked_admission_fits_small_pool(jax_params, torch_params):
    """tests/test_paged.py:341 on the port: a windowed prompt larger than
    the pool chunk-admits, trimming the blocks no later chunk can see; the
    batcher's up-front feasibility check accounts for the trimming."""
    jcfg, tcfg = _cfgs(16)
    wj = jm.init_params(jcfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    wt = params_from_jax(jax.tree.map(np.asarray, wj))
    prompt = [int(t) for t in np.random.default_rng(15).integers(1, 500, 150)]
    dense = _port(wt, tcfg, max_context=256)
    first, _ = _chunked(dense, 0, prompt, 16)
    ref = [first] + dense.step(8)[:, 0].tolist()
    eng = _port(wt, tcfg, max_context=256, paged_pool_rows=80, page_size=8)
    first, _ = _chunked(eng, 0, prompt, 16)  # 150 rows through an 80-row pool
    got = [first] + eng.step(8)[:, 0].tolist()
    assert eng.allocator.pages_in_use() <= 10 and eng.kv_pages_trimmed > 0
    eng.release(0)
    jeng = _jax(wj, jcfg, max_context=256, paged_pool_rows=80, page_size=8)
    first_j, _ = _chunked(jeng, 0, prompt, 16)
    want = [first_j] + [int(t) for t in jeng.step(8)[:, 0]]
    assert got == ref == want
    b = ContinuousBatcher(eng, prefill_chunk=16)
    out = b.generate(prompt, max_tokens=6, temperature=0.0)
    b.shutdown()
    assert b.last_error is None and out == ref[:6]


def test_batcher_chunk_off_when_the_buckets_cannot_honour_it(torch_params):
    eng = _port(torch_params)
    assert ContinuousBatcher(eng, prefill_chunk=48).prefill_chunk is None  # not a bucket
    assert ContinuousBatcher(eng, prefill_chunk=0).prefill_chunk is None
    # the engine's default (512) exceeds this 128-row context
    assert ContinuousBatcher(eng).prefill_chunk is None
    eng = _port(torch_params, max_context=1024)
    assert ContinuousBatcher(eng).prefill_chunk == 512


# -- the split workspace of a chunk launch --------------------------------------


@pytest.mark.parametrize("cfg,floats", [(TINYLLAMA_1_1B, 8_650_752), (MISTRAL_7B, 17_039_360)],
                         ids=["tinyllama", "mistral"])
def test_workspace_covers_the_chunk_launch(cfg, floats):
    """A 512-row chunk over the whole context is the largest split launch of
    a paged engine (KH x ceil(512 G / 64) = 256 groups split 8 ways on an
    H100's 132 SMs) and sets the workspace the engine reserves."""
    launches = engine_mod.workspace_launches(cfg, 8, cfg.max_context, chunk=512,
                                             speculative=False, sms=132)
    assert launches[-1] == (256, 8, 64)
    assert engine_mod.workspace_floats(launches, cfg.head_dim) == floats
    without = engine_mod.workspace_launches(cfg, 8, cfg.max_context, chunk=None,
                                            speculative=True, sms=132)
    assert engine_mod.workspace_floats(without, cfg.head_dim) < floats


def test_the_engine_reserves_its_chunk_launch(torch_params, monkeypatch, sms=132):
    """The split workspace an engine reserves before its first capture takes
    a chunk of the admission (B = 1, T = 512 over the context), so a held
    workspace never has to grow for one; a larger chunk was not reserved."""
    stream = 0xC4A1

    class Stream:
        cuda_stream = stream

    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: Stream())
    monkeypatch.setattr(engine_mod, "sm_count", lambda index: sms)
    eng = _port(torch_params, max_context=1024, paged_pool_rows=4096, num_slots=8)
    dev, key = eng.device, (eng.device.index, stream)
    KH, G = TINY_TEST.num_kv_heads, TINY_TEST.num_heads // TINY_TEST.num_kv_heads
    splits = split.split_plan(1024, 1, KH, sms)
    try:
        eng._reserve_workspaces()
        split.hold(dev, stream)
        split.workspace(dev, stream, *split.launch_groups(1, KH, 512 * G)[:1], splits, D,
                        split.MQ_BLOCK_ROWS)
        groups, rows = split.launch_groups(1, KH, 1024 * G)
        with pytest.raises(RuntimeError, match="held"):
            split.workspace(dev, stream, groups, splits, D, rows)
    finally:
        split._workspaces.pop(key, None)
        importlib.import_module("aios_tpu_torch.ops.quantized_matmul")._counters.pop(key, None)
