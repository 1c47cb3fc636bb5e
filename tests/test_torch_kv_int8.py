"""The port's int8 paged KV pool (K4's module, the int8 write path, window
trimming) and its int4 + int8-KV engine and runtime against the JAX package
on the same numpy inputs and the same int4 weights.

Tolerances: K4's plain version against the Pallas kernel in interpret mode
and the JAX reference at ``atol = rtol = 1e-5`` (f32 throughout, sums taken
in another order); model logits at 1e-4 (two layers of such sums);
``quantize_kv`` bytes and scales exactly on the same rows. Rows that the two
models compute themselves differ by such f32 sums, which the int4 matmuls'
bf16 rounding of x can lift to ~1e-5 relative; that moves a row's absmax
and may flip a half-way rounding, so pools written by the models hold
scales to ``rtol = 1e-4`` (the logits' tolerance) and int8 values to within
1, with at most 1% of them off at all. Greedy streams, page tables
and pages in use exactly. The engines quantize on their own side: ``quantize_params`` gives
the same int4 bytes in both packages (tests/test_torch_int4.py). The CUDA
kernel itself runs on the card against its plain version (``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aios_tpu.engine import model as jm
from aios_tpu.engine import paged as jpaged
from aios_tpu.engine.config import TINY_TEST as JAX_TINY
from aios_tpu.engine.engine import TPUEngine
from aios_tpu.ops.paged_attention import paged_decode_attention_int8 as jax_paged8
from aios_tpu.ops.paged_attention import (
    paged_decode_attention_int8_reference as jax_paged8_ref,
)
from aios_tpu_torch import ops, rpc, services
from aios_tpu_torch.engine import model as tm
from aios_tpu_torch.engine import paged as tpaged
from aios_tpu_torch.engine.config import TINY_TEST
from aios_tpu_torch.engine.engine import TorchEngine
from aios_tpu_torch.engine.weights import params_from_jax
from aios_tpu_torch.proto_gen import common_pb2, runtime_pb2
from aios_tpu_torch.runtime.model_manager import ModelManager
from aios_tpu_torch.runtime.service import serve

# The shapes here are tiny: one intra-op thread is faster and leaves the
# cores to the other test workers.
torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


def _assert_pool_close(got: np.ndarray, want: np.ndarray, what: str = "") -> None:
    """An int8 pool or its f32 scales, written by both models."""
    if want.dtype == np.int8:
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.01, what
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=0, err_msg=what)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_params():
    return jm.init_params(JAX_TINY, jax.random.PRNGKey(0), dtype=jnp.float32)


# -- quantize_kv ---------------------------------------------------------------


def test_quantize_kv_same_bytes_as_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 40, 2, 16)).astype(np.float32)
    x[1, 5, 0] = 0.0  # an all-zero row keeps scale 1.0
    x[2, 7, 1, 3] = 50.0  # an outlier sets its row's scale
    # the JAX engine runs quantize_kv compiled, inside its prefill and decode
    qj, sj = jax.jit(jm.quantize_kv)(jnp.asarray(x))
    qt, st = tm.quantize_kv(torch.from_numpy(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert st[1, 5, 0] == 1.0
    np.testing.assert_array_equal(
        tm.dequantize_kv(qt, st, torch.float32).numpy(),
        np.asarray(jm.dequantize_kv(qj, sj, jnp.float32)))


def test_scatter_quant_and_gather_dequant_match_jax():
    rng = np.random.default_rng(1)
    N, P, KH, D = 6, 4, 2, 8
    pool = rng.integers(-127, 128, size=(N, P, KH, D), dtype=np.int8)
    scales = rng.uniform(0.01, 0.1, size=(N, P, KH)).astype(np.float32)
    rows = rng.normal(size=(3, KH, D)).astype(np.float32)
    pages, offs = np.asarray([2, 5, 0]), np.asarray([1, 3, 3])
    jp, js = jax.jit(jm.scatter_quant)(jnp.asarray(pool), jnp.asarray(scales),
                                       jnp.asarray(pages), jnp.asarray(offs),
                                       jnp.asarray(rows))
    tp, ts = torch.from_numpy(pool.copy()), torch.from_numpy(scales.copy())
    tm.scatter_quant(tp, ts, torch.from_numpy(pages), torch.from_numpy(offs),
                     torch.from_numpy(rows))  # in place
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    tables = np.asarray([[2, 5], [0, 1]], np.int32)
    want = jm.gather_dequant(jp, js, jnp.asarray(tables), jnp.float32)
    got = tm.gather_dequant(tp, ts, torch.from_numpy(tables), torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- K4: int8 paged decode attention -------------------------------------------

P, MB, KH_, H_, D_ = 16, 8, 2, 8, 16
# ragged: an empty (inactive) slot, both sides of a page boundary, a long one
LENGTHS = [0, P - 1, P, 37, 2 * P + 3, 5 * P + 9]


def _int8_inputs(seed):
    rng = np.random.default_rng(seed)
    B = len(LENGTHS)
    need = [-(-(n + 1) // P) for n in LENGTHS]
    N = 1 + sum(need) + 2
    free = list(rng.permutation(np.arange(1, N)))  # shuffled physical pages
    tables = np.zeros((B, MB), np.int32)
    for b, n in enumerate(need):
        if LENGTHS[b] == 0:
            continue  # unbacked: maps the sacrificial page 0, like an idle slot
        for i in range(n):
            tables[b, i] = free.pop()
    q = rng.normal(size=(B, H_, D_)).astype(np.float32)
    kq, ks = (np.asarray(a) for a in jm.quantize_kv(
        jnp.asarray(rng.normal(size=(N, P, KH_, D_)).astype(np.float32))))
    vq, vs = (np.asarray(a) for a in jm.quantize_kv(
        jnp.asarray(rng.normal(size=(N, P, KH_, D_)).astype(np.float32))))
    return q, kq, vq, ks, vs, tables, np.asarray(LENGTHS, np.int32)


@pytest.mark.parametrize("case", ["full", "window", "sink"])
def test_paged_decode_attention_int8_matches_jax(case):
    args = _int8_inputs(len(case))
    kw = {}
    if case == "window":
        kw = dict(window=48)
    elif case == "sink":
        kw = dict(win_starts=np.asarray([0, 0, 0, 24, 32, 48], np.int32), sink=P)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    got = ops.paged_decode_attention_int8(*(torch.from_numpy(a) for a in args), **tkw)
    assert got.dtype == torch.float32 and got.shape == (len(LENGTHS), H_, D_)
    jargs = [jnp.asarray(a) for a in args]
    for ref in (jax_paged8(*jargs, interpret=True, **jkw), jax_paged8_ref(*jargs, **jkw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_int8_reference_is_the_bf16_reference_on_dequantized_pools():
    q, kq, vq, ks, vs, tables, lengths = (torch.from_numpy(a) for a in _int8_inputs(9))
    got = ops.paged_decode_attention_int8_reference(q, kq, vq, ks, vs, tables, lengths,
                                                    window=40)
    want = ops.paged_decode_attention_reference(
        q, kq.float() * ks[..., None], vq.float() * vs[..., None], tables, lengths,
        window=40)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


# -- the model over an int8 pool with int4 weights -----------------------------


def test_decode_step_paged_int8_pool_int4_weights_matches_jax(jax_params):
    jp = jm.quantize_params(jax_params, mode="int4")
    tp = params_from_jax(_numpy_tree(jp))
    slots, max_blocks, num_pages = 4, 8, 14
    L, KH, D = TINY_TEST.num_layers, TINY_TEST.num_kv_heads, TINY_TEST.head_dim
    ja = jpaged.PageAllocator(num_pages, P, slots, max_blocks)
    ta = tpaged.PageAllocator(num_pages, P, slots, max_blocks)
    rng = np.random.default_rng(2)
    shape = (L, num_pages, P, KH, D)
    kq, ks = (np.asarray(a) for a in jm.quantize_kv(jnp.asarray(rng.normal(size=shape),
                                                                jnp.float32)))
    vq, vs = (np.asarray(a) for a in jm.quantize_kv(jnp.asarray(rng.normal(size=shape),
                                                                jnp.float32)))
    jk, jv, jks, jvs = (jnp.asarray(a) for a in (kq, vq, ks, vs))
    tk, tv, tks, tvs = (torch.from_numpy(a.copy()) for a in (kq, vq, ks, vs))
    # slot 1 is inactive: it writes the sacrificial page and reads nothing
    lengths = np.asarray([20, 0, 15, 33], np.int32)
    active = np.asarray([True, False, True, True])
    tokens = rng.integers(0, TINY_TEST.vocab_size, slots)
    for _ in range(3):
        for s in np.flatnonzero(active):
            ja.ensure(int(s), int(lengths[s]) + 1)
            ta.ensure(int(s), int(lengths[s]) + 1)
        np.testing.assert_array_equal(ta.tables, ja.tables)
        jl, jk, jv, (jks, jvs) = jm.decode_step_paged(
            jp, JAX_TINY, jnp.asarray(tokens, jnp.int32), jnp.asarray(lengths), jk, jv,
            jnp.asarray(ja.tables), cache_scales=(jks, jvs), active=jnp.asarray(active),
        )
        tl = tm.decode_step_paged(
            tp, TINY_TEST, torch.from_numpy(tokens), torch.from_numpy(lengths), tk, tv,
            torch.from_numpy(ta.tables), active=torch.from_numpy(active),
            cache_scales=(tks, tvs),
        )
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        for got, want in ((tk, jk), (tv, jv), (tks, jks), (tvs, jvs)):
            _assert_pool_close(got.numpy(), np.asarray(want))
        tokens = np.asarray(jl).argmax(-1)
        lengths = lengths + 1


# -- window trimming -----------------------------------------------------------


def test_trim_below_window_matches_jax_allocator():
    ja = jpaged.PageAllocator(12, 4, 3, 8)
    ta = tpaged.PageAllocator(12, 4, 3, 8)
    for alloc in (ja, ta):
        alloc.ensure(0, 30)
        alloc.ensure(1, 9)
    freed = []
    for alloc in (ja, ta):
        got = [alloc.trim_below_window(0, 21, 8),  # rows < 13 dead: blocks 0-2
               alloc.trim_below_window(0, 21, 8),  # nothing new
               alloc.trim_below_window(1, 9, 8),   # 1 dead row: no whole block
               alloc.trim_below_window(0, 29, 8)]  # rows < 21: blocks 3-4 too
        alloc.ensure(0, 32)
        alloc.ensure(2, 14)  # reuses trimmed pages
        freed.append((got, alloc.pages_in_use(), alloc.free_pages, alloc.tables.copy()))
        alloc.free_slot(0)  # trimmed blocks are not released twice
        freed[-1] += (alloc.free_pages,)
    (jg, ju, jf, jt, jf2), (tg, tu, tf, tt, tf2) = freed
    assert tg == jg == [3, 0, 0, 2]
    assert (tu, tf, tf2) == (ju, jf, jf2)
    np.testing.assert_array_equal(tt, jt)
    assert len(set(ta._free)) == len(ta._free) == ta.free_pages


# -- the engine: int4 weights over an int8 pool --------------------------------


def _engines(jax_params, cfg_j=JAX_TINY, cfg_t=TINY_TEST, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("paged_pool_rows", 256)
    # the JAX engine's prefix index is off, and so is the port's
    common = dict(max_context=128, quantize="int4", page_size=16, prefix_cache=False, **kw)
    jax_eng = TPUEngine(cfg_j, jax_params, cache_dtype=jnp.int8, **common)
    port = TorchEngine(cfg_t, params_from_jax(_numpy_tree(jax_params)),
                       cache_dtype=torch.int8, device="cpu", **common)
    return jax_eng, port


@pytest.fixture(scope="module")
def engines(jax_params):
    return _engines(jax_params)


# prompt lengths in three different prefill buckets (16, 32, 64)
PROMPTS = [[256, 7, 99, 3, 41], [256] + list(range(60, 80)),
           [256] + [(i * 37) % 256 for i in range(40)]]


@pytest.mark.parametrize("prompt", PROMPTS, ids=["bucket16", "bucket32", "bucket64"])
def test_int4_int8kv_greedy_matches_jax_engine(engines, prompt):
    jax_eng, port = engines
    assert port.quant_cache and port.k_pool.dtype == torch.int8
    assert "q4" in port.params["layers"]["w_down"]
    want = jax_eng.generate(prompt, max_new_tokens=17, temperature=0.0)
    got = port.generate(prompt, max_new_tokens=17, temperature=0.0)
    assert got == want
    assert port.allocator.pages_in_use() == 0  # released


def test_int8_prefill_writes_the_same_pool_rows_as_jax(engines):
    jax_eng, port = engines
    prompt = PROMPTS[2]
    first_j = jax_eng.prefill(1, prompt)
    first_t = port.prefill(1, prompt)
    try:
        assert first_t == first_j
        np.testing.assert_array_equal(port.allocator.tables, jax_eng.allocator.tables)
        pages = port.allocator.tables[1, : port.allocator.blocks_for(len(prompt))]
        n = len(prompt)
        for name, pool in (("k", port.k_pool), ("v", port.v_pool),
                           ("k_s", port.k_scales), ("v_s", port.v_scales)):
            got = pool[:, pages].reshape(TINY_TEST.num_layers, -1, *pool.shape[3:])[:, :n]
            want = np.asarray(jax_eng.state[name])[:, pages]
            want = want.reshape(got.shape[0], -1, *want.shape[3:])[:, :n]
            _assert_pool_close(got.numpy(), want, name)
    finally:
        jax_eng.release(1)
        port.release(1)


def test_windowed_engine_trims_like_jax(jax_params):
    """A 24-row sliding window over 16-row pages: once a slot runs past the
    window both engines return the same pages, keep the same tables, and
    stream the same greedy tokens."""
    jcfg, tcfg = JAX_TINY.scaled(sliding_window=24), TINY_TEST.scaled(sliding_window=24)
    jax_eng, port = _engines(jax_params, jcfg, tcfg)
    prompt = [256] + list(range(30, 60))  # 31 rows: already past the window
    try:
        outs = []
        for eng in (jax_eng, port):
            toks = [eng.prefill(0, prompt, temperature=0.0)]
            trace = []
            for _ in range(5):
                toks += eng.step(8)[:, 0].tolist()
                trace.append((eng.allocator.pages_in_use(), eng.allocator.tables.copy()))
            outs.append((toks, trace, eng.slot_length(0)))
        (jt, jtrace, jlen), (tt, ttrace, tlen) = outs
        assert tt == jt and tlen == jlen
        for (ju, jtab), (tu, ttab) in zip(jtrace, ttrace):
            assert tu == ju
            np.testing.assert_array_equal(ttab, jtab)
        # the slot's rows alone would need this many pages; trimming left fewer
        assert ttrace[-1][0] < port.allocator.blocks_for(tlen + 1)
        assert port.kv_pages_trimmed > 0
    finally:
        jax_eng.release(0)
        port.release(0)
    assert port.allocator.pages_in_use() == 0
    assert port.allocator.free_pages == port.allocator.num_pages - 1


# -- the runtime ---------------------------------------------------------------


def test_model_manager_reads_the_jax_stack_variables(monkeypatch):
    monkeypatch.setenv("AIOS_TPU_QUANTIZE", "int4")
    monkeypatch.setenv("AIOS_TPU_KV_CACHE", "int8")
    m = ModelManager(num_slots=2, device="cpu")
    assert (m.quantize, m.cache_dtype) == ("int4", torch.int8)
    monkeypatch.setenv("AIOS_TPU_QUANTIZE", "0")
    monkeypatch.setenv("AIOS_TPU_KV_CACHE", "bogus")
    m = ModelManager(num_slots=2, device="cpu")
    assert (m.quantize, m.cache_dtype) == (False, torch.bfloat16)
    m = ModelManager(num_slots=2, device="cpu", quantize="int8", kv_cache="bf16")
    assert (m.quantize, m.cache_dtype) == ("int8", torch.bfloat16)
    with pytest.raises(ValueError):
        ModelManager(device="cpu", kv_cache="fp8")


def test_int8_pool_needs_a_context_multiple_of_128():
    """The int8 POOL does; a context that is not such a multiple is served
    from the dense cache, as by the JAX ``ModelManager`` (the streams of the
    two stacks there: tests/test_torch_spec.py)."""
    m = ModelManager(num_slots=2, device="cpu", quantize="int4", kv_cache="int8")
    try:
        eng = m.load_model("tiny", "synthetic://tiny-test", context_length=96).engine
        assert not eng.paged and eng.allocator is None and eng.quant_cache
        assert eng.k_pool.shape[1:3] == (2, 96) and eng.k_scales.shape[1:3] == (2, 96)
        eng = m.load_model("tiny128", "synthetic://tiny-test", context_length=128).engine
        assert eng.paged and eng.allocator.page_size == 128
    finally:
        m.close()


def test_int4_int8kv_manager_serves_over_grpc():
    manager = ModelManager(num_slots=2, device="cpu", quantize="int4", kv_cache="int8")
    server, _, port = serve(address="127.0.0.1:0", manager=manager, block=False)
    channel = rpc.insecure_channel(f"127.0.0.1:{port}")
    try:
        stub = services.AIRuntimeStub(channel)
        status = stub.LoadModel(runtime_pb2.LoadModelRequest(
            model_name="tiny", model_path="synthetic://tiny-test"))
        assert status.status == "ready"
        eng = manager.get("tiny").engine
        assert eng.quant_cache and eng.k_scales.shape == eng.k_pool.shape[:4]
        assert "q4" in eng.params["layers"]["wo"]
        resp = stub.Infer(runtime_pb2.InferRequest(prompt="hello", max_tokens=8))
        assert resp.model_used == "tiny" and resp.tokens_used > 0
        chunks = list(stub.StreamInfer(runtime_pb2.InferRequest(
            prompt="status?", max_tokens=6, temperature=0.3)))
        assert chunks[-1].done and all(not c.done for c in chunks[:-1])
        h = stub.HealthCheck(common_pb2.Empty())
        assert "kv_pages_trimmed=0" in h.details["tiny.serving"]
    finally:
        manager.close()
        channel.close()
        server.stop(grace=None)
