"""The port's admission dispatch as CUDA graphs, as far as the CPU can hold
it: ``_prefill_body`` and ``_chunk_body`` on the static admission operands
against the engine's eager admission as it ran before them (rebuilt here
from the model's functions with host-built operands) and against the JAX
TPUEngine, over the pool and the dense cache, f32, bf16 and int8 caches,
a sliding window, a prefix hit and a hit whose final bucket overruns the
context; the static buffers' storage; the graph keys warmup plans against
the JAX warmup's; and, with a stand-in for the graphs, that serving
replays admission graphs and captures none, that a mid chunk reads
nothing back, that a size warmup did not plan is captured once and
counted, and that no body keeps or returns a tensor it allocated.

Tolerances: first tokens and int8 cache bytes exactly; logits within 1e-4;
f32 cache rows within 1e-5 (sums in another order than JAX's)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aios_tpu.engine import model as jm
from aios_tpu.engine.config import TINY_TEST as JAX_TINY
from aios_tpu.engine.engine import TPUEngine
from aios_tpu_torch.engine import graphs, model
from aios_tpu_torch.engine.batching import ContinuousBatcher, Request
from aios_tpu_torch.engine.config import TINY_TEST
from aios_tpu_torch.engine.engine import TorchEngine
from aios_tpu_torch.engine.weights import params_from_jax

# The shapes here are tiny: one intra-op thread is faster and leaves the
# cores to the other test workers.
torch.set_num_threads(1)

CTX, PAGE = 256, 32
CHUNK = 32
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
ROW_TOL = dict(atol=1e-5, rtol=1e-5)
CACHES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16),
          "int8": (torch.int8, jnp.int8)}
STATIC = ("_adm_tokens", "_adm_slot", "_adm_start", "_adm_n_valid", "_adm_true_len",
          "_adm_temp", "_adm_top_p", "_adm_first", "_adm_logits", "lengths", "last_tokens",
          "temps", "top_ps", "active_dev", "history", "tables_dev")


@pytest.fixture(scope="module")
def jax_params():
    return jm.init_params(JAX_TINY, jax.random.PRNGKey(3), dtype=jnp.float32)


@pytest.fixture(scope="module")
def torch_params(jax_params):
    return params_from_jax(jax.tree.map(np.asarray, jax_params))


def _bf16(tree):
    """A parameter tree with every float leaf in bf16 (a bf16 cache's
    engine computes in bf16)."""
    if isinstance(tree, dict):
        return {k: _bf16(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(torch.bfloat16) if tree.is_floating_point() else tree
    return tree.astype(jnp.bfloat16) if jnp.issubdtype(tree.dtype, jnp.floating) else tree


def _prompt(seed: int, n: int):
    return [int(t) for t in np.random.default_rng(seed).integers(1, 500, n)]


def _geometry(paged: bool, prefix: bool) -> dict:
    if not paged:
        return {}
    return dict(paged_pool_rows=4 * CTX, page_size=PAGE, prefix_cache=prefix)


def _port(torch_params, paged, cache="f32", window=None, prefix=False, **kw):
    cfg = TINY_TEST.scaled(sliding_window=window)
    return TorchEngine(cfg, torch_params, num_slots=2, max_context=CTX, quantize="int8",
                       cache_dtype=CACHES[cache][0], device="cpu",
                       **_geometry(paged, prefix), **kw)


def _jax(jax_params, paged, cache="f32", window=None, prefix=False):
    cfg = JAX_TINY.scaled(sliding_window=window)
    return TPUEngine(cfg, jax_params, num_slots=2, max_context=CTX, quantize="int8",
                     cache_dtype=CACHES[cache][1], **_geometry(paged, prefix))


# -- the eager admission the bodies replace ----------------------------------------


def _write_rows(eng, pages, offs, ks, vs) -> None:
    if eng.quant_cache:
        (kq, k_s), (vq, v_s) = model.quantize_kv(ks), model.quantize_kv(vs)
        eng.k_pool[:, pages, offs], eng.v_pool[:, pages, offs] = kq, vq
        eng.k_scales[:, pages, offs], eng.v_scales[:, pages, offs] = k_s, v_s
    else:
        eng.k_pool[:, pages, offs] = ks.to(eng.k_pool.dtype)
        eng.v_pool[:, pages, offs] = vs.to(eng.v_pool.dtype)


def _reference_admit(eng, slot: int, ids, chunk=None):
    """The engine's eager admission before its graph bodies: host ints for
    the slot and the start, tokens and page rows built on the host, one
    whole-prompt pass (``chunk`` None and no prefix hit) or chunks (a hit
    admits its tail at the prefix chunk). Greedy; returns (first token,
    the logits row it was taken from)."""
    ids = list(ids)
    n = len(ids)
    start, hashes = 0, []
    if eng.prefix_index is not None:
        start, hashes = eng._match_prefix(slot, ids)
    if start:
        chunk = eng._prefix_chunk
    if chunk is None:
        bucket = eng.bucket_for(n)
        tokens = torch.zeros((1, bucket), dtype=torch.int64)
        tokens[0, :n] = torch.tensor(ids)
        logits, ks, vs = model.prefill(eng.params, eng.cfg, tokens)
        if eng.paged:
            eng.allocator.ensure(slot, n)
            P = eng.allocator.page_size
            pages = torch.from_numpy(np.repeat(eng.allocator.tables[slot, :-(-bucket // P)],
                                               P)[:bucket].astype(np.int64))
            offs = torch.arange(bucket) % P
        else:
            pages, offs = slot, slice(0, bucket)
        _write_rows(eng, pages, offs, ks[:, 0], vs[:, 0])
        row = logits[0, n - 1]
    else:
        pos = start
        while pos < n:
            m = min(chunk, n - pos)
            bucket = eng.bucket_for(m) if n - pos <= chunk else chunk
            tokens = torch.zeros((1, bucket), dtype=torch.int64)
            tokens[0, :m] = torch.tensor(ids[pos:pos + m])
            scales = (eng.k_scales, eng.v_scales) if eng.quant_cache else None
            if eng.paged:
                if eng.cfg.sliding_window is not None:
                    eng.allocator.trim_below_window(slot, pos, eng.cfg.sliding_window)
                eng.allocator.ensure(slot, pos + m)
                logits = model.prefill_chunk_paged(
                    eng.params, eng.cfg, tokens, pos, eng.k_pool, eng.v_pool,
                    torch.from_numpy(eng.allocator.tables[slot]), cache_scales=scales)
            else:
                logits = model.prefill_chunk(eng.params, eng.cfg, tokens, slot, pos,
                                             eng.k_pool, eng.v_pool, cache_scales=scales)
            pos += m
        row = logits[0, m - 1]
    eng._register_prefix(slot, ids, hashes)
    return int(row.argmax()), row


def _admit(eng, slot: int, ids, chunk=None):
    """The engine's own admission (whole-prompt or chunked), greedy; the
    port's returns the logits row of its first token as well."""
    if chunk is None:
        first = eng.prefill(slot, ids, temperature=0.0)
    else:
        pc = eng.start_chunked_prefill(slot, ids, temperature=0.0, chunk=chunk)
        first = pc.step()
        while first is None:
            first = pc.step()
    return first, (eng._adm_logits.clone() if isinstance(eng, TorchEngine) else None)


def _rows(pools, tables, slot: int, lo: int, hi: int, paged: bool):
    """Rows [lo, hi) of ``slot`` in each of ``pools`` (numpy [L, N, P, ...]
    or [L, S, C, ...]) through its page table."""
    out = []
    for p in pools:
        p = np.asarray(p)
        if paged:
            view = p[:, np.asarray(tables[slot])]
            view = view.reshape(p.shape[0], -1, *p.shape[3:])
        else:
            view = p[:, slot]
        out.append(view[:, lo:hi])
    return out


def _port_rows(eng, slot, lo, hi):
    pools = [eng.k_pool, eng.v_pool] + ([eng.k_scales, eng.v_scales] if eng.quant_cache else [])
    tables = eng.allocator.tables if eng.paged else None
    return _rows([t if t.dtype != torch.bfloat16 else t.float() for t in pools], tables,
                 slot, lo, hi, eng.paged)


def _jax_rows(eng, slot, lo, hi):
    st = eng.state
    keys = ["k", "v"] + (["k_s", "v_s"] if "k_s" in st else [])
    pools = [np.asarray(jnp.asarray(st[k], jnp.float32) if st[k].dtype == jnp.bfloat16
                        else st[k]) for k in keys]
    tables = eng.allocator.tables if eng.paged else None
    return _rows(pools, tables, slot, lo, hi, eng.paged)


def _same_rows(got, want, exact_floats=False):
    for g, w in zip(got, want):
        if w.dtype == np.int8 or exact_floats:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, **ROW_TOL)


# (paged, cache, window, kind): kind "prefill" is one whole-prompt pass,
# "chunked" a 100-token prompt in 32-row chunks (3 mid, 1 final), "hit" a
# prompt whose first 96 rows hit the index (its 60-row tail: a mid chunk and
# a final one at a prefix chunk of 32), "overrun" a hit of 160 rows whose
# 95-row tail is one final bucket of 128 rows (a prefix chunk of 128),
# which runs 32 rows past the 256-row context
CASES = [(paged, cache, None, kind) for paged in (True, False)
         for cache in ("f32", "bf16", "int8") for kind in ("prefill", "chunked")]
CASES += [(True, "f32", 24, "chunked"), (False, "int8", 24, "chunked"),
          (True, "f32", 24, "prefill"), (True, "f32", None, "hit"),
          (True, "int8", None, "hit"), (True, "f32", None, "overrun")]


def _case_id(case):
    paged, cache, window, kind = case
    return f"{'paged' if paged else 'dense'}-{cache}-{kind}" + (f"-window{window}" if window else "")


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_admission_bodies_match_the_eager_path_and_jax(jax_params, torch_params, case):
    """The admission bodies on the static operands give the logits row,
    first token and cache rows of the eager admission they replace and the
    JAX engine's first token and cache rows (bf16: its first token)."""
    paged, cache, window, kind = case
    prefix = kind in ("hit", "overrun")
    if cache == "bf16":
        jax_params, torch_params = _bf16(jax_params), _bf16(torch_params)
    port, ref = (_port(torch_params, paged, cache, window, prefix) for _ in range(2))
    jeng = _jax(jax_params, paged, cache, window, prefix)
    chunk = CHUNK if kind == "chunked" else None
    if kind == "overrun":
        for eng in (port, ref, jeng):
            eng._prefix_chunk = 128
        pre = _prompt(11, 160)
        warm, ids = pre + _prompt(12, 20), pre + _prompt(13, 95)
    elif kind == "hit":
        for eng in (port, ref, jeng):
            eng._prefix_chunk = 32
        pre = _prompt(14, 96)
        warm, ids = pre + _prompt(15, 40), pre + _prompt(16, 60)
    else:
        warm, ids = None, _prompt(17, 100)
    try:
        if warm is not None:  # publishes the prefix the admission then hits
            _admit(port, 0, warm)
            _reference_admit(ref, 0, warm)
            jeng.prefill(0, warm, temperature=0.0)
            for eng in (port, ref, jeng):
                eng.release(0)
        first, row = _admit(port, 1, ids, chunk)
        ref_first, ref_row = _reference_admit(ref, 1, ids, chunk)
        jax_first = _admit(jeng, 1, ids, chunk)[0]
        assert first == ref_first == jax_first
        assert first == int(row.argmax())
        torch.testing.assert_close(row, ref_row, **LOGIT_TOL)
        if prefix:
            assert port.prefix_rows_reused == ref.prefix_rows_reused == len(pre)
        n = len(ids)
        lo = 0 if window is None else n - window  # a windowed pool holds the window
        got = _port_rows(port, 1, lo, n)
        _same_rows(got, _port_rows(ref, 1, lo, n), exact_floats=True)
        if cache != "bf16":
            _same_rows(got, _jax_rows(jeng, 1, lo, n))
        if kind == "prefill" and cache != "bf16":
            bucket = port.bucket_for(n)
            tokens = np.zeros((1, bucket), np.int32)
            tokens[0, :n] = ids
            want = jm.prefill(jeng.params, jeng.cfg, jnp.asarray(tokens))[0][0, n - 1]
            np.testing.assert_allclose(row.numpy(), np.asarray(want), **LOGIT_TOL)
        # the slot is live as the JAX engine's: its next greedy tokens
        assert port.step(3)[:, 1].tolist() == [int(t) for t in jeng.step(3)[:, 1]]
    finally:
        jeng.close()


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_admission_buffers_keep_their_storage(torch_params, paged):
    """Every operand, output and state buffer an admission body reads or
    writes keeps its storage across whole-prompt, chunked and hit
    admissions, decode and release (a graph holds its address)."""
    eng = _port(torch_params, paged, prefix=paged)
    eng._prefix_chunk = 32
    held = [n for n in STATIC if getattr(eng, n) is not None]
    assert ("tables_dev" in held) == paged
    ptrs = {n: getattr(eng, n).data_ptr() for n in held}
    pre = _prompt(20, 96)
    eng.prefill(0, pre + [5] * 10, temperature=0.0)
    eng.step(2)
    eng.release(0)
    eng.prefill(1, pre + [6] * 40, temperature=0.9, top_p=0.8)  # a hit over the pool
    pc = eng.start_chunked_prefill(0, _prompt(21, 90), temperature=0.0, chunk=CHUNK)
    while pc.step() is None:
        eng.step(1)
    eng.release(0)
    eng.prefill_eager(0, [1, 2, 3], temperature=0.0)
    eng.release(1)
    eng.step(1)
    assert {n: getattr(eng, n).data_ptr() for n in held} == ptrs
    assert eng.stats()["prefill_chunks"] > 0 and (not paged or eng.prefix_rows_reused == 96)
    eng.close()


# -- the graph plan against the JAX warmup --------------------------------------------

# a pool of 4 pages of 32 rows backs buckets up to 128 (blocks_for(65) = 3),
# not 256; the batcher's chunk 64 and the prefix chunk 256 differ
PLAN_GEOMETRY = dict(num_slots=2, max_context=CTX, paged_pool_rows=128, page_size=PAGE)


@pytest.fixture(scope="module")
def jax_warmed(jax_params):
    eng = TPUEngine(JAX_TINY, jax_params, cache_dtype=jnp.float32, **PLAN_GEOMETRY)
    eng.warmup(step_sizes=(1,), prefill_chunk=64, jump_sizes=())
    yield eng
    eng.close()


def test_planned_graph_keys_are_the_jax_warmups(torch_params, jax_warmed):
    """The port plans the JAX warmup's prefill and chunk executables on the
    same geometry, less the history backfill per bucket, which is one copy
    here."""
    port = TorchEngine(TINY_TEST, torch_params, cache_dtype=torch.float32, device="cpu",
                       **PLAN_GEOMETRY)
    buckets, chunks = port.admission_plan(64)
    jax_prefill = set(jax_warmed._prefill_fns)
    hist = {k for k in jax_prefill if isinstance(k, tuple) and k[0] == "hist"}
    assert hist == {("hist", b) for b in port.buckets}
    assert set(buckets) == jax_prefill - hist == {16, 32, 64, 128}
    assert set(chunks) == set(jax_warmed._chunk_fns)
    assert len(chunks) == len(set(chunks))
    assert (64, False) in chunks and (port._prefix_chunk, False) in chunks
    # without the index only the batcher's chunk; 0 plans no chunk at all
    dense = TorchEngine(TINY_TEST, torch_params, cache_dtype=torch.float32, device="cpu",
                        num_slots=2, max_context=CTX)
    assert dense.admission_plan(64) == (list(dense.buckets),
                                        [(64, False), (16, True), (32, True), (64, True)])
    assert dense.admission_plan(0)[1] == [] and dense.admission_plan(48)[1] == []


# -- with a stand-in for the CUDA graphs ------------------------------------------------


class _StandInGraph:
    """What ``graphs.Graph`` needs of a CUDA graph, ``replay``: here it runs
    the captured body again, as a replay reruns its kernels."""

    def __init__(self, body):
        self.body = body

    def replay(self):
        self.body()


class _StandInGraphs(graphs.GraphSet):
    """A GraphSet enabled on the CPU: ``capture`` runs ``prepare`` and keeps
    the body; it records the pool each graph was captured in."""

    def __init__(self, generator):
        super().__init__(torch.device("cpu"), generator)
        self.enabled = True
        self.pools = {}

    def new_pool(self):
        return "admission pool"

    def capture(self, key, body, prepare, pool=None):
        prepare()
        self.graphs[key] = graphs.Graph(_StandInGraph(body), body(), {})
        self.pools[key] = pool
        self.captures += 1
        return self.graphs[key]


def _stand_in(eng, monkeypatch):
    eng.graphs = _StandInGraphs(eng.generator)
    eng._admission_pool = eng.graphs.new_pool()
    monkeypatch.setattr(eng, "_reserve_workspaces", lambda: None)
    return eng.graphs


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_serving_replays_admission_graphs_and_captures_none(torch_params, monkeypatch, paged):
    """After warmup's captures the batcher's whole-prompt, chunked and hit
    admissions only replay: one replay per prefill, chunk and decode step,
    no capture; admission graphs share the pool, the step keeps its own;
    the streams are the eager engine's."""
    eng = _port(torch_params, paged, prefix=paged)
    gs = _stand_in(eng, monkeypatch)
    eng.capture_step()
    planned = eng.capture_admission(CHUNK)
    buckets, chunks = eng.admission_plan(CHUNK)
    assert planned == len(buckets) + len(chunks) == eng.admission_graphs()
    assert gs.captures == planned + 1
    assert gs.pools == {"step": None, **{k: "admission pool" for k in gs.pools if k != "step"}}
    assert eng.prefills == eng.prefill_chunks == 0 and not eng.active.any()
    pre = _prompt(30, 100)
    prompts = [pre + _prompt(31, 10), _prompt(32, 20), pre + _prompt(33, 30)]
    b = ContinuousBatcher(eng, prefill_chunk=CHUNK)
    try:
        got = [b.submit(Request(prompt_ids=p, max_tokens=6, temperature=0.0)).tokens()
               for p in prompts]
        assert b.last_error is None
    finally:
        b.shutdown()
    assert gs.captures == planned + 1
    assert gs.replays == eng.prefills + eng.prefill_chunks + eng.decode_steps
    assert eng.prefill_chunks > 0 and eng.prefills > 0
    if paged:
        assert eng.prefix_rows_reused == 96
    plain = _port(torch_params, paged, prefix=paged)
    b = ContinuousBatcher(plain, prefill_chunk=CHUNK)
    try:
        want = [b.submit(Request(prompt_ids=p, max_tokens=6, temperature=0.0)).tokens()
                for p in prompts]
    finally:
        b.shutdown()
    assert got == want


READBACKS = ("item", "tolist", "cpu", "numpy", "__int__", "__bool__", "__float__", "__index__")


def _count_readbacks(monkeypatch):
    """Count every tensor-to-host read of the process from now on."""
    calls = []
    for name in READBACKS:
        orig = getattr(torch.Tensor, name)

        def spy(self, *a, _orig=orig, _name=name, **kw):
            calls.append(_name)
            return _orig(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, spy)
    return calls


@pytest.mark.parametrize("graphed", [True, False], ids=["replay", "eager"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_a_mid_chunk_reads_nothing_back(torch_params, monkeypatch, paged, graphed):
    """A mid chunk's dispatch, staging and body included, reads no tensor
    back to the host; the final chunk reads one, its first token."""
    eng = _port(torch_params, paged)
    if graphed:
        _stand_in(eng, monkeypatch)
        eng.capture_admission(CHUNK)
    pc = eng.start_chunked_prefill(0, _prompt(40, 70), temperature=0.7, chunk=CHUNK)
    calls = _count_readbacks(monkeypatch)
    assert pc.step() is None and pc.step() is None
    assert calls == []
    assert pc.step() is not None
    assert calls == ["item"]


def test_an_unplanned_size_is_captured_once_and_counted(torch_params, monkeypatch):
    """A chunk warmup did not plan is captured at its first use, counted,
    and replayed from then on; the planned ones are not captured again."""
    eng = _port(torch_params, True)
    gs = _stand_in(eng, monkeypatch)
    planned = eng.capture_admission(64)
    assert ("chunk", CHUNK, False) not in gs

    def admit(chunk):
        pc = eng.start_chunked_prefill(0, _prompt(50, 90), temperature=0.0, chunk=chunk)
        while pc.step() is None:
            pass
        eng.release(0)
        return pc.first_token

    # 32 + 32 + 26 rows: the mid chunk of 32 is new; the final bucket of 32
    # was planned as a final of the chunk of 64
    first = admit(CHUNK)
    assert gs.captures == planned + 1 and ("chunk", CHUNK, False) in gs
    assert admit(CHUNK) == first and admit(64) == first
    assert gs.captures == planned + 1 and eng.admission_graphs() == planned + 1


def test_capture_admission_refuses_after_an_admission(torch_params, monkeypatch):
    eng = _port(torch_params, False)
    _stand_in(eng, monkeypatch)
    eng.prefill(0, [1, 2, 3], temperature=0.0)
    with pytest.raises(RuntimeError, match="before the first admission"):
        eng.capture_admission(CHUNK)


def _tensors(eng):
    return {k: (id(v), v.data_ptr()) for k, v in vars(eng).items()
            if isinstance(v, torch.Tensor)}


@pytest.mark.parametrize("body", ["prefill", "mid", "final"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_no_body_keeps_or_returns_a_tensor(torch_params, paged, body):
    """An admission body returns nothing and binds no tensor to the engine:
    what it allocates dies with it (in a capture, the shared pool's
    intermediates), its results are in the static buffers."""
    eng = _port(torch_params, paged)
    ids = _prompt(60, 40)
    if paged:
        eng.allocator.ensure(0, 64)
    eng._stage_admission(0, ids[:32], 0, 32, 40, 0.0, 1.0, 32)
    fn = {"prefill": functools.partial(eng._prefill_body, 64),
          "mid": functools.partial(eng._chunk_body, 32, False),
          "final": functools.partial(eng._chunk_body, 32, True)}[body]
    before, attrs = _tensors(eng), set(vars(eng))
    assert fn() is None
    assert _tensors(eng) == before and set(vars(eng)) == attrs


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_warmup_with_a_chunk_on_the_cpu_captures_nothing(torch_params, paged):
    eng = _port(torch_params, paged)
    eng.warmup(prefill_chunk=CHUNK)
    assert eng.capture_admission(CHUNK) == 0
    pc = eng.start_chunked_prefill(0, _prompt(70, 80), temperature=0.0, chunk=CHUNK)
    while pc.step() is None:
        pass
    eng.prefill(1, [1, 2, 3], temperature=0.0)
    stats = eng.stats()
    assert (stats["graph_captures"], stats["graph_replays"]) == (0, 0)
    assert eng.admission_graphs() == 0 and eng.admission_pool_bytes == 0
    assert not eng.graphs.graphs and eng._admission_pool is None
