"""Draft-model speculation in the port against the JAX package: the
``DraftModel`` leaves, ``spec_step_draft`` over the dense cache and the page
pool for a draft with the serving model's own weights (the accept path) and
an unrelated one (the reject and sync path), bulk ingest after a long prompt
and a slot's readmission, sampling slots, the batcher's proposer ladder, the
model manager's pairing (``AIOS_TPU_DRAFT_MODEL``; its fallbacks are in
``tests/test_torch_spec_paged.py``) and the gRPC streams with the draft on
and off.

Both engines run TINY_TEST on the same f32 weights with an f32 cache and
dense f32 drafts, where greedy streams agree token for token and the
draft's K/V rows agree to ~1e-7. One engine pair per cache and draft is
shared by the tests of this file; each test releases what it admits.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aios_tpu.engine import model as jm
from aios_tpu.engine import spec as jspec
from aios_tpu.engine.batching import ContinuousBatcher as JaxBatcher
from aios_tpu.engine.config import TINY_TEST as JAX_TINY
from aios_tpu.engine.engine import TPUEngine
from aios_tpu_torch import faults, rpc, services
from aios_tpu_torch.engine import batching, spec
from aios_tpu_torch.engine.batching import ContinuousBatcher, Request
from aios_tpu_torch.engine.config import TINY_TEST
from aios_tpu_torch.engine.engine import DRAFT_INGEST_BUCKETS, TorchEngine
from aios_tpu_torch.engine.weights import params_from_jax
from aios_tpu_torch.proto_gen import runtime_pb2
from aios_tpu_torch.runtime import model_manager as tmm
from aios_tpu_torch.runtime.service import serve

# The shapes here are tiny: one intra-op thread is faster and leaves the
# cores to the other test workers.
torch.set_num_threads(1)

CTX = 128
DL = 3  # draft_len of every dispatch here
GREEDY_PROMPTS = ([5, 9, 13, 27, 40] * 3, list(range(3, 50)))
KV_TOL = 1e-5


@pytest.fixture(scope="module")
def jax_params():
    return jm.init_params(JAX_TINY, jax.random.PRNGKey(1), dtype=jnp.float32)


@pytest.fixture(scope="module")
def jax_bad():
    return jm.init_params(JAX_TINY, jax.random.PRNGKey(9), dtype=jnp.float32)


@pytest.fixture(scope="module")
def torch_params(jax_params):
    return params_from_jax(jax.tree.map(np.asarray, jax_params))


@pytest.fixture(scope="module")
def torch_bad(jax_bad):
    return params_from_jax(jax.tree.map(np.asarray, jax_bad))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
    return out


def _tensors(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _tensors(v)
        else:
            yield v


# -- DraftModel -------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["int4", "int8"])
def test_draft_model_leaves_equal_jax(jax_params, torch_params, mode):
    jd = jspec.DraftModel(JAX_TINY, jax_params, quantize=mode)
    td = spec.DraftModel(TINY_TEST, torch_params, quantize=mode)
    assert td.quant_mode == jd.quant_mode == mode
    want, got = _flat(jd.params), _flat(td.params)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        np.testing.assert_array_equal(got[key].view(np.uint8), w.view(np.uint8), err_msg=key)
    assert td.weight_bytes() == jd.weight_bytes()
    # serving leaves keep their stored mode, whatever is asked
    again = spec.DraftModel(TINY_TEST, td.params, quantize="int8" if mode == "int4" else "int4")
    assert again.quant_mode == mode and again.params is td.params


def test_draft_model_modes_state_and_the_engine_checks(torch_params, torch_bad):
    assert spec.DraftModel(TINY_TEST, torch_params, quantize=True).quant_mode == "int8"
    dense = spec.DraftModel(TINY_TEST, torch_params, quantize=None)
    assert dense.quant_mode is None and dense.params is torch_params
    with pytest.raises(ValueError, match="quantize"):
        spec.DraftModel(TINY_TEST, torch_params, quantize="int2")
    st = dense.init_state(3, 64, torch.int8)  # no scales: bf16 beside an int8 cache
    L, KH, D = TINY_TEST.num_layers, TINY_TEST.num_kv_heads, TINY_TEST.head_dim
    assert st["k"].shape == st["v"].shape == (L, 3, 64, KH, D)
    assert st["k"].dtype == torch.bfloat16 and st["lengths"].dtype == torch.int32
    assert dense.init_state(2, 32, torch.float32)["v"].dtype == torch.float32
    wide = TINY_TEST.scaled(vocab_size=TINY_TEST.vocab_size * 2)
    from aios_tpu_torch.engine.weights import init_params
    bad = spec.DraftModel(wide, init_params(wide, torch.Generator().manual_seed(2),
                                            dtype=torch.float32, device="cpu"), quantize=None)
    with pytest.raises(ValueError, match="vocab"):
        TorchEngine(TINY_TEST, torch_params, num_slots=2, max_context=64,
                    cache_dtype=torch.float32, device="cpu", draft=bad)
    eng = TorchEngine(TINY_TEST, torch_params, num_slots=2, max_context=64,
                      cache_dtype=torch.float32, device="cpu", track_history=False,
                      draft=dense)
    assert eng.draft is None and eng.draft_state is None
    with pytest.raises(ValueError, match="draft"):
        eng.spec_step_draft(1)
    eng.close()
    eng = TorchEngine(TINY_TEST, torch_params, num_slots=2, max_context=64,
                      cache_dtype=torch.float32, device="cpu",
                      draft=spec.DraftModel(TINY_TEST, torch_bad, quantize=None))
    with pytest.raises(ValueError, match="draft_len"):
        eng.spec_step_draft(1, draft_len=spec.HISTORY_PAD - 1)
    assert eng._draft_ingest_buckets() == (32, 64)  # up to the context
    eng.close()


# -- spec_step_draft against the JAX engine -------------------------------------


def _engine_pair(jax_params, torch_params, jd_params, td_params, paged, ctx=CTX):
    kw = dict(num_slots=4, max_context=ctx)
    if paged:
        kw.update(paged_pool_rows=4 * ctx, page_size=16, prefix_cache=False)
    je = TPUEngine(JAX_TINY, jax_params, cache_dtype=jnp.float32,
                   draft=jspec.DraftModel(JAX_TINY, jd_params, quantize=None), **kw)
    te = TorchEngine(TINY_TEST, torch_params, cache_dtype=torch.float32, device="cpu",
                     draft=spec.DraftModel(TINY_TEST, td_params, quantize=None), **kw)
    return je, te


@pytest.fixture(scope="module",
                params=[(False, True), (False, False), (True, True), (True, False)],
                ids=["dense-self", "dense-unrelated", "paged-self", "paged-unrelated"])
def pair(request, jax_params, jax_bad, torch_params, torch_bad):
    paged, same = request.param
    je, te = _engine_pair(jax_params, torch_params, jax_params if same else jax_bad,
                          torch_params if same else torch_bad, paged)
    yield je, te, same
    je.close()
    te.close()


def _same_draft_rows(je, te, slots):
    """The draft lengths of every slot equal; the K/V rows [0, d_len) of
    ``slots`` within KV_TOL."""
    dl = np.asarray(je.draft_state["lengths"])
    np.testing.assert_array_equal(te.draft_state["lengths"].numpy(), dl)
    np.testing.assert_array_equal(te._draft_host_lengths, je._draft_host_lengths)
    for key in ("k", "v"):
        want, got = np.asarray(je.draft_state[key]), te.draft_state[key].numpy()
        for s in slots:
            np.testing.assert_allclose(got[:, s, :dl[s]], want[:, s, :dl[s]], atol=KV_TOL,
                                       rtol=0, err_msg=f"{key} slot {s}")


def _same_paging(je, te):
    if te.paged:
        np.testing.assert_array_equal(te.allocator.tables, je.allocator.tables)
        np.testing.assert_array_equal(te.allocator._rc, je.allocator._rc[0])
        np.testing.assert_array_equal(te.allocator._trimmed, je.allocator._trimmed)


def test_spec_step_draft_matches_jax(pair):
    """Two greedy slots, one sampling slot and one idle slot, three calls of
    two rounds each: the same tokens, counts and ``proposed``, the draft's
    lengths and rows, the history, the pages and their refcounts."""
    je, te, same = pair
    for e in (je, te):
        for s, prompt in enumerate(GREEDY_PROMPTS):
            e.prefill(s, prompt, temperature=0.0)
        e.prefill(2, [7, 8, 9], temperature=0.9, top_p=0.9)
    try:
        for _ in range(3):
            jt, jc, jp = je.spec_step_draft(2, draft_len=DL)
            tt, tc, tp = te.spec_step_draft(2, draft_len=DL)
            assert tt.shape == (2, 4, DL + 1) and tc.shape == tp.shape == (2, 4)
            np.testing.assert_array_equal(tc[:, :2], jc[:, :2])
            np.testing.assert_array_equal(tp, jp)
            for r in range(2):
                for s in range(2):
                    np.testing.assert_array_equal(tt[r, s, :tc[r, s]], jt[r, s, :tc[r, s]])
            # the sampling slot: one token a round, nothing proposed, no ingest
            assert (tc[:, 2] == 1).all() and (tp[:, 2] == 0).all()
            assert int(te.draft_state["lengths"][2]) == 0
            _same_draft_rows(je, te, (0, 1))
            np.testing.assert_array_equal(te._host_lengths[:2], je._host_lengths[:2])
            hist = np.asarray(je.state["history"])
            for s in range(2):
                n = te.slot_length(s) + 1
                np.testing.assert_array_equal(te.history[s, :n].numpy(), hist[s, :n])
            _same_paging(je, te)
        assert (tp[:, :2] == DL).all()
        stats = te.stats()
        for key in ("draft_ingest_dispatches", "draft_proposed_tokens", "spec_draft_rounds",
                    "spec_draft_accepted"):
            assert stats[key] == je.stats()[key], key
        if same:
            assert stats["draft_acceptance"] > 0.6
            assert (tc[:, :2] == DL + 1).all()
        else:
            assert stats["draft_acceptance"] < 0.5
    finally:
        for e in (je, te):
            for s in range(3):
                e.release(s)
    assert not te.draft_state["lengths"].any() and not te._draft_host_lengths.any()
    assert not te._host_greedy.any()


def test_generate_through_the_draft_equals_plain_greedy(pair):
    """Whatever the draft proposes, a greedy stream is the plain one (which
    ``tests/test_torch_spec.py`` holds to the JAX engine's)."""
    _, te, _ = pair
    want = te.generate(GREEDY_PROMPTS[1], max_new_tokens=30, chunk=4)
    assert te.generate(GREEDY_PROMPTS[1], max_new_tokens=30, chunk=4,
                       speculative="draft", draft_len=DL) == want
    assert not te.active.any() and not te.draft_state["lengths"].any()


@pytest.fixture(scope="module")
def long_pair(jax_params, torch_params):
    je, te = _engine_pair(jax_params, torch_params, jax_params, torch_params, paged=True,
                          ctx=512)
    yield je, te
    je.close()
    te.close()


def test_bulk_ingest_after_a_long_prompt_and_a_readmission(long_pair):
    """A 300-token prompt's draft rows come in one ingest dispatch of the
    512 bucket; a released slot's next occupant rebuilds its rows from its
    own history (a 100-token prompt: the 128 bucket)."""
    je, te = long_pair
    rng = np.random.default_rng(3)
    first = [int(t) for t in rng.integers(1, 250, size=300)]
    second = [int(t) for t in rng.integers(1, 250, size=100)]
    try:
        for prompt in (first, second):
            for e in (je, te):
                e.prefill(0, prompt, temperature=0.0)
            before = te.draft_ingest_dispatches
            jt, jc, jp = je.spec_step_draft(2, draft_len=DL)
            tt, tc, tp = te.spec_step_draft(2, draft_len=DL)
            assert te.draft_ingest_dispatches - before == 1
            assert te.draft_ingest_dispatches == je.draft_ingest_dispatches
            np.testing.assert_array_equal(tc[:, 0], jc[:, 0])
            np.testing.assert_array_equal(tp, jp)
            for r in range(2):
                np.testing.assert_array_equal(tt[r, 0, :tc[r, 0]], jt[r, 0, :tc[r, 0]])
            _same_draft_rows(je, te, (0,))
            _same_paging(je, te)
            assert int(te.draft_state["lengths"][0]) >= len(prompt)
            for e in (je, te):
                e.release(0)
            assert int(te._draft_host_lengths[0]) == 0
    finally:
        for e in (je, te):
            if e.active[0]:
                e.release(0)
    assert te._draft_ingest_buckets() == DRAFT_INGEST_BUCKETS


# -- the batcher's proposer ladder ----------------------------------------------


def test_batcher_draft_streams_equal_plain_decode(torch_params):
    eng = TorchEngine(TINY_TEST, torch_params, num_slots=3, max_context=CTX,
                      paged_pool_rows=4 * CTX, page_size=16, cache_dtype=torch.float32,
                      device="cpu", draft=spec.DraftModel(TINY_TEST, torch_params,
                                                          quantize=None))
    prompts = [[3 + i, 7, 11] for i in range(3)] + [GREEDY_PROMPTS[0]]

    def wave(speculative):
        b = ContinuousBatcher(eng, speculative=speculative, spec_draft_len=DL)
        try:
            hs = [b.submit(Request(prompt_ids=p, max_tokens=20, temperature=0.0))
                  for p in prompts]
            out = [h.tokens() for h in hs]
            assert b.last_error is None
            return out, b
        finally:
            b.shutdown()

    try:
        plain, _ = wave(False)
        out, b = wave(True)
        assert out == plain and all(len(o) == 20 for o in out)
        assert b.spec_proposers == ("draft", "ngram")
        assert eng.spec_proposer_rounds["draft"] > 0 and eng.draft_ingest_dispatches > 0
        assert b.spec_ewma["draft"] > 0.5
    finally:
        eng.close()


class _Clock:
    """A monotonic clock the test moves; the rest of ``time`` is real."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def __getattr__(self, name):
        return getattr(time, name)


def test_ladder_falls_draft_to_ngram_to_off_like_jax(jax_params, torch_params, monkeypatch):
    """Both batchers under one fake clock: a collapsed draft falls to
    n-gram, a collapsed n-gram to plain ticks, both windows expire
    together, the draft rung re-probes first and is skipped with no greedy
    slot live; the EWMAs, probe budgets and suspensions step alike."""
    je, te = _engine_pair(jax_params, torch_params, jax_params, torch_params, paged=False)
    clock = _Clock()
    monkeypatch.setattr(batching, "time", clock)
    import aios_tpu.engine.batching as jax_batching
    monkeypatch.setattr(jax_batching, "time", clock)
    kw = dict(speculative=True, spec_draft_len=DL, spec_min_accept=0.5,
              spec_reprobe_secs=10.0)
    jb, tb = JaxBatcher(je, **kw), ContinuousBatcher(te, **kw)
    ones = np.ones((2, 4), np.int64)
    offered = np.full((2, 4), DL, np.int64)
    full = np.full((2, 4), DL + 1, np.int64)

    def both(fn):
        got, want = fn(tb), fn(jb)
        assert got == want
        assert tb.spec_ewma == jb.spec_ewma
        assert tb._spec_probe_left == jb._spec_probe_left
        assert tb._spec_off_until == jb._spec_off_until
        return got

    try:
        assert both(lambda b: b.spec_proposers) == ("draft", "ngram")
        assert both(lambda b: b._spec_proposer()) == "draft"
        both(lambda b: b._spec_measure("draft", ones, {0: 2, 1: 2}, offered))
        assert both(lambda b: b._spec_proposer()) == "ngram"
        both(lambda b: b._spec_measure("ngram", ones, {0: 2, 1: 2}))
        assert both(lambda b: (b._spec_proposer(), b._spec_active())) == (None, False)
        # nothing offered is no verdict
        both(lambda b: b._spec_measure("draft", ones, {0: 2}, np.zeros((2, 4), np.int64)))
        clock.t += 10.5
        assert both(lambda b: b._spec_proposer(greedy_live=False)) == "ngram"
        assert both(lambda b: b._spec_proposer()) == "draft"
        for _ in range(3):  # the probe budget, then the floor judges again
            both(lambda b: b._spec_measure("draft", full, {0: 2, 1: 2}, offered))
        assert both(lambda b: b._spec_proposer()) == "draft"
        assert both(lambda b: b.spec_autodisables) == 2
    finally:
        jb.shutdown()
        tb.shutdown()
        je.close()
        te.close()


# -- the model manager's pairing --------------------------------------------------

def test_manager_pairs_the_draft_shares_it_and_budgets_it(monkeypatch):
    """``AIOS_TPU_DRAFT_MODEL`` with speculation otherwise off: both replicas
    serve through the draft rung over one shared set of draft leaves, each
    with its own cache; the budget adds the draft's weights once and its
    bf16 cache once a replica; a respawned batcher keeps the rung; an
    unload drops the draft with the pool."""
    for name in ("AIOS_TPU_SPECULATIVE", "AIOS_TPU_DRAFT_MODEL", "AIOS_TPU_REPLICAS"):
        monkeypatch.delenv(name, raising=False)
    manager = tmm.ModelManager(num_slots=2, device="cpu")
    try:
        base = manager.load_model("plain", "synthetic://tiny-test", context_length=CTX)
        assert not base.batcher.speculative and base.engine.draft is None
        monkeypatch.setenv("AIOS_TPU_DRAFT_MODEL", "tiny-test")
        monkeypatch.setenv("AIOS_TPU_REPLICAS", "2")
        m = manager.load_model("paired", "synthetic://tiny-test", context_length=CTX)
        e0, e1 = (r.engine for r in m.pool.replicas)
        assert e0.draft is e1.draft is not None and e0.draft.quant_mode == "int4"
        for a, b in zip(_tensors(e0._draft_params), _tensors(e1._draft_params)):
            assert a.data_ptr() == b.data_ptr()
        assert e0.draft_state["k"].data_ptr() != e1.draft_state["k"].data_ptr()
        assert all(r.batcher.speculative and r.batcher.spec_proposers == ("draft", "ngram")
                   for r in m.pool.replicas)
        # one more page pool ((slots + 1) x ctx rows), the draft's weights,
        # and a bf16 draft cache of slots x ctx rows a replica
        dcfg = e0.draft.cfg
        pool = tmm._kv_row_bytes(m.config, manager.cache_dtype) * 3 * CTX
        cache = 2 * dcfg.num_layers * dcfg.num_kv_heads * dcfg.head_dim * 2 * 2 * CTX
        assert m.hbm_chip_bytes == (base.hbm_chip_bytes + pool + e0.draft.weight_bytes()
                                    + 2 * cache)
        # served through the rung
        out = m.batcher.generate(GREEDY_PROMPTS[0], max_tokens=12, temperature=0.0)
        assert len(out) == 12
        assert sum(r.engine.spec_proposer_rounds["draft"] for r in m.pool.replicas) > 0
        faults.activate("pool.scheduler_crash=nth:1")
        try:
            h = m.submit(Request(prompt_ids=[1, 2, 3], max_tokens=8, temperature=0.0))
            h.tokens()
        finally:
            faults.deactivate()
        h = m.submit(Request(prompt_ids=[1, 2, 3], max_tokens=8, temperature=0.0))
        assert len(h.tokens()) == 8 and m.pool.restarts >= 1
        assert all(r.batcher.spec_proposers == ("draft", "ngram") for r in m.pool.replicas)
        manager.unload_model("paired")
        assert e0.draft is None and e0.draft_state is None
    finally:
        manager.close()


# -- gRPC, the draft on and off ----------------------------------------------------


class _Recorded:
    """A stream handle that keeps the token ids it yields."""

    def __init__(self, handle, into):
        self._handle, self._into = handle, into

    def __iter__(self):
        for t in self._handle:
            self._into.append(t)
            yield t

    def __getattr__(self, name):
        return getattr(self._handle, name)


def test_grpc_streams_with_the_draft_on_and_off_are_identical(monkeypatch):
    """The twin of the JAX ``test_e2e_grpc_draft_on_off_identical``: the
    whole stack (service, pool, batcher, engine) with ``AIOS_TPU_DRAFT_MODEL``
    streams the greedy tokens of the same stack on the n-gram proposer."""
    monkeypatch.setenv("AIOS_TPU_SPECULATIVE", "1")
    monkeypatch.delenv("AIOS_TPU_REPLICAS", raising=False)

    def run_stack(draft: str):
        if draft:
            monkeypatch.setenv("AIOS_TPU_DRAFT_MODEL", draft)
        else:
            monkeypatch.delenv("AIOS_TPU_DRAFT_MODEL", raising=False)
        manager = tmm.ModelManager(num_slots=2, device="cpu")
        server, _, port = serve(address="127.0.0.1:0", manager=manager, block=False)
        channel = rpc.insecure_channel(f"127.0.0.1:{port}")
        try:
            stub = services.AIRuntimeStub(channel)
            status = stub.LoadModel(runtime_pb2.LoadModelRequest(
                model_name="tiny-draft", model_path="synthetic://tiny-test",
                context_length=CTX))
            assert status.status == "ready"
            managed = manager.get("tiny-draft")
            ids = []
            submit = managed.submit
            monkeypatch.setattr(managed, "submit",
                                lambda req, **kw: _Recorded(submit(req, **kw), ids))
            for prompt in ("hello there", "draft me"):
                chunks = list(stub.StreamInfer(runtime_pb2.InferRequest(
                    prompt=prompt, max_tokens=12, temperature=1e-6, model="tiny-draft")))
                assert chunks
            return ids, managed.engine.stats()
        finally:
            manager.close()
            channel.close()
            server.stop(grace=None)

    on, on_stats = run_stack("tiny-test")
    off, off_stats = run_stack("")
    assert len(on) == 24 and on == off
    assert on_stats.get("spec_draft_rounds", 0) > 0
    assert off_stats.get("spec_ngram_rounds", 0) > 0 and "spec_draft_rounds" not in off_stats
