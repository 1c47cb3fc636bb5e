"""The decode loop's modes in the port against the JAX package: the
pipelined loop (``step_async``, the batcher's depth-2 double buffer and its
flushes), the unified step and the multi-tick megagraph (``mega_step``, its
early exit, the ``pool.megatick_abort`` fault, its pipelined form).

The twins of ``tests/test_decode_pipeline.py`` and
``tests/test_mega_decode.py`` (less the shard_map twin, which waits for the
multi-card port). Both packages run TINY_TEST on the same f32 weights
(``params_from_jax``): greedy streams are held equal to the JAX engine's and
batcher's, the tick count k of every megagraph dispatch to the JAX
dispatch's; sampled streams only to the port's own sync loop (the JAX
sampler's threefry stream is not the port's generator). On the CPU the
port runs its graph bodies eagerly: the graphs' plumbing (keys,
buckets, one graph for every step count, no capture after warmup) runs
against a stand-in for the CUDA graphs whose replay runs the eager ticks.
"""

import json
import threading

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
from aios_tpu_torch import faults, ops
from aios_tpu_torch.engine import graphs
from aios_tpu_torch.engine.batching import ContinuousBatcher, Request
from aios_tpu_torch.engine.config import TINY_TEST
from aios_tpu_torch.engine.engine import MEGA_STOP_SLOTS, TorchEngine
from aios_tpu_torch.engine.tokenizer import ByteTokenizer
from aios_tpu_torch.engine.weights import params_from_jax
from aios_tpu_torch.serving import ReplicaPool, ServingConfig

torch.set_num_threads(1)

CTX = 128
JAX_CFG = JAX_TINY.scaled(name="loop-test")
CFG = TINY_TEST.scaled(name="loop-test")
GREEDY = [dict(prompt_ids=[3 + i, 17, 91, 4 + i], max_tokens=18 + 5 * i, temperature=0.0)
          for i in range(4)]
SAMPLED = [dict(prompt_ids=[7 + i, 2, 55], max_tokens=21 + 4 * i, temperature=0.85,
                top_p=0.9) for i in range(4)]


@pytest.fixture(scope="module")
def jax_params():
    return jm.init_params(JAX_TINY, jax.random.PRNGKey(0), dtype=jnp.float32)


@pytest.fixture(scope="module")
def torch_params(jax_params):
    return params_from_jax(jax.tree.map(np.asarray, jax_params))


@pytest.fixture
def no_faults():
    yield
    faults.deactivate()
    jfaults.deactivate()


def _record_ticks(eng, ticks: list) -> None:
    """Append each megagraph dispatch's tick count k to ``ticks``."""
    real = eng._mega_dispatch

    def spy(*a, **kw):
        out = real(*a, **kw)
        ticks.append(int(out[2]))
        return out

    eng._mega_dispatch = spy


def _engine_kw(engine_kw):
    kw = dict(num_slots=4, max_context=CTX)
    kw.update(engine_kw or {})
    return kw


def run_port(torch_params, reqs, *, pipeline=False, mega=0, unified=None, engine_kw=None,
             batcher_kw=None, tokenizer=None, chunk=(4, 2)):
    """One port engine and batcher: submit ``reqs`` at once, drain every
    stream; returns (streams, stats) with the batcher's counters and the
    k of every megagraph dispatch."""
    eng = TorchEngine(CFG, torch_params, cache_dtype=torch.float32, device="cpu",
                      mega_ticks=mega, unified_step=unified, **_engine_kw(engine_kw))
    ticks = []
    _record_ticks(eng, ticks)
    b = ContinuousBatcher(eng, chunk_steps=chunk[0], admit_chunk_steps=chunk[1],
                          pipeline=pipeline, tokenizer=tokenizer, **(batcher_kw or {}))
    try:
        handles = [b.submit(Request(**r)) for r in reqs]
        outs = [h.tokens() for h in handles]
        stats = dict(eng.stats(), flushes=b.flushes, dispatches=b.decode_dispatches,
                     evictions=b.pool_evictions, aborted=[h.abort_reason for h in handles],
                     ticks=ticks, last_error=b.last_error)
        return outs, stats
    finally:
        b.shutdown()
        eng.close()


def run_jax(jax_params, reqs, *, pipeline=False, mega=0, engine_kw=None, batcher_kw=None,
            tokenizer=None, chunk=(4, 2)):
    """The same lifecycle on the JAX engine and batcher (not warmed: its
    graphs compile lazily)."""
    eng = TPUEngine(JAX_CFG, jax_params, cache_dtype=jnp.float32, mega_ticks=mega,
                    **_engine_kw(engine_kw))
    ticks = []
    _record_ticks(eng, ticks)
    b = JaxBatcher(eng, chunk_steps=chunk[0], admit_chunk_steps=chunk[1], pipeline=pipeline,
                   tokenizer=tokenizer, **(batcher_kw or {}))
    try:
        handles = [b.submit(JaxRequest(**r)) for r in reqs]
        outs = [h.tokens() for h in handles]
        stats = dict(eng.stats(), evictions=b.pool_evictions,
                     aborted=[h.abort_reason for h in handles], ticks=ticks)
        return outs, stats
    finally:
        b.shutdown()
        eng.close()


@pytest.fixture(scope="module")
def greedy_reqs(jax_params):
    """GREEDY with request 1 stopping early on a token its free run emits,
    and the JAX batcher's streams of it."""
    free, _ = run_jax(jax_params, GREEDY)
    reqs = [dict(r) for r in GREEDY]
    reqs[1]["stop_ids"] = (free[1][4],)
    want, _ = run_jax(jax_params, reqs)
    assert len(want[1]) <= 5 + 1  # the stop fired
    return reqs, want


# -- the pipelined loop (tests/test_decode_pipeline.py) -------------------------


def test_pipeline_token_identical_greedy(torch_params, greedy_reqs):
    """Pipeline on and off give the JAX streams, with staggered retirements
    and a stop token mid-dispatch; the pipelined run issued ahead."""
    reqs, want = greedy_reqs
    off, _ = run_port(torch_params, reqs)
    on, s_on = run_port(torch_params, reqs, pipeline=True)
    assert off == want and on == want
    assert s_on["dispatches"] > 0 and s_on["last_error"] is None


def test_pipeline_token_identical_sampled(torch_params, jax_params):
    """Sampled streams: the pipelined chain draws the generator in the same
    order as the sync loop, so the streams match token for token; against
    JAX only their lengths (the samplers' noise differs)."""
    off, _ = run_port(torch_params, SAMPLED)
    on, _ = run_port(torch_params, SAMPLED, pipeline=True)
    assert on == off
    assert any(len(set(t)) > 1 for t in on)
    want, _ = run_jax(jax_params, SAMPLED)
    assert [len(t) for t in on] == [len(t) for t in want]


def test_pipeline_flushes_idle_after_retirement(torch_params, jax_params):
    """When the whole batch retires, the next tick flushes the dispatch
    issued ahead (or shutdown drops it); the stream is exactly max_tokens
    long, the JAX stream."""
    reqs = [dict(prompt_ids=[5, 6, 7], max_tokens=13, temperature=0.0)]
    want, _ = run_jax(jax_params, reqs)
    on, stats = run_port(torch_params, reqs, pipeline=True)
    assert on == want and len(on[0]) == 13
    assert stats["last_error"] is None


def test_pipeline_constrained_flush_and_force_pending_token(torch_params, jax_params):
    """A json_mode request admitted mid-stream forces its opener
    (force_pending_token) and rides one-step masked dispatches: the
    pipeline drains first (cause constrained); the constrained stream
    parses and the co-resident greedy stream is the JAX batcher's."""
    tok = ByteTokenizer()
    plain_req = dict(prompt_ids=tok.encode("plain"), max_tokens=60, temperature=0.0)
    want, _ = run_jax(jax_params, [plain_req])
    eng = TorchEngine(CFG, torch_params, cache_dtype=torch.float32, device="cpu",
                      num_slots=4, max_context=CTX)
    b = ContinuousBatcher(eng, chunk_steps=4, admit_chunk_steps=2, pipeline=True,
                          tokenizer=tok)
    try:
        plain = b.submit(Request(**plain_req))
        it = iter(plain)
        # after a plain tick the pipeline holds a dispatch in flight: the
        # constrained admission below must drain it
        t_plain = [next(it) for _ in range(4)]
        constrained = b.submit(Request(prompt_ids=tok.encode("emit json"), max_tokens=40,
                                       temperature=0.9, stop_ids=(tok.eos_id,),
                                       json_mode=True))
        t_plain += list(it)
        parsed = json.loads(tok.decode(constrained.tokens()))
        assert isinstance(parsed, dict)
        assert t_plain == want[0] and len(t_plain) == 60
        assert b.flushes >= 1
    finally:
        b.shutdown()
        eng.close()


def test_pipeline_chunked_prefill_interleave_identical(torch_params, jax_params):
    """A long prompt admitted chunk by chunk between pipelined dispatches:
    the streams are the sync loop's and the JAX batcher's."""
    long_prompt = (np.arange(1, 90) % 250 + 1).tolist()  # > the 32-row chunk
    reqs = [dict(prompt_ids=[9, 8, 7], max_tokens=24, temperature=0.0),
            dict(prompt_ids=long_prompt, max_tokens=12, temperature=0.0),
            dict(prompt_ids=[41, 2], max_tokens=16, temperature=0.0)]
    kw = dict(batcher_kw=dict(prefill_chunk=32))
    want, _ = run_jax(jax_params, reqs, **kw)
    off, _ = run_port(torch_params, reqs, **kw)
    on, _ = run_port(torch_params, reqs, pipeline=True, **kw)
    assert on == off == want
    assert len(on[1]) == 12


EVICT_REQS = [dict(prompt_ids=list(range(1, 31)), max_tokens=50, temperature=0.0, priority=1),
              dict(prompt_ids=list(range(40, 70)), max_tokens=80, temperature=0.0)]
EVICT_POOL = dict(num_slots=2, paged_pool_rows=128, page_size=32, prefix_cache=False)


def test_pipeline_pool_eviction_flush(torch_params, jax_params):
    """Pool exhaustion with a dispatch in flight: the eviction flushes
    first (the victim keeps every token it produced), the higher-priority
    survivor completes with the JAX batcher's stream."""
    want, s_want = run_jax(jax_params, EVICT_REQS, pipeline=True, engine_kw=EVICT_POOL)
    outs, stats = run_port(torch_params, EVICT_REQS, pipeline=True, engine_kw=EVICT_POOL)
    assert stats["evictions"] >= 1 and stats["last_error"] is None
    aborted = [r for r in stats["aborted"] if r]
    assert aborted and "evicted" in aborted[0]
    assert stats["aborted"] == s_want["aborted"]
    assert outs[0] == want[0] and len(outs[0]) == 50


# -- the stand-in for the CUDA graphs ---------------------------------------------


class _Replay:
    """A stand-in graph: ``replay`` runs ``run`` and returns its output, as
    a replay reruns its kernels; no launch to add."""

    launches = {}

    def __init__(self, run):
        self.run = run

    def replay(self):
        return self.run()


class _StandInGraphs(graphs.GraphSet):
    """A GraphSet enabled on the CPU. ``capture`` runs ``prepare`` and keeps
    a replay: a megagraph's runs the engine's eager ticks of its bucket
    and packs them as the graph's readback (the m token rows, then k); any
    other graph's reruns its body."""

    def __init__(self, eng):
        super().__init__(torch.device("cpu"), eng.generator)
        self.enabled = True
        self.eng = eng

    def new_pool(self):
        return "pool"

    def capture(self, key, body, prepare, pool=None):
        prepare()
        eng = self.eng
        if isinstance(key, tuple) and key[0] == "mega":
            tg = eng._tick_graphs[key]

            def run():
                k = eng._ticks_eager(tg)
                return torch.cat([tg.tokens.view(-1), torch.tensor([k])])
        else:
            def run():
                return body()
        self.graphs[key] = _Replay(run)
        self.captures += 1
        return self.graphs[key]


def _stand_in(eng, monkeypatch):
    eng.graphs = _StandInGraphs(eng)
    eng._admission_pool = eng.graphs.new_pool()
    monkeypatch.setattr(eng, "_reserve_workspaces", lambda: None)
    return eng.graphs


def _close(eng):
    """Close an engine that ran on stand-in graphs (there is no card to
    synchronise)."""
    eng.graphs.enabled = False
    eng.close()


def _warm(eng, prefill_chunk=None, masked_step=False):
    """What ``warmup`` captures after the kernel build (which needs the
    card): the step, the megagraph buckets, the masked step and the
    admission graphs."""
    eng.capture_step()
    eng.capture_decode_loop()
    if masked_step:
        eng.capture_masked()
    eng.capture_admission(prefill_chunk)


def _decode_graphs(gs):
    """The keys of the stand-in's graphs other than the whole-prompt
    prefill's."""
    return [k for k in gs.graphs if not (isinstance(k, tuple) and k[0] == "prefill")]


def _port_engine(torch_params, **kw):
    return TorchEngine(CFG, torch_params, cache_dtype=torch.float32, device="cpu",
                       **_engine_kw(kw))


def test_no_capture_after_warmup_serving_sweep(torch_params, monkeypatch):
    """Warmup captures every graph the decode loop dispatches (the step,
    every megagraph bucket, the admission graphs): a sweep of every step
    size, the unified step's among them, the masked step and a mega wave
    after it captures nothing."""
    eng = _port_engine(torch_params, unified_step=True, mega_ticks=8)
    gs = _stand_in(eng, monkeypatch)
    _warm(eng, prefill_chunk=32, masked_step=True)
    keys = set(gs.graphs)
    assert {"step", ("mega", 1), ("mega", 2), ("mega", 4), ("mega", 8)} <= keys
    before = gs.captures
    eng.prefill(0, [3, 17, 91, 4], temperature=0.0)
    for n in (1, 2, 8, 16, 5):
        eng.step(n)
    eng.step_masked({0: np.zeros(CFG.vocab_size, np.float32)})
    stops = np.full((4, MEGA_STOP_SLOTS), -1, np.int32)
    for n in (8, 3, 1):
        eng.mega_step(n, stops, np.full(4, 100, np.int32))
    eng.release(0)
    assert gs.captures == before and set(gs.graphs) == keys
    _close(eng)


def test_unified_step_greedy_identical_one_graph(torch_params, jax_params, monkeypatch):
    """AIOS_TPU_UNIFIED_STEP: one graph, the one-step graph, serves every
    step count (the sizes of a JAX warmup and two it never warms) with no
    capture, and the greedy stream is the engine's without the knob and
    the JAX unified engine's."""
    uni = _port_engine(torch_params, unified_step=True)
    ref = _port_engine(torch_params)
    gs = _stand_in(uni, monkeypatch)
    _warm(uni, prefill_chunk=0)
    assert uni.unified_step and not ref.unified_step
    assert _decode_graphs(gs) == ["step"]
    before = gs.captures
    je = TPUEngine(JAX_CFG, jax_params, num_slots=4, max_context=CTX,
                   cache_dtype=jnp.float32, unified_step=True)
    prompt = [3, 17, 91, 4, 55, 8]
    got = [uni.prefill(0, prompt, temperature=0.0)]
    plain = [ref.prefill(0, prompt, temperature=0.0)]
    want = [je.prefill(0, prompt, temperature=0.0)]
    for n in (1, 2, 8, 5, 16, 3):  # 5 and 3 were never warmed
        got += [int(t) for t in uni.step(n)[:, 0]]
        plain += [int(t) for t in ref.step(n)[:, 0]]
        want += [int(t) for t in je.step(n)[:, 0]]
    assert got == plain == want
    assert gs.captures == before and _decode_graphs(gs) == ["step"]
    assert uni.decode_steps == ref.decode_steps == 35
    _close(uni)
    ref.close()
    je.close()


def test_batcher_attach_captures_missing_sizes_without_dispatch(torch_params, monkeypatch):
    """A batcher whose sizes the engine's warmup did not cover captures
    them when it attaches (the step, the megagraph buckets of its windows),
    and the engine's state does not move."""
    eng = _port_engine(torch_params, unified_step=True, mega_ticks=16)
    gs = _stand_in(eng, monkeypatch)
    assert eng.mega_graphs() == 0 and not gs.graphs
    b = ContinuousBatcher(eng, chunk_steps=5, admit_chunk_steps=3)
    try:
        assert {"step", ("mega", 4), ("mega", 8)} <= set(gs.graphs)
        assert eng.mega_graphs() == 2
        assert eng.decode_steps == 0 and not eng.active.any()
        assert int(eng.lengths.abs().sum()) == 0
    finally:
        b.shutdown()
        _close(eng)


def test_pending_decode_lengths_snapshot(torch_params):
    """step_async dispatches run FIFO on the dispatch worker and each
    handle carries the lengths after its own dispatch, never a later
    one's (the out-of-cache retirement's anchor)."""
    eng = _port_engine(torch_params)
    try:
        eng.prefill(0, [1, 2, 3], temperature=0.0)
        p1 = eng.step_async(2)
        p2 = eng.step_async(4)
        assert p1.wait().shape == (2, 4)
        assert p2.wait().shape == (4, 4)
        assert p1.lengths[0] == 5 and p2.lengths[0] == 9
        assert eng.slot_length(0) == 9
        p2.wait_started()
        stops = np.full((4, MEGA_STOP_SLOTS), -1, np.int32)
        budgets = np.array([3, 0, 0, 0], np.int32)
        p3 = eng.mega_step_async(8, stops, budgets)
        assert p3.wait().shape == (3, 4) and p3.ticks == 3
        np.testing.assert_array_equal(p3.lengths[:, 0], [10, 11, 12])
    finally:
        eng.close()


POOL = dict(paged_pool_rows=40 * 16, page_size=16, prefix_cache=False)
MODES = {"sync": dict(), "pipeline": dict(pipeline=True), "unified": dict(unified=True),
         "mega": dict(mega=8), "mega+pipeline": dict(mega=8, pipeline=True)}


@pytest.fixture(scope="module")
def pool_reference(jax_params, greedy_reqs):
    """The JAX batcher's greedy streams over a page pool of 16-row pages."""
    reqs, _ = greedy_reqs
    want, _ = run_jax(jax_params, reqs, engine_kw=POOL)
    return reqs, want


@pytest.mark.parametrize("mode", sorted(MODES))
def test_each_mode_over_the_pool_is_the_jax_stream(torch_params, pool_reference, mode,
                                                   monkeypatch):
    """Over the page pool, each mode of the port's loop gives the JAX
    batcher's greedy streams (the unified step through the stand-in for the
    CUDA graphs, so that its one graph, the one-step graph, serves the
    dispatches)."""
    reqs, want = pool_reference
    kw = dict(MODES[mode])
    eng = TorchEngine(CFG, torch_params, cache_dtype=torch.float32, device="cpu",
                      mega_ticks=kw.get("mega", 0), unified_step=kw.get("unified"),
                      **_engine_kw(POOL))
    if mode == "unified":
        gs = _stand_in(eng, monkeypatch)
    b = ContinuousBatcher(eng, chunk_steps=4, admit_chunk_steps=2,
                          pipeline=kw.get("pipeline", False))
    try:
        got = [h.tokens() for h in [b.submit(Request(**r)) for r in reqs]]
        assert b.last_error is None
    finally:
        b.shutdown()
    assert got == want
    if mode == "unified":
        assert "step" in gs.graphs and eng.mega_graphs() == 0
        _close(eng)
    else:
        assert (eng.mega_dispatches > 0) == ("mega" in mode)
        eng.close()


# -- the megagraph (tests/test_mega_decode.py) ----------------------------------


@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipelined"])
def test_mega_token_identical_greedy(torch_params, jax_params, greedy_reqs, pipeline):
    """Greedy streams with staggered retirements and a stop mid-window:
    mega_ticks = 8 gives the K = 1 loop's streams and the JAX megagraph
    batcher's. In the sync loop each dispatch runs the JAX dispatch's k
    ticks; pipelined, a dispatch is issued before the previous one's
    retirements land, so its k depends on the threads' timing, in both
    packages."""
    reqs, _ = greedy_reqs
    want, s_want = run_jax(jax_params, reqs, mega=8, pipeline=pipeline, chunk=(8, 8))
    off, _ = run_port(torch_params, reqs, pipeline=pipeline, chunk=(8, 8))
    on, s_on = run_port(torch_params, reqs, mega=8, pipeline=pipeline, chunk=(8, 8))
    assert on == off == want
    assert s_on["mega_dispatches"] > 0 and s_on["mega_ticks"] == sum(s_on["ticks"])
    if not pipeline:
        assert s_on["ticks"] == s_want["ticks"]


@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipelined"])
def test_mega_token_identical_sampled(torch_params, pipeline):
    """Sampled streams: the eager megagraph draws the generator once a tick
    that runs, as the K = 1 loop does, so the streams match token for
    token (on the card a replay advances it by the whole bucket, and
    sampled streams match in distribution only, as JAX's key fanout
    differs from its scan graph's under an early exit)."""
    off, _ = run_port(torch_params, SAMPLED, pipeline=pipeline, chunk=(8, 8))
    on, s_on = run_port(torch_params, SAMPLED, mega=8, pipeline=pipeline, chunk=(8, 8))
    assert on == off
    assert any(len(set(t)) > 1 for t in on)
    assert s_on["mega_dispatches"] > 0


def test_mega_token_identical_constrained(torch_params, jax_params):
    """A json_mode stream beside a greedy one: constrained ticks take the
    masked and jump path in both arms, so arming the megagraph changes
    nothing; the greedy stream is the JAX batcher's."""
    tok = ByteTokenizer()
    reqs = [dict(prompt_ids=tok.encode("emit json"), max_tokens=40, temperature=0.9,
                 top_p=0.95, stop_ids=(tok.eos_id,), json_mode=True),
            dict(prompt_ids=tok.encode("plain"), max_tokens=24, temperature=0.0)]
    off, _ = run_port(torch_params, reqs, tokenizer=tok, pipeline=True, chunk=(8, 8))
    on, _ = run_port(torch_params, reqs, tokenizer=tok, pipeline=True, mega=8, chunk=(8, 8))
    want, _ = run_jax(jax_params, reqs[1:], mega=8, pipeline=True, chunk=(8, 8))
    assert on == off
    assert isinstance(json.loads(tok.decode(on[0])), dict)
    assert on[1] == want[0]


def test_mega_early_exit_on_budget_and_eos(torch_params, jax_params):
    """Every live slot retiring mid-window (budget, then a stop id) ends the
    dispatch after k < K ticks, the JAX dispatch's k; mega_ticks counts
    k, never the window."""
    reqs = [dict(prompt_ids=[9, 8, 7], max_tokens=3, temperature=0.0)]
    outs, stats = run_port(torch_params, reqs, mega=8, chunk=(8, 8))
    want, s_want = run_jax(jax_params, reqs, mega=8, chunk=(8, 8))
    assert outs == want and len(outs[0]) == 3
    assert stats["ticks"] == s_want["ticks"] == [2]
    assert stats["mega_ticks"] == stats["decode_steps"] == 2
    free, _ = run_port(torch_params, [dict(prompt_ids=[5, 6, 7], max_tokens=32,
                                           temperature=0.0)], chunk=(8, 8))
    reqs = [dict(prompt_ids=[5, 6, 7], max_tokens=32, temperature=0.0,
                 stop_ids=(free[0][4],))]
    off, _ = run_port(torch_params, reqs, chunk=(8, 8))
    on, s_on = run_port(torch_params, reqs, mega=8, chunk=(8, 8))
    want, s_want = run_jax(jax_params, reqs, mega=8, chunk=(8, 8))
    assert on == off == want and on[0][-1] == free[0][4]
    assert s_on["ticks"] == s_want["ticks"]
    assert s_on["mega_ticks"] < s_on["mega_dispatches"] * 8


def test_megatick_abort_fault_forces_early_exit(torch_params, jax_params, no_faults):
    """``pool.megatick_abort`` caps a dispatch mid-window: it returns after
    k < K ticks (in the sync loop the JAX dispatches' k under the same
    schedule), and the streams are the unfaulted run's, pipelined too."""
    reqs = [dict(prompt_ids=[3 + i, 17, 91], max_tokens=20, temperature=0.0)
            for i in range(3)]
    clean, _ = run_port(torch_params, reqs, mega=8, pipeline=True, chunk=(8, 8))
    faults.activate("seed=5;pool.megatick_abort=nth:1,ticks=2")
    piped, _ = run_port(torch_params, reqs, mega=8, pipeline=True, chunk=(8, 8))
    faults.deactivate()
    plan = faults.activate("seed=5;pool.megatick_abort=nth:1,ticks=2")
    out, stats = run_port(torch_params, reqs, mega=8, chunk=(8, 8))
    faults.deactivate()
    jfaults.activate("seed=5;pool.megatick_abort=nth:1,ticks=2")
    want, s_want = run_jax(jax_params, reqs, mega=8, chunk=(8, 8))
    jfaults.deactivate()
    assert out == piped == clean == want
    assert [e["point"] for e in plan.journal()] == ["pool.megatick_abort"]
    assert stats["ticks"] == s_want["ticks"] and stats["ticks"][0] == 2
    assert stats["mega_ticks"] < stats["mega_dispatches"] * 8


def test_mega_eviction_mid_window_recovers(torch_params, jax_params):
    """Pool exhaustion from a megagraph dispatch: the eviction consumes the
    window in flight first, and the survivor completes with the JAX
    stream."""
    want, s_want = run_jax(jax_params, EVICT_REQS, mega=8, pipeline=True,
                           engine_kw=EVICT_POOL, chunk=(8, 8))
    outs, stats = run_port(torch_params, EVICT_REQS, mega=8, pipeline=True,
                           engine_kw=EVICT_POOL, chunk=(8, 8))
    assert stats["evictions"] >= 1 and stats["mega_dispatches"] > 0
    assert stats["aborted"] == s_want["aborted"] and "evicted" in stats["aborted"][1]
    assert outs[0] == want[0] and len(outs[0]) == 50


def test_mega_no_capture_after_warmup_sweep(torch_params, monkeypatch):
    """Warmup captures every power-of-two megagraph bucket up to K; a
    batcher attaching and a pipelined wave afterwards capture nothing
    (the admission window 2 and the full window 8 hit warmed buckets)."""
    eng = _port_engine(torch_params, mega_ticks=8)
    gs = _stand_in(eng, monkeypatch)
    _warm(eng, prefill_chunk=32)
    before = gs.captures
    b = ContinuousBatcher(eng, chunk_steps=8, admit_chunk_steps=2, pipeline=True)
    try:
        assert gs.captures == before
        hs = [b.submit(Request(prompt_ids=[3 + i, 4, 5], max_tokens=12 + i,
                               temperature=0.0)) for i in range(4)]
        got = [h.tokens() for h in hs]
    finally:
        b.shutdown()
    assert eng.mega_dispatches > 0 and gs.captures == before
    assert eng.mega_graphs() == 4
    want, _ = run_port(torch_params, [dict(prompt_ids=[3 + i, 4, 5], max_tokens=12 + i,
                                           temperature=0.0) for i in range(4)],
                       chunk=(8, 2))
    assert got == want
    _close(eng)


def test_mega_failover_mid_megadispatch_resumes(torch_params, jax_params, no_faults):
    """A replica crash while megagraph dispatches serve a 2-replica pool:
    failover resumes every stream from the tokens it emitted, token for
    token the fault-free run's and the JAX single engine's."""
    name = "mega-failover-test"
    cfg = TINY_TEST.scaled(name=name, max_context=CTX)
    e0 = TorchEngine(cfg, torch_params, num_slots=4, max_context=CTX,
                     cache_dtype=torch.float32, device="cpu", mega_ticks=8)
    e1 = TorchEngine(cfg, e0.params, num_slots=4, max_context=CTX,
                     cache_dtype=torch.float32, device="cpu", mega_ticks=8)
    pool = ReplicaPool(name, [e0, e1],
                       lambda e: ContinuousBatcher(e, chunk_steps=8, admit_chunk_steps=8),
                       ServingConfig(replicas=2, failover_retries=2, failover_backoff_ms=5.0))

    def wave(tag):
        handles = [pool.submit(Request(prompt_ids=[3 + i, 7, 11], max_tokens=24,
                                       temperature=0.0, request_id=f"{tag}-{i}"))
                   for i in range(4)]
        streams, threads = {}, []
        for i, h in enumerate(handles):
            t = threading.Thread(target=lambda i=i, h=h: streams.__setitem__(i, h.tokens()),
                                 daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads), "a request leaked"
        return [streams.get(i) for i in range(4)], handles

    try:
        ref, _ = wave("ref")
        assert all(len(s) == 24 for s in ref)
        faults.activate("seed=2;pool.scheduler_crash=nth:4")
        out, handles = wave("crash")
        faults.deactivate()
        assert out == ref
        assert not any(h.aborted for h in handles)
        assert pool.restarts == 1
        assert pool.stats()["mega_k"] == 8
    finally:
        pool.shutdown()
    want, _ = run_jax(jax_params, [dict(prompt_ids=[3 + i, 7, 11], max_tokens=24,
                                        temperature=0.0) for i in range(4)],
                      mega=8, chunk=(8, 8))
    assert ref == want


def test_mega_gate_reference_is_the_jax_cond():
    """The gate's plain version (the CPU's, and the kernel's check on the
    card) is the JAX loop's cond: tick < cap and some slot active, not
    done, with budget and below the context cap."""
    S = 4
    cap = torch.tensor([3], dtype=torch.int32)
    active = torch.tensor([True, True, False, True])
    done = torch.tensor([False, True, False, False])
    rem = torch.tensor([0, 5, 5, 2], dtype=torch.int32)
    lengths = torch.tensor([3, 4, 5, 126], dtype=torch.int32)
    go = torch.zeros(4, dtype=torch.int32)
    for tick in range(4):
        ops.mega_gate(tick, cap, active, done, rem, lengths, 127, go)
    assert go.tolist() == [1, 1, 1, 0]
    lengths[3] = 127  # slot 3 at the cap: no slot live
    go.zero_()
    ops.mega_gate(0, cap, active, done, rem, lengths, 127, go)
    assert int(go[0]) == 0
    lengths[3] = 126
    done[3] = True  # slot 3 done: no slot live
    ops.mega_gate(1, cap, active, done, rem, lengths, 127, go)
    assert int(go[1]) == 0
    rem[0] = 1  # slot 0 with budget again: live
    ops.mega_gate(1, cap, active, done, rem, lengths, 127, go)
    ops.mega_gate(3, cap, active, done, rem, lengths, 127, go)
    assert go.tolist() == [0, 1, 0, 0]
    assert go.shape == (S,)
