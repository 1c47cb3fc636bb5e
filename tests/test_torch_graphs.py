"""The port's decode dispatch as CUDA graphs, as far as the CPU can hold it:
the static step state, the split-out step and round bodies against the
engine's public calls and against the JAX TPUEngine (int8 weights, fp32
caches), a warmup that captures nothing on the CPU, the launch tally a
replay adds (with a stand-in for the graph), the held split workspace and
the engine's reservation of it, the batcher's attach, and the graph
counters in HealthCheck."""

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
from aios_tpu_torch.engine import graphs
from aios_tpu_torch.engine.batching import ContinuousBatcher, Request
from aios_tpu_torch.engine.config import TINY_TEST
from aios_tpu_torch.engine.engine import TorchEngine
from aios_tpu_torch.engine.weights import params_from_jax
from aios_tpu_torch.ops import build, split
from aios_tpu_torch.proto_gen import common_pb2
from aios_tpu_torch.runtime.model_manager import ModelManager
from aios_tpu_torch.runtime.service import RuntimeService

# the module: the package's name is bound to the wrapper
qmm = importlib.import_module("aios_tpu_torch.ops.quantized_matmul")

# The shapes here are tiny: one intra-op thread is faster and leaves the
# cores to the other test workers.
torch.set_num_threads(1)

CTX = 128
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
REPEATING = [256] + [(i % 6) * 11 + 3 for i in range(30)]  # period 6: drafts accepted
PROMPTS = [[256, 7, 99, 3, 41], REPEATING, [256] + [(i * 37) % 256 for i in range(40)]]
STATE = ("lengths", "last_tokens", "temps", "top_ps", "active_dev", "history", "tables_dev")


@pytest.fixture(scope="module")
def jax_params():
    return jm.init_params(JAX_TINY, jax.random.PRNGKey(0), dtype=jnp.float32)


@pytest.fixture(scope="module")
def torch_params(jax_params):
    return params_from_jax(jax.tree.map(np.asarray, jax_params))


def _geometry(paged: bool) -> dict:
    return dict(paged_pool_rows=256, page_size=16) if paged else {}


def _port(torch_params, paged: bool, **kw) -> TorchEngine:
    kw.setdefault("num_slots", 3)
    return TorchEngine(TINY_TEST, torch_params, max_context=CTX, quantize="int8",
                       cache_dtype=torch.float32, device="cpu", **_geometry(paged), **kw)


def _pair(jax_params, torch_params, paged: bool):
    jax_eng = TPUEngine(JAX_TINY, jax_params, num_slots=3, max_context=CTX, quantize="int8",
                        cache_dtype=jnp.float32, prefix_cache=False, **_geometry(paged))
    return jax_eng, _port(torch_params, paged, prefix_cache=False)


PAGED = pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])


@PAGED
def test_step_state_keeps_its_storage(torch_params, paged):
    """Every step buffer is updated in place: the same storage across
    prefill, step, spec_step and release (a graph holds its address)."""
    eng = _port(torch_params, paged)
    held = [n for n in STATE if getattr(eng, n) is not None]
    assert ("tables_dev" in held) == paged and "history" in held
    ptrs = {n: getattr(eng, n).data_ptr() for n in held}
    eng.prefill(0, PROMPTS[0], temperature=0.0)
    eng.prefill(1, PROMPTS[1], temperature=0.8, top_p=0.9)
    eng.step(3)
    if not paged:
        eng.spec_step(2, draft_len=5, ngram=2)
        eng.spec_step_eager(1)
    eng.step_eager(1)
    eng.release(0)
    eng.step(1)
    assert {n: getattr(eng, n).data_ptr() for n in held} == ptrs
    eng.close()


def _greedy_slots(eng: TorchEngine) -> None:
    for s, prompt in enumerate(PROMPTS):
        eng.prefill(s, prompt, temperature=0.0)


@PAGED
def test_step_body_gives_the_engine_tokens(torch_params, paged):
    """The split-out step body, run by hand on the static state, gives the
    tokens, lengths and logits of ``step`` and ``step_eager``."""
    a, b, c = (_port(torch_params, paged) for _ in range(3))
    for eng in (a, b, c):
        _greedy_slots(eng)
    want = a.step(5)
    np.testing.assert_array_equal(c.step_eager(5), want)
    if paged:  # what step does before its dispatch
        b._back_active_slots(5)
        b.tables_dev.copy_(torch.from_numpy(b.allocator.tables))
    got = []
    for _ in range(5):
        logits = b._step_body()
        got.append(b.last_tokens.clone())
    np.testing.assert_array_equal(torch.stack(got).numpy(), want)
    np.testing.assert_array_equal(b.lengths.numpy(), a.lengths.numpy())
    torch.testing.assert_close(logits, a.last_logits, rtol=0, atol=0)
    torch.testing.assert_close(c.last_logits, a.last_logits, rtol=0, atol=0)
    for eng in (a, b, c):
        eng.close()


def test_round_body_gives_the_engine_rounds(torch_params):
    """The split-out round body gives ``spec_step``'s tokens and counts, and
    so does ``spec_step_eager``; drafts are accepted on the repeating
    prompt."""
    a, b, c = (_port(torch_params, False) for _ in range(3))
    for eng in (a, b, c):
        _greedy_slots(eng)
    tokens, counts = a.spec_step(10, draft_len=5, ngram=2)
    t2, c2 = c.spec_step_eager(10, draft_len=5, ngram=2)
    np.testing.assert_array_equal(t2, tokens)
    np.testing.assert_array_equal(c2, counts)
    for r in range(10):
        g, n, logits = b._round_body(5, 2)
        np.testing.assert_array_equal(n.numpy(), counts[r])
        for s in range(3):
            np.testing.assert_array_equal(g[s, : n[s]].numpy(), tokens[r, s, : counts[r, s]])
    assert counts[:, 1].max() > 1  # the repeating prompt's drafts were accepted
    np.testing.assert_array_equal(b.lengths.numpy(), a.lengths.numpy())
    np.testing.assert_array_equal(b.history.numpy(), a.history.numpy())
    torch.testing.assert_close(logits, a.last_logits, rtol=0, atol=0)
    for eng in (a, b, c):
        eng.close()


@PAGED
def test_warmup_on_the_cpu_captures_nothing(torch_params, paged):
    eng = _port(torch_params, paged)
    eng.warmup()
    eng.capture_step()
    eng.capture_spec(5, 2)
    eng.prefill(0, PROMPTS[1], temperature=0.0)
    eng.step(2)
    if not paged:
        eng.spec_step(2)
    stats = eng.stats()
    assert (stats["graph_captures"], stats["graph_capture_seconds"],
            stats["graph_replays"]) == (0, 0.0, 0)
    assert not eng.graphs.enabled and eng.graphs.stream is None and not eng.graphs.graphs
    eng.close()


@PAGED
def test_warmed_engine_streams_and_logits_match_jax(jax_params, torch_params, paged):
    """Greedy streams of a warmed engine equal the JAX engine's (plain and,
    over the dense cache, speculative), and the logits of one step equal
    the JAX model's on the JAX engine's own state within 1e-4."""
    jax_eng, port = _pair(jax_params, torch_params, paged)
    try:
        port.warmup()
        for prompt in PROMPTS:
            want = jax_eng.generate(prompt, max_new_tokens=20, temperature=0.0)
            assert port.generate(prompt, max_new_tokens=20, temperature=0.0) == want
            if not paged:
                assert port.generate(prompt, max_new_tokens=20, temperature=0.0,
                                     speculative=True, draft_len=5, ngram=2) == want
        for s, prompt in enumerate(PROMPTS):
            assert port.prefill(s, prompt) == jax_eng.prefill(s, prompt)
        st = jax_eng.state
        args = (jax_eng.params, JAX_TINY, st["last_tokens"].astype(jnp.int32), st["lengths"],
                st["k"], st["v"])
        if paged:
            for s, prompt in enumerate(PROMPTS):
                jax_eng.allocator.ensure(s, len(prompt) + 1)
            want = jm.decode_step_paged(*args, jnp.asarray(jax_eng.allocator.tables),
                                        active=st["active"])[0]
        else:
            want = jm.decode_step(*args, active=st["active"])[0]
        port.step(1)
        np.testing.assert_allclose(port.last_logits.numpy(), np.asarray(want), **LOGIT_TOL)
        np.testing.assert_array_equal(port.last_tokens.numpy(), np.asarray(want).argmax(-1))
    finally:
        jax_eng.close()
        port.close()


@pytest.mark.parametrize("speculative", [False, True], ids=["plain", "speculative"])
def test_batcher_on_a_warmed_engine_matches_the_jax_batcher(jax_params, torch_params,
                                                            speculative):
    jax_eng = TPUEngine(JAX_TINY, jax_params, num_slots=3, max_context=CTX,
                        cache_dtype=jnp.float32)
    jb = JaxBatcher(jax_eng, speculative=speculative)
    try:
        hs = [jb.submit(JaxRequest(prompt_ids=p, max_tokens=24, temperature=0.0))
              for p in PROMPTS]
        want = [h.tokens() for h in hs]
    finally:
        jb.shutdown()
        jax_eng.close()
    port = TorchEngine(TINY_TEST, torch_params, num_slots=3, max_context=CTX,
                       cache_dtype=torch.float32, device="cpu")
    port.warmup()
    tb = ContinuousBatcher(port, speculative=speculative)
    try:
        hs = [tb.submit(Request(prompt_ids=p, max_tokens=24, temperature=0.0))
              for p in PROMPTS]
        got = [h.tokens() for h in hs]
        assert tb.last_error is None
    finally:
        tb.shutdown()
        port.close()
    assert got == want and all(len(o) == 24 for o in got)


def test_batcher_attach_captures_its_sizes_without_dispatch(torch_params, monkeypatch):
    """The twin of the JAX batcher's attach compiling its missing sizes:
    attaching asks the engine for the step graph and the round graph of the
    batcher's own draft_len and ngram, and dispatches nothing."""
    eng = _port(torch_params, False)
    asked = []
    monkeypatch.setattr(eng, "capture_step", lambda: asked.append(("step",)))
    monkeypatch.setattr(eng, "capture_spec", lambda d, n: asked.append(("spec", d, n)))
    b = ContinuousBatcher(eng, speculative=True, spec_draft_len=5, spec_ngram=2)
    plain = ContinuousBatcher(eng)
    try:
        assert asked == [("step",), ("spec", 5, 2), ("step",)]
        assert eng.decode_steps == 0 and eng.prefills == 0
    finally:
        b.shutdown()
        plain.shutdown()
        eng.close()


class _StandInGraph:
    """What ``Graph`` needs of a CUDA graph: ``replay``."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_a_replay_adds_the_launches_its_capture_recorded():
    before = {k: k.launches for k in ops.KERNELS}
    other = []
    with build.recording_launches() as recorded:
        for _ in range(3):
            build.count_launch(ops.quantized_matmul)
        build.count_launch(ops.paged_decode_attention)
        # another thread's launches are not this capture's: they count now
        t = threading.Thread(target=lambda: other.append(build.count_launch(ops.int4_matmul)))
        t.start()
        t.join()
    assert recorded == {ops.quantized_matmul: 3, ops.paged_decode_attention: 1}
    after_capture = {k: k.launches for k in ops.KERNELS}
    assert after_capture == {**before, ops.int4_matmul: before[ops.int4_matmul] + 1}
    stand_in = _StandInGraph()
    graph = graphs.Graph(stand_in, ("tokens", "logits"), recorded)
    gs = graphs.GraphSet(torch.device("cpu"), torch.Generator())
    gs.graphs["step"] = graph
    assert "step" in gs and "spec" not in gs
    assert gs.replay("step") == ("tokens", "logits")
    assert graph.replay() == ("tokens", "logits")
    assert stand_in.replays == 2 and gs.replays == 1
    assert {k: k.launches for k in ops.KERNELS} == {
        **after_capture,
        ops.quantized_matmul: after_capture[ops.quantized_matmul] + 6,
        ops.paged_decode_attention: after_capture[ops.paged_decode_attention] + 2,
    }
    # recording nests: an inner recording leaves the outer one as it was
    with build.recording_launches() as outer:
        with build.recording_launches() as inner:
            build.count_launch(ops.decode_attention)
        build.count_launch(ops.decode_attention_int8)
    assert inner == {ops.decode_attention: 1} and outer == {ops.decode_attention_int8: 1}


def test_a_held_workspace_raises_instead_of_being_replaced():
    dev, stream = torch.device("cpu"), 0x5EED
    try:
        ptrs = split.workspace(dev, stream, 6, 4, 64)
        assert split.workspace(dev, stream, 3, 4, 64) == ptrs  # fits: the same
        split.hold(dev, stream)
        split.hold(dev, stream)  # two graphs hold it
        with pytest.raises(RuntimeError, match="held by a captured CUDA graph"):
            split.workspace(dev, stream, 12, 4, 64)
        with pytest.raises(RuntimeError, match="held by a captured CUDA graph"):
            split.workspace(dev, stream, 6, 4, 64, rows=split.MQ_BLOCK_ROWS)
        assert split.workspace(dev, stream, 6, 4, 64) == ptrs
        split.release(dev, stream)
        with pytest.raises(RuntimeError):
            split.workspace(dev, stream, 12, 4, 64)
        split.release(dev, stream)  # the last holder: freed
        assert (dev.index, stream) not in split._workspaces
        grown = split.workspace(dev, stream, 12, 4, 64)
        assert split._workspaces[(dev.index, stream)].floats == 12 * 4 * split.partial_floats(64)
        assert grown == split.workspace(dev, stream, 12, 4, 64)
    finally:
        split._workspaces.pop((dev.index, stream), None)


@pytest.mark.parametrize("paged,track", [(True, False), (False, False), (False, True)],
                         ids=["paged", "dense", "dense-speculative"])
def test_the_reserved_workspace_takes_every_launch_a_graph_can_make(
        torch_params, monkeypatch, paged, track, sms=132):
    """An engine reserves its stream's workspace at the largest launch of
    any graph it can capture (every draft_len spec_step takes, and every
    jump bucket), so that a held workspace never has to grow; and the
    split-K counters."""
    stream = 0xCAB1E

    class Stream:
        cuda_stream = stream

    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: Stream())
    monkeypatch.setattr(engine_mod, "sm_count", lambda index: sms)
    eng = _port(torch_params, paged, num_slots=8, track_history=track)
    cfg, dev, key = TINY_TEST, eng.device, (eng.device.index, stream)
    try:
        eng._reserve_workspaces()
        split.hold(dev, stream)
        B, KH, D, G = 8, cfg.num_kv_heads, cfg.head_dim, cfg.num_heads // cfg.num_kv_heads
        splits = split.split_plan(CTX, B, KH, sms)
        split.workspace(dev, stream, *split.launch_groups(B, KH)[:1], splits, D)
        if track:
            for draft_len in range(1, engine_mod.spec.HISTORY_PAD - 1):
                groups, rows = split.launch_groups(B, KH, (draft_len + 1) * G)
                split.workspace(dev, stream, groups, splits, D, rows)
        else:  # every jump fits; a verify launch of one more query tile would not
            for kb in engine_mod.JUMP_BUCKETS:
                groups, rows = split.launch_groups(B, KH, (kb + 1) * G)
                split.workspace(dev, stream, groups, splits, D, rows)
            largest = -(-(engine_mod.JUMP_BUCKETS[-1] + 1) * G // split.MQ_BLOCK_ROWS)
            groups, rows = split.launch_groups(B, KH, largest * split.MQ_BLOCK_ROWS + G)
            with pytest.raises(RuntimeError, match="held"):
                split.workspace(dev, stream, groups, splits, D, rows)
        assert qmm.counters_for(dev, stream) is qmm._counters[key]
    finally:
        split._workspaces.pop(key, None)
        qmm._counters.pop(key, None)
        eng.close()


def test_health_check_carries_the_graph_counters():
    manager = ModelManager(num_slots=2, device="cpu")
    try:
        manager.load_model("tiny", "synthetic://tiny-test")
        manager.get("tiny").batcher.generate([256, 1, 2, 3], max_tokens=4, temperature=0.0)
        details = RuntimeService(manager).HealthCheck(common_pb2.Empty(), None).details
        serving = dict(kv.split("=") for kv in details["tiny.serving"].split(","))
        assert (serving["graph_captures"], serving["graph_capture_seconds"],
                serving["graph_replays"]) == ("0", "0.0", "0")
        assert int(serving["decode_steps"]) >= 1
    finally:
        manager.close()
