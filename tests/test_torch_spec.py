"""The port's dense-cache serving path with n-gram speculation against the
JAX package: the proposer and the acceptance rule (integer functions, equal
exactly), the dense ``TorchEngine`` against ``TPUEngine(paged_pool_rows=None)``
(greedy streams, ``spec_step`` counts and lengths from a carried-over state),
the speculative batcher against the JAX batcher and the plain one, and the
runtime on the CPU (``paged_kv``, ``speculative``, the dense fallback for an
int8 cache whose context the pool cannot page).

Both engines run TINY_TEST on the same f32 weights with an f32 or int8 cache,
where greedy streams agree token for token (logits agree to ~1e-5, far below
the margins of this model's argmaxes on these prompts).
"""

import logging
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aios_tpu.engine import model as jm
from aios_tpu.engine import spec as jspec
from aios_tpu.engine.batching import ContinuousBatcher as JaxBatcher
from aios_tpu.engine.batching import Request as JaxRequest
from aios_tpu.engine.config import TINY_TEST as JAX_TINY
from aios_tpu.engine.engine import TPUEngine
from aios_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from aios_tpu.runtime.model_manager import ModelManager as JaxModelManager
from aios_tpu_torch import rpc, services
from aios_tpu_torch.engine import batching, spec
from aios_tpu_torch.engine.batching import ContinuousBatcher, Request
from aios_tpu_torch.engine.config import TINY_TEST
from aios_tpu_torch.engine.engine import TorchEngine
from aios_tpu_torch.engine.tokenizer import ByteTokenizer
from aios_tpu_torch.engine.weights import params_from_jax
from aios_tpu_torch.proto_gen import common_pb2, runtime_pb2
from aios_tpu_torch.runtime.model_manager import ModelManager
from aios_tpu_torch.runtime.service import serve

# The shapes here are tiny: one intra-op thread is faster and leaves the
# cores to the other test workers.
torch.set_num_threads(1)

CTX = 128


@pytest.fixture(scope="module")
def jax_params():
    return jm.init_params(JAX_TINY, jax.random.PRNGKey(1), dtype=jnp.float32)


@pytest.fixture(scope="module")
def torch_params(jax_params):
    return params_from_jax(jax.tree.map(np.asarray, jax_params))


# -- the proposer and the acceptance rule ---------------------------------------


def _random_histories(seed, S=6, C=48):
    """Small-vocabulary token runs with repeats, at ragged lengths that reach
    from too short for an n-gram up to the cache end."""
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, 4, size=(S, C + spec.HISTORY_PAD)).astype(np.int32)
    period = rng.integers(2, 9, size=S)
    for s in range(S // 2):  # half the slots strictly periodic
        hist[s] = np.resize(hist[s, : period[s]], hist.shape[1])
    lengths = rng.integers(0, C, size=S).astype(np.int32)
    lengths[0], lengths[-1] = 1, C - 1
    return hist, lengths, C


@pytest.mark.parametrize("floor", [False, True], ids=["anywhere", "min_pos"])
@pytest.mark.parametrize("ngram,draft_len", [(1, 4), (3, 7), (2, 30)])
@pytest.mark.parametrize("seed", range(4))
def test_propose_ngram_equals_jax(seed, ngram, draft_len, floor):
    hist, lengths, C = _random_histories(seed)
    min_pos = np.random.default_rng(seed).integers(0, C // 2, len(lengths)).astype(np.int32)
    jd, jn = jspec.propose_ngram(
        jnp.asarray(hist), jnp.asarray(lengths), draft_len, ngram, C,
        min_pos=jnp.asarray(min_pos) if floor else None)
    td, tn = spec.propose_ngram(
        torch.from_numpy(hist).long(), torch.from_numpy(lengths), draft_len, ngram, C,
        min_pos=torch.from_numpy(min_pos) if floor else None)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    if not floor and ngram == 3:
        assert int(tn.max()) > 0  # the periodic slots do find drafts


def test_propose_ngram_most_recent_full_match_and_cache_room():
    C = 16
    hist = torch.zeros((2, C + spec.HISTORY_PAD), dtype=torch.int64)
    seq = [1, 2, 3, 4, 5, 1, 2, 3, 4, 5, 1, 2, 3]
    hist[0, : len(seq)] = torch.tensor(seq)
    hist[1, :6] = torch.tensor([1, 2, 3, 4, 5, 6])  # no repeated trigram
    lengths = torch.tensor([len(seq) - 1, 5], dtype=torch.int32)  # room = 16-2-12 = 2
    drafts, num = spec.propose_ngram(hist, lengths, 8, 3, C)
    assert num.tolist() == [2, 0]
    assert drafts[0].tolist() == [4, 5] + [-1] * 6 and (drafts[1] == -1).all()


@pytest.mark.parametrize("seed", range(3))
def test_accept_counts_equals_jax(seed):
    rng = np.random.default_rng(seed)
    drafts = rng.integers(-1, 3, size=(16, 7)).astype(np.int32)
    g = rng.integers(0, 3, size=(16, 8)).astype(np.int32)
    g[:4, :7] = np.where(drafts[:4] >= 0, drafts[:4], g[:4, :7])  # long accepted runs
    want = np.asarray(jspec.accept_counts(jnp.asarray(drafts), jnp.asarray(g)))
    got = spec.accept_counts(torch.from_numpy(drafts), torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.max() >= 1


def test_history_buffer_shape():
    h = spec.init_history(3, 64)
    assert h.shape == (3, 64 + spec.HISTORY_PAD) == tuple(jspec.init_history(3, 64).shape)
    assert spec.HISTORY_PAD == jspec.HISTORY_PAD and spec.SPEC_PROPOSERS == jspec.SPEC_PROPOSERS


# -- the dense engine -------------------------------------------------------------

CACHES = {"f32": (jnp.float32, torch.float32), "int8": (jnp.int8, torch.int8)}


def _engines(jax_params, torch_params, cache="f32", quantize=None, **kw):
    kw.setdefault("num_slots", 3)
    kw.setdefault("max_context", CTX)
    jdt, tdt = CACHES[cache]
    jax_eng = TPUEngine(JAX_TINY, jax_params, cache_dtype=jdt, quantize=quantize, **kw)
    port = TorchEngine(TINY_TEST, torch_params, cache_dtype=tdt, quantize=quantize,
                       device="cpu", **kw)
    assert not port.paged and port.allocator is None
    return jax_eng, port


def _carry_state(jax_eng: TPUEngine, port: TorchEngine) -> None:
    """Copy a JAX dense decode state (caches, scales, lengths, last tokens,
    sampling parameters, active mask, history) into the port's engine."""
    st = {k: np.asarray(v) for k, v in jax_eng.state.items() if k != "key"}
    pairs = [(port.k_pool, "k"), (port.v_pool, "v"), (port.lengths, "lengths"),
             (port.last_tokens, "last_tokens"), (port.temps, "temps"),
             (port.top_ps, "top_ps"), (port.active_dev, "active"),
             (port.history, "history")]
    if port.quant_cache:
        pairs += [(port.k_scales, "k_s"), (port.v_scales, "v_s")]
    for dst, key in pairs:
        dst.copy_(torch.from_numpy(st[key].copy()))
    port.active[:] = jax_eng.active
    port._host_lengths[:] = jax_eng._host_lengths


REPEATING = [256] + [(i % 6) * 11 + 3 for i in range(30)]  # period 6
PROMPTS = {"short": [1, 2, 3], "repeating": REPEATING,
           "long": [256] + [(i * 37) % 256 for i in range(40)]}


@pytest.fixture(scope="module", params=[("f32", None), ("int8", None), ("int8", "int4")],
                ids=["f32", "int8kv", "int4-int8kv"])
def dense_engines(request, jax_params, torch_params):
    """One pair of engines per cache and weight type, shared by the prompts:
    ``generate`` releases its slot, and what stays in the caches lies beyond
    every later length."""
    jax_eng, port = _engines(jax_params, torch_params, *request.param)
    yield jax_eng, port
    jax_eng.close()
    port.close()


@pytest.mark.parametrize("prompt", list(PROMPTS))
def test_dense_generate_plain_and_speculative_match_jax(dense_engines, prompt):
    jax_eng, port = dense_engines
    ids = PROMPTS[prompt]
    want = jax_eng.generate(ids, max_new_tokens=40, temperature=0.0)
    assert port.generate(ids, max_new_tokens=40, temperature=0.0) == want
    steps, accepted = port.decode_steps, port.stats().get("spec_accepted", 0)
    got = port.generate(ids, max_new_tokens=40, temperature=0.0, speculative=True)
    assert got == want
    assert jax_eng.generate(ids, max_new_tokens=40, temperature=0.0,
                            speculative=True) == want
    assert port.decode_steps - steps <= 39
    if prompt == "repeating":  # its stream keeps cycling: drafts are accepted
        assert port.decode_steps - steps < 39
        assert port.stats()["spec_accepted"] > accepted


@pytest.mark.parametrize("cache", ["f32", "int8"])
def test_spec_step_from_a_carried_state_matches_jax(jax_params, torch_params, cache):
    """Both engines start a speculative dispatch from the JAX engine's state:
    two greedy slots, one sampling slot and one inactive slot."""
    jax_eng, port = _engines(jax_params, torch_params, cache, num_slots=4)
    try:
        jax_eng.prefill(0, REPEATING, temperature=0.0)
        jax_eng.prefill(1, PROMPTS["long"], temperature=0.0)
        jax_eng.prefill(3, [5, 6, 5, 6, 5, 6], temperature=0.9, top_p=0.9)
        jax_eng.step(3)
        _carry_state(jax_eng, port)
        for _ in range(3):
            jt, jc = jax_eng.spec_step(2, draft_len=5, ngram=2)
            tt, tc = port.spec_step(2, draft_len=5, ngram=2)
            assert tt.shape == (2, 4, 6) and tc.shape == (2, 4)
            np.testing.assert_array_equal(tc[:, :2], jc[:, :2])
            for r in range(2):
                for s in range(2):
                    n = tc[r, s]
                    np.testing.assert_array_equal(tt[r, s, :n], jt[r, s, :n])
            assert (tc[:, 3] == 1).all() and (jc[:, 3] == 1).all()  # sampled: 1 a round
            assert ((tt[:, 3, 0] >= 0) & (tt[:, 3, 0] < TINY_TEST.vocab_size)).all()
            np.testing.assert_array_equal(port._host_lengths[:2], jax_eng._host_lengths[:2])
            np.testing.assert_array_equal(port.lengths.numpy(), port._host_lengths)
            hist_j = np.asarray(jax_eng.state["history"])
            for s in range(2):
                n = port.slot_length(s) + 1
                np.testing.assert_array_equal(port.history[s, :n].numpy(), hist_j[s, :n])
        assert port.stats()["spec_rounds"] == 6
        assert port.spec_slot_rounds == 18 and port.spec_tokens >= 18
    finally:
        jax_eng.close()
        port.close()


def test_spec_step_host_lengths_track_device_to_the_cache_end(torch_params):
    port = TorchEngine(TINY_TEST, torch_params, num_slots=2, max_context=32,
                       cache_dtype=torch.float32, device="cpu")
    port.prefill(0, [1, 2, 3], temperature=0.0)
    total = 3
    for _ in range(30):
        _, counts = port.spec_step(1, draft_len=4)
        total = min(total + int(counts[0, 0]), port.max_context - 1)
    assert port.slot_length(0) == total == int(port.lengths[0]) == 31
    port.close()


def test_saturating_speculative_generate_matches_plain(jax_params, torch_params):
    jax_eng, port = _engines(jax_params, torch_params, max_context=48)
    try:
        want = jax_eng.generate(REPEATING, max_new_tokens=64, temperature=0.0)
        got = port.generate(REPEATING, max_new_tokens=64, temperature=0.0, speculative=True)
        assert got == want == port.generate(REPEATING, max_new_tokens=64, temperature=0.0)
        assert len(got) < 64  # stopped by the cache end
    finally:
        jax_eng.close()
        port.close()


def test_spec_step_argument_checks(torch_params):
    port = TorchEngine(TINY_TEST, torch_params, num_slots=2, max_context=64,
                       cache_dtype=torch.float32, track_history=False, device="cpu")
    with pytest.raises(ValueError, match="draft_len"):
        port.spec_step(1, draft_len=spec.HISTORY_PAD - 1)
    with pytest.raises(ValueError, match="ngram"):
        port.spec_step(1, ngram=0)
    with pytest.raises(ValueError, match="track_history"):
        port.spec_step(1)
    port.close()
    paged = TorchEngine(TINY_TEST, torch_params, num_slots=2, max_context=64,
                        paged_pool_rows=128, page_size=16, cache_dtype=torch.float32,
                        device="cpu")
    # the round runs over the pool too (verify_step_paged); its argument
    # checks are the dense engine's
    assert paged.paged
    with pytest.raises(ValueError, match="draft_len"):
        paged.spec_step(1, draft_len=spec.HISTORY_PAD - 1)
    _, counts = paged.spec_step(1)
    assert counts.shape == (1, 2)
    paged.close()


# -- the batcher ----------------------------------------------------------------

BATCH_PROMPTS = [[1, 2, 3], [7, 8, 9, 7, 8, 9, 7, 8], [11, 12], REPEATING]


def _torch_batch(torch_params, speculative, prompts=BATCH_PROMPTS, degrade=False, **bkw):
    eng = TorchEngine(TINY_TEST, torch_params, num_slots=3, max_context=CTX,
                      cache_dtype=torch.float32, device="cpu")
    b = ContinuousBatcher(eng, speculative=speculative, **bkw)
    b.degrade_spec = degrade
    try:
        hs = [b.submit(Request(prompt_ids=p, max_tokens=40, temperature=0.0))
              for p in prompts]
        outs = [h.tokens() for h in hs]
        assert b.last_error is None
        return outs, eng.stats(), b
    finally:
        b.shutdown()
        eng.close()


def test_speculative_batcher_streams_match_jax_and_plain(jax_params, torch_params):
    jax_eng = TPUEngine(JAX_TINY, jax_params, num_slots=3, max_context=CTX,
                        cache_dtype=jnp.float32)
    jb = JaxBatcher(jax_eng, speculative=True)
    try:
        hs = [jb.submit(JaxRequest(prompt_ids=p, max_tokens=40, temperature=0.0))
              for p in BATCH_PROMPTS]
        want = [h.tokens() for h in hs]
    finally:
        jb.shutdown()
        jax_eng.close()
    plain, plain_stats, _ = _torch_batch(torch_params, False)
    got, stats, b = _torch_batch(torch_params, True)
    assert got == want == plain and all(len(o) == 40 for o in got)
    assert "spec_rounds" not in plain_stats
    assert stats["spec_rounds"] > 0 and stats["spec_accepted"] > 0
    assert stats["decode_steps"] < plain_stats["decode_steps"]
    assert b.spec_ewma["ngram"] > 0


def test_degrade_spec_routes_to_plain_ticks(torch_params):
    want, _, _ = _torch_batch(torch_params, False)
    got, stats, b = _torch_batch(torch_params, True, degrade=True)
    assert got == want and b.speculative
    assert "spec_rounds" not in stats and not b._spec_active()


def test_speculative_batcher_mixes_sampling_and_respects_max_tokens(torch_params):
    eng = TorchEngine(TINY_TEST, torch_params, num_slots=3, max_context=CTX,
                      cache_dtype=torch.float32, device="cpu")
    b = ContinuousBatcher(eng, speculative=True)
    try:
        hs = [b.submit(Request(prompt_ids=REPEATING, max_tokens=13, temperature=0.0)),
              b.submit(Request(prompt_ids=[5, 6], max_tokens=9, temperature=0.8, top_p=0.9))]
        outs = [h.tokens() for h in hs]
        assert [len(o) for o in outs] == [13, 9] and b.last_error is None
    finally:
        b.shutdown()
        eng.close()


def test_speculative_on_a_paged_engine_warns_and_serves_plain(torch_params, caplog):
    eng = TorchEngine(TINY_TEST, torch_params, num_slots=2, max_context=64,
                      paged_pool_rows=128, page_size=16, cache_dtype=torch.float32,
                      device="cpu")
    with caplog.at_level(logging.WARNING, logger="aios.torch.batcher"):
        b = ContinuousBatcher(eng, speculative=True)
    try:
        # speculation now runs over the pool: no warning, rounds dispatched
        assert b.speculative and "speculative decoding disabled" not in caplog.text
        assert len(b.generate([1, 2, 3], max_tokens=6, temperature=0.0)) == 6
        assert eng.spec_rounds > 0
    finally:
        b.shutdown()
        eng.close()


def test_spec_ewma_suspends_and_reprobes_like_the_reference(torch_params):
    """The sequence of tests/test_structured_fastpath.py's EWMA test."""
    eng = TorchEngine(TINY_TEST, torch_params, num_slots=4, max_context=CTX,
                      cache_dtype=torch.float32, device="cpu")
    b = ContinuousBatcher(eng, speculative=True, spec_min_accept=0.5)
    try:
        assert b.spec_proposers == ("ngram",)
        assert b._spec_active() and b._spec_proposer() == "ngram"
        counts = np.ones((2, 4), np.int64)  # one token a round: nothing accepted
        b._spec_measure("ngram", counts, {0: 2, 1: 2})
        assert b.spec_ewma["ngram"] == 0.0 and b.spec_autodisables == 1
        assert not b._spec_active()
        b._spec_off_until["ngram"] = time.monotonic() - 1  # the suspension ends
        assert b._spec_active() and b.spec_ewma["ngram"] is None
        assert b._spec_probe_left["ngram"] == batching.SPEC_PROBE_DISPATCHES == 3
        b._spec_measure("ngram", counts, {0: 2, 1: 2})
        assert b._spec_active(), "one bad probe must not suspend again"
        full = np.full((2, 4), b.spec_draft_len + 1, np.int64)
        b._spec_measure("ngram", full, {0: 2, 1: 2})
        b._spec_measure("ngram", full, {0: 2, 1: 2})
        assert b._spec_active() and abs(b.spec_ewma["ngram"] - 2.0 / 3.0) < 1e-9
        b._spec_measure("ngram", counts, {0: 2, 1: 2})  # past the probes: an EWMA
        assert abs(b.spec_ewma["ngram"] - 0.7 * 2.0 / 3.0) < 1e-9
        assert b.spec_autodisables == 2 and not b._spec_active()
        # rounds past a slot's retirement are excluded
        b._spec_off_until["ngram"] = time.monotonic() - 1
        assert b._spec_active() and b.spec_ewma["ngram"] is None
        mixed = full.copy()
        mixed[1, 0] = 1
        b._spec_measure("ngram", mixed, {0: 1, 1: 2})
        assert b.spec_ewma["ngram"] == 1.0 and b._spec_active()
    finally:
        b.shutdown()
        eng.close()


def test_spec_autodisable_end_to_end_and_its_variables(torch_params, monkeypatch):
    """A sampled stream never accepts a draft: with a floor from the JAX
    stack's variable the first dispatch suspends speculation and the stream
    finishes on plain ticks."""
    monkeypatch.setenv("AIOS_TPU_SPEC_MIN_ACCEPT", "0.25")
    monkeypatch.setenv("AIOS_TPU_SPEC_REPROBE_SECS", "300")
    eng = TorchEngine(TINY_TEST, torch_params, num_slots=2, max_context=CTX,
                      cache_dtype=torch.float32, device="cpu")
    b = ContinuousBatcher(eng, speculative=True)
    try:
        assert (b.spec_min_accept, b.spec_reprobe_secs) == (0.25, 300.0)
        assert len(b.generate([7, 2, 55], max_tokens=24, temperature=0.9)) == 24
        assert b.spec_autodisables >= 1 and not b._spec_active()
        rounds = eng.spec_rounds
        assert len(b.generate([9, 4, 33], max_tokens=12, temperature=0.9)) == 12
        assert eng.spec_rounds == rounds  # suspended: plain ticks only
    finally:
        b.shutdown()
        eng.close()
    monkeypatch.setenv("AIOS_TPU_SPEC_MIN_ACCEPT", "7")
    monkeypatch.setenv("AIOS_TPU_SPEC_REPROBE_SECS", "soon")
    eng = TorchEngine(TINY_TEST, torch_params, num_slots=2, max_context=64,
                      cache_dtype=torch.float32, device="cpu")
    b = ContinuousBatcher(eng, speculative=True)
    assert (b.spec_min_accept, b.spec_reprobe_secs) == (0.0, batching.SPEC_REPROBE_SECS)
    b.shutdown()
    eng.close()


# -- the runtime ----------------------------------------------------------------


def test_dense_speculative_manager_serves_over_grpc():
    manager = ModelManager(num_slots=2, device="cpu", paged_kv="off", speculative=True)
    server, _, port = serve(address="127.0.0.1:0", manager=manager, block=False)
    channel = rpc.insecure_channel(f"127.0.0.1:{port}")
    try:
        stub = services.AIRuntimeStub(channel)
        status = stub.LoadModel(runtime_pb2.LoadModelRequest(
            model_name="tiny", model_path="synthetic://tiny-test"))
        assert status.status == "ready"
        m = manager.get("tiny")
        assert not m.engine.paged and m.engine.track_history and m.batcher.speculative
        resp = stub.Infer(runtime_pb2.InferRequest(prompt="hello", max_tokens=8))
        assert resp.model_used == "tiny" and resp.tokens_used > 0
        chunks = list(stub.StreamInfer(runtime_pb2.InferRequest(
            prompt="status?", max_tokens=6, temperature=0.3)))
        assert chunks[-1].done and all(not c.done for c in chunks[:-1])
        # temperature 0 on the wire is unset, so greedy goes through the batcher
        ids = m.tokenizer.encode("ab" * 20)
        a = m.batcher.generate(ids, max_tokens=24, temperature=0.0)
        assert a == m.batcher.generate(ids, max_tokens=24, temperature=0.0) and len(a) == 24
        details = stub.HealthCheck(common_pb2.Empty()).details["tiny.serving"]
        assert "spec_rounds=" in details and "kv_pages" not in details
    finally:
        manager.close()
        channel.close()
        server.stop(grace=None)


def test_manager_reads_paged_kv_and_speculative(monkeypatch):
    for name in ("AIOS_TPU_PAGED_KV", "AIOS_TPU_SPECULATIVE"):
        monkeypatch.delenv(name, raising=False)
    m = ModelManager(num_slots=2, device="cpu")
    assert (m.paged_pool_rows, m.speculative) == ("auto", False)  # the boot default
    for env, want in (("auto", "auto"), ("off", None), ("0", None), ("false", None),
                      ("4096", 4096), ("-3", None), ("lots", None)):
        monkeypatch.setenv("AIOS_TPU_PAGED_KV", env)
        assert ModelManager(num_slots=2, device="cpu").paged_pool_rows == want, env
    for env, want in (("1", True), ("on", True), ("true", True), ("0", False), ("", False)):
        monkeypatch.setenv("AIOS_TPU_SPECULATIVE", env)
        assert ModelManager(num_slots=2, device="cpu").speculative is want, env
    # arguments win over the variables
    monkeypatch.setenv("AIOS_TPU_PAGED_KV", "off")
    monkeypatch.setenv("AIOS_TPU_SPECULATIVE", "1")
    m = ModelManager(num_slots=2, device="cpu", paged_kv=512, speculative=False)
    assert (m.paged_pool_rows, m.speculative) == (512, False)
    assert ModelManager(device="cpu", paged_kv=0).paged_pool_rows is None
    with pytest.raises(ValueError, match="paged_kv"):
        ModelManager(device="cpu", paged_kv="some")


def test_manager_pages_what_it_can_and_serves_the_rest_dense(caplog):
    m = ModelManager(num_slots=2, device="cpu", paged_kv=300, speculative=True)
    try:
        with caplog.at_level(logging.WARNING):
            eng = m.load_model("a", "synthetic://tiny-test", context_length=128).engine
            assert eng.paged and eng.allocator.page_size == 128
            assert eng.allocator.num_pages == 1 + 3  # 300 rows in pages of 128
            # speculation runs over the pool: no warning, speculative ticks
            assert m.get("a").batcher.speculative
            assert "speculative decoding disabled" not in caplog.text
            eng = m.load_model("b", "synthetic://tiny-test", context_length=48).engine
            assert eng.paged and eng.allocator.page_size == 16
            eng = m.load_model("c", "synthetic://tiny-test", context_length=40).engine
            assert not eng.paged and m.get("c").batcher.speculative
            assert "context 40 needs a multiple of 16; serving dense" in caplog.text
    finally:
        m.close()


def test_int8_cache_at_an_unpageable_context_serves_dense_like_jax(
        jax_params, torch_params, monkeypatch, caplog):
    """int4 weights over an int8 cache at context 96 (not a multiple of 128):
    both stacks' managers fall back to the dense cache and give the same
    greedy stream on the same weights."""
    monkeypatch.setenv("AIOS_TPU_QUANTIZE", "int4")
    monkeypatch.setenv("AIOS_TPU_KV_CACHE", "int8")
    monkeypatch.setenv("AIOS_TPU_PAGED_KV", "auto")
    monkeypatch.delenv("AIOS_TPU_SPECULATIVE", raising=False)
    monkeypatch.setattr(JaxModelManager, "_load_weights",
                        lambda self, name, path, ctx: (JAX_TINY, jax_params,
                                                       JaxByteTokenizer()))
    monkeypatch.setattr(ModelManager, "_load_weights",
                        lambda self, name, path, ctx: (TINY_TEST.scaled(max_context=ctx),
                                                       torch_params, ByteTokenizer()))
    prompt = [256] + [(i * 7) % 200 for i in range(20)]
    jman = JaxModelManager(num_slots=2, warm_compile=False)
    tman = ModelManager(num_slots=2, device="cpu")
    try:
        jm_ = jman.load_model("tiny", "synthetic://tiny-test", context_length=96)
        assert not jm_.engine.paged and jm_.engine.quant_cache
        want = jm_.batcher.submit(JaxRequest(prompt_ids=prompt, max_tokens=24,
                                             temperature=0.0)).tokens()
        with caplog.at_level(logging.WARNING, logger="aios.torch.runtime.models"):
            tm_ = tman.load_model("tiny", "synthetic://tiny-test", context_length=96)
        assert "context 96 needs a multiple of 128; serving dense" in caplog.text
        eng = tm_.engine
        assert not eng.paged and eng.quant_cache and "q4" in eng.params["layers"]["wo"]
        got = tm_.batcher.generate(prompt, max_tokens=24, temperature=0.0)
        assert got == want and len(got) == 24
    finally:
        for man in (jman, tman):
            for name in list(man.models):
                man.unload_model(name)
