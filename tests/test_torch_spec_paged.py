"""n-gram speculation over the page pool in the port against the JAX package:
``spec_step`` on a paged ``TorchEngine`` and a paged ``TPUEngine`` (tiny-test
and a windowed twin: tokens, counts, history, the allocator's tables,
refcounts and trimmed blocks), the backing of the drafted rows before the
dispatch (PoolExhausted with the state untouched), the speculative batcher
over the pool, the split workspace of a draft-carrying engine, the
speculative instrument families, and the model manager's draft pairings
that fall back to n-gram speculation.

Both engines run TINY_TEST on the same f32 weights over an f32 pool of
16-row pages, without the prefix index (its references would keep pages in
use on one side only).
"""

import importlib
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aios_tpu.engine import gguf as jg
from aios_tpu.engine import model as jm
from aios_tpu.engine.batching import ContinuousBatcher as JaxBatcher
from aios_tpu.engine.batching import Request as JaxRequest
from aios_tpu.engine.config import TINY_TEST as JAX_TINY
from aios_tpu.engine.engine import TPUEngine
from aios_tpu.engine.paged import PoolExhausted as JaxPoolExhausted
from aios_tpu.obs import instruments as jax_obs
from aios_tpu.runtime.model_manager import ModelManager as JaxModelManager
from aios_tpu_torch.engine import engine as engine_mod
from aios_tpu_torch.engine import spec
from aios_tpu_torch.engine.batching import ContinuousBatcher, Request
from aios_tpu_torch.engine.config import TINY_TEST
from aios_tpu_torch.engine.engine import TorchEngine
from aios_tpu_torch.engine.paged import PoolExhausted
from aios_tpu_torch.engine.weights import params_from_jax
from aios_tpu_torch.obs import instruments as obs
from aios_tpu_torch.obs import metrics
from aios_tpu_torch.ops import split
from aios_tpu_torch.runtime import model_manager as tmm

# the module, not the wrapper of the same name that ops/__init__ exports
qmm = importlib.import_module("aios_tpu_torch.ops.quantized_matmul")

torch.set_num_threads(1)

CTX = 128
PAGE = 16
WINDOW = 32
REPEATING = [256] + [(i % 6) * 11 + 3 for i in range(30)]  # period 6: drafts accepted
LONG = [256] + [(i * 37) % 256 for i in range(40)]


@pytest.fixture(scope="module")
def jax_params():
    return jm.init_params(JAX_TINY, jax.random.PRNGKey(1), dtype=jnp.float32)


@pytest.fixture(scope="module")
def torch_params(jax_params):
    return params_from_jax(jax.tree.map(np.asarray, jax_params))


def _pair(jax_params, torch_params, window=None, pages=24, num_slots=4):
    kw = dict(num_slots=num_slots, max_context=CTX, paged_pool_rows=pages * PAGE,
              page_size=PAGE, prefix_cache=False)
    je = TPUEngine(JAX_TINY.scaled(sliding_window=window), jax_params,
                   cache_dtype=jnp.float32, **kw)
    te = TorchEngine(TINY_TEST.scaled(sliding_window=window), torch_params,
                     cache_dtype=torch.float32, device="cpu", **kw)
    assert te.paged
    return je, te


def _same_pool_state(je, te):
    np.testing.assert_array_equal(te.allocator.tables, je.allocator.tables)
    np.testing.assert_array_equal(te.allocator._rc, je.allocator._rc[0])
    np.testing.assert_array_equal(te.allocator._trimmed, je.allocator._trimmed)
    np.testing.assert_array_equal(te.allocator._blocks_used, je.allocator._blocks_used)
    assert te.allocator.free_pages == je.allocator.free_pages


@pytest.mark.parametrize("window", [None, WINDOW], ids=["tiny-test", "windowed"])
def test_paged_spec_step_matches_jax(jax_params, torch_params, window):
    """Two greedy slots (one repeating, whose drafts are accepted), one
    sampling slot and one idle slot, from the same admissions and three
    plain steps: four calls of two rounds each give the same tokens and
    counts, history, host lengths and pool state; the windowed model trims
    the same blocks before each dispatch."""
    je, te = _pair(jax_params, torch_params, window)
    try:
        for e in (je, te):
            e.prefill(0, REPEATING, temperature=0.0)
            e.prefill(1, LONG, temperature=0.0)
            e.prefill(3, [5, 6, 5, 6, 5, 6], temperature=0.9, top_p=0.9)
            e.step(3)
        _same_pool_state(je, te)
        for _ in range(4):
            jt, jc = je.spec_step(2, draft_len=5, ngram=2)
            tt, tc = te.spec_step(2, draft_len=5, ngram=2)
            assert tt.shape == (2, 4, 6) and tc.shape == (2, 4)
            np.testing.assert_array_equal(tc[:, :2], jc[:, :2])
            for r in range(2):
                for s in range(2):
                    np.testing.assert_array_equal(tt[r, s, :tc[r, s]], jt[r, s, :tc[r, s]])
            assert (tc[:, 3] == 1).all()  # the sampling slot: one token a round
            np.testing.assert_array_equal(te._host_lengths[:2], je._host_lengths[:2])
            np.testing.assert_array_equal(te.lengths.numpy(), te._host_lengths)
            hist = np.asarray(je.state["history"])
            for s in range(2):
                n = te.slot_length(s) + 1
                np.testing.assert_array_equal(te.history[s, :n].numpy(), hist[s, :n])
            _same_pool_state(je, te)
        assert te.stats()["spec_ngram_rounds"] == 8 == je.stats()["spec_ngram_rounds"]
        assert te.stats()["spec_ngram_accepted"] == je.stats()["spec_ngram_accepted"]
        if window is None:
            assert te.stats()["spec_ngram_accepted"] > 0  # the repeating slot's drafts
        else:
            assert te.kv_pages_trimmed == te.allocator._trimmed.sum() > 0
        for s in (0, 1, 3):
            je.release(s)
            te.release(s)
        _same_pool_state(je, te)
        assert te.allocator.pages_in_use() == 0
    finally:
        je.close()
        te.close()


def test_drafted_rows_are_backed_before_the_dispatch(jax_params, torch_params):
    """Six pages for two 40-row slots (three pages each): two rounds of
    draft_len 5 need 12 more rows a slot, a fourth page, so both engines
    raise PoolExhausted before touching any state; with one slot released
    the other's rounds are backed and match."""
    je, te = _pair(jax_params, torch_params, pages=6, num_slots=2)
    try:
        for e in (je, te):
            e.prefill(0, LONG[:40], temperature=0.0)
            e.prefill(1, REPEATING + REPEATING[1:10], temperature=0.0)
        before = (te.lengths.clone(), te.last_tokens.clone(), te.history.clone(),
                  te.allocator.tables.copy(), te.allocator.free_pages)
        with pytest.raises(JaxPoolExhausted):
            je.spec_step(2, draft_len=5, ngram=2)
        with pytest.raises(PoolExhausted):
            te.spec_step(2, draft_len=5, ngram=2)
        assert torch.equal(te.lengths, before[0]) and torch.equal(te.last_tokens, before[1])
        assert torch.equal(te.history, before[2])
        np.testing.assert_array_equal(te.allocator.tables, before[3])
        assert te.allocator.free_pages == before[4] == 0 and te.spec_rounds == 0
        _same_pool_state(je, te)
        for e in (je, te):
            e.release(0)
        jt, jc = je.spec_step(2, draft_len=5, ngram=2)
        tt, tc = te.spec_step(2, draft_len=5, ngram=2)
        np.testing.assert_array_equal(tc[:, 1], jc[:, 1])
        for r in range(2):
            np.testing.assert_array_equal(tt[r, 1, :tc[r, 1]], jt[r, 1, :tc[r, 1]])
        _same_pool_state(je, te)
        assert te.allocator._blocks_used[1] == 4  # 40 + 12 rows backed
    finally:
        je.close()
        te.close()


BATCH_PROMPTS = [[1, 2, 3], [7, 8, 9, 7, 8, 9, 7, 8], [11, 12], REPEATING]


def test_paged_speculative_batcher_matches_jax_and_plain(jax_params, torch_params, caplog):
    """A paged speculative batcher dispatches rounds, warns of nothing, and
    streams what the JAX paged speculative batcher and the port's plain
    batcher stream."""
    je, te = _pair(jax_params, torch_params, num_slots=3)
    try:
        jb = JaxBatcher(je, speculative=True)
        try:
            hs = [jb.submit(JaxRequest(prompt_ids=p, max_tokens=40, temperature=0.0))
                  for p in BATCH_PROMPTS]
            want = [h.tokens() for h in hs]
        finally:
            jb.shutdown()
        outs = {}
        for speculative in (False, True):
            with caplog.at_level(logging.WARNING):
                b = ContinuousBatcher(te, speculative=speculative)
            try:
                assert b.speculative is speculative and b.spec_proposers == ("ngram",)
                hs = [b.submit(Request(prompt_ids=p, max_tokens=40, temperature=0.0))
                      for p in BATCH_PROMPTS]
                outs[speculative] = [h.tokens() for h in hs]
                assert b.last_error is None
            finally:
                b.shutdown()
        assert "speculative decoding disabled" not in caplog.text
        assert outs[True] == outs[False] == want and all(len(o) == 40 for o in want)
        stats = te.stats()
        assert stats["spec_rounds"] > 0 and stats["spec_accepted"] > 0
        assert te.allocator.pages_in_use() == 0
    finally:
        je.close()
        te.close()


def test_speculative_ticks_evict_under_pool_pressure(torch_params):
    """A pool of eight 16-row pages for three 40-token requests: a round's
    backing runs out, the batcher retires the longest request and retries;
    every stream ends whole or as an abort, and the scheduler survives."""
    te = TorchEngine(TINY_TEST, torch_params, num_slots=3, max_context=CTX,
                     paged_pool_rows=8 * PAGE, page_size=PAGE, prefix_cache=False,
                     cache_dtype=torch.float32, device="cpu")
    b = ContinuousBatcher(te, speculative=True)
    try:
        hs = [b.submit(Request(prompt_ids=p, max_tokens=40, temperature=0.0))
              for p in (REPEATING, LONG[:30], [9] * 25)]
        outs = [h.tokens() for h in hs]
        assert b.last_error is None and b.pool_evictions > 0
        assert all(len(o) == 40 or h.aborted for o, h in zip(outs, hs))
        assert any(len(o) == 40 for o in outs) and te.spec_rounds > 0
    finally:
        b.shutdown()
        te.close()


def test_the_workspace_takes_every_launch_of_the_draft(torch_params, monkeypatch, sms=132):
    """A paged engine with a draft reserves its stream's workspace for the
    draft's launches too (K8 steps, K6 catch-up up to HISTORY_PAD - 1 and
    ingest up to its widest bucket, at the draft's head dim) beside the
    serving round's verify; a launch one query tile wider than the widest
    ingest would not fit."""
    stream = 0xD4AF7

    class Stream:
        cuda_stream = stream

    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: Stream())
    monkeypatch.setattr(engine_mod, "sm_count", lambda index: sms)
    C, B = 512, 8
    draft_cfg = TINY_TEST.scaled(head_dim=TINY_TEST.head_dim * 2)
    from aios_tpu_torch.engine.weights import init_params
    draft = spec.DraftModel(draft_cfg, init_params(draft_cfg, torch.Generator().manual_seed(3),
                                                   dtype=torch.float32, device="cpu"),
                            quantize=None)
    eng = TorchEngine(TINY_TEST, torch_params, num_slots=B, max_context=C,
                      paged_pool_rows=(B + 1) * C, page_size=PAGE, prefix_cache=False,
                      cache_dtype=torch.float32, device="cpu", draft=draft)
    dev, key = eng.device, (eng.device.index, stream)
    try:
        launches = eng._workspace_launches()
        assert {d for *_, d in launches} == {TINY_TEST.head_dim, draft_cfg.head_dim}
        eng._reserve_workspaces()
        split.hold(dev, stream)
        KH, D = draft_cfg.num_kv_heads, draft_cfg.head_dim
        G = draft_cfg.num_heads // KH
        splits = split.split_plan(C, B, KH, sms)
        split.workspace(dev, stream, *split.launch_groups(B, KH)[:1], splits, D)
        for T in (*range(2, spec.HISTORY_PAD), *engine_mod.DRAFT_INGEST_BUCKETS):
            groups, rows = split.launch_groups(B, KH, T * G)
            split.workspace(dev, stream, groups, splits, D, rows)
        widest = engine_mod.DRAFT_INGEST_BUCKETS[-1] * G
        groups, rows = split.launch_groups(B, KH, widest + split.MQ_BLOCK_ROWS)
        with pytest.raises(RuntimeError, match="held"):
            split.workspace(dev, stream, groups, splits, D, rows)
        floats = split._workspaces[key].floats
        assert eng.workspace_bytes() == 0  # off CUDA
        assert floats == max(g * s * split.partial_floats(d, r) for g, s, r, d in launches)
    finally:
        split._workspaces.pop(key, None)
        qmm._counters.pop(key, None)
        eng.close()


def test_spec_instrument_families_equal_jax_and_sum_over_replicas(torch_params):
    """The speculative families under the JAX names, help and labels; rounds
    and accepted tokens summed over the live engines of a model, one series
    a proposer; the acceptance gauge averaged over the live batchers."""
    for name in ("SPEC_ROUNDS", "SPEC_ACCEPTED", "SPEC_ACCEPTANCE"):
        mine, theirs = getattr(obs, name), getattr(jax_obs, name)
        assert (mine.name, mine.help, mine.labelnames, type(mine).__name__) == (
            theirs.name, theirs.help, theirs.labelnames, type(theirs).__name__)
        assert mine.labelnames == ("model", "proposer")
    cfg = TINY_TEST.scaled(name="tiny-spec-obs")
    engines = [TorchEngine(cfg, torch_params, num_slots=2, max_context=64,
                           cache_dtype=torch.float32, device="cpu") for _ in range(2)]
    batchers = [ContinuousBatcher(e, speculative=True) for e in engines]
    try:
        engines[0].spec_proposer_rounds["ngram"] = 5
        engines[1].spec_proposer_rounds["ngram"] = 7
        engines[1].spec_proposer_accepted["draft"] = 3
        batchers[0].spec_ewma["ngram"], batchers[1].spec_ewma["ngram"] = 0.25, 0.75
        child = {n: {p: getattr(obs, n).labels(model=cfg.name, proposer=p)
                     for p in spec.SPEC_PROPOSERS}
                 for n in ("SPEC_ROUNDS", "SPEC_ACCEPTED", "SPEC_ACCEPTANCE")}
        assert child["SPEC_ROUNDS"]["ngram"].value == 12.0
        assert child["SPEC_ROUNDS"]["draft"].value == 0.0
        assert child["SPEC_ACCEPTED"]["draft"].value == 3.0
        assert child["SPEC_ACCEPTANCE"]["ngram"].value == 0.5
        assert child["SPEC_ACCEPTANCE"]["draft"].value == 0.0
        assert ('aios_tpu_spec_rounds_total{model="tiny-spec-obs",proposer="ngram"} 12'
                in metrics.REGISTRY.render())
    finally:
        for b in batchers:
            b.shutdown()
        for e in engines:
            e.close()


# -- the model manager's draft pairings that fall back -----------------------

E, FF, L2, H, KH, D = 64, 128, 2, 4, 2, 16


def _sp_tokens(rng, n_pieces=300):
    chars = ["▁"] + list("abcdefghijklmnopqrstuvwxyz.,!?{}\"")
    pieces, seen = list(chars), set(chars)
    while len(pieces) < n_pieces:
        a, b = rng.integers(0, len(pieces), 2)
        if len(pieces[a] + pieces[b]) <= 8 and pieces[a] + pieces[b] not in seen:
            seen.add(pieces[a] + pieces[b])
            pieces.append(pieces[a] + pieces[b])
    return {"tokenizer.ggml.model": "llama",
            "tokenizer.ggml.tokens": (["<unk>", "<s>", "</s>"]
                                      + [f"<0x{i:02X}>" for i in range(256)] + pieces),
            "tokenizer.ggml.scores": [0.0] * 259 + [-float(i // 2) for i in range(n_pieces)],
            "tokenizer.ggml.token_type": [2, 3, 3] + [6] * 256 + [1] * n_pieces,
            "tokenizer.ggml.bos_token_id": 1, "tokenizer.ggml.eos_token_id": 2}


def _write_gguf(path, vocab_seed, pieces=300, seed=0):
    """A 2-layer llama GGUF with a SentencePiece vocab from ``vocab_seed``
    (``pieces`` merges past the bytes) and Q8_0 matrices from ``seed``."""
    md = {"general.architecture": "llama", "general.name": path.stem,
          "llama.block_count": L2, "llama.context_length": CTX,
          "llama.embedding_length": E, "llama.feed_forward_length": FF,
          "llama.attention.head_count": H, "llama.attention.head_count_kv": KH,
          "llama.attention.key_length": D, "llama.attention.layer_norm_rms_epsilon": 1e-5,
          "llama.rope.freq_base": 10000.0}
    md.update(_sp_tokens(np.random.default_rng(vocab_seed), pieces))
    rng = np.random.default_rng(seed)
    V = len(md["tokenizer.ggml.tokens"])
    tensors = {}

    def mat(name, rows, cols):
        w = (rng.standard_normal((rows, cols)) * 0.02).astype(np.float32)
        tensors[name] = ((rows, cols), jg.Q8_0, jg.quantize_q8_0(w).tobytes())

    def norm(name, n):
        tensors[name] = ((n,), jg.F32, rng.uniform(0.8, 1.2, n).astype(np.float32).tobytes())

    mat("token_embd.weight", V, E)
    for i in range(L2):
        p = f"blk.{i}."
        norm(p + "attn_norm.weight", E)
        norm(p + "ffn_norm.weight", E)
        mat(p + "attn_q.weight", H * D, E)
        mat(p + "attn_k.weight", KH * D, E)
        mat(p + "attn_v.weight", KH * D, E)
        mat(p + "attn_output.weight", E, H * D)
        mat(p + "ffn_gate.weight", FF, E)
        mat(p + "ffn_up.weight", FF, E)
        mat(p + "ffn_down.weight", E, FF)
    norm("output_norm.weight", E)
    mat("output.weight", V, E)
    jg.write_gguf(path, md, tensors)
    return str(path)


def test_draft_pairing_falls_back_like_jax(tmp_path, caplog):
    """The same sources through both managers' ``_build_draft``: a file of
    the serving vocab and tokenizer pairs; another tokenizer of the same
    size, another vocabulary size, a missing file and an HF directory fall
    back to n-gram with a warning. A preset's other vocabulary is refused
    before its weights are made."""
    serving = _write_gguf(tmp_path / "serving.gguf", vocab_seed=0)
    sources = {
        "same": (_write_gguf(tmp_path / "same.gguf", vocab_seed=0, seed=5), True),
        "other tokenizer": (_write_gguf(tmp_path / "other.gguf", vocab_seed=7), False),
        "other vocab": (_write_gguf(tmp_path / "wide.gguf", vocab_seed=0, pieces=340), False),
        "missing": (str(tmp_path / "absent.gguf"), False),
        "hf directory": (str(tmp_path), False),
    }
    jm_, tm_ = JaxModelManager(num_slots=2), tmm.ModelManager(num_slots=2, device="cpu")
    jcfg, _, jtok = jm_._load_weights("serving", serving, 0)
    tcfg, _, ttok = tm_._load_weights("serving", serving, 0)
    for what, (source, pairs) in sources.items():
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            td = tm_._build_draft(source, tcfg, CTX, ttok)
        jd = jm_._build_draft(source, jcfg, CTX, jtok)
        assert (td is not None) == (jd is not None) == pairs, what
        if pairs:
            assert td.quant_mode == "int4" and td.weight_bytes() == jd.weight_bytes()
        else:
            assert "serving with n-gram speculation" in caplog.text, what
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        assert tm_._build_draft("tinyllama", tcfg, CTX, ttok) is None
    assert "vocab (32000) does not match" in caplog.text
    assert "HF checkpoint directories" in _warning_for(tm_, str(tmp_path), tcfg, ttok, caplog)


def _warning_for(manager, source, cfg, tok, caplog):
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        manager._build_draft(source, cfg, CTX, tok)
    return caplog.text
