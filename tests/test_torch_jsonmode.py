"""The port's grammar automata (``aios_tpu_torch/engine/jsonmode.py`` and
``jsonschema.py``) against the JAX package's on the same inputs: the token
byte tables of the three tokenizers, and at automaton states reached by
random JSON byte walks from a numpy seed, the mask, closing, distance and
budget rows (byte-equal), the singleton tokens and forced runs (equal);
``schema_cache_key`` and the error of every rejected schema (equal class
and message). The vocabs are the byte tokenizer's and a small SentencePiece
and a small byte-level BPE vocab built from the seed."""

import numpy as np
import pytest
import torch

from aios_tpu.engine import jsonmode as jj
from aios_tpu.engine import jsonschema as js
from aios_tpu.engine import tokenizer as jt
from aios_tpu_torch.engine import jsonmode as tj
from aios_tpu_torch.engine import jsonschema as ts
from aios_tpu_torch.engine import tokenizer as tt

# The shapes here are tiny: one intra-op thread is faster and leaves the
# cores to the other test workers.
torch.set_num_threads(1)

JSON_CHARS = '{}[]":,.-+0123456789eE truefalsnxyz_abcdkpwio'


def _sp_metadata(seed: int, n_pieces: int = 400):
    """A SentencePiece vocab: the byte tokens, the characters of JSON text
    and pieces of two earlier ones (``{"``, ``":``, ``true`` ...)."""
    rng = np.random.default_rng(seed)
    chars = ["▁"] + sorted(set(JSON_CHARS) - {" "})
    pieces, seen = list(chars), set(chars)
    while len(pieces) < n_pieces:
        a, b = rng.integers(0, len(pieces), 2)
        piece = pieces[a] + pieces[b]
        if len(piece) <= 6 and piece not in seen:
            seen.add(piece)
            pieces.append(piece)
    tokens = ["<unk>", "<s>", "</s>"] + [f"<0x{i:02X}>" for i in range(256)] + pieces
    return {"tokenizer.ggml.model": "llama", "tokenizer.ggml.tokens": tokens,
            "tokenizer.ggml.scores": [0.0] * 259 + [-float(i) for i in range(len(pieces))],
            "tokenizer.ggml.token_type": [2, 3, 3] + [6] * 256 + [1] * len(pieces),
            "tokenizer.ggml.bos_token_id": 1, "tokenizer.ggml.eos_token_id": 2}


def _bpe_metadata(seed: int, n_merges: int = 300):
    """A byte-level BPE vocab: the 256 byte symbols, merges of JSON
    characters and then of earlier tokens, and control tokens last."""
    rng = np.random.default_rng(seed)
    b2u = jt._bytes_to_unicode()
    tokens = [b2u[b] for b in range(256)]
    common = [b2u[b] for b in JSON_CHARS.encode()]
    seen, merges = set(tokens), []
    while len(merges) < n_merges:
        pool = common if len(merges) < n_merges // 2 else tokens
        left, right = (pool[i] for i in rng.integers(0, len(pool), 2))
        if left + right not in seen and len(left + right) <= 8:
            seen.add(left + right)
            tokens.append(left + right)
            merges.append(f"{left} {right}")
    specials = ["<|im_start|>", "<|im_end|>", "<|endoftext|>"]
    return {"tokenizer.ggml.model": "gpt2", "tokenizer.ggml.pre": "qwen2",
            "tokenizer.ggml.tokens": tokens + specials, "tokenizer.ggml.merges": merges,
            "tokenizer.ggml.token_type": [1] * len(tokens) + [3] * len(specials),
            "tokenizer.ggml.eos_token_id": len(tokens) + 1}


def _vocab(kind: str):
    """(JAX tokenizer, port tokenizer, vocab size) of one vocab kind."""
    if kind == "bytes":
        return jt.ByteTokenizer(), tt.ByteTokenizer(), 258
    md = _sp_metadata(3) if kind == "sentencepiece" else _bpe_metadata(4)
    return jt.gguf_tokenizer(md), tt.gguf_tokenizer(md), len(md["tokenizer.ggml.tokens"])


VOCABS = ["bytes", "sentencepiece", "byte-level"]
TABLES = {}


def _tables(kind: str):
    if kind not in TABLES:
        jtok, ttok, V = _vocab(kind)
        TABLES[kind] = (jj.token_bytes_table(jtok, V), tj.token_bytes_table(ttok, V),
                        jtok.eos_id)
    return TABLES[kind]


TOOL_SCHEMA = {
    "type": "object",
    "properties": {
        "tool": {"type": "string", "enum": ["read_file", "write_file", "list_dir"]},
        "path": {"type": "string", "enum": ["slash_tmp", "slash_etc"]},
        "recursive": {"type": "boolean"},
    },
    "required": ["tool", "path", "recursive"],
}
SCHEMAS = {
    "tool": TOOL_SCHEMA,
    "mixed": {"type": "object", "properties": {"name": {"type": "string"},
                                               "count": {"type": "integer"}},
              "required": ["name", "count"]},
    "nested": {"type": "object", "properties": {
        "level": {"type": "string", "enum": ["low", "high"]},
        "ratio": {"type": "number"}, "ok": {"type": "boolean"}, "none": {"type": "null"},
        "tags": {"type": "array", "items": {"type": "string"}, "minItems": 1},
        "args": {}, "meta": {"type": "object", "properties": {}},
        "inner": {"type": "object", "properties": {"k": {"const": "v"},
                                                   "n": {"type": "integer"}},
                  "required": ["k"]}}, "required": ["level", "inner"]},
    "array-root": {"type": "array", "items": {"type": "integer"}},
}


@pytest.mark.parametrize("kind", VOCABS)
def test_token_bytes_table_matches_jax(kind):
    want, got, _ = _tables(kind)
    assert got == want
    assert sum(t is not None for t in got) >= 256


def test_token_bytes_table_refuses_an_unknown_tokenizer():
    with pytest.raises(TypeError, match="no token byte table"):
        tj.token_bytes_table(object(), 16)


def _caches(kind: str, grammar: str, compact: bool):
    """The JAX and the port's mask cache of one grammar over one vocab."""
    jtab, ttab, eos = _tables(kind)
    if grammar == "json":
        return (jj.JsonMaskCache(jtab, eos, compact=compact),
                tj.JsonMaskCache(ttab, eos, compact=compact))
    schema = SCHEMAS[grammar]
    return (js.SchemaMaskCache(jtab, eos, schema, compact=compact),
            ts.SchemaMaskCache(ttab, eos, schema, compact=compact))


def _walk_states(cache, seed: int, walks: int = 6, steps: int = 60):
    """States along random byte walks from the start state: each step takes
    a byte the grammar admits, drawn from the seed, a closer or quote more
    often so that walks complete values."""
    rng = np.random.default_rng(seed)
    states = []
    for _ in range(walks):
        st = cache.start()
        states.append(st)
        for _ in range(steps):
            allowed = [b for b in range(256) if cache._transition(st, b) is not None]
            if not allowed:
                break
            weights = np.array([4.0 if b in b'}]":,' else 1.0 for b in allowed])
            b = int(rng.choice(allowed, p=weights / weights.sum()))
            st = cache._transition(st, b)
            states.append(st)
    return states


GRAMMARS = ["json"] + sorted(SCHEMAS)


@pytest.mark.parametrize("compact", [True, False], ids=["compact", "lenient"])
@pytest.mark.parametrize("grammar", GRAMMARS)
@pytest.mark.parametrize("kind", VOCABS)
def test_rows_singletons_and_forced_runs_match_jax(kind, grammar, compact):
    jc, tc = _caches(kind, grammar, compact)
    assert tc.start_token_id == jc.start_token_id
    states = _walk_states(tc, seed=len(kind) * 31 + len(grammar) + compact)
    assert len(set(states)) >= 5
    for st in states:
        assert tc._distance(st) == jc._distance(st) and tc._terminal(st) == jc._terminal(st)
        assert tc.mask_row(st).tobytes() == jc.mask_row(st).tobytes()
        assert tc.closing_row(st).tobytes() == jc.closing_row(st).tobytes()
        assert tc.dist_row(st).tobytes() == jc.dist_row(st).tobytes()
        assert tc.singleton_token(st) == jc.singleton_token(st)
        for remaining in (None, 1, 3, 12):
            assert (tc.effective_row(st, remaining).tobytes()
                    == jc.effective_row(st, remaining).tobytes())
        jcon, tcon = jj.JsonConstraint(jc), tj.JsonConstraint(tc)
        jcon.state = tcon.state = st
        for max_len, remaining in ((16, None), (4, None), (16, 8)):
            assert (tcon.forced_run(max_len, remaining=remaining, stop_ids=(1,))
                    == jcon.forced_run(max_len, remaining=remaining, stop_ids=(1,)))


@pytest.mark.parametrize("grammar", GRAMMARS)
def test_constraint_cursor_follows_jax_over_a_token_stream(grammar):
    """Tokens drawn from each step's mask advance both cursors alike, to a
    terminal state where the stream ends on EOS."""
    jc, tc = _caches("sentencepiece", grammar, True)
    jcon, tcon = jj.JsonConstraint(jc), tj.JsonConstraint(tc)
    rng = np.random.default_rng(len(grammar))
    for step in range(200):
        row = tcon.mask_row(remaining=200 - step)
        assert row.tobytes() == jcon.mask_row(remaining=200 - step).tobytes()
        tok = int(rng.choice(np.flatnonzero(row == 0.0)))
        tcon.advance(tok)
        jcon.advance(tok)
        assert tcon.state == jcon.state and tcon.failed == jcon.failed
        if tok == tc.eos_id:
            break
    assert tcon.satisfied and jcon.satisfied


def test_device_rows_cache_only_persistent_rows():
    """``device_row`` keeps a tensor on the cache's device for a per-state
    row, at most 512 of them, and none for a one-shot budget row."""
    jtab = _tables("bytes")[1]
    cache = tj.JsonMaskCache(jtab, 257, compact=True, device="cpu")
    con = tj.JsonConstraint(cache)
    row = con.device_mask()
    assert row.dtype == torch.float32 and row.device.type == "cpu"
    assert con.device_mask() is row and len(cache._dev) == 1
    assert torch.equal(row, torch.from_numpy(cache.mask_row(con.state)))
    con.advance(ord("{"))
    con.device_mask(remaining=2)  # a budget-gated row: not cached
    assert len(cache._dev) == 1
    assert torch.equal(cache.zeros_row(), torch.zeros(258))


KEY_SCHEMAS = [TOOL_SCHEMA, {"required": [], "type": "object", "properties": {"a": {}}},
               {"type": "array", "items": {"enum": ["x"], "type": "string"}}]


@pytest.mark.parametrize("schema", KEY_SCHEMAS)
def test_schema_cache_key_matches_jax(schema):
    assert ts.schema_cache_key(schema) == js.schema_cache_key(schema)


REJECTED = {
    "not-a-node": {"type": "object", "properties": {"a": 3}},
    "bad-type": {"type": "tuple"},
    "bad-properties": {"type": "object", "properties": ["a"]},
    "bad-required": {"type": "object", "properties": {"a": {}}, "required": "a"},
    "unknown-required": {"type": "object", "properties": {"a": {}}, "required": ["b"]},
    "escaped-enum": {"type": "string", "enum": ['say "hi"']},
    "empty-enum": {"type": "string", "enum": []},
    "non-string-enum": {"type": "string", "enum": [1]},
    "min-items": {"type": "array", "minItems": 2},
    "escaped-key": {"type": "object", "properties": {"a\\b": {}}},
    "const-number": {"const": 3},
    "malformed": {"type": "object", "properties": {"a": {"type": "array", "items": []}}},
}


@pytest.mark.parametrize("case", sorted(REJECTED))
def test_rejected_schemas_raise_as_jax(case):
    with pytest.raises(Exception) as want:
        js.compile_schema(REJECTED[case])
    with pytest.raises(Exception) as got:
        ts.compile_schema(REJECTED[case])
    assert type(got.value) is type(want.value) is ValueError
    assert str(got.value) == str(want.value)
