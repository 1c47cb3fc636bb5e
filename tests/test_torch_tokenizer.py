"""The port's GGUF tokenizers (``aios_tpu_torch/engine/tokenizer.py``)
against the JAX package's on the same vocabs and texts: the same ids, the
same text back, and no ``regex`` package needed."""

import os
import re
import subprocess
import sys
import unicodedata

import numpy as np
import pytest
import regex
from hypothesis import given, settings
from hypothesis import strategies as st

from aios_tpu.engine import tokenizer as jt
from aios_tpu_torch.engine import tokenizer as tt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALPHABET = "abcdefgh xyz.,'!"


def _sp_metadata(seed: int = 0, n_pieces: int = 600):
    """A SentencePiece vocab of single characters and pieces joined from two
    earlier ones, with scores in tied groups of 3 (the leftmost rule
    decides), the byte tokens and the control tokens."""
    rng = np.random.default_rng(seed)
    chars = ["▁"] + sorted(set(ALPHABET) - {" "})
    pieces, seen = list(chars), set(chars)
    while len(pieces) < n_pieces:
        a, b = rng.integers(0, len(pieces), 2)
        piece = pieces[a] + pieces[b]
        if len(piece) <= 8 and piece not in seen:
            seen.add(piece)
            pieces.append(piece)
    tokens = ["<unk>", "<s>", "</s>"] + [f"<0x{i:02X}>" for i in range(256)] + pieces
    scores = [0.0] * 259 + [-float(i // 3) for i in range(len(pieces))]
    types = [2, 3, 3] + [6] * 256 + [1] * len(pieces)
    return {"tokenizer.ggml.model": "llama", "tokenizer.ggml.tokens": tokens,
            "tokenizer.ggml.scores": scores, "tokenizer.ggml.token_type": types,
            "tokenizer.ggml.bos_token_id": 1, "tokenizer.ggml.eos_token_id": 2}


SP_MD = _sp_metadata()
SP_JAX, SP_PORT = jt.gguf_tokenizer(SP_MD), tt.gguf_tokenizer(SP_MD)


@settings(max_examples=150, deadline=None)
@given(st.text(alphabet=ALPHABET + "Zé中\n\t", max_size=80), st.booleans())
def test_sentencepiece_ids_match_jax(text, add_bos):
    assert isinstance(SP_PORT, tt.SentencePieceBPE)
    ids = SP_PORT.encode(text, add_bos=add_bos)
    assert ids == SP_JAX.encode(text, add_bos=add_bos)
    assert SP_PORT.decode(ids) == SP_JAX.decode(ids)


def test_sentencepiece_2000_characters_match_jax():
    rng = np.random.default_rng(1)
    text = "".join(rng.choice(list(ALPHABET + "Z"), 2000))
    ids = SP_PORT.encode(text)
    assert ids == SP_JAX.encode(text)
    assert len(ids) > 400  # merges happened, and many of them


def _spec_fixture_sp(module):
    import test_gguf_spec_fixture as spec

    return module.SentencePieceBPE.from_gguf_metadata({
        "tokenizer.ggml.tokens": spec.VOCAB, "tokenizer.ggml.scores": spec.SCORES,
        "tokenizer.ggml.token_type": spec.TYPES, "tokenizer.ggml.bos_token_id": 1,
        "tokenizer.ggml.eos_token_id": 2})


@pytest.mark.parametrize("module", [jt, tt], ids=["jax", "port"])
def test_sp_bpe_merges_by_score_not_left_to_right(module):
    """The spec fixture's case (tests/test_gguf_spec_fixture.py): 'abc' with
    {ab: -5, bc: -1} merges b+c first."""
    tok = _spec_fixture_sp(module)
    assert [tok.tokens[i] for i in tok.encode("abc", add_bos=False)] == ["▁", "a", "bc"]


@pytest.mark.parametrize("module", [jt, tt], ids=["jax", "port"])
def test_sp_bpe_byte_fallback_on_unknown_chars(module):
    tok = _spec_fixture_sp(module)
    ids = tok.encode("aZ", add_bos=False)
    pieces = [tok.tokens[i] for i in ids]
    assert "a" in pieces and "<0x5A>" in pieces
    assert tok.decode(ids) == "aZ"


def test_sp_ties_go_to_the_leftmost_pair():
    """'abab' with ab and ba tied: the JAX scan merges the leftmost best pair
    first (a+b at 0), then the second a+b, never the middle b+a."""
    md = {"tokenizer.ggml.tokens": ["<unk>", "<s>", "</s>", "▁", "a", "b", "ab", "ba"],
          "tokenizer.ggml.scores": [0.0, 0.0, 0.0, -9.0, -9.0, -9.0, -1.0, -1.0],
          "tokenizer.ggml.token_type": [2, 3, 3, 1, 1, 1, 1, 1]}
    for module in (jt, tt):
        tok = module.SentencePieceBPE.from_gguf_metadata(md)
        ids = tok.encode("abab", add_bos=False)
        assert [tok.tokens[i] for i in ids] == ["▁", "ab", "ab"]


# -- byte-level BPE --------------------------------------------------------------------

SPECIALS = ["<|im_start|>", "<|im_end|>", "<|endoftext|>"]


def _bpe_metadata(pre: str, seed: int = 0, n_merges: int = 400, **extra):
    """Byte-level merges: first pairs of common letters, the space symbol
    and digits, then pairs of earlier tokens; control tokens last."""
    rng = np.random.default_rng(seed)
    b2u = jt._bytes_to_unicode()
    tokens = [b2u[b] for b in range(256)]
    common = [b2u[b] for b in b"etaoinshrdl 0123'"]
    seen, merges = set(tokens), []
    while len(merges) < n_merges:
        pool = common if len(merges) < n_merges // 2 else tokens
        left, right = (pool[i] for i in rng.integers(0, len(pool), 2))
        if left + right not in seen:
            seen.add(left + right)
            tokens.append(left + right)
            merges.append(f"{left} {right}")
    md = {"tokenizer.ggml.model": "gpt2", "tokenizer.ggml.pre": pre,
          "tokenizer.ggml.tokens": tokens + SPECIALS, "tokenizer.ggml.merges": merges,
          "tokenizer.ggml.token_type": [1] * len(tokens) + [3] * len(SPECIALS),
          "tokenizer.ggml.eos_token_id": len(tokens) + 1}
    md.update(extra)
    return md


PRES = ["gpt2", "qwen2", "llama-bpe", "deepseek-r1-qwen", "unknown-pre"]
BPE = {pre: (jt.gguf_tokenizer(_bpe_metadata(pre)), tt.gguf_tokenizer(_bpe_metadata(pre)))
       for pre in PRES}
# every class the pretokenizers split on: letters of several scripts,
# digits and other numbers, contractions in either case, punctuation, and
# whitespace that Unicode's White_Space and str.isspace disagree on
TEXT_ALPHABET = ("aeiouhtnrsdlEST0123456789\u00b2\u00bd\u0663'\u2019 .,!?-_\t\n\r\x0b\x0c"
                 "\x1c\x1d\x1e\x1f\x85\xa0\u1680\u2007\u202f\u3000\u00e9\u00df\u0130\u0131"
                 "\u017f\u212a\u4e2d\u6587\U0001f642\u216b\u03a9")
SAMPLES = [
    "hello world", "don't STOP can'T it's WE'LL", "numbers 1234567 and 3.14",
    "  leading and   multiple spaces\t\n\n", "line\r\nbreaks\r\n\r\n", "tail space ",
    "<|im_start|>user\nhi there<|im_end|>\n<|im_start|>assistant\n",
    "unicode h\u00e9llo w\u00f6rld \u2014 em-dash \u2026 ellipsis \U0001f642 \u4f60\u597d",
    "x\x1cy\x1d z\x85\xa0w\u3000v",
    "", " ", "\n\n\n",
]


@pytest.mark.parametrize("pre", PRES)
@pytest.mark.parametrize("text", SAMPLES)
def test_byte_level_ids_match_jax(pre, text):
    jax_tok, port = BPE[pre]
    assert isinstance(port, tt.ByteLevelBPE)
    ids = port.encode(text)
    assert ids == jax_tok.encode(text)
    assert port.decode(ids) == jax_tok.decode(ids)


@pytest.mark.parametrize("pre", ["gpt2", "qwen2", "llama-bpe"])
@settings(max_examples=120, deadline=None)
@given(pieces=st.lists(st.one_of(st.text(alphabet=TEXT_ALPHABET, max_size=12),
                                 st.sampled_from(SPECIALS)), max_size=8))
def test_byte_level_ids_match_jax_on_random_text(pre, pieces):
    jax_tok, port = BPE[pre]
    text = "".join(pieces)
    ids = port.encode(text)
    assert ids == jax_tok.encode(text)
    assert port.decode(ids) == jax_tok.decode(ids)
    if not any(s in text for s in SPECIALS):  # control tokens vanish on decode
        assert port.decode(ids) == text


def test_byte_level_bos_rules_match_jax():
    """No BOS without a declared id; a declared id only with
    add_bos_token (the JAX rules of tests/test_tokenizer_bpe.py)."""
    for module in (jt, tt):
        tok = module.gguf_tokenizer(_bpe_metadata("gpt2"))
        assert tok.bos_id is None
        assert tok.encode("hello", add_bos=True) == tok.encode("hello", add_bos=False)
    md = {"tokenizer.ggml.model": "gpt2", "tokenizer.ggml.tokens": ["a", "b", "<|endoftext|>"],
          "tokenizer.ggml.merges": [], "tokenizer.ggml.token_type": [1, 1, 3],
          "tokenizer.ggml.bos_token_id": 2, "tokenizer.ggml.eos_token_id": 2}
    for module in (jt, tt):
        assert module.gguf_tokenizer(md).encode("a", add_bos=True) == [0]
        flagged = module.gguf_tokenizer({**md, "tokenizer.ggml.add_bos_token": True})
        assert flagged.encode("a", add_bos=True) == [2, 0]
        assert flagged.encode("a", add_bos=False) == [0]


@pytest.mark.parametrize("md", [SP_MD, _bpe_metadata("qwen2")], ids=["spm", "bpe"])
def test_decode_matches_jax_on_random_ids(md):
    """Any ids, out of range, control and byte tokens included."""
    jax_tok, port = jt.gguf_tokenizer(md), tt.gguf_tokenizer(md)
    rng = np.random.default_rng(2)
    n = len(md["tokenizer.ggml.tokens"])
    for _ in range(50):
        ids = rng.integers(-2, n + 3, int(rng.integers(0, 40))).tolist()
        assert port.decode(ids) == jax_tok.decode(ids)


def test_gguf_tokenizer_dispatch_matches_jax():
    for md in (SP_MD, {k: v for k, v in SP_MD.items() if k != "tokenizer.ggml.model"},
               _bpe_metadata("qwen2")):
        assert type(tt.gguf_tokenizer(md)).__name__ == type(jt.gguf_tokenizer(md)).__name__


def test_unicode_classes_match_regex_on_assigned_code_points():
    """The classes built from the checked-in table against the regex
    package's \\p{L}, \\p{N} and \\s over every code point assigned in the
    standard library's Unicode version; and the pretokenizers split a string
    of all of them alike."""
    assigned = "".join(chr(c) for c in range(0x110000)
                       if unicodedata.category(chr(c)) != "Cn"
                       and not 0xD800 <= c <= 0xDFFF)
    tt._compile_pre("")  # builds the classes
    for name, pattern in (("L", r"\p{L}"), ("N", r"\p{N}"), ("s", r"\s")):
        got = re.findall(f"[{tt._CLASSES[name]}]", assigned)
        assert got == regex.findall(pattern, assigned), name
    sample = assigned[::97] + " 'S 'll\r\n 12345 "
    for family, pattern in tt._PRE_PATTERNS.items():
        assert tt._compile_pre(pattern).findall(sample) == regex.findall(pattern, sample)


# every code point but the surrogates, which no text the tokenizer is given holds
ALL_CODE_POINTS = "".join(chr(c) for c in range(0x110000) if not 0xD800 <= c <= 0xDFFF)


@pytest.mark.parametrize("name,pattern", [("L", r"\p{L}"), ("N", r"\p{N}"), ("s", r"\s")])
def test_unicode_classes_match_regex_on_every_code_point(name, pattern):
    """The pretokenizer's classes match what the installed regex package
    matches on every code point, the ones assigned after the standard
    library's Unicode version included, and the table was taken from that
    regex version."""
    from aios_tpu_torch.engine import unicode_classes

    assert unicode_classes.REGEX_VERSION == regex.__version__
    tt._compile_pre("")  # builds the classes
    got = re.findall(f"[{tt._CLASSES[name]}]", ALL_CODE_POINTS)
    assert got == regex.findall(pattern, ALL_CODE_POINTS)


LATE_CODE_POINTS = "ab\u088fcd 12"  # U+088F: a letter assigned after Unicode 15.0


@pytest.mark.parametrize("pre", PRES)
def test_code_points_assigned_after_unicode_15_split_and_encode_as_jax(pre):
    """U+088F is a letter to regex and unassigned to Python 3.12's
    unicodedata: the port's pretokenizer splits the text where the JAX one
    does, and the ids are the JAX ids."""
    jax_tok, port = BPE[pre]
    assert port._pat.findall(LATE_CODE_POINTS) == jax_tok._pat.findall(LATE_CODE_POINTS)
    assert any("\u088f" in w and "ab" in w for w in port._pat.findall(LATE_CODE_POINTS))
    ids = port.encode(LATE_CODE_POINTS)
    assert ids == jax_tok.encode(LATE_CODE_POINTS)
    assert port.decode(ids) == LATE_CODE_POINTS


def test_tokenizer_needs_no_regex_package():
    """A fresh interpreter where ``import regex`` fails encodes with both
    tokenizers."""
    code = (
        "import sys\n"
        "sys.modules['regex'] = None\n"
        "from aios_tpu_torch.engine import tokenizer as t\n"
        "b2u = t._bytes_to_unicode()\n"
        "tokens = [b2u[b] for b in range(256)] + ['hi', '<|im_end|>']\n"
        "tok = t.gguf_tokenizer({'tokenizer.ggml.model': 'gpt2', 'tokenizer.ggml.pre': 'qwen2',\n"
        "    'tokenizer.ggml.tokens': tokens, 'tokenizer.ggml.merges': ['h i'],\n"
        "    'tokenizer.ggml.token_type': [1] * 257 + [3]})\n"
        "ids = tok.encode('hi there 42<|im_end|>')\n"
        "assert ids[0] == 256 and ids[-1] == 257, ids\n"
        "assert tok.decode(ids) == 'hi there 42'\n"
        "sp = t.gguf_tokenizer({'tokenizer.ggml.tokens': ['<unk>', '<s>', '</s>', '\\u2581',\n"
        "    'h', 'i', '\\u2581h', '\\u2581hi'],\n"
        "    'tokenizer.ggml.scores': [0, 0, 0, -3.0, -3.0, -3.0, -1.0, -0.5]})\n"
        "assert sp.encode('hi') == [1, 7], sp.encode('hi')\n"
        "assert 'regex' not in sys.modules or sys.modules['regex'] is None\n"
        "print('ok')\n"
    )
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
