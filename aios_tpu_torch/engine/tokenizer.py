"""Tokenizers and chat templating: the GGUF-embedded SentencePiece-BPE and
byte-level BPE, the byte tokenizer of synthetic models, and ``render_chat``.

A copy of ``aios_tpu/engine/tokenizer.py``'s token-type constants,
``SentencePieceBPE``, ``ByteLevelBPE``, ``gguf_tokenizer``, ``ByteTokenizer``
and ``render_chat``, giving the same ids for the same text, by two other
routes:

* ``SentencePieceBPE.encode`` merges through a heap of adjacent pairs over a
  linked list of symbols (llama.cpp's SPM tokenizer), O(n log n) in the
  text's length, where the JAX class rescans every pair after each merge;
* ``ByteLevelBPE`` pretokenizes with the standard library's ``re``: the
  ``\\p{L}``, ``\\p{N}`` and ``\\s`` of the JAX patterns are spelled out as
  the code point ranges the ``regex`` package matches
  (``unicode_classes.py``, taken from ``regex`` by
  ``tools/unicode_classes.py``; ``re``'s own ``\\s`` also takes
  U+001C-U+001F), so the port needs no ``regex``.

``HFTokenizer`` reads an HF directory's ``tokenizer.json`` (with
``tokenizer_config.json`` and ``special_tokens_map.json`` for BOS, EOS and
the decode cleanup) without ``transformers`` or ``tokenizers``, and gives
the ids the JAX ``HFTokenizer`` gets from ``AutoTokenizer`` with
``add_special_tokens=False``: the added tokens split out of the text first,
then the normalizers, the pre-tokenizers and the BPE model of the file, as
the ``tokenizers`` library runs them. A Llama/Mistral ``tokenizer.json`` is
a BPE of ranked merges with byte fallback behind a ``▁`` normalizer or a
``Metaspace`` pre-tokenizer, not a SentencePiece score table; a Qwen or
Llama-3 one a byte-level BPE behind a regex ``Split``. Both run through one
merge loop: a heap of adjacent pairs keyed on (merge rank, the left
symbol's position), the ``tokenizers`` library's ``Word::merge_all``.
``tokenizer_to_dict`` / ``tokenizer_from_dict`` carry a tokenizer into a
prepared checkpoint, as the JAX functions do.
"""

from __future__ import annotations

import heapq
import json
import re
import unicodedata
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from . import unicode_classes

# token_type values in GGUF (llama.cpp llama_token_type)
TOKEN_TYPE_NORMAL = 1
TOKEN_TYPE_UNKNOWN = 2
TOKEN_TYPE_CONTROL = 3
TOKEN_TYPE_USER_DEFINED = 4
TOKEN_TYPE_BYTE = 6

SPIECE_SPACE = "▁"  # ▁


class BaseTokenizer:
    bos_id: Optional[int] = None
    eos_id: Optional[int] = None

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        raise NotImplementedError

    def decode(self, ids: Sequence[int]) -> str:
        raise NotImplementedError

    @property
    def vocab_size(self) -> int:
        raise NotImplementedError


@dataclass
class SentencePieceBPE(BaseTokenizer):
    """SentencePiece-style BPE over a GGUF vocab (llama/mistral models)."""

    tokens: List[str]
    scores: List[float]
    token_types: List[int]
    bos_id: Optional[int] = 1
    eos_id: Optional[int] = 2
    add_prefix_space: bool = True
    _index: Dict[str, int] = field(default_factory=dict, repr=False)
    _byte_ids: Dict[int, int] = field(default_factory=dict, repr=False)

    def __post_init__(self):
        self._index = {t: i for i, t in enumerate(self.tokens)}
        for i, (tok, typ) in enumerate(zip(self.tokens, self.token_types)):
            if typ == TOKEN_TYPE_BYTE and tok.startswith("<0x") and tok.endswith(">"):
                self._byte_ids[int(tok[3:-1], 16)] = i

    @classmethod
    def from_gguf_metadata(cls, md: dict) -> "SentencePieceBPE":
        tokens = md["tokenizer.ggml.tokens"]
        n = len(tokens)
        return cls(
            tokens=tokens,
            scores=list(md.get("tokenizer.ggml.scores", [0.0] * n)),
            token_types=list(md.get("tokenizer.ggml.token_type", [1] * n)),
            bos_id=int(md.get("tokenizer.ggml.bos_token_id", 1)),
            eos_id=int(md.get("tokenizer.ggml.eos_token_id", 2)),
        )

    @property
    def vocab_size(self) -> int:
        return len(self.tokens)

    def _piece_score(self, s: str) -> Optional[float]:
        i = self._index.get(s)
        if i is None:
            return None
        return self.scores[i] if i < len(self.scores) else 0.0

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        """The JAX ids: repeatedly merge the adjacent pair whose concatenation
        is the best-scoring piece, then byte-fall-back what is left unknown.

        The JAX loop scans the current symbols left to right and keeps a pair
        only on a strictly higher score, so it merges the leftmost of the
        best-scoring pairs. Here the symbols are a doubly linked list in text
        order, and a heap holds every adjacent pair that forms a piece, keyed
        by (-score, the left symbol's start offset in the text). A symbol's
        start offset never changes (a merge keeps the left symbol's) and the
        list keeps text order, so among equal scores the smallest offset is
        the leftmost pair of the current list: the pair the JAX scan picks.
        An entry whose symbols have since merged (a side gone, or a side
        grown) is dropped when popped; each merge pushes the two new pairs it
        forms."""
        if self.add_prefix_space and not text.startswith(" "):
            text = " " + text
        text = text.replace(" ", SPIECE_SPACE)

        # one symbol per character: its text, start offset and neighbours
        syms = list(text)
        n = len(syms)
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n)) + [-1]
        heap: List[tuple] = []

        def push(left: int) -> None:
            right = nxt[left]
            if right < 0:
                return
            merged = syms[left] + syms[right]
            score = self._piece_score(merged)
            if score is not None:
                heapq.heappush(heap, (-score, left, right, len(merged)))

        for i in range(n - 1):
            push(i)
        while heap:
            _, left, right, size = heapq.heappop(heap)
            if (syms[left] is None or syms[right] is None or nxt[left] != right
                    or len(syms[left]) + len(syms[right]) != size):
                continue  # stale: a side has merged since the push
            syms[left] += syms[right]
            syms[right] = None
            nxt[left] = nxt[right]
            if nxt[left] >= 0:
                prev[nxt[left]] = left
            if prev[left] >= 0:
                push(prev[left])
            push(left)

        ids: List[int] = []
        if add_bos and self.bos_id is not None:
            ids.append(self.bos_id)
        for sym in syms:
            if sym is None:
                continue
            idx = self._index.get(sym)
            if idx is not None:
                ids.append(idx)
                continue
            for b in sym.encode("utf-8"):  # byte fallback
                bid = self._byte_ids.get(b)
                if bid is not None:
                    ids.append(bid)
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        out: List[str] = []
        byte_run: List[int] = []

        def flush_bytes():
            if byte_run:
                out.append(bytes(byte_run).decode("utf-8", errors="replace"))
                byte_run.clear()

        for i in ids:
            if not 0 <= i < len(self.tokens):
                continue
            typ = self.token_types[i] if i < len(self.token_types) else 1
            if typ == TOKEN_TYPE_BYTE:
                tok = self.tokens[i]
                byte_run.append(int(tok[3:-1], 16))
                continue
            flush_bytes()
            if typ == TOKEN_TYPE_CONTROL:
                continue
            out.append(self.tokens[i])
        flush_bytes()
        return "".join(out).replace(SPIECE_SPACE, " ").lstrip(" ")


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte<->printable-unicode table (every byte gets a visible
    char so BPE merges operate on strings)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


# pretokenizer split patterns by GGUF `tokenizer.ggml.pre` family, as the JAX
# package writes them for the regex package; _compile_pre translates them
_PRE_PATTERNS = {
    "gpt2": r"""'(?:[sdmt]|ll|ve|re)| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""",
    "qwen2": r"""(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+""",
    "llama3": r"""(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+""",
}

# the `pre` strings convert_hf_to_gguf actually writes -> pattern family
# (nearest approximation where llama.cpp has a bespoke regex)
_PRE_ALIASES = {
    "llama-bpe": "llama3",  # Llama-3 vocabs (incl. DeepSeek-R1-Distill)
    "llama3": "llama3",
    "qwen2": "qwen2",
    "deepseek-r1-qwen": "qwen2",  # qwen2-derived split (digits singly)
    "deepseek-llm": "gpt2",
    "gpt-2": "gpt2",
}

_CLASSES: Dict[str, str] = {}


def _class_body(ranges: Tuple[Tuple[int, int], ...]) -> str:
    """A character-class body (no brackets) of inclusive code point runs."""
    out = []
    for a, b in ranges:
        a_, b_ = re.escape(chr(a)), re.escape(chr(b))
        out.append(a_ if a == b else f"{a_}-{b_}")
    return "".join(out)


def _compile_pre(pattern: str) -> "re.Pattern":
    """``pattern`` (regex-package syntax) for ``re``: \\p{L}, \\p{N} and \\s
    become explicit classes, inside a bracket and outside one."""
    if not _CLASSES:
        _CLASSES.update(L=_class_body(unicode_classes.LETTER),
                        N=_class_body(unicode_classes.NUMBER),
                        s=_class_body(unicode_classes.WHITE_SPACE))
    out, i, in_class = [], 0, False
    while i < len(pattern):
        c = pattern[i]
        if c == "\\":
            esc = pattern[i:i + 5] if pattern[i + 1] == "p" else pattern[i:i + 2]
            body = {r"\p{L}": _CLASSES["L"], r"\p{N}": _CLASSES["N"],
                    r"\s": _CLASSES["s"]}.get(esc)
            if body is not None:
                out.append(body if in_class else f"[{body}]")
            elif esc == r"\S" and not in_class:
                out.append(f"[^{_CLASSES['s']}]")
            elif esc.startswith(r"\p") or esc == r"\S":
                raise ValueError(f"no translation for {esc} in {pattern!r}")
            else:
                out.append(esc)
            i += len(esc)
            continue
        if c == "[" and not in_class:
            in_class = True
        elif c == "]" and in_class:
            in_class = False
        out.append(c)
        i += 1
    return re.compile("".join(out))


@dataclass
class ByteLevelBPE(BaseTokenizer):
    """GPT-2-style byte-level BPE over a GGUF vocab — the tokenizer family
    of the Qwen3 / Qwen3-MoE / DeepSeek-R1-Distill (Llama-3 vocab) tiers
    (GGUF ``tokenizer.ggml.model == "gpt2"``; rank-ordered merges in
    ``tokenizer.ggml.merges``). Special (control/user-defined) tokens are
    split out of the text before the merge loop, so chat-template markers
    like <|im_start|> encode to their single ids."""

    tokens: List[str]
    merges: List[str]  # "left right" pairs, rank = list position
    token_types: List[int]
    bos_id: Optional[int] = None
    eos_id: Optional[int] = None
    pre: str = "gpt2"
    # llama.cpp defaults add_bos FALSE for BPE vocabs (true only when the
    # GGUF says so); real Qwen GGUFs declare bos_token_id=<endoftext> WITH
    # add_bos_token=false, so bos_id being set must not imply prepending
    add_bos: bool = False
    _index: Dict[str, int] = field(default_factory=dict, repr=False)
    _ranks: Dict[tuple, int] = field(default_factory=dict, repr=False)
    _b2u: Dict[int, str] = field(default_factory=dict, repr=False)
    _u2b: Dict[str, int] = field(default_factory=dict, repr=False)
    _cache: Dict[str, List[str]] = field(default_factory=dict, repr=False)

    def __post_init__(self):
        self._index = {t: i for i, t in enumerate(self.tokens)}
        self._ranks = {
            tuple(m.split(" ", 1)): r for r, m in enumerate(self.merges)
        }
        self._b2u = _bytes_to_unicode()
        self._u2b = {c: b for b, c in self._b2u.items()}
        self._pat = _compile_pre(
            _PRE_PATTERNS[_PRE_ALIASES.get(self.pre, "gpt2")]
        )
        specials = [
            t
            for t, typ in zip(self.tokens, self.token_types)
            if typ in (TOKEN_TYPE_CONTROL, TOKEN_TYPE_USER_DEFINED)
        ]
        self._special_pat = None
        if specials:
            self._special_pat = re.compile(
                "("
                + "|".join(
                    re.escape(t)
                    for t in sorted(specials, key=len, reverse=True)
                )
                + ")"
            )

    @classmethod
    def from_gguf_metadata(cls, md: dict) -> "ByteLevelBPE":
        tokens = md["tokenizer.ggml.tokens"]
        n = len(tokens)
        bos = md.get("tokenizer.ggml.bos_token_id")
        eos = md.get("tokenizer.ggml.eos_token_id")
        return cls(
            tokens=tokens,
            merges=list(md.get("tokenizer.ggml.merges", [])),
            token_types=list(md.get("tokenizer.ggml.token_type", [1] * n)),
            bos_id=int(bos) if bos is not None else None,
            eos_id=int(eos) if eos is not None else None,
            pre=md.get("tokenizer.ggml.pre", "gpt2"),
            add_bos=bool(md.get("tokenizer.ggml.add_bos_token", False)),
        )

    @property
    def vocab_size(self) -> int:
        return len(self.tokens)

    def _bpe(self, word: str) -> List[str]:
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        syms = list(word)
        while len(syms) > 1:
            best, best_rank = None, None
            for i in range(len(syms) - 1):
                r = self._ranks.get((syms[i], syms[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best is None:
                break
            syms[best : best + 2] = [syms[best] + syms[best + 1]]
        if len(self._cache) < 65536:
            self._cache[word] = syms
        return syms

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids: List[int] = []
        # bos is prepended only when the GGUF's add_bos_token flag says so
        # (self.add_bos) — a declared bos_token_id alone must not trigger
        # it (Qwen GGUFs set bos_token_id=<endoftext>, add_bos_token=false)
        if add_bos and self.add_bos and self.bos_id is not None:
            ids.append(self.bos_id)
        chunks = (
            self._special_pat.split(text) if self._special_pat else [text]
        )
        for chunk in chunks:
            if not chunk:
                continue
            sid = self._index.get(chunk)
            if sid is not None and self._special_pat and (
                self.token_types[sid]
                in (TOKEN_TYPE_CONTROL, TOKEN_TYPE_USER_DEFINED)
            ):
                ids.append(sid)
                continue
            for m in self._pat.finditer(chunk):
                word = "".join(
                    self._b2u[b] for b in m.group().encode("utf-8")
                )
                for piece in self._bpe(word):
                    idx = self._index.get(piece)
                    if idx is not None:
                        ids.append(idx)
                    else:  # single-char fallback (vocab covers all bytes)
                        ids.extend(
                            self._index[c] for c in piece if c in self._index
                        )
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        chars: List[str] = []
        for i in ids:
            if not 0 <= i < len(self.tokens):
                continue
            typ = self.token_types[i] if i < len(self.token_types) else 1
            if typ == TOKEN_TYPE_CONTROL:
                continue
            chars.append(self.tokens[i])
        data = bytes(
            b
            for ch in "".join(chars)
            for b in (
                [self._u2b[ch]]
                if ch in self._u2b
                else ch.encode("utf-8")  # user-defined tokens pass through
            )
        )
        return data.decode("utf-8", errors="replace")


def gguf_tokenizer(md: dict) -> BaseTokenizer:
    """Build the right tokenizer for a GGUF file's embedded vocab:
    ``tokenizer.ggml.model`` "gpt2" (byte-level BPE — Qwen/Llama-3/DeepSeek
    families) vs "llama" (SentencePiece BPE — Llama/Mistral families)."""
    model = md.get("tokenizer.ggml.model", "llama")
    if model == "gpt2":
        return ByteLevelBPE.from_gguf_metadata(md)
    return SentencePieceBPE.from_gguf_metadata(md)


# ---------------------------------------------------------------------------
# HF tokenizer.json (no transformers, no tokenizers)
# ---------------------------------------------------------------------------

HF_TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json", "special_tokens_map.json")
Piece = Tuple[str, int]  # a piece of text and its start offset in the encoded text


def _pattern(spec: dict, where: str) -> "re.Pattern":
    """A ``{"String": s}`` or ``{"Regex": r}`` pattern of tokenizer.json."""
    if "String" in spec:
        return re.compile(re.escape(spec["String"]))
    if "Regex" in spec:
        return _compile_pre(spec["Regex"])
    raise ValueError(f"tokenizer.json: {where} pattern {spec!r}")


def _unsupported(kind: str, spec: dict) -> ValueError:
    return ValueError(f"tokenizer.json: {kind} {spec.get('type')!r} is not supported "
                      f"by the port's HFTokenizer")


def _normalizer(spec: Optional[dict]) -> Callable[[str], str]:
    if not spec:
        return lambda s: s
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [_normalizer(n) for n in spec["normalizers"]]

        def run(s: str) -> str:
            for step in steps:
                s = step(s)
            return s
        return run
    if kind == "Prepend":
        return lambda s: spec["prepend"] + s if s else s
    if kind == "Replace":
        pat = _pattern(spec["pattern"], "Replace")
        return lambda s: pat.sub(lambda _: spec["content"], s)
    if kind in ("NFC", "NFD", "NFKC", "NFKD"):
        return lambda s: unicodedata.normalize(kind, s)
    raise _unsupported("normalizer", spec)


def _split_isolated(pieces: List[Piece], pat: "re.Pattern", keep: bool) -> List[Piece]:
    """Each match becomes a piece of its own (``keep``; removed otherwise),
    the text between matches another; empty pieces go."""
    out: List[Piece] = []
    for text, start in pieces:
        at = 0
        for m in pat.finditer(text):
            if m.start() > at:
                out.append((text[at:m.start()], start + at))
            if keep and m.end() > m.start():
                out.append((m.group(), start + m.start()))
            at = m.end()
        if at < len(text):
            out.append((text[at:], start + at))
    return out


_GPT2_SPLIT = None


def _pre_tokenizer(spec: Optional[dict]) -> Callable[[List[Piece]], List[Piece]]:
    if not spec:
        return lambda pieces: pieces
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [_pre_tokenizer(p) for p in spec["pretokenizers"]]

        def run(pieces: List[Piece]) -> List[Piece]:
            for step in steps:
                pieces = step(pieces)
            return pieces
        return run
    if kind == "Split":
        behavior = spec.get("behavior", "Isolated")
        if spec.get("invert") or behavior not in ("Isolated", "Removed"):
            raise ValueError(f"tokenizer.json: Split with behavior {behavior!r}"
                             f"{' inverted' if spec.get('invert') else ''} is not supported "
                             f"by the port's HFTokenizer")
        pat = _pattern(spec["pattern"], "Split")
        return lambda pieces: _split_isolated(pieces, pat, behavior == "Isolated")
    if kind == "ByteLevel":
        global _GPT2_SPLIT
        if _GPT2_SPLIT is None:
            _GPT2_SPLIT = _compile_pre(_PRE_PATTERNS["gpt2"])
        b2u = _bytes_to_unicode()
        prefix, use_regex = spec.get("add_prefix_space", False), spec.get("use_regex", True)

        def byte_level(pieces: List[Piece]) -> List[Piece]:
            if prefix:
                pieces = [(t if t.startswith(" ") else " " + t, s) for t, s in pieces]
            if use_regex:
                pieces = _split_isolated(pieces, _GPT2_SPLIT, True)
            return [("".join(b2u[b] for b in t.encode("utf-8")), s) for t, s in pieces]
        return byte_level
    if kind == "Metaspace":
        rep = spec.get("replacement", SPIECE_SPACE)
        scheme = spec.get("prepend_scheme") or (
            "always" if spec.get("add_prefix_space", True) else "never")
        split = spec.get("split", True)

        def metaspace(pieces: List[Piece]) -> List[Piece]:
            out: List[Piece] = []
            for text, start in pieces:
                text = text.replace(" ", rep)
                if not text.startswith(rep) and (
                        scheme == "always" or (scheme == "first" and start == 0)):
                    text = rep + text
                if not split:
                    out.append((text, start))
                    continue
                cuts = [i for i, c in enumerate(text) if c == rep and i > 0]
                for a, b in zip([0] + cuts, cuts + [len(text)]):
                    out.append((text[a:b], start + a))
            return out
        return metaspace
    raise _unsupported("pre-tokenizer", spec)


def _byte_fallback_tokens(tokens: List[str]) -> List[str]:
    """The ByteFallback decoder: runs of ``<0xXX>`` tokens become their
    UTF-8 text, or one U+FFFD a byte where the run is not valid UTF-8."""
    out: List[str] = []
    run: List[int] = []

    def flush() -> None:
        if run:
            try:
                out.append(bytes(run).decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("�" for _ in run)
            run.clear()

    for t in tokens:
        if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
            try:
                run.append(int(t[3:5], 16))
                continue
            except ValueError:
                pass
        flush()
        out.append(t)
    flush()
    return out


def _strip_tokens(tokens: List[str], content: str, start: int, stop: int) -> List[str]:
    out = []
    for t in tokens:
        a = 0
        while a < min(start, len(t)) and t[a] == content:
            a += 1
        b = len(t)
        while len(t) - b < stop and b > a and t[b - 1] == content:
            b -= 1
        out.append(t[a:b])
    return out


def _decoder(spec: Optional[dict]) -> Callable[[List[str]], List[str]]:
    if not spec:
        return lambda tokens: [" ".join(tokens)]
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [_decoder(d) for d in spec["decoders"]]

        def run(tokens: List[str]) -> List[str]:
            for step in steps:
                tokens = step(tokens)
            return tokens
        return run
    if kind == "Replace":
        pat = _pattern(spec["pattern"], "Replace")
        return lambda tokens: [pat.sub(lambda _: spec["content"], t) for t in tokens]
    if kind == "ByteFallback":
        return _byte_fallback_tokens
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "Strip":
        return lambda tokens: _strip_tokens(tokens, spec["content"], spec.get("start", 0),
                                            spec.get("stop", 0))
    if kind == "Metaspace":
        rep = spec.get("replacement", SPIECE_SPACE)
        scheme = spec.get("prepend_scheme") or (
            "always" if spec.get("add_prefix_space", True) else "never")
        # the first token loses its replacement characters, the rest become spaces
        return lambda tokens: [
            "".join("" if c == rep and i == 0 and scheme != "never" else " " if c == rep
                    else c for c in t) for i, t in enumerate(tokens)]
    if kind == "ByteLevel":
        u2b = {c: b for b, c in _bytes_to_unicode().items()}

        def byte_level(tokens: List[str]) -> List[str]:
            data = bytearray()
            for t in tokens:
                if all(c in u2b for c in t):
                    data.extend(u2b[c] for c in t)
                else:
                    data.extend(t.encode("utf-8"))
            return [data.decode("utf-8", errors="replace")]
        return byte_level
    raise _unsupported("decoder", spec)


def _clean_up_tokenization(text: str) -> str:
    """transformers' ``clean_up_tokenization``."""
    for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
                 (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"),
                 (" 're", "'re")):
        text = text.replace(a, b)
    return text


class HFTokenizer(BaseTokenizer):
    """An HF model directory's ``tokenizer.json``, run without
    ``transformers``: the JAX ``HFTokenizer``'s ids for the same text.

    ``encode(text, add_bos)``: the ``add_special_tokens=False`` ids, with
    ``bos_id`` prepended when asked and the tokenizer has one. The text is
    first split on the added tokens (longest first at the leftmost match,
    their ``lstrip``/``rstrip`` honoured; tokens marked ``normalized`` are
    matched after the normalizer); every other piece is normalized,
    pre-tokenized and run through the BPE model: each character's token,
    else its ``<0xXX>`` byte tokens (``byte_fallback``), else ``unk``
    (consecutive unknowns fused with ``fuse_unk``), then the merges by rank
    (``ignore_merges``: a piece that is itself in the vocab is one token).
    ``decode`` drops special tokens and runs the decoder chain, then
    transformers' cleanup where ``clean_up_tokenization_spaces`` is set.
    BOS and EOS come from ``tokenizer_config.json`` (else
    ``special_tokens_map.json``). A component the port does not implement
    raises ``ValueError`` naming it when the tokenizer is built."""

    def __init__(self, path: str):
        self.path = str(path)
        d = Path(path)
        # the files' bytes, which ``save`` writes again: a prepared
        # checkpoint carries them whatever becomes of the source directory
        self._files = {name: (d / name).read_bytes() for name in HF_TOKENIZER_FILES
                       if (d / name).is_file() or name == "tokenizer.json"}
        spec = json.loads(self._files["tokenizer.json"])
        config = json.loads(self._files.get("tokenizer_config.json", b"{}"))
        special_map = json.loads(self._files.get("special_tokens_map.json", b"{}"))
        model = spec.get("model") or {}
        if model.get("type", "BPE") != "BPE":
            raise _unsupported("model", model)
        for key in ("continuing_subword_prefix", "end_of_word_suffix", "dropout"):
            if model.get(key):
                raise ValueError(f"tokenizer.json: BPE {key} {model[key]!r} is not "
                                 f"supported by the port's HFTokenizer")
        self._vocab: Dict[str, int] = dict(model.get("vocab") or {})
        self._merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, merge in enumerate(model.get("merges") or []):
            a, b = merge.split(" ", 1) if isinstance(merge, str) else merge
            ids = (self._vocab.get(a), self._vocab.get(b), self._vocab.get(a + b))
            if None in ids:
                raise ValueError(f"tokenizer.json: merge {a!r} {b!r} names a token "
                                 f"outside the vocab")
            self._merges[(ids[0], ids[1])] = (rank, ids[2])
        unk = model.get("unk_token")
        self._unk_id = self._vocab.get(unk) if unk is not None else None
        self._fuse_unk = bool(model.get("fuse_unk", False))
        self._byte_fallback = bool(model.get("byte_fallback", False))
        self._ignore_merges = bool(model.get("ignore_merges", False))
        self._id_to_token = {i: t for t, i in self._vocab.items()}
        added = spec.get("added_tokens") or []
        self._added = {a["content"]: a for a in added}
        for a in added:
            self._id_to_token[a["id"]] = a["content"]
        self._normalize = _normalizer(spec.get("normalizer"))
        self._pre_tokenize = _pre_tokenizer(spec.get("pre_tokenizer"))
        self._decode = _decoder(spec.get("decoder"))
        self._raw_split = self._added_pattern([a for a in added if not a.get("normalized")])
        self._normalized_split = self._added_pattern([a for a in added if a.get("normalized")])
        self._clean_up = bool(config.get("clean_up_tokenization_spaces", False))
        self._cache: Dict[str, List[int]] = {}

        def special(name: str) -> Optional[str]:
            v = config.get(name) if config.get(name) is not None else special_map.get(name)
            return v.get("content") if isinstance(v, dict) else v

        self._special_ids = {a["id"] for a in added if a.get("special")}
        for name in ("bos_token", "eos_token", "unk_token", "pad_token"):
            tid = self._token_id(special(name))
            if tid is not None:
                self._special_ids.add(tid)
        self.bos_id = self._token_id(special("bos_token"))
        self.eos_id = self._token_id(special("eos_token"))

    def _token_id(self, token: Optional[str]) -> Optional[int]:
        if token is None:
            return None
        if token in self._added:
            return self._added[token]["id"]
        return self._vocab.get(token)

    @staticmethod
    def _added_pattern(tokens: List[dict]) -> Optional["re.Pattern"]:
        if not tokens:
            return None
        contents = sorted({a["content"] for a in tokens}, key=len, reverse=True)
        return re.compile("|".join(re.escape(c) for c in contents))

    @property
    def vocab_size(self) -> int:
        return len(self._id_to_token)

    def _split_added(self, pieces: List[Tuple[str, int, Optional[int]]],
                     pat: Optional["re.Pattern"]) -> List[Tuple[str, int, Optional[int]]]:
        """Cut the added tokens ``pat`` matches out of the pieces not yet
        tokenized: (text, start, None) pieces and (content, start, id)
        tokens; ``lstrip``/``rstrip`` take the whitespace beside a token."""
        if pat is None:
            return pieces
        out: List[Tuple[str, int, Optional[int]]] = []
        for text, start, tid in pieces:
            if tid is not None:
                out.append((text, start, tid))
                continue
            at = 0
            for m in pat.finditer(text):
                tok = self._added[m.group()]
                if tok.get("single_word") and (
                        (m.start() > 0 and text[m.start() - 1].isalnum())
                        or (m.end() < len(text) and text[m.end()].isalnum())):
                    continue
                a, b = m.start(), m.end()
                if tok.get("lstrip"):
                    while a > at and text[a - 1].isspace():
                        a -= 1
                if tok.get("rstrip"):
                    while b < len(text) and text[b].isspace():
                        b += 1
                if a > at:
                    out.append((text[at:a], start + at, None))
                out.append((m.group(), start + m.start(), tok["id"]))
                at = b
            if at < len(text):
                out.append((text[at:], start + at, None))
        return out

    def _bpe(self, word: str) -> List[int]:
        """The BPE model on one pre-tokenized piece (``tokenizers``'
        ``BPE::merge_word`` and ``Word::merge_all``)."""
        if self._ignore_merges and word in self._vocab:
            return [self._vocab[word]]
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        ids: List[int] = []
        unk = False  # an unknown character waits, to fuse with the next one
        for ch in word:
            tid = self._vocab.get(ch)
            if tid is not None:
                if unk:
                    ids.append(self._unk_id)
                    unk = False
                ids.append(tid)
                continue
            if self._byte_fallback:
                byte_ids = [self._vocab.get(f"<0x{b:02X}>") for b in ch.encode("utf-8")]
                if None not in byte_ids:
                    ids.extend(byte_ids)
                    continue
            if self._unk_id is not None:
                if unk and not self._fuse_unk:
                    ids.append(self._unk_id)
                unk = True
        if unk:
            ids.append(self._unk_id)
        n = len(ids)
        prev, nxt, alive = list(range(-1, n - 1)), list(range(1, n)) + [-1], [True] * n
        heap = [(m[0], i, m[1]) for i in range(n - 1)
                for m in (self._merges.get((ids[i], ids[i + 1])),) if m is not None]
        heapq.heapify(heap)
        while heap:
            _, pos, new = heapq.heappop(heap)
            right = nxt[pos]
            if not alive[pos] or right < 0:
                continue
            m = self._merges.get((ids[pos], ids[right]))
            if m is None or m[1] != new:
                continue  # stale: a side has merged since the push
            ids[pos], alive[right] = new, False
            nxt[pos] = nxt[right]
            if nxt[pos] >= 0:
                prev[nxt[pos]] = pos
            for left in (prev[pos], pos):
                if left >= 0 and nxt[left] >= 0:
                    m = self._merges.get((ids[left], ids[nxt[left]]))
                    if m is not None:
                        heapq.heappush(heap, (m[0], left, m[1]))
        out = [t for t, live in zip(ids, alive) if live]
        if len(self._cache) < 65536:
            self._cache[word] = out
        return out

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids: List[int] = []
        if add_bos and self.bos_id is not None:
            ids.append(self.bos_id)
        pieces = self._split_added([(text, 0, None)], self._raw_split)
        pieces = [(t, s, i) if i is not None else (self._normalize(t), s, None)
                  for t, s, i in pieces]
        for t, s, tid in self._split_added(pieces, self._normalized_split):
            if tid is not None:
                ids.append(tid)
                continue
            for word, _ in self._pre_tokenize([(t, s)]):
                if word:
                    ids.extend(self._bpe(word))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        tokens = [self._id_to_token[i] for i in ids
                  if i in self._id_to_token and i not in self._special_ids]
        text = "".join(self._decode(tokens))
        return _clean_up_tokenization(text) if self._clean_up else text

    def save(self, directory: str) -> None:
        """Write the tokenizer's files, as read, into ``directory``."""
        out = Path(directory)
        out.mkdir(parents=True, exist_ok=True)
        for name, data in self._files.items():
            (out / name).write_bytes(data)


class ByteTokenizer(BaseTokenizer):
    """256-symbol byte tokenizer — synthetic models, benches, smoke tests."""

    bos_id = 256
    eos_id = 257

    @property
    def vocab_size(self) -> int:
        return 258

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = list(text.encode("utf-8"))
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8", errors="replace")


# ---------------------------------------------------------------------------
# Serialization (a prepared checkpoint carries its tokenizer, as a GGUF does)
# ---------------------------------------------------------------------------


def tokenizer_to_dict(tok: BaseTokenizer) -> dict:
    """The JAX ``tokenizer_to_dict``: the vocab of a GGUF tokenizer, the
    source directory of an HF one."""
    if isinstance(tok, SentencePieceBPE):
        return {"type": "spbpe", "tokens": tok.tokens, "scores": tok.scores,
                "token_types": tok.token_types, "bos_id": tok.bos_id, "eos_id": tok.eos_id,
                "add_prefix_space": tok.add_prefix_space}
    if isinstance(tok, ByteLevelBPE):
        return {"type": "blbpe", "tokens": tok.tokens, "merges": tok.merges,
                "token_types": tok.token_types, "bos_id": tok.bos_id, "eos_id": tok.eos_id,
                "pre": tok.pre, "add_bos": tok.add_bos}
    if isinstance(tok, HFTokenizer):
        return {"type": "hf", "path": tok.path}
    return {"type": "byte"}


def tokenizer_from_dict(d: dict) -> BaseTokenizer:
    """The JAX ``tokenizer_from_dict``."""
    t = d.get("type", "byte")
    if t == "spbpe":
        return SentencePieceBPE(tokens=list(d["tokens"]), scores=list(d["scores"]),
                                token_types=list(d["token_types"]), bos_id=d.get("bos_id"),
                                eos_id=d.get("eos_id"),
                                add_prefix_space=d.get("add_prefix_space", True))
    if t == "blbpe":
        return ByteLevelBPE(tokens=list(d["tokens"]), merges=list(d["merges"]),
                            token_types=list(d["token_types"]), bos_id=d.get("bos_id"),
                            eos_id=d.get("eos_id"), pre=d.get("pre", "gpt2"),
                            add_bos=bool(d.get("add_bos", False)))
    if t == "hf":
        return HFTokenizer(d["path"])
    return ByteTokenizer()


def render_chat(family: str, prompt: str, system_prompt: str = "") -> str:
    """Render a single-turn chat for the given model family."""
    fam = family.lower()
    if "tinyllama" in fam or "zephyr" in fam:
        parts = []
        if system_prompt:
            parts.append(f"<|system|>\n{system_prompt}</s>\n")
        parts.append(f"<|user|>\n{prompt}</s>\n<|assistant|>\n")
        return "".join(parts)
    if "mistral" in fam:
        sys = f"{system_prompt}\n\n" if system_prompt else ""
        return f"[INST] {sys}{prompt} [/INST]"
    if "qwen" in fam or "deepseek" in fam or "chatml" in fam:
        parts = []
        if system_prompt:
            parts.append(f"<|im_start|>system\n{system_prompt}<|im_end|>\n")
        parts.append(f"<|im_start|>user\n{prompt}<|im_end|>\n<|im_start|>assistant\n")
        return "".join(parts)
    sys = f"System: {system_prompt}\n\n" if system_prompt else ""
    return f"{sys}User: {prompt}\n\nAssistant:"
