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

The HF-directory tokenizer and the checkpoint (de)serializers wait for the
HF and prepared-checkpoint loaders.
"""

from __future__ import annotations

import heapq
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

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
