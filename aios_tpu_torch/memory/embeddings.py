"""Hash-projected bag-of-words embeddings + hybrid search scoring.

Reference parity: long-term memory embeds text as 64-dim hash-projected
bag-of-words vectors and searches with a cosine/keyword hybrid
(memory/src/longterm.rs:14-66). Same scheme here (vectorized in numpy):
each lowercase word hashes to a dimension and a sign; vectors are
L2-normalized; search scores are a blend of cosine similarity and keyword
overlap so exact term matches can't be drowned out by the projection noise.
"""

from __future__ import annotations

import hashlib
import re
from typing import List, Sequence

import numpy as np

DIM = 64
_WORD_RE = re.compile(r"[a-z0-9]+")


def _tokenize(text: str) -> List[str]:
    return _WORD_RE.findall(text.lower())


def _word_projection(word: str) -> tuple[int, float]:
    digest = hashlib.md5(word.encode("utf-8")).digest()
    dim = int.from_bytes(digest[:4], "little") % DIM
    sign = 1.0 if digest[4] & 1 else -1.0
    return dim, sign


def embed(text: str) -> np.ndarray:
    """64-dim L2-normalized hash embedding of ``text``."""
    v = np.zeros(DIM, dtype=np.float32)
    for word in _tokenize(text):
        dim, sign = _word_projection(word)
        v[dim] += sign
    norm = float(np.linalg.norm(v))
    if norm > 0:
        v /= norm
    return v


def cosine(a: np.ndarray, b: np.ndarray) -> float:
    denom = float(np.linalg.norm(a) * np.linalg.norm(b))
    if denom == 0:
        return 0.0
    return float(np.dot(a, b) / denom)


def keyword_overlap(query: str, text: str) -> float:
    q = set(_tokenize(query))
    if not q:
        return 0.0
    t = set(_tokenize(text))
    return len(q & t) / len(q)


def hybrid_score(query: str, query_vec: np.ndarray, text: str, vec: np.ndarray) -> float:
    """Blend of vector similarity and exact keyword overlap in [0, 1]."""
    cos = max(0.0, cosine(query_vec, vec))
    kw = keyword_overlap(query, text)
    return 0.5 * cos + 0.5 * kw


def rank(
    query: str, texts: Sequence[str], vecs: Sequence[np.ndarray]
) -> List[tuple[int, float]]:
    qv = embed(query)
    scored = [
        (i, hybrid_score(query, qv, texts[i], vecs[i])) for i in range(len(texts))
    ]
    scored.sort(key=lambda x: x[1], reverse=True)
    return scored
