"""Device-side n-gram (prompt-lookup) speculative decoding.

Batched decode streams every matmul weight once whether it scores 1 token or
8 per slot, so verifying K draft tokens in one ``model.verify_step`` moves
about the bytes of a single decode step, and every accepted draft is a token
for little extra work. This module supplies the drafts and the acceptance
rule; the loop — propose, verify, accept, update — runs on the device in
``TorchEngine.spec_step`` with one host readback per call.

Drafts come from prompt lookup (n-gram matching against the slot's own token
history), which needs no draft model and suits agent loops that re-emit JSON
tool calls, file contents and quoted context. The history is a device
``[S, C + HISTORY_PAD]`` buffer in the engine's decode state; the proposer is
a vectorized compare over it.

Acceptance is exact for greedy slots (temperature < GREEDY_EPS): a draft
token is accepted iff it equals the model's own argmax at that position, so
speculative greedy decoding emits the token sequence of plain greedy decoding
in fewer dispatches. Slots sampling at temperature > 0 do not speculate: they
emit one sampled token per round from the first logits row. The two kinds of
slot mix freely in one batch.

Beside prompt lookup, ``DraftModel`` turns a small model into a proposer:
it runs K greedy decode steps a round over its own dense cache, and the
serving model verifies the draft in the same forward (``TorchEngine``'s
``spec_step_draft``).

The port of ``aios_tpu/engine/spec.py``: integer functions whose results
equal the JAX ones exactly, and ``DraftModel``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# The closed proposer enum of the JAX package: the ``proposer`` label of the
# speculative metric families and the batcher's ladder (draft -> ngram).
SPEC_PROPOSERS = ("ngram", "draft")

# Extra columns appended to the history buffer beyond max_context so the
# post-verify scatter (columns lengths+1 .. lengths+1+K) never has to clamp:
# clamping would collide several writes onto one column, and the winner among
# duplicate indices is undefined. Bounds the draft length.
HISTORY_PAD = 32


def init_history(num_slots: int, max_context: int, device=None) -> torch.Tensor:
    """Device token-history buffer. Invariant maintained by the engine:
    ``history[s, 0:lengths[s]]`` are the tokens whose K/V sit in cache rows
    ``[0, lengths[s])`` and ``history[s, lengths[s]]`` is the pending
    ``last_tokens[s]``. Columns beyond that are garbage."""
    return torch.zeros((num_slots, max_context + HISTORY_PAD), dtype=torch.int64,
                       device=device)


def propose_ngram(
    history: torch.Tensor,  # [S, C+pad] integer
    lengths: torch.Tensor,  # [S] integer — history[0:lengths+1) is known
    draft_len: int,
    ngram: int,
    max_context: int,
    min_pos: Optional[torch.Tensor] = None,  # [S] search floor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Propose up to ``draft_len`` tokens per slot by prompt lookup.

    Finds the most recent earlier occurrence of the trailing ``ngram``
    tokens (ending at the pending last token, history column ``lengths``)
    and proposes the tokens that followed it, preferring an occurrence with
    a full draft's worth of known continuation. ``min_pos`` restricts the
    search to match windows starting at or past ``min_pos[s]``.

    Returns (drafts [S, draft_len] with -1 beyond each slot's count,
    num_drafts [S]). The count is clamped so the verify step's accepted rows
    stay within the cache: lengths + num_drafts <= C-2.
    """
    S, W = history.shape
    n, K, C = int(ngram), int(draft_len), int(max_context)
    dev = history.device
    last = lengths.to(torch.int64)  # history column of the pending last token
    p = torch.arange(W, device=dev)[None, :]
    # trailing pattern: history[last-n+1 .. last]
    pat_idx = (last[:, None] - n + 1 + torch.arange(n, device=dev)[None, :]).clamp(0, W - 1)
    pattern = history.gather(1, pat_idx)  # [S, n]
    # match[s, p] = the window of n tokens starting at p equals the pattern
    match = torch.ones((S, W), dtype=torch.bool, device=dev)
    for i in range(n):
        shifted = history if i == 0 else torch.cat(
            [history[:, i:], history.new_full((S, i), -1)], dim=1)
        match &= shifted == pattern[:, i:i + 1]
    # the window must end strictly before the trailing pattern's start, and
    # exist at all (n+1 known tokens: the pattern plus some history)
    valid = (p <= (last - n)[:, None]) & (last[:, None] >= n)
    if min_pos is not None:
        valid &= p >= min_pos.to(torch.int64)[:, None]
    hit = match & valid
    # Prefer the most recent occurrence that still has a FULL draft's worth
    # of known continuation after it; fall back to the most recent partial
    # one. Plain "most recent" degenerates on token runs (x x x x): the
    # freshest window ends right at the tail, leaving one known continuation
    # token, and acceptance collapses to about one per round.
    full = hit & (p <= (last - n - K + 1)[:, None])
    none = torch.full_like(p, -1)
    best_full = torch.where(full, p, none).amax(dim=1)
    best_any = torch.where(hit, p, none).amax(dim=1)
    best = torch.where(best_full >= 0, best_full, best_any)  # -1 = none
    start = best + n  # first draft token's history column
    known = last - start + 1  # continuation tokens actually known
    room = (C - 2) - last  # cache rows the verify step may consume
    num = torch.minimum(known, room).clamp(0, K)
    num = torch.where(best >= 0, num, torch.zeros_like(num))
    steps = torch.arange(K, device=dev)[None, :]
    drafts = history.gather(1, (start[:, None] + steps).clamp(0, W - 1))
    drafts = torch.where(steps < num[:, None], drafts, torch.full_like(drafts, -1))
    return drafts, num


class DraftModel:
    """A small model as the draft proposer beside ``propose_ngram`` (the
    JAX ``spec.DraftModel``): K greedy steps a round through its own
    ``decode_step``, verified by the serving model in one forward. Holds
    the draft's config and serving leaves only, shared read-only by every
    replica engine of a managed model; each engine makes its own slot-
    aligned cache with ``init_state`` and keeps the invariant that draft
    cache rows [0, d_len) hold the K/V of ``history[:, 0:d_len)``, so a
    rejected draft row is unreadable once d_len is clamped back to the
    verified length. The draft must share the serving model's tokenizer
    (its proposals are token ids of the serving vocabulary).

    ``quantize`` is "int4" (the default), "int8" (True too) or None for
    dense leaves; params that already hold serving leaves keep their
    stored mode."""

    def __init__(self, cfg, params, *, quantize: Optional[str] = "int4"):
        from . import model  # model imports nothing of this module, but engine does

        self.cfg = cfg
        if quantize is True:
            quantize = "int8"
        elif not quantize:
            quantize = None
        elif quantize not in ("int8", "int4"):
            raise ValueError(f"unknown draft quantize mode {quantize!r}")
        if model.is_quantized(params):
            self.quant_mode = model.quantized_mode(params)
        else:
            if quantize is not None:
                params = model.quantize_params(params, mode=quantize)
            self.quant_mode = quantize
        self.params = params

    def init_state(self, num_slots: int, max_context: int,
                   cache_dtype: torch.dtype = torch.bfloat16, device=None):
        """A fresh draft state on ``device`` (None: the draft's): a dense
        cache [L, S, C, KH, D] sized to the SERVING model's context (rows
        map 1:1 onto history columns) and the [S] int32 lengths. bf16
        stands in for an int8 serving cache: the draft path keeps no
        scales."""
        from . import model

        if cache_dtype == torch.int8:
            cache_dtype = torch.bfloat16
        device = self.params["embed"].device if device is None else device
        k, v = model.init_kv_cache(self.cfg, num_slots, max_context, cache_dtype, device)
        return {"k": k, "v": v,
                "lengths": torch.zeros(num_slots, dtype=torch.int32, device=device)}

    def weight_bytes(self) -> int:
        from . import model

        return model.serving_weight_bytes(self.params)


def accept_counts(drafts: torch.Tensor, argmax_rows: torch.Tensor) -> torch.Tensor:
    """Longest accepted draft prefix per slot.

    drafts [S, K] (-1 padded), argmax_rows [S, K+1] — the model's greedy
    prediction at each verified position. Draft j is accepted iff it equals
    argmax_rows[:, j] and every draft before it was; the -1 padding can
    never match. Returns [S] int64 in [0, K].
    """
    m = (drafts == argmax_rows[:, : drafts.shape[1]]).to(torch.int64)
    return m.cumprod(dim=1).sum(dim=1)
