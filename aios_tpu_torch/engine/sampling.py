"""On-device token sampling: temperature, top-p over a top-k pool, greedy.

Vectorized over slots with per-slot temperature and top_p, like
``aios_tpu/engine/sampling.py``. The candidate pool is the exact top
``topk_cap()`` logits (llama.cpp's chain also applies top-k before top-p);
the categorical draw is a Gumbel-max over that pool with noise from the
caller's ``torch.Generator``. The JAX sampler's threefry stream cannot be
replayed here, so sampled tokens agree with it in distribution only.

``AIOS_TPU_SAMPLE_POOL`` sets the pool's size, as in the JAX package. The
engine reads it once, when it is built, and passes it to every ``sample``:
its CUDA graphs bake the size in, as a JAX trace does, so that an eager body
and its graph never disagree.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

GREEDY_EPS = 1e-4  # temperatures below this mean argmax
DEFAULT_TOPK_CAP = 64


def topk_cap() -> int:
    """Size of the candidate pool nucleus sampling works on:
    ``AIOS_TPU_SAMPLE_POOL``, else 64. Not an integer, or below 1, raises
    ``ValueError`` (0 does not mean "off": that would sort the whole vocab
    every step, and a silent pool of 1 would make all sampling greedy)."""
    raw = os.environ.get("AIOS_TPU_SAMPLE_POOL", "")
    if not raw:
        return DEFAULT_TOPK_CAP
    try:
        cap = int(raw)
    except ValueError:
        raise ValueError(f"AIOS_TPU_SAMPLE_POOL={raw!r} is not an integer") from None
    if cap < 1:
        raise ValueError("AIOS_TPU_SAMPLE_POOL must be >= 1")
    return cap


def sample(
    logits: torch.Tensor,  # [B, V] fp32
    generator: torch.Generator,
    temperature: torch.Tensor,  # [B]
    top_p: torch.Tensor,  # [B]; 1.0 keeps the whole (capped) pool
    out: Optional[torch.Tensor] = None,  # int64 [B]: written in place
    pool: int = DEFAULT_TOPK_CAP,  # the candidate pool (the engine's topk_cap())
) -> torch.Tensor:
    """One token per row (int64 [B]); rows with temperature < GREEDY_EPS
    take the argmax."""
    K = min(pool, logits.shape[-1])
    greedy = torch.argmax(logits, dim=-1)
    temp = torch.clamp(temperature, min=GREEDY_EPS)[:, None]
    vals, idx = torch.topk(logits / temp, K, dim=-1)  # sorted descending
    probs = torch.softmax(vals, dim=-1)
    cumulative = torch.cumsum(probs, dim=-1)
    # keep tokens while the cumulative mass before them is < top_p
    keep = (cumulative - probs) < top_p[:, None]
    vals = torch.where(keep, vals, torch.full_like(vals, float("-inf")))
    u = torch.rand(vals.shape, generator=generator, device=vals.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))
    choice = torch.argmax(vals + gumbel, dim=-1)
    sampled = idx.gather(1, choice[:, None])[:, 0]
    return torch.where(temperature < GREEDY_EPS, greedy, sampled, out=out)
