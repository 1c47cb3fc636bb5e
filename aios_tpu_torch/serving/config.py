"""Serving-layer configuration: replica count, quotas, queues, deadlines.

A copy of ``aios_tpu/serving/config.py``: one dataclass read once per
``LoadModel`` (ModelManager.load_model), so a running pool's policy is
immutable, with the same ``AIOS_TPU_*`` knobs and the same lenient
parsing: a malformed knob logs and falls back instead of taking down a
model load. ``draft_model`` names the draft the model manager pairs with
the model (``runtime/model_manager.py``, ``_build_draft``).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass

log = logging.getLogger("aios.torch.serving")


def _env_float(name: str, default: float, minimum: float = 0.0) -> float:
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        v = float(raw)
        if v < minimum:
            raise ValueError(f"must be >= {minimum}")
        return v
    except ValueError as exc:
        log.warning("%s=%r ignored (%s); using %s", name, raw, exc, default)
        return default


def _env_int(name: str, default: int, minimum: int = 0) -> int:
    return int(_env_float(name, float(default), float(minimum)))


@dataclass(frozen=True)
class ServingConfig:
    # replicas per managed model (AIOS_TPU_REPLICAS overrides
    # ModelConfig.replicas; each replica is its own engine + batcher)
    replicas: int = 1
    # per-tenant token-bucket quota: sustained tokens/sec refill and burst
    # capacity (tokens). 0 tokens/sec = quotas off. A request costs
    # prompt_tokens + max_tokens up front (the reservation is the bound —
    # admission cannot know the true decode length).
    tenant_tokens_per_sec: float = 0.0
    tenant_burst_tokens: float = 0.0  # 0 -> 4 s of refill
    # tenant identity: "agent" = requesting_agent, falling back to the
    # task_id prefix; "task_prefix" = always the task_id prefix
    tenant_by: str = "agent"
    # bounded queues: shed (RESOURCE_EXHAUSTED + retry-after-ms) instead
    # of queueing more than this many waiting requests per replica;
    # 0 = unbounded (the pre-serving behavior)
    max_queue: int = 64
    # cache-aware routing: route to the best prefix-overlapping replica
    # only when the overlap covers at least this fraction of the prompt;
    # below it, least-outstanding-tokens wins
    overlap_min_ratio: float = 0.25
    # deadline admission: a request is shed when
    # (replica outstanding tokens + request max_tokens) / observed
    # tokens-per-sec exceeds the propagated gRPC deadline. When the
    # observed rate is 0 (cold pool), assumed_tokens_per_sec substitutes;
    # 0 disables the feasibility check until a rate is observed.
    assumed_tokens_per_sec: float = 0.0
    # transparent failover (serving/failover.py): how many times an
    # in-flight request whose replica died (or was evicted, on a
    # multi-replica pool) is re-routed to a surviving replica before the
    # abort surfaces as UNAVAILABLE + retry-after. 0 disables wrapping
    # (the pre-failover truncate-and-error behavior).
    failover_retries: int = 2
    # base of the failover exponential backoff (doubles per attempt,
    # +-50% jitter, capped at failover.MAX_BACKOFF_S)
    failover_backoff_ms: float = 50.0
    # draft-model speculation source paired with this managed model
    # (AIOS_TPU_DRAFT_MODEL overrides ModelConfig.draft_model): a preset
    # name or weights path loaded as an int4 draft (engine/spec.py
    # DraftModel). "" = n-gram prompt-lookup speculation only. The manager
    # falls back to n-gram when it cannot carry the draft (a source that
    # does not load, another vocabulary or tokenizer).
    draft_model: str = ""

    @classmethod
    def from_env(
        cls, replicas_default: int = 1, draft_model_default: str = "",
    ) -> "ServingConfig":
        replicas = _env_int("AIOS_TPU_REPLICAS", replicas_default, minimum=1)
        tps = _env_float("AIOS_TPU_TENANT_TOKENS_PER_SEC", 0.0)
        burst = _env_float("AIOS_TPU_TENANT_BURST_TOKENS", 0.0)
        if tps > 0 and burst <= 0:
            burst = 4.0 * tps
        tenant_by = os.environ.get("AIOS_TPU_TENANT_BY", "agent").lower()
        if tenant_by not in ("agent", "task_prefix"):
            log.warning(
                "AIOS_TPU_TENANT_BY=%r ignored (expected agent|task_prefix)",
                tenant_by,
            )
            tenant_by = "agent"
        return cls(
            replicas=replicas,
            tenant_tokens_per_sec=tps,
            tenant_burst_tokens=burst,
            tenant_by=tenant_by,
            max_queue=_env_int("AIOS_TPU_MAX_QUEUE", 64),
            overlap_min_ratio=_env_float(
                "AIOS_TPU_ROUTE_OVERLAP_MIN", 0.25
            ),
            assumed_tokens_per_sec=_env_float("AIOS_TPU_ASSUMED_TPS", 0.0),
            failover_retries=_env_int("AIOS_TPU_FAILOVER_RETRIES", 2),
            failover_backoff_ms=_env_float(
                "AIOS_TPU_FAILOVER_BACKOFF_MS", 50.0
            ),
            draft_model=os.environ.get(
                "AIOS_TPU_DRAFT_MODEL", draft_model_default
            ).strip(),
        )
