"""Serving layer: replica pools, cache-aware routing, admission control
and transparent failover — the port of ``aios_tpu/serving``.

Sits between the runtime gRPC service and the batchers: ``RuntimeService``
talks to a :class:`ReplicaPool` per managed model; the pool routes each
request to the replica most likely to hold its prompt prefix (SGLang-style
cache-aware routing, arXiv:2312.07104), sheds work a saturated pool cannot
serve inside its deadline (RTP-LLM-style admission, arXiv:2605.29639) and
resumes a stream whose replica crashed on a respawned batcher. The SLO
autoscaler is not ported yet.
"""

from .admission import AdmissionController, AdmissionError, TokenBucket, tenant_of
from .config import ServingConfig
from .failover import FailoverHandle
from .pool import Replica, ReplicaPool
from .router import ROUTE_REASONS, Router

__all__ = [
    "AdmissionController",
    "AdmissionError",
    "FailoverHandle",
    "ROUTE_REASONS",
    "Replica",
    "ReplicaPool",
    "Router",
    "ServingConfig",
    "TokenBucket",
    "tenant_of",
]
