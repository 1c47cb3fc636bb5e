"""Result aggregation + decision logging.

Reference parity:
  * ResultAggregator (agent-core/src/result_aggregator.rs): per-goal
    TaskResult collection with GoalSummary {total/succeeded/failed/tokens/
    duration/models} (result_aggregator.rs:65-94);
  * DecisionLogger (agent-core/src/decision_logger.rs): bounded ring
    (10k) of {context, options, chosen, reasoning, level, model, outcome}
    with success-rate analytics (decision_logger.rs:33-121).
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..obs import instruments as obs


@dataclass
class TaskOutcome:
    task_id: str
    success: bool
    output: Dict = field(default_factory=dict)
    error: str = ""
    duration_ms: int = 0
    tokens_used: int = 0
    model_used: str = ""


@dataclass
class GoalSummary:
    goal_id: str
    total_tasks: int = 0
    succeeded: int = 0
    failed: int = 0
    total_tokens: int = 0
    total_duration_ms: int = 0
    models_used: List[str] = field(default_factory=list)


class ResultAggregator:
    def __init__(self):
        self._by_goal: Dict[str, List[TaskOutcome]] = {}
        self._lock = threading.Lock()

    def record(self, goal_id: str, outcome: TaskOutcome) -> None:
        with self._lock:
            self._by_goal.setdefault(goal_id, []).append(outcome)
        # the same numbers the per-goal summary() aggregates, exported
        # through the process registry (no parallel telemetry path)
        obs.GOAL_TASKS.labels(
            outcome="success" if outcome.success else "failure"
        ).inc()
        if outcome.tokens_used:
            obs.GOAL_TASK_TOKENS.inc(outcome.tokens_used)
        obs.GOAL_TASK_DURATION.observe(outcome.duration_ms / 1000.0)

    def summary(self, goal_id: str) -> GoalSummary:
        with self._lock:
            outcomes = list(self._by_goal.get(goal_id, []))
        s = GoalSummary(goal_id=goal_id, total_tasks=len(outcomes))
        for o in outcomes:
            s.succeeded += int(o.success)
            s.failed += int(not o.success)
            s.total_tokens += o.tokens_used
            s.total_duration_ms += o.duration_ms
            if o.model_used and o.model_used not in s.models_used:
                s.models_used.append(o.model_used)
        return s


@dataclass
class Decision:
    context: str
    options: List[str]
    chosen: str
    reasoning: str
    intelligence_level: str = ""
    model_used: str = ""
    outcome: str = ""  # success | failure | "" (pending)
    timestamp: int = field(default_factory=lambda: int(time.time()))


class DecisionLogger:
    def __init__(self, capacity: int = 10_000):
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()

    def log(self, decision: Decision) -> None:
        with self._lock:
            self._ring.append(decision)
        obs.DECISIONS.labels(
            level=decision.intelligence_level or "unknown"
        ).inc()

    def recent(self, limit: int = 50) -> List[Decision]:
        with self._lock:
            return list(self._ring)[-limit:]

    def success_rate(self, context_filter: str = "") -> Optional[float]:
        with self._lock:
            relevant = [
                d
                for d in self._ring
                if d.outcome and (not context_filter or context_filter in d.context)
            ]
        if not relevant:
            return None
        return sum(1 for d in relevant if d.outcome == "success") / len(relevant)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)
