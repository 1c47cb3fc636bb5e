"""Monthly budget tracking for cloud providers.

Reference parity (api-gateway/src/budget.rs:18-114): $100/month Claude,
$50/month OpenAI (env-overridable); cost model $3/$15 per Mtok in/out for
Claude, $2.50/$10 for OpenAI; free local/qwen3 paths; 80% spend warning;
automatic reset on month rollover. Usage records are queryable per provider
and day window (GetUsage RPC).
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List

from ..obs import instruments as obs

# (input $/Mtok, output $/Mtok)
COST_MODEL: Dict[str, tuple] = {
    "claude": (3.0, 15.0),
    "openai": (2.5, 10.0),
    "qwen3": (0.0, 0.0),
    "local": (0.0, 0.0),
}

WARN_FRACTION = 0.8


@dataclass
class UsageRecord:
    provider: str
    model: str
    input_tokens: int
    output_tokens: int
    cost_usd: float
    timestamp: int
    requesting_agent: str = ""
    task_id: str = ""


@dataclass
class BudgetManager:
    claude_budget: float = field(
        default_factory=lambda: float(os.environ.get("CLAUDE_MONTHLY_BUDGET", "100"))
    )
    openai_budget: float = field(
        default_factory=lambda: float(os.environ.get("OPENAI_MONTHLY_BUDGET", "50"))
    )

    def __post_init__(self):
        self._records: List[UsageRecord] = []
        self._month_key = self._current_month()
        self._lock = threading.Lock()

    @staticmethod
    def _current_month() -> str:
        return time.strftime("%Y-%m")

    def _maybe_reset(self) -> None:
        month = self._current_month()
        if month != self._month_key:
            self._records = [r for r in self._records if False]  # clear
            self._month_key = month

    def budget_for(self, provider: str) -> float:
        return {"claude": self.claude_budget, "openai": self.openai_budget}.get(
            provider, float("inf")
        )

    def used(self, provider: str) -> float:
        with self._lock:
            self._maybe_reset()
            return sum(r.cost_usd for r in self._records if r.provider == provider)

    def cost_of(self, provider: str, input_tokens: int, output_tokens: int) -> float:
        cin, cout = COST_MODEL.get(provider, (0.0, 0.0))
        return input_tokens / 1e6 * cin + output_tokens / 1e6 * cout

    def can_afford(self, provider: str, est_tokens: int = 2048) -> bool:
        budget = self.budget_for(provider)
        if budget == float("inf"):
            return True
        est_cost = self.cost_of(provider, est_tokens, est_tokens)
        return self.used(provider) + est_cost <= budget

    def record(
        self,
        provider: str,
        model: str,
        input_tokens: int,
        output_tokens: int,
        agent: str = "",
        task_id: str = "",
    ) -> UsageRecord:
        rec = UsageRecord(
            provider=provider,
            model=model,
            input_tokens=input_tokens,
            output_tokens=output_tokens,
            cost_usd=self.cost_of(provider, input_tokens, output_tokens),
            timestamp=int(time.time()),
            requesting_agent=agent,
            task_id=task_id,
        )
        with self._lock:
            self._maybe_reset()
            self._records.append(rec)
        # registry counters do NOT reset on month rollover (Prometheus
        # counters are monotonic; dashboards take increase() over windows)
        if rec.cost_usd:
            obs.GATEWAY_SPEND.labels(provider=provider).inc(rec.cost_usd)
        obs.GATEWAY_TOKENS.labels(
            provider=provider, direction="input"
        ).inc(input_tokens)
        obs.GATEWAY_TOKENS.labels(
            provider=provider, direction="output"
        ).inc(output_tokens)
        return rec

    def warning(self, provider: str) -> str:
        budget = self.budget_for(provider)
        if budget == float("inf"):
            return ""
        used = self.used(provider)
        if used >= budget:
            return f"{provider} monthly budget exhausted (${used:.2f}/${budget:.0f})"
        if used >= WARN_FRACTION * budget:
            return f"{provider} at {used / budget:.0%} of monthly budget"
        return ""

    def status(self) -> dict:
        now = time.localtime()
        import calendar

        days_in_month = calendar.monthrange(now.tm_year, now.tm_mon)[1]
        days_remaining = days_in_month - now.tm_mday
        claude_used = self.used("claude")
        openai_used = self.used("openai")
        total_used = claude_used + openai_used
        daily_rate = total_used / max(now.tm_mday, 1)
        return {
            "claude_monthly_budget_usd": self.claude_budget,
            "claude_used_usd": claude_used,
            "openai_monthly_budget_usd": self.openai_budget,
            "openai_used_usd": openai_used,
            "days_remaining": days_remaining,
            "daily_rate_usd": daily_rate,
            "budget_exceeded": (
                claude_used >= self.claude_budget or openai_used >= self.openai_budget
            ),
        }

    def usage(self, provider: str = "", days: int = 30) -> List[UsageRecord]:
        cutoff = int(time.time()) - days * 86400
        with self._lock:
            return [
                r
                for r in self._records
                if r.timestamp >= cutoff and (not provider or r.provider == provider)
            ]
