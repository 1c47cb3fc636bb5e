"""Token-bucket rate limiting: per-agent and per-tool.

Reference parity (tools/src/executor.rs:52-104): 10 requests/sec per agent,
50 requests/sec per tool, refilled continuously.
"""

from __future__ import annotations

import threading
import time
from typing import Dict

AGENT_RPS = 10.0
TOOL_RPS = 50.0


class TokenBucket:
    def __init__(self, rate: float, capacity: float | None = None):
        self.rate = rate
        self.capacity = capacity if capacity is not None else rate
        self.tokens = self.capacity
        self.updated = time.monotonic()
        self._lock = threading.Lock()

    def try_acquire(self, n: float = 1.0) -> bool:
        with self._lock:
            now = time.monotonic()
            self.tokens = min(self.capacity, self.tokens + (now - self.updated) * self.rate)
            self.updated = now
            if self.tokens >= n:
                self.tokens -= n
                return True
            return False


def _make_bucket(rate: float):
    """Native C++ bucket when the library is built, Python otherwise."""
    try:
        from .. import native

        if native.available():
            return native.NativeTokenBucket(rate)
    except Exception:  # noqa: BLE001 — fall back silently
        pass
    return TokenBucket(rate)


class RateLimiter:
    def __init__(self, agent_rps: float = AGENT_RPS, tool_rps: float = TOOL_RPS):
        self.agent_rps = agent_rps
        self.tool_rps = tool_rps
        self._agents: Dict[str, object] = {}
        self._tools: Dict[str, object] = {}
        self._lock = threading.Lock()
        # Pay the native-library build/load at construction (service start),
        # not inside check()'s lock on the first request — a cold g++ compile
        # there would stall every concurrent tool call for seconds.
        try:
            from .. import native

            native.load()
        except Exception:  # noqa: BLE001
            pass

    def check(self, agent_id: str, tool_name: str) -> tuple[bool, str]:
        with self._lock:
            ab = self._agents.setdefault(agent_id, _make_bucket(self.agent_rps))
            tb = self._tools.setdefault(tool_name, _make_bucket(self.tool_rps))
        if not ab.try_acquire():
            return False, f"agent {agent_id} rate limit exceeded ({self.agent_rps}/s)"
        if not tb.try_acquire():
            return False, f"tool {tool_name} rate limit exceeded ({self.tool_rps}/s)"
        return True, ""
