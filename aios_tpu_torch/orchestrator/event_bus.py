"""Event bus: pub/sub with goal-creating subscriptions.

Reference parity (agent-core/src/event_bus.rs): bounded queue (1000),
subscriptions {pattern, min_severity, goal_template with {event_type}/
{source} substitution} that auto-create goals on match (event_bus.rs:94-171),
and a ring of the 100 most recent events.
"""

from __future__ import annotations

import collections
import fnmatch
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

SEVERITIES = {"debug": 0, "info": 1, "warning": 2, "error": 3, "critical": 4}


@dataclass
class Event:
    event_type: str
    source: str
    severity: str = "info"
    data: Dict = field(default_factory=dict)
    timestamp: float = field(default_factory=time.time)


@dataclass
class Subscription:
    pattern: str  # fnmatch over event_type
    min_severity: str = "info"
    goal_template: str = ""  # "{event_type}"/"{source}" substituted
    priority: int = 5
    callback: Optional[Callable[[Event], None]] = None


class EventBus:
    def __init__(
        self,
        submit_goal: Optional[Callable[[str, int], object]] = None,
        capacity: int = 1000,
        recent: int = 100,
    ):
        self.submit_goal = submit_goal
        self._queue: collections.deque = collections.deque(maxlen=capacity)
        self._recent: collections.deque = collections.deque(maxlen=recent)
        self._subs: List[Subscription] = []
        self._lock = threading.Lock()
        self.published = 0
        self.goals_created = 0

    def subscribe(self, sub: Subscription) -> None:
        with self._lock:
            self._subs.append(sub)

    def publish(self, event: Event) -> None:
        with self._lock:
            self._queue.append(event)
            self._recent.append(event)
            self.published += 1
            subs = list(self._subs)
        sev = SEVERITIES.get(event.severity, 1)
        for sub in subs:
            if not fnmatch.fnmatch(event.event_type, sub.pattern):
                continue
            if sev < SEVERITIES.get(sub.min_severity, 1):
                continue
            if sub.callback is not None:
                try:
                    sub.callback(event)
                except Exception:  # noqa: BLE001
                    pass
            if sub.goal_template and self.submit_goal is not None:
                description = sub.goal_template.format(
                    event_type=event.event_type, source=event.source
                )
                self.submit_goal(description, sub.priority)
                self.goals_created += 1

    def recent_events(self, limit: int = 100) -> List[Event]:
        with self._lock:
            return list(self._recent)[-limit:]
