"""Cron-scheduled goals.

Reference parity (agent-core/src/scheduler.rs): SQLite-persisted schedule
entries, a 60 s tick, and a 5-field cron matcher supporting `*`, `*/n` and
comma lists (scheduler.rs:186-226); last_run persisted so restarts don't
double-fire (scheduler.rs:123-134).
"""

from __future__ import annotations

import sqlite3
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from ..obs import instruments as obs


def _field_matches(spec: str, value: int) -> bool:
    if spec == "*":
        return True
    for part in spec.split(","):
        part = part.strip()
        if part.startswith("*/"):
            try:
                step = int(part[2:])
            except ValueError:
                return False
            if step > 0 and value % step == 0:
                return True
        elif "-" in part:
            try:
                lo, hi = part.split("-", 1)
                if int(lo) <= value <= int(hi):
                    return True
            except ValueError:
                return False
        else:
            try:
                if int(part) == value:
                    return True
            except ValueError:
                return False
    return False


def matches_cron(expr: str, t: Optional[time.struct_time] = None) -> bool:
    """5-field cron: minute hour day-of-month month day-of-week."""
    fields = expr.split()
    if len(fields) != 5:
        return False
    t = t or time.localtime()
    minute, hour, dom, month, dow = fields
    return (
        _field_matches(minute, t.tm_min)
        and _field_matches(hour, t.tm_hour)
        and _field_matches(dom, t.tm_mday)
        and _field_matches(month, t.tm_mon)
        and _field_matches(dow, t.tm_wday)  # 0 = Monday (python convention)
    )


@dataclass
class ScheduleEntry:
    id: str
    cron_expr: str
    goal_template: str
    priority: int = 5
    enabled: bool = True
    last_run: int = 0


class GoalScheduler:
    def __init__(
        self,
        submit_goal: Callable[[str, int], object],
        db_path: str = ":memory:",
        tick_seconds: float = 60.0,
    ):
        self.submit_goal = submit_goal
        self.tick_seconds = tick_seconds
        self._conn = sqlite3.connect(db_path, check_same_thread=False)
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS schedules ("
            " id TEXT PRIMARY KEY, cron_expr TEXT, goal_template TEXT,"
            " priority INTEGER, enabled INTEGER, last_run INTEGER)"
        )
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def create(self, cron_expr: str, goal_template: str, priority: int = 5) -> str:
        if len(cron_expr.split()) != 5:
            raise ValueError(f"bad cron expression {cron_expr!r}")
        sid = str(uuid.uuid4())
        with self._lock:
            self._conn.execute(
                "INSERT INTO schedules VALUES (?,?,?,?,1,0)",
                (sid, cron_expr, goal_template, priority),
            )
            self._conn.commit()
        return sid

    def delete(self, schedule_id: str) -> bool:
        with self._lock:
            cur = self._conn.execute(
                "DELETE FROM schedules WHERE id=?", (schedule_id,)
            )
            self._conn.commit()
            return cur.rowcount > 0

    def list(self) -> List[ScheduleEntry]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT id, cron_expr, goal_template, priority, enabled,"
                " last_run FROM schedules"
            ).fetchall()
        return [
            ScheduleEntry(r[0], r[1], r[2], r[3], bool(r[4]), r[5]) for r in rows
        ]

    def tick(self, now: Optional[float] = None) -> int:
        """Fire matching schedules at most once per minute; returns count."""
        now = now or time.time()
        t = time.localtime(now)
        fired = 0
        for entry in self.list():
            if not entry.enabled:
                continue
            # don't double-fire within the same minute (scheduler.rs:123-134)
            if entry.last_run and int(now) - entry.last_run < 60:
                continue
            if matches_cron(entry.cron_expr, t):
                self.submit_goal(entry.goal_template, entry.priority)
                obs.SCHEDULER_FIRED.inc()
                with self._lock:
                    self._conn.execute(
                        "UPDATE schedules SET last_run=? WHERE id=?",
                        (int(now), entry.id),
                    )
                    self._conn.commit()
                fired += 1
        return fired

    def start(self) -> None:
        def loop():
            while not self._stop.wait(self.tick_seconds):
                try:
                    self.tick()
                except Exception:  # noqa: BLE001
                    pass

        self._thread = threading.Thread(target=loop, name="goal-scheduler",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
