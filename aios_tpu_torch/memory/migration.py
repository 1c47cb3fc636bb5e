"""Tier migration pipeline.

Reference parity (memory/src/migration.rs:1-50):
  * finished working-tier goals migrate to long-term after 1 hour;
  * operational events migrate to long-term after 24 hours;
  * successful goals with their tasks are distilled into procedures;
  * patterns pruned at 1000; long-term capped at 365 days.

Runs as a background thread with a configurable period (the reference runs
it inside the memory service process the same way).
"""

from __future__ import annotations

import json
import threading
from typing import Optional

from .tiers import LongTermMemory, OperationalMemory, WorkingMemory

WORKING_TO_LONGTERM_AGE = 3600  # 1 h
OPERATIONAL_TO_LONGTERM_AGE = 86400  # 24 h


class MigrationPipeline:
    def __init__(
        self,
        operational: OperationalMemory,
        working: WorkingMemory,
        longterm: LongTermMemory,
        period_seconds: float = 300.0,
    ):
        self.operational = operational
        self.working = working
        self.longterm = longterm
        self.period = period_seconds
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def run_once(self) -> dict:
        """One migration pass; returns counters (also used by tests)."""
        stats = {"goals": 0, "events": 0, "procedures": 0, "patterns_pruned": 0}

        # finished goals -> long-term memories (+ procedure extraction)
        for goal in self.working.finished_goals_older_than(WORKING_TO_LONGTERM_AGE):
            tasks = self.working.tasks_for_goal(goal["id"])
            summary = (
                f"goal '{goal['description']}' {goal['status']}"
                f" with {len(tasks)} task(s); result: {goal.get('result','')}"
            )
            self.longterm.store_memory(
                summary,
                collection="goal_history",
                metadata={"goal_id": goal["id"], "status": goal["status"]},
            )
            stats["goals"] += 1
            if goal["status"] == "completed" and tasks:
                steps = [
                    {"description": t["description"], "agent": t["agent"]}
                    for t in tasks
                ]
                self.longterm.store_procedure(
                    {
                        "name": goal["description"][:80],
                        "description": f"extracted from goal {goal['id']}",
                        "steps_json": json.dumps(steps),
                        "success_count": 1,
                    }
                )
                stats["procedures"] += 1
            self.working.delete_goal(goal["id"])

        # old operational events -> long-term
        for ev in self.operational.drain_older_than(OPERATIONAL_TO_LONGTERM_AGE):
            self.longterm.store_memory(
                f"event {ev.get('category','')}/{ev.get('source','')}: "
                f"{ev.get('data_json','')}",
                collection="events",
                metadata={"critical": ev.get("critical", False)},
            )
            stats["events"] += 1

        stats["patterns_pruned"] = self.working.prune_patterns()
        self.working.retention_sweep()
        self.longterm.retention_sweep()
        return stats

    def start(self) -> None:
        def loop():
            while not self._stop.wait(self.period):
                try:
                    self.run_once()
                except Exception:  # noqa: BLE001 — keep the pipeline alive
                    pass

        self._thread = threading.Thread(target=loop, name="memory-migration", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
