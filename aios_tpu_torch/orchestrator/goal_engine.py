"""Goal lifecycle engine with SQLite persistence and crash recovery.

Reference parity (agent-core/src/goal_engine.rs):
  * goal states pending -> planning -> in_progress -> completed/failed/
    cancelled; task states pending/assigned/in_progress/completed/failed;
  * in-memory cache + SQLite WAL persistence (tables goals/tasks/messages,
    goal_engine.rs:48-97) at a configurable path;
  * per-goal conversation threads (GoalMessage, goal_engine.rs:17-23) for
    the awaiting_input flow;
  * crash recovery: on restart, in_progress tasks reset to pending and
    unfinished goals reload into the planner (get_all_resumable_tasks,
    goal_engine.rs:493-518);
  * progress = fraction of completed tasks (goal_engine.rs:272-286).
"""

from __future__ import annotations

import json
import logging
import sqlite3
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional

log = logging.getLogger("aios.goals")

GOAL_STATES = ("pending", "planning", "in_progress", "completed", "failed",
               "cancelled")
TASK_STATES = ("pending", "assigned", "in_progress", "completed", "failed",
               "cancelled")
TERMINAL_GOAL = ("completed", "failed", "cancelled")
TERMINAL_TASK = ("completed", "failed", "cancelled")


def _now() -> int:
    return int(time.time())


@dataclass
class Goal:
    id: str
    description: str
    priority: int = 5
    source: str = "user"
    status: str = "pending"
    created_at: int = field(default_factory=_now)
    updated_at: int = field(default_factory=_now)
    tags: List[str] = field(default_factory=list)
    metadata: Dict = field(default_factory=dict)


@dataclass
class Task:
    id: str
    goal_id: str
    description: str
    assigned_agent: str = ""
    status: str = "pending"
    intelligence_level: str = "operational"
    required_tools: List[str] = field(default_factory=list)
    depends_on: List[str] = field(default_factory=list)
    input: Dict = field(default_factory=dict)
    output: Dict = field(default_factory=dict)
    created_at: int = field(default_factory=_now)
    started_at: int = 0
    completed_at: int = 0
    error: str = ""


@dataclass
class GoalMessage:
    goal_id: str
    role: str  # user | assistant | system
    content: str
    timestamp: int = field(default_factory=_now)


_SCHEMA = """
CREATE TABLE IF NOT EXISTS goals (
    id TEXT PRIMARY KEY, description TEXT, priority INTEGER, source TEXT,
    status TEXT, created_at INTEGER, updated_at INTEGER, tags TEXT,
    metadata TEXT
);
CREATE TABLE IF NOT EXISTS tasks (
    id TEXT PRIMARY KEY, goal_id TEXT, description TEXT, assigned_agent TEXT,
    status TEXT, intelligence_level TEXT, required_tools TEXT, depends_on TEXT,
    input TEXT, output TEXT, created_at INTEGER, started_at INTEGER,
    completed_at INTEGER, error TEXT
);
CREATE TABLE IF NOT EXISTS messages (
    seq INTEGER PRIMARY KEY AUTOINCREMENT, goal_id TEXT, role TEXT,
    content TEXT, timestamp INTEGER
);
CREATE INDEX IF NOT EXISTS idx_tasks_goal ON tasks(goal_id);
CREATE INDEX IF NOT EXISTS idx_messages_goal ON messages(goal_id);
"""


class GoalEngine:
    """In-memory cache over SQLite; all mutations write through."""

    def __init__(self, db_path: str = ":memory:"):
        self._conn = sqlite3.connect(db_path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.executescript(_SCHEMA)
        self._lock = threading.RLock()
        self.goals: Dict[str, Goal] = {}
        self.tasks: Dict[str, Task] = {}
        self._load()

    # -- persistence --------------------------------------------------------

    def _load(self) -> None:
        with self._lock:
            for row in self._conn.execute(
                "SELECT id, description, priority, source, status, created_at,"
                " updated_at, tags, metadata FROM goals"
            ):
                self.goals[row[0]] = Goal(
                    id=row[0], description=row[1], priority=row[2],
                    source=row[3], status=row[4], created_at=row[5],
                    updated_at=row[6], tags=json.loads(row[7] or "[]"),
                    metadata=json.loads(row[8] or "{}"),
                )
            for row in self._conn.execute(
                "SELECT id, goal_id, description, assigned_agent, status,"
                " intelligence_level, required_tools, depends_on, input,"
                " output, created_at, started_at, completed_at, error FROM tasks"
            ):
                self.tasks[row[0]] = Task(
                    id=row[0], goal_id=row[1], description=row[2],
                    assigned_agent=row[3], status=row[4],
                    intelligence_level=row[5],
                    required_tools=json.loads(row[6] or "[]"),
                    depends_on=json.loads(row[7] or "[]"),
                    input=json.loads(row[8] or "{}"),
                    output=json.loads(row[9] or "{}"),
                    created_at=row[10], started_at=row[11],
                    completed_at=row[12], error=row[13],
                )

    def _persist_goal(self, g: Goal) -> None:
        self._conn.execute(
            "INSERT OR REPLACE INTO goals VALUES (?,?,?,?,?,?,?,?,?)",
            (g.id, g.description, g.priority, g.source, g.status, g.created_at,
             g.updated_at, json.dumps(g.tags), json.dumps(g.metadata)),
        )
        self._conn.commit()

    def _persist_task(self, t: Task) -> None:
        self._conn.execute(
            "INSERT OR REPLACE INTO tasks VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
            (t.id, t.goal_id, t.description, t.assigned_agent, t.status,
             t.intelligence_level, json.dumps(t.required_tools),
             json.dumps(t.depends_on), json.dumps(t.input),
             json.dumps(t.output), t.created_at, t.started_at, t.completed_at,
             t.error),
        )
        self._conn.commit()

    # -- goals --------------------------------------------------------------

    def submit_goal(
        self,
        description: str,
        priority: int = 5,
        source: str = "user",
        tags: Optional[List[str]] = None,
        metadata: Optional[Dict] = None,
    ) -> Goal:
        goal = Goal(
            id=str(uuid.uuid4()),
            description=description,
            priority=priority,
            source=source,
            tags=tags or [],
            metadata=metadata or {},
        )
        with self._lock:
            self.goals[goal.id] = goal
            self._persist_goal(goal)
        return goal

    def set_goal_status(self, goal_id: str, status: str) -> None:
        assert status in GOAL_STATES, status
        with self._lock:
            g = self.goals.get(goal_id)
            if g is None:
                return
            if g.status in TERMINAL_GOAL:
                # terminal goals are final: CancelGoal can land during the
                # planner's slow AI decomposition, and the subsequent
                # add_tasks -> "in_progress" write must not resurrect the
                # cancelled goal (its tasks would start dispatching)
                log.info(
                    "ignoring %s -> %s for terminal goal %s",
                    g.status, status, goal_id,
                )
                return
            g.status = status
            g.updated_at = _now()
            self._persist_goal(g)

    def is_abandoned(self, task_id: str, goal_id: str) -> bool:
        """True when the goal or the task reached a terminal state — the
        signal a long-running executor (the reasoning loop) checks between
        rounds to stop working for a dead goal."""
        with self._lock:
            g = self.goals.get(goal_id)
            t = self.tasks.get(task_id)
        if g is not None and g.status in TERMINAL_GOAL:
            return True
        return t is not None and t.status in TERMINAL_TASK

    def cancel_goal(self, goal_id: str) -> bool:
        with self._lock:
            g = self.goals.get(goal_id)
            if g is None or g.status in TERMINAL_GOAL:
                return False
            g.status = "cancelled"
            g.updated_at = _now()
            self._persist_goal(g)
            for t in self.tasks_for_goal(goal_id):
                if t.status not in TERMINAL_TASK:
                    t.status = "cancelled"
                    self._persist_task(t)
            return True

    def list_goals(
        self, status_filter: str = "", limit: int = 100, offset: int = 0
    ) -> List[Goal]:
        with self._lock:
            goals = sorted(
                self.goals.values(), key=lambda g: g.created_at, reverse=True
            )
        if status_filter:
            goals = [g for g in goals if g.status == status_filter]
        return goals[offset : offset + limit]

    def active_goals(self) -> List[Goal]:
        with self._lock:
            return [
                g for g in self.goals.values() if g.status not in TERMINAL_GOAL
            ]

    def set_metadata(self, goal_id: str, key: str, value) -> None:
        with self._lock:
            g = self.goals.get(goal_id)
            if g is None:
                return
            g.metadata[key] = value
            self._persist_goal(g)

    def progress(self, goal_id: str) -> float:
        tasks = self.tasks_for_goal(goal_id)
        if not tasks:
            return 0.0
        done = sum(1 for t in tasks if t.status == "completed")
        return done / len(tasks) * 100.0

    # -- tasks --------------------------------------------------------------

    def add_tasks(self, goal_id: str, tasks: List[Task]) -> None:
        with self._lock:
            goal = self.goals.get(goal_id)
            dead = goal is not None and goal.status in TERMINAL_GOAL
            for t in tasks:
                if dead:
                    # the goal was cancelled while the planner decomposed
                    # it: record its tasks as cancelled, not as pending
                    # strays under a terminal goal
                    t.status = "cancelled"
                    t.completed_at = _now()
                self.tasks[t.id] = t
                self._persist_task(t)
            if goal is not None and tasks and not dead:
                self.set_goal_status(goal_id, "in_progress")

    def tasks_for_goal(self, goal_id: str) -> List[Task]:
        with self._lock:
            return sorted(
                (t for t in self.tasks.values() if t.goal_id == goal_id),
                key=lambda t: t.created_at,
            )

    def set_task_status(
        self, task_id: str, status: str, error: str = "",
        output: Optional[Dict] = None, agent: str = "",
    ) -> None:
        assert status in TASK_STATES, status
        with self._lock:
            t = self.tasks.get(task_id)
            if t is None:
                return
            if t.status in TERMINAL_TASK:
                # terminal states are final — name AND payload: a late or
                # duplicate ReportTaskResult (agent retry after a dropped
                # response) must neither resurrect a cancelled task nor
                # overwrite the first report's output/error/completed_at
                log.info(
                    "ignoring %s -> %s for terminal task %s",
                    t.status, status, task_id,
                )
                return
            t.status = status
            if agent:
                t.assigned_agent = agent
            if status == "in_progress" and not t.started_at:
                t.started_at = _now()
            if status in TERMINAL_TASK:
                t.completed_at = _now()
            if error:
                t.error = error
            if output is not None:
                t.output = output
            self._persist_task(t)

    def complete_task(self, task_id: str, output: Optional[Dict] = None) -> None:
        self.set_task_status(task_id, "completed", output=output)

    def unblocked_pending_tasks(self, limit: int = 3) -> List[Task]:
        """Pending tasks whose dependencies are all completed, priority order
        (task_planner.rs next_tasks:755-768)."""
        with self._lock:
            out = []
            for t in self.tasks.values():
                if t.status != "pending":
                    continue
                goal = self.goals.get(t.goal_id)
                if goal is None or goal.status in TERMINAL_GOAL:
                    continue
                deps_done = all(
                    self.tasks.get(d) is not None
                    and self.tasks[d].status == "completed"
                    for d in t.depends_on
                )
                if deps_done:
                    out.append(t)
            out.sort(
                key=lambda t: (
                    -(self.goals[t.goal_id].priority if t.goal_id in self.goals else 0),
                    t.created_at,
                )
            )
            return out[:limit]

    def check_goal_completion(self, goal_id: str) -> Optional[str]:
        """completed when all tasks done; failed if any task failed
        (autonomy.rs:709-733 housekeeping)."""
        tasks = self.tasks_for_goal(goal_id)
        if not tasks:
            return None
        if any(t.status == "failed" for t in tasks):
            self.set_goal_status(goal_id, "failed")
            return "failed"
        if all(t.status == "completed" for t in tasks):
            self.set_goal_status(goal_id, "completed")
            return "completed"
        return None

    # -- conversation threads ----------------------------------------------

    def add_message(self, goal_id: str, role: str, content: str) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT INTO messages (goal_id, role, content, timestamp)"
                " VALUES (?,?,?,?)",
                (goal_id, role, content, _now()),
            )
            self._conn.commit()

    def messages_for_goal(self, goal_id: str, limit: int = 50) -> List[GoalMessage]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT goal_id, role, content, timestamp FROM messages"
                " WHERE goal_id=? ORDER BY seq DESC LIMIT ?",
                (goal_id, limit),
            ).fetchall()
        return [GoalMessage(*r) for r in reversed(rows)]

    def count_messages(self, goal_id: str, role: str = "") -> int:
        with self._lock:
            if role:
                row = self._conn.execute(
                    "SELECT COUNT(*) FROM messages WHERE goal_id=? AND role=?",
                    (goal_id, role),
                ).fetchone()
            else:
                row = self._conn.execute(
                    "SELECT COUNT(*) FROM messages WHERE goal_id=?", (goal_id,)
                ).fetchone()
        return row[0]

    # -- crash recovery -----------------------------------------------------

    def recover(self) -> int:
        """in_progress/assigned tasks -> pending on restart
        (goal_engine.rs:493-518)."""
        n = 0
        with self._lock:
            for t in self.tasks.values():
                if t.status in ("in_progress", "assigned"):
                    t.status = "pending"
                    t.assigned_agent = ""
                    self._persist_task(t)
                    n += 1
        return n
