"""The three memory tiers + knowledge base.

Reference parity (memory/src/):
  * operational (operational.rs): in-process ring buffer of events + metric
    map; target <1 ms access — pure python structures under a lock.
  * working (working.rs): SQLite WAL, tables goals/tasks/tool_calls/
    decisions/patterns/agent_state; 30-day retention.
  * long-term (longterm.rs): SQLite + hash embeddings (embeddings.py) with
    hybrid keyword/vector search; stores memories/procedures/incidents/
    config changes; collections are search-filterable.
  * knowledge (knowledge.rs): same embedding scheme, separate table.

All SQLite handles are per-tier connections with WAL enabled, guarded by a
lock (sqlite connections are not thread-safe under the default isolation;
the reference wraps its !Send connection in a Mutex the same way,
goal_engine.rs:30-31).
"""

from __future__ import annotations

import collections
import json
import sqlite3
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..obs import instruments as obs
from .embeddings import embed, rank


def _lookup(tier: str, hit: bool) -> None:
    """Per-tier hit/miss accounting: a lookup that returns something is a
    hit, an empty result a miss (the tier-efficiency signal the migration
    policy and dashboards watch)."""
    obs.MEMORY_TIER_LOOKUPS.labels(
        tier=tier, result="hit" if hit else "miss"
    ).inc()

RING_CAPACITY = 10_000
WORKING_RETENTION_DAYS = 30
LONGTERM_RETENTION_DAYS = 365
PATTERN_CAP = 1_000


def _now() -> int:
    return int(time.time())


# ---------------------------------------------------------------------------
# Operational tier
# ---------------------------------------------------------------------------


@dataclass
class OperationalMemory:
    """Hot tier: bounded event ring + last-value metric map."""

    capacity: int = RING_CAPACITY
    _events: collections.deque = field(default_factory=collections.deque)
    _metrics: Dict[str, Tuple[float, int]] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def push_event(self, event: Dict[str, Any]) -> None:
        with self._lock:
            if not event.get("id"):
                event["id"] = str(uuid.uuid4())
            if not event.get("timestamp"):
                event["timestamp"] = _now()
            self._events.append(event)
            while len(self._events) > self.capacity:
                self._events.popleft()

    def recent_events(
        self, count: int = 50, category: str = "", source: str = ""
    ) -> List[Dict[str, Any]]:
        with self._lock:
            out = []
            for ev in reversed(self._events):
                if category and ev.get("category") != category:
                    continue
                if source and ev.get("source") != source:
                    continue
                out.append(ev)
                if len(out) >= count:
                    break
            return out

    def drain_older_than(self, age_seconds: int) -> List[Dict[str, Any]]:
        """Remove and return events older than ``age_seconds`` (migration)."""
        cutoff = _now() - age_seconds
        with self._lock:
            old, keep = [], collections.deque()
            for ev in self._events:
                (old if ev.get("timestamp", 0) < cutoff else keep).append(ev)
            self._events = keep
            return old

    def update_metric(self, key: str, value: float, timestamp: int = 0) -> None:
        with self._lock:
            self._metrics[key] = (value, timestamp or _now())

    def get_metric(self, key: str) -> Optional[Tuple[float, int]]:
        with self._lock:
            value = self._metrics.get(key)
        _lookup("operational", value is not None)
        return value

    def all_metrics(self) -> Dict[str, Tuple[float, int]]:
        with self._lock:
            return dict(self._metrics)


# ---------------------------------------------------------------------------
# Working tier
# ---------------------------------------------------------------------------

_WORKING_SCHEMA = """
CREATE TABLE IF NOT EXISTS goals (
    id TEXT PRIMARY KEY, description TEXT, status TEXT, priority INTEGER,
    created_at INTEGER, completed_at INTEGER, result TEXT, metadata_json TEXT
);
CREATE TABLE IF NOT EXISTS tasks (
    id TEXT PRIMARY KEY, goal_id TEXT, description TEXT, agent TEXT,
    status TEXT, input_json TEXT, output_json TEXT,
    started_at INTEGER, completed_at INTEGER, duration_ms INTEGER, error TEXT
);
CREATE TABLE IF NOT EXISTS tool_calls (
    id TEXT PRIMARY KEY, task_id TEXT, tool_name TEXT, agent TEXT,
    input_json TEXT, output_json TEXT, success INTEGER,
    duration_ms INTEGER, reason TEXT, timestamp INTEGER
);
CREATE TABLE IF NOT EXISTS decisions (
    id TEXT PRIMARY KEY, context TEXT, options_json TEXT, chosen TEXT,
    reasoning TEXT, intelligence_level TEXT, model_used TEXT,
    outcome TEXT, timestamp INTEGER
);
CREATE TABLE IF NOT EXISTS patterns (
    id TEXT PRIMARY KEY, trigger TEXT, action TEXT, success_rate REAL,
    uses INTEGER, last_used INTEGER, created_from TEXT
);
CREATE TABLE IF NOT EXISTS agent_state (
    agent_name TEXT PRIMARY KEY, state_json TEXT, updated_at INTEGER
);
CREATE INDEX IF NOT EXISTS idx_tasks_goal ON tasks(goal_id);
CREATE INDEX IF NOT EXISTS idx_patterns_trigger ON patterns(trigger);
"""


class WorkingMemory:
    """Warm tier: SQLite WAL; goal/task/tool-call/decision/pattern records."""

    def __init__(self, path: str = ":memory:"):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.executescript(_WORKING_SCHEMA)
        self._lock = threading.Lock()

    def _exec(self, sql: str, args: tuple = ()):
        with self._lock:
            cur = self._conn.execute(sql, args)
            self._conn.commit()
            return cur

    def _query(self, sql: str, args: tuple = ()) -> List[tuple]:
        with self._lock:
            return self._conn.execute(sql, args).fetchall()

    # goals
    def store_goal(self, g: Dict[str, Any]) -> None:
        self._exec(
            "INSERT OR REPLACE INTO goals VALUES (?,?,?,?,?,?,?,?)",
            (
                g["id"],
                g.get("description", ""),
                g.get("status", "pending"),
                g.get("priority", 5),
                g.get("created_at") or _now(),
                g.get("completed_at", 0),
                g.get("result", ""),
                g.get("metadata_json", ""),
            ),
        )

    def update_goal(self, goal_id: str, status: str, result: str = "") -> None:
        completed = _now() if status in ("completed", "failed", "cancelled") else 0
        self._exec(
            "UPDATE goals SET status=?, result=?, "
            "completed_at=CASE WHEN ?>0 THEN ? ELSE completed_at END WHERE id=?",
            (status, result, completed, completed, goal_id),
        )

    def active_goals(self) -> List[Dict[str, Any]]:
        rows = self._query(
            "SELECT id, description, status, priority, created_at, completed_at,"
            " result, metadata_json FROM goals"
            " WHERE status IN ('pending','planning','in_progress')"
            " ORDER BY priority DESC, created_at"
        )
        keys = [
            "id", "description", "status", "priority",
            "created_at", "completed_at", "result", "metadata_json",
        ]
        return [dict(zip(keys, r)) for r in rows]

    def finished_goals_older_than(self, age_seconds: int) -> List[Dict[str, Any]]:
        cutoff = _now() - age_seconds
        rows = self._query(
            "SELECT id, description, status, result, completed_at FROM goals"
            " WHERE status IN ('completed','failed')"
            " AND completed_at > 0 AND completed_at < ?",
            (cutoff,),
        )
        return [
            dict(zip(["id", "description", "status", "result", "completed_at"], r))
            for r in rows
        ]

    def delete_goal(self, goal_id: str) -> None:
        self._exec("DELETE FROM goals WHERE id=?", (goal_id,))
        self._exec("DELETE FROM tasks WHERE goal_id=?", (goal_id,))

    # tasks
    def store_task(self, t: Dict[str, Any]) -> None:
        self._exec(
            "INSERT OR REPLACE INTO tasks VALUES (?,?,?,?,?,?,?,?,?,?,?)",
            (
                t["id"],
                t.get("goal_id", ""),
                t.get("description", ""),
                t.get("agent", ""),
                t.get("status", "pending"),
                t.get("input_json", ""),
                t.get("output_json", ""),
                t.get("started_at", 0),
                t.get("completed_at", 0),
                t.get("duration_ms", 0),
                t.get("error", ""),
            ),
        )

    def tasks_for_goal(self, goal_id: str) -> List[Dict[str, Any]]:
        rows = self._query(
            "SELECT id, goal_id, description, agent, status, input_json,"
            " output_json, started_at, completed_at, duration_ms, error"
            " FROM tasks WHERE goal_id=?",
            (goal_id,),
        )
        keys = [
            "id", "goal_id", "description", "agent", "status", "input_json",
            "output_json", "started_at", "completed_at", "duration_ms", "error",
        ]
        return [dict(zip(keys, r)) for r in rows]

    # tool calls / decisions
    def store_tool_call(self, c: Dict[str, Any]) -> None:
        self._exec(
            "INSERT OR REPLACE INTO tool_calls VALUES (?,?,?,?,?,?,?,?,?,?)",
            (
                c.get("id") or str(uuid.uuid4()),
                c.get("task_id", ""),
                c.get("tool_name", ""),
                c.get("agent", ""),
                c.get("input_json", ""),
                c.get("output_json", ""),
                1 if c.get("success") else 0,
                c.get("duration_ms", 0),
                c.get("reason", ""),
                c.get("timestamp") or _now(),
            ),
        )

    def store_decision(self, d: Dict[str, Any]) -> None:
        self._exec(
            "INSERT OR REPLACE INTO decisions VALUES (?,?,?,?,?,?,?,?,?)",
            (
                d.get("id") or str(uuid.uuid4()),
                d.get("context", ""),
                d.get("options_json", ""),
                d.get("chosen", ""),
                d.get("reasoning", ""),
                d.get("intelligence_level", ""),
                d.get("model_used", ""),
                d.get("outcome", ""),
                d.get("timestamp") or _now(),
            ),
        )

    def recent_decisions(self, limit: int = 20) -> List[Dict[str, Any]]:
        rows = self._query(
            "SELECT context, chosen, reasoning, outcome, timestamp FROM decisions"
            " ORDER BY timestamp DESC LIMIT ?",
            (limit,),
        )
        keys = ["context", "chosen", "reasoning", "outcome", "timestamp"]
        return [dict(zip(keys, r)) for r in rows]

    # patterns
    def store_pattern(self, p: Dict[str, Any]) -> None:
        self._exec(
            "INSERT OR REPLACE INTO patterns VALUES (?,?,?,?,?,?,?)",
            (
                p.get("id") or str(uuid.uuid4()),
                p.get("trigger", ""),
                p.get("action", ""),
                p.get("success_rate", 0.0),
                p.get("uses", 0),
                p.get("last_used", 0),
                p.get("created_from", ""),
            ),
        )

    def find_pattern(
        self, trigger: str, min_success_rate: float = 0.0
    ) -> Optional[Dict[str, Any]]:
        rows = self._query(
            "SELECT id, trigger, action, success_rate, uses, last_used,"
            " created_from FROM patterns"
            " WHERE trigger LIKE ? AND success_rate >= ?"
            " ORDER BY success_rate DESC, uses DESC LIMIT 1",
            (f"%{trigger}%", min_success_rate),
        )
        _lookup("working", bool(rows))
        if not rows:
            return None
        keys = ["id", "trigger", "action", "success_rate", "uses", "last_used",
                "created_from"]
        return dict(zip(keys, rows[0]))

    def update_pattern_stats(self, pattern_id: str, success: bool) -> None:
        row = self._query(
            "SELECT success_rate, uses FROM patterns WHERE id=?", (pattern_id,)
        )
        if not row:
            return
        rate, uses = row[0]
        new_rate = (rate * uses + (1.0 if success else 0.0)) / (uses + 1)
        self._exec(
            "UPDATE patterns SET success_rate=?, uses=?, last_used=? WHERE id=?",
            (new_rate, uses + 1, _now(), pattern_id),
        )

    def prune_patterns(self, cap: int = PATTERN_CAP) -> int:
        """Keep the best `cap` patterns (migration.rs pattern pruning)."""
        n = self._query("SELECT COUNT(*) FROM patterns")[0][0]
        if n <= cap:
            return 0
        self._exec(
            "DELETE FROM patterns WHERE id NOT IN ("
            " SELECT id FROM patterns ORDER BY success_rate DESC, uses DESC"
            " LIMIT ?)",
            (cap,),
        )
        return n - cap

    # agent state
    def store_agent_state(self, name: str, state_json: str) -> None:
        self._exec(
            "INSERT OR REPLACE INTO agent_state VALUES (?,?,?)",
            (name, state_json, _now()),
        )

    def get_agent_state(self, name: str) -> Optional[Tuple[str, int]]:
        rows = self._query(
            "SELECT state_json, updated_at FROM agent_state WHERE agent_name=?",
            (name,),
        )
        _lookup("working", bool(rows))
        return (rows[0][0], rows[0][1]) if rows else None

    def retention_sweep(self, days: int = WORKING_RETENTION_DAYS) -> None:
        cutoff = _now() - days * 86400
        self._exec(
            "DELETE FROM tool_calls WHERE timestamp < ?", (cutoff,)
        )
        self._exec("DELETE FROM decisions WHERE timestamp < ?", (cutoff,))


# ---------------------------------------------------------------------------
# Long-term tier + knowledge base
# ---------------------------------------------------------------------------

_LONGTERM_SCHEMA = """
CREATE TABLE IF NOT EXISTS memories (
    id TEXT PRIMARY KEY, collection TEXT, content TEXT,
    metadata_json TEXT, embedding BLOB, created_at INTEGER
);
CREATE TABLE IF NOT EXISTS procedures (
    id TEXT PRIMARY KEY, name TEXT, description TEXT, steps_json TEXT,
    success_count INTEGER, fail_count INTEGER, avg_duration_ms INTEGER,
    tags TEXT, created_at INTEGER, last_used INTEGER, embedding BLOB
);
CREATE TABLE IF NOT EXISTS incidents (
    id TEXT PRIMARY KEY, description TEXT, symptoms_json TEXT,
    root_cause TEXT, resolution TEXT, resolved_by TEXT, prevention TEXT,
    timestamp INTEGER, embedding BLOB
);
CREATE TABLE IF NOT EXISTS config_changes (
    id TEXT PRIMARY KEY, file_path TEXT, content TEXT, changed_by TEXT,
    reason TEXT, timestamp INTEGER
);
CREATE TABLE IF NOT EXISTS knowledge (
    id TEXT PRIMARY KEY, title TEXT, content TEXT, source TEXT,
    tags TEXT, embedding BLOB, created_at INTEGER
);
CREATE INDEX IF NOT EXISTS idx_memories_coll ON memories(collection);
"""


class LongTermMemory:
    """Cold tier: SQLite + hash-embedding vectors, hybrid search."""

    def __init__(self, path: str = ":memory:"):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.executescript(_LONGTERM_SCHEMA)
        self._lock = threading.Lock()

    def _exec(self, sql: str, args: tuple = ()):
        with self._lock:
            cur = self._conn.execute(sql, args)
            self._conn.commit()
            return cur

    def _query(self, sql: str, args: tuple = ()) -> List[tuple]:
        with self._lock:
            return self._conn.execute(sql, args).fetchall()

    def store_memory(
        self,
        content: str,
        collection: str = "general",
        metadata: Optional[Dict[str, Any]] = None,
        memory_id: str = "",
    ) -> str:
        memory_id = memory_id or str(uuid.uuid4())
        vec = embed(content)
        self._exec(
            "INSERT OR REPLACE INTO memories VALUES (?,?,?,?,?,?)",
            (
                memory_id,
                collection,
                content,
                json.dumps(metadata or {}),
                vec.tobytes(),
                _now(),
            ),
        )
        return memory_id

    def search(
        self,
        query: str,
        collections: Optional[List[str]] = None,
        n_results: int = 5,
        min_relevance: float = 0.0,
    ) -> List[Dict[str, Any]]:
        if collections:
            marks = ",".join("?" * len(collections))
            rows = self._query(
                f"SELECT id, collection, content, metadata_json, embedding"
                f" FROM memories WHERE collection IN ({marks})",
                tuple(collections),
            )
        else:
            rows = self._query(
                "SELECT id, collection, content, metadata_json, embedding"
                " FROM memories"
            )
        texts = [r[2] for r in rows]
        vecs = [np.frombuffer(r[4], dtype=np.float32) for r in rows]
        out = []
        for idx, score in rank(query, texts, vecs)[:n_results]:
            if score < min_relevance:
                continue
            r = rows[idx]
            out.append(
                {
                    "id": r[0],
                    "collection": r[1],
                    "content": r[2],
                    "metadata_json": r[3],
                    "relevance": score,
                }
            )
        _lookup("longterm", bool(out))
        return out

    def store_procedure(self, p: Dict[str, Any]) -> None:
        text = f"{p.get('name','')} {p.get('description','')}"
        self._exec(
            "INSERT OR REPLACE INTO procedures VALUES (?,?,?,?,?,?,?,?,?,?,?)",
            (
                p.get("id") or str(uuid.uuid4()),
                p.get("name", ""),
                p.get("description", ""),
                p.get("steps_json", ""),
                p.get("success_count", 0),
                p.get("fail_count", 0),
                p.get("avg_duration_ms", 0),
                json.dumps(p.get("tags", [])),
                p.get("created_at") or _now(),
                p.get("last_used", 0),
                embed(text).tobytes(),
            ),
        )

    def store_incident(self, inc: Dict[str, Any]) -> None:
        text = f"{inc.get('description','')} {inc.get('root_cause','')}"
        self._exec(
            "INSERT OR REPLACE INTO incidents VALUES (?,?,?,?,?,?,?,?,?)",
            (
                inc.get("id") or str(uuid.uuid4()),
                inc.get("description", ""),
                inc.get("symptoms_json", ""),
                inc.get("root_cause", ""),
                inc.get("resolution", ""),
                inc.get("resolved_by", ""),
                inc.get("prevention", ""),
                inc.get("timestamp") or _now(),
                embed(text).tobytes(),
            ),
        )

    def store_config_change(self, c: Dict[str, Any]) -> None:
        self._exec(
            "INSERT OR REPLACE INTO config_changes VALUES (?,?,?,?,?,?)",
            (
                c.get("id") or str(uuid.uuid4()),
                c.get("file_path", ""),
                c.get("content", ""),
                c.get("changed_by", ""),
                c.get("reason", ""),
                c.get("timestamp") or _now(),
            ),
        )

    def retention_sweep(self, days: int = LONGTERM_RETENTION_DAYS) -> None:
        cutoff = _now() - days * 86400
        self._exec("DELETE FROM memories WHERE created_at < ?", (cutoff,))

    # knowledge base (knowledge.rs — same embedding scheme, own table)
    def add_knowledge(
        self, title: str, content: str, source: str = "", tags: Optional[List[str]] = None
    ) -> str:
        kid = str(uuid.uuid4())
        self._exec(
            "INSERT INTO knowledge VALUES (?,?,?,?,?,?,?)",
            (
                kid,
                title,
                content,
                source,
                json.dumps(tags or []),
                embed(f"{title} {content}").tobytes(),
                _now(),
            ),
        )
        return kid

    def search_knowledge(
        self, query: str, n_results: int = 5, min_relevance: float = 0.0
    ) -> List[Dict[str, Any]]:
        rows = self._query(
            "SELECT id, title, content, source, tags, embedding FROM knowledge"
        )
        texts = [f"{r[1]} {r[2]}" for r in rows]
        vecs = [np.frombuffer(r[5], dtype=np.float32) for r in rows]
        out = []
        for idx, score in rank(query, texts, vecs)[:n_results]:
            if score < min_relevance:
                continue
            r = rows[idx]
            out.append(
                {
                    "id": r[0],
                    "collection": "knowledge",
                    "content": r[2],
                    "metadata_json": json.dumps({"title": r[1], "source": r[3]}),
                    "relevance": score,
                }
            )
        _lookup("knowledge", bool(out))
        return out
