"""SHA-256 hash-chained audit ledger.

Reference parity (tools/src/audit.rs): every tool execution appends a record
whose hash covers the previous record's hash — `verify_chain` recomputes the
whole chain and reports the first break (audit.rs:54-150). SQLite-backed.
"""

from __future__ import annotations

import hashlib
import json
import sqlite3
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from ..obs import instruments as obs

_SCHEMA = """
CREATE TABLE IF NOT EXISTS audit_log (
    seq INTEGER PRIMARY KEY AUTOINCREMENT,
    id TEXT NOT NULL,
    timestamp INTEGER NOT NULL,
    agent_id TEXT,
    tool_name TEXT,
    input_hash TEXT,
    output_hash TEXT,
    success INTEGER,
    reason TEXT,
    prev_hash TEXT NOT NULL,
    hash TEXT NOT NULL
);
"""

GENESIS = "0" * 64


def _sha256(data: str) -> str:
    from .. import native

    if native.available():
        return native.sha256_hex(data.encode("utf-8"))
    return hashlib.sha256(data.encode("utf-8")).hexdigest()


class AuditLog:
    def __init__(self, path: str = ":memory:"):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.executescript(_SCHEMA)
        self._lock = threading.Lock()

    def record(
        self,
        agent_id: str,
        tool_name: str,
        input_bytes: bytes,
        output_bytes: bytes,
        success: bool,
        reason: str = "",
    ) -> str:
        """Append one chained record; returns its id."""
        with self._lock:
            row = self._conn.execute(
                "SELECT hash FROM audit_log ORDER BY seq DESC LIMIT 1"
            ).fetchone()
            prev_hash = row[0] if row else GENESIS
            rec_id = str(uuid.uuid4())
            ts = int(time.time())
            input_hash = hashlib.sha256(input_bytes).hexdigest()
            output_hash = hashlib.sha256(output_bytes).hexdigest()
            payload = json.dumps(
                [rec_id, ts, agent_id, tool_name, input_hash, output_hash,
                 int(success), reason, prev_hash],
                separators=(",", ":"),
            )
            h = _sha256(payload)
            self._conn.execute(
                "INSERT INTO audit_log (id, timestamp, agent_id, tool_name,"
                " input_hash, output_hash, success, reason, prev_hash, hash)"
                " VALUES (?,?,?,?,?,?,?,?,?,?)",
                (rec_id, ts, agent_id, tool_name, input_hash, output_hash,
                 int(success), reason, prev_hash, h),
            )
            self._conn.commit()
        # every tool execution flows through this ledger (executor records
        # success and failure alike), so this is THE invocation counter
        obs.TOOL_INVOCATIONS.labels(
            tool=tool_name, outcome="success" if success else "failure"
        ).inc()
        return rec_id

    def verify_chain(self) -> Tuple[bool, Optional[int]]:
        """Recompute the whole chain; returns (ok, first_bad_seq)."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT seq, id, timestamp, agent_id, tool_name, input_hash,"
                " output_hash, success, reason, prev_hash, hash FROM audit_log"
                " ORDER BY seq"
            ).fetchall()
        expected_prev = GENESIS
        for (seq, rec_id, ts, agent, tool, ih, oh, success, reason,
             prev_hash, h) in rows:
            if prev_hash != expected_prev:
                return False, seq
            payload = json.dumps(
                [rec_id, ts, agent, tool, ih, oh, success, reason, prev_hash],
                separators=(",", ":"),
            )
            if _sha256(payload) != h:
                return False, seq
            expected_prev = h
        return True, None

    def query(
        self,
        agent_id: str = "",
        tool_name: str = "",
        limit: int = 100,
    ) -> List[Dict[str, Any]]:
        sql = (
            "SELECT seq, id, timestamp, agent_id, tool_name, success, reason"
            " FROM audit_log WHERE 1=1"
        )
        args: list = []
        if agent_id:
            sql += " AND agent_id=?"
            args.append(agent_id)
        if tool_name:
            sql += " AND tool_name=?"
            args.append(tool_name)
        sql += " ORDER BY seq DESC LIMIT ?"
        args.append(limit)
        with self._lock:
            rows = self._conn.execute(sql, tuple(args)).fetchall()
        keys = ["seq", "id", "timestamp", "agent_id", "tool_name", "success", "reason"]
        return [dict(zip(keys, r)) for r in rows]

    def count(self) -> int:
        with self._lock:
            return self._conn.execute("SELECT COUNT(*) FROM audit_log").fetchone()[0]

    def tamper_for_test(self, seq: int) -> None:
        """Corrupt a record (tests of verify_chain only)."""
        with self._lock:
            self._conn.execute(
                "UPDATE audit_log SET reason='tampered' WHERE seq=?", (seq,)
            )
            self._conn.commit()
