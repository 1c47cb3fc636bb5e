"""Pre-execution backups + rollback for reversible tools.

Reference parity (tools/src/backup.rs): before a reversible tool runs, the
affected file/directory is copied into the backup cache keyed by execution
id; `rollback(execution_id)` restores it.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import uuid
from pathlib import Path
from typing import Dict, Optional


class BackupManager:
    def __init__(self, backup_dir: str = "/tmp/aios/backups"):
        self.backup_dir = Path(backup_dir)
        self.backup_dir.mkdir(parents=True, exist_ok=True)
        self._index: Dict[str, dict] = {}
        self._lock = threading.Lock()
        self._load_index()

    def _index_path(self) -> Path:
        return self.backup_dir / "index.json"

    def _load_index(self) -> None:
        try:
            self._index = json.loads(self._index_path().read_text())
        except (OSError, ValueError):
            self._index = {}

    def _save_index(self) -> None:
        self._index_path().write_text(json.dumps(self._index))

    def backup_path_for(self, execution_id: str, target: str) -> Optional[str]:
        """Snapshot ``target`` (file or dir) before a reversible mutation."""
        src = Path(target)
        if not src.exists():
            # record intent so rollback can delete a newly-created path
            with self._lock:
                self._index[execution_id] = {
                    "target": target,
                    "backup": "",
                    "existed": False,
                    "timestamp": time.time(),
                }
                self._save_index()
            return None
        dest = self.backup_dir / f"{execution_id}-{uuid.uuid4().hex[:8]}"
        if src.is_dir():
            shutil.copytree(src, dest)
        else:
            shutil.copy2(src, dest)
        with self._lock:
            self._index[execution_id] = {
                "target": target,
                "backup": str(dest),
                "existed": True,
                "timestamp": time.time(),
            }
            self._save_index()
        return str(dest)

    def rollback(self, execution_id: str) -> tuple[bool, str]:
        with self._lock:
            entry = self._index.get(execution_id)
        if entry is None:
            return False, f"no backup recorded for execution {execution_id}"
        target = Path(entry["target"])
        if not entry["existed"]:
            # target did not exist before -> undo means delete
            if target.is_dir():
                shutil.rmtree(target, ignore_errors=True)
            elif target.exists():
                target.unlink()
            return True, f"removed {target}"
        backup = Path(entry["backup"])
        if not backup.exists():
            return False, f"backup blob missing for {execution_id}"
        if target.exists():
            if target.is_dir():
                shutil.rmtree(target)
            else:
                target.unlink()
        if backup.is_dir():
            shutil.copytree(backup, target)
        else:
            os.makedirs(target.parent, exist_ok=True)
            shutil.copy2(backup, target)
        return True, f"restored {target}"

    def has_backup(self, execution_id: str) -> bool:
        with self._lock:
            return execution_id in self._index
