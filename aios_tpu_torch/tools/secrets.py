"""Secret store: TOML file loader with TTL cache and shutdown wipe.

Reference parity (tools/src/secrets.rs:1-31): loads /etc/aios/secrets.toml,
caches values in memory for 1 hour, wipes the cache on shutdown.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path

from .._compat import tomllib
from typing import Dict, Optional

CACHE_TTL = 3600.0


class SecretManager:
    def __init__(self, path: str = "/etc/aios/secrets.toml", ttl: float = CACHE_TTL):
        self.path = Path(path)
        self.ttl = ttl
        self._cache: Dict[str, str] = {}
        self._loaded_at = 0.0
        self._lock = threading.Lock()

    def _flatten(self, data: dict, prefix: str = "") -> Dict[str, str]:
        out: Dict[str, str] = {}
        for k, v in data.items():
            key = f"{prefix}{k}" if not prefix else f"{prefix}.{k}"
            if isinstance(v, dict):
                out.update(self._flatten(v, key))
            else:
                out[key] = str(v)
        return out

    def _ensure_loaded(self) -> None:
        now = time.monotonic()
        if self._cache and now - self._loaded_at < self.ttl:
            return
        try:
            data = tomllib.loads(self.path.read_text())
            self._cache = self._flatten(data)
        except (OSError, ValueError):
            self._cache = {}
        self._loaded_at = now

    def get(self, key: str) -> Optional[str]:
        with self._lock:
            self._ensure_loaded()
            return self._cache.get(key)

    def wipe(self) -> None:
        with self._lock:
            for k in list(self._cache):
                self._cache[k] = ""
            self._cache.clear()
            self._loaded_at = 0.0
