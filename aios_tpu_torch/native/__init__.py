"""ctypes bindings for the native C++ runtime primitives.

Builds lazily (g++ via build.py) and degrades gracefully: when the shared
library is missing or the toolchain is absent, `available()` is False and
callers fall back to their pure-Python implementations — same semantics,
native speed when present. Wired consumers: the tool-registry rate limiter
(tools/ratelimit.py, NativeTokenBucket) and the audit ledger's record hash
(tools/audit.py, sha256_hex). NativeRing and chain_hash are standalone
primitives with parity tests; the memory service's operational ring keeps
its Python deque because its queries filter on event dict fields.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional

from .build import OUT as _LIB_PATH

_lib: Optional[ctypes.CDLL] = None
_load_lock = threading.Lock()
_load_failed = False


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.aios_sha256_hex.argtypes = [u8p, ctypes.c_uint64, ctypes.c_char_p]
    lib.aios_chain_hash.argtypes = [ctypes.c_char_p, u8p, ctypes.c_uint64,
                                    ctypes.c_char_p]
    lib.aios_ring_create.restype = ctypes.c_void_p
    lib.aios_ring_create.argtypes = [ctypes.c_uint64]
    lib.aios_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.aios_ring_push.argtypes = [ctypes.c_void_p, u8p, ctypes.c_uint64]
    lib.aios_ring_size.restype = ctypes.c_uint64
    lib.aios_ring_size.argtypes = [ctypes.c_void_p]
    lib.aios_ring_total.restype = ctypes.c_uint64
    lib.aios_ring_total.argtypes = [ctypes.c_void_p]
    lib.aios_ring_get_recent.restype = ctypes.c_int64  # -1 = index absent
    lib.aios_ring_get_recent.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                         u8p, ctypes.c_uint64]
    lib.aios_bucket_create.restype = ctypes.c_void_p
    lib.aios_bucket_create.argtypes = [ctypes.c_double, ctypes.c_double]
    lib.aios_bucket_destroy.argtypes = [ctypes.c_void_p]
    lib.aios_bucket_try_acquire.restype = ctypes.c_int
    lib.aios_bucket_try_acquire.argtypes = [ctypes.c_void_p, ctypes.c_double]
    lib.aios_bucket_tokens.restype = ctypes.c_double
    lib.aios_bucket_tokens.argtypes = [ctypes.c_void_p]
    return lib


def load(build_if_missing: bool = True) -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    with _load_lock:
        if _lib is not None:
            return _lib
        if _load_failed:
            return None
        if not _LIB_PATH.exists() and build_if_missing:
            try:
                from .build import build

                build()
            except Exception:
                _load_failed = True
                return None
        if not _LIB_PATH.exists():
            _load_failed = True
            return None
        try:
            _lib = _configure(ctypes.CDLL(str(_LIB_PATH)))
        except OSError:
            _load_failed = True
            return None
        return _lib


def available() -> bool:
    return load() is not None


def _as_u8p(data: bytes):
    return ctypes.cast(ctypes.c_char_p(data), ctypes.POINTER(ctypes.c_uint8))


def sha256_hex(data: bytes) -> str:
    lib = load()
    assert lib is not None, "native library unavailable"
    out = ctypes.create_string_buffer(65)
    lib.aios_sha256_hex(_as_u8p(data), len(data), out)
    return out.value.decode()


def chain_hash(prev_hex: str, payload: bytes) -> str:
    lib = load()
    assert lib is not None, "native library unavailable"
    out = ctypes.create_string_buffer(65)
    lib.aios_chain_hash(prev_hex.encode(), _as_u8p(payload), len(payload), out)
    return out.value.decode()


class NativeRing:
    """Bounded event ring backed by the C++ deque (operational tier)."""

    def __init__(self, capacity: int):
        lib = load()
        assert lib is not None, "native library unavailable"
        self._lib = lib
        self._handle = lib.aios_ring_create(capacity)

    def push(self, item: bytes) -> None:
        self._lib.aios_ring_push(self._handle, _as_u8p(item), len(item))

    def __len__(self) -> int:
        return self._lib.aios_ring_size(self._handle)

    @property
    def total_pushed(self) -> int:
        return self._lib.aios_ring_total(self._handle)

    def recent(self, count: int) -> List[bytes]:
        out: List[bytes] = []
        buf = ctypes.create_string_buffer(64 * 1024)
        u8 = ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8))
        for i in range(count):
            n = self._lib.aios_ring_get_recent(self._handle, i, u8, len(buf))
            if n < 0:  # index beyond ring (0 is a valid empty item)
                break
            if n > len(buf):  # grow and retry
                buf = ctypes.create_string_buffer(int(n))
                u8 = ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8))
                n = self._lib.aios_ring_get_recent(self._handle, i, u8, len(buf))
            out.append(buf.raw[:n])
        return out

    def __del__(self):
        try:
            self._lib.aios_ring_destroy(self._handle)
        except Exception:
            pass


class NativeTokenBucket:
    """Token bucket backed by the C++ steady-clock implementation."""

    def __init__(self, rate: float, capacity: Optional[float] = None):
        lib = load()
        assert lib is not None, "native library unavailable"
        self._lib = lib
        self._handle = lib.aios_bucket_create(rate, capacity or 0.0)

    def try_acquire(self, n: float = 1.0) -> bool:
        return bool(self._lib.aios_bucket_try_acquire(self._handle, n))

    @property
    def tokens(self) -> float:
        return self._lib.aios_bucket_tokens(self._handle)

    def __del__(self):
        try:
            self._lib.aios_bucket_destroy(self._handle)
        except Exception:
            pass
