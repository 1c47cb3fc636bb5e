"""Build the native shared library with g++ (no cmake needed for one TU).

Safe under concurrent callers (the supervisor spawns ~10 agent processes at
boot and each may trigger the lazy build): the compile writes to a private
temp path and is published with an atomic ``os.replace``, serialized by an
``flock`` so only one process pays for the compile.
"""

from __future__ import annotations

import fcntl
import os
import subprocess
from pathlib import Path

HERE = Path(__file__).parent
SRC = HERE / "src" / "aios_native.cpp"
# the checkout's git-ignored build/, never the package tree
OUT_DIR = HERE.resolve().parents[1] / "build" / "native"
OUT = OUT_DIR / "libaios_native.so"
LOCK = OUT_DIR / ".build.lock"


def _fresh() -> bool:
    return OUT.exists() and OUT.stat().st_mtime >= SRC.stat().st_mtime


def build(force: bool = False) -> Path:
    if _fresh() and not force:
        return OUT
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    with open(LOCK, "w") as lock_fh:
        fcntl.flock(lock_fh, fcntl.LOCK_EX)
        try:
            # someone else may have built while we waited for the lock
            if _fresh() and not force:
                return OUT
            tmp = OUT.with_suffix(f".tmp.{os.getpid()}.so")
            cmd = [
                "g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                "-o", str(tmp), str(SRC),
            ]
            try:
                subprocess.run(cmd, check=True, capture_output=True, text=True)
                os.replace(tmp, OUT)  # atomic publish: readers never see a
                # half-written library
            finally:
                tmp.unlink(missing_ok=True)
            return OUT
        finally:
            fcntl.flock(lock_fh, fcntl.LOCK_UN)


if __name__ == "__main__":
    print(build(force=True))
