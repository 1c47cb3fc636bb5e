"""Build and bind the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (``build/lib<name>.so`` inside the
package), loaded with ``ctypes``. A library builds at first use — or all of
them at once from ``TorchEngine.warmup`` / ``build_all`` — and rebuilds
when its source, or any ``csrc/*.cuh`` header, is newer. Stale sources
compile in parallel, one ``nvcc`` process each.

Safe under concurrent callers, like ``aios_tpu/native/build.py``: an
``flock`` serializes builds across processes, each compile writes a
private temporary file, and ``os.replace`` publishes it atomically.
Importing this module needs neither ``nvcc`` nor CUDA.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Iterable, Iterator, Sequence, Tuple

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"
SOURCES = ("quantized_matmul", "flash_attention", "paged_attention", "int4_matmul",
           "dense_attention", "mega_graph")
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")  # when nvcc is not on PATH
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[Tuple[str, str], object] = {}
_tally = threading.local()  # .launches: the recording of this thread's capture
# the wrappers' counters are read-modify-writes shared by every thread that
# launches (one scheduler thread per replica): one lock keeps them exact
_count_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if DEFAULT_NVCC.exists():
        return str(DEFAULT_NVCC)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels build on a machine with the CUDA "
        "toolkit (PATH or /usr/local/cuda/bin)"
    )


def library_path(name: str) -> Path:
    return BUILD / f"lib{name}.so"


def _fresh(name: str) -> bool:
    out = library_path(name)
    newest = max(p.stat().st_mtime for p in (CSRC / f"{name}.cu", *CSRC.glob("*.cuh")))
    return out.exists() and out.stat().st_mtime >= newest


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every stale source among ``names``; returns {name: compiler
    output} for the ones compiled now (``-Xptxas -v`` register and spill
    report). The output is also kept in ``build/<name>.log``."""
    names = [n for n in names if not _fresh(n)]
    if not names:
        return {}
    BUILD.mkdir(parents=True, exist_ok=True)
    with open(BUILD / ".build.lock", "w") as lock_fh:
        fcntl.flock(lock_fh, fcntl.LOCK_EX)
        try:
            # another process may have built them while we waited
            names = [n for n in names if not _fresh(n)]
            nvcc = _nvcc() if names else ""
            procs = []
            for name in names:
                tmp = BUILD / f"lib{name}.tmp.{os.getpid()}.so"
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
                procs.append((name, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True,
                )))
            logs, failed = {}, []
            for name, tmp, proc in procs:
                out, _ = proc.communicate()
                logs[name] = out
                (BUILD / f"{name}.log").write_text(out)
                if proc.returncode:
                    tmp.unlink(missing_ok=True)
                    failed.append(f"{name}:\n{out}")
                else:
                    os.replace(tmp, library_path(name))
            if failed:
                raise RuntimeError("nvcc failed for " + "\n".join(failed))
            return logs
        finally:
            fcntl.flock(lock_fh, fcntl.LOCK_UN)


def build_all() -> None:
    """Build (in parallel) and load every kernel library."""
    with _lock:
        build(SOURCES)
        for name in SOURCES:
            _load(name)


def _load(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        lib.aios_error_string.argtypes = [ctypes.c_int]
        lib.aios_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def kernel(name: str, symbol: str, argtypes: Sequence):
    """The C entry point ``symbol`` of library ``name``, built and loaded on
    first use, with its argument types declared (pointers and the stream as
    ``c_void_p``, so ctypes never truncates them to 32 bits)."""
    key = (name, symbol)
    fn = _fns.get(key)
    if fn is None:
        with _lock:
            lib = _load(name)
            fn = getattr(lib, symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _fns[key] = fn
    return fn


def check(name: str, rc: int) -> None:
    """Raise when a C entry point returned a CUDA error (a refused launch
    never runs, and ``torch.cuda.synchronize`` would not report it)."""
    if rc:
        msg = _libs[name].aios_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} ({msg})")


def count_launch(wrapper) -> None:
    """Count one launch of ``wrapper``'s kernel: one more in
    ``wrapper.launches``, or, while this thread records a graph capture
    (``recording_launches``), one more in the recording instead, since a
    captured launch runs only when the graph replays."""
    recording = getattr(_tally, "launches", None)
    if recording is None:
        with _count_lock:
            wrapper.launches += 1
    else:
        recording[wrapper] = recording.get(wrapper, 0) + 1


@contextmanager
def recording_launches() -> Iterator[Dict[object, int]]:
    """Record this thread's kernel launches as {wrapper: launches} instead
    of counting them; the counters stay as they were. A graph adds the
    recording to the counters each time it replays (``add_launches``)."""
    outer = getattr(_tally, "launches", None)
    _tally.launches = recording = {}
    try:
        yield recording
    finally:
        _tally.launches = outer


def add_launches(recording: Dict[object, int], times: int = 1) -> None:
    """Count the launches of ``times`` runs of a recorded capture (a
    replay, or the ticks a megagraph replay ran)."""
    with _count_lock:
        for wrapper, n in recording.items():
            wrapper.launches += n * times


def scratch_stream(stream: int) -> int:
    """The stream whose split workspace and ticket counters a launch on
    ``stream`` uses: ``stream`` itself, or while this thread captures a
    megagraph tick on a side stream (``scratch_alias``), the graph's own
    capture stream, whose workspace the graph holds. The tick's nodes run
    in the graph's order, after and before the rest of it, so sharing it
    is safe."""
    aliases = getattr(_tally, "aliases", None)
    return stream if aliases is None else aliases.get(stream, stream)


@contextmanager
def scratch_alias(side: int, stream: int) -> Iterator[None]:
    """Launches of this thread on stream ``side`` use the workspace and
    counters of ``stream`` (``scratch_stream``) inside the block."""
    outer = getattr(_tally, "aliases", None)
    _tally.aliases = {**(outer or {}), side: stream}
    try:
        yield
    finally:
        _tally.aliases = outer


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def device_of(*tensors: torch.Tensor) -> torch.device:
    """The one device every operand lives on. The wrappers take their plain
    version for CPU operands and launch their kernel for CUDA operands, so
    mixed or other devices are refused instead of silently routed."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"operands on different devices: {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)
