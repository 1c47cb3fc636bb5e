"""The port's kernel build and launch planning, the parts that run on the
host: a stand-in ``nvcc`` records what the build asks for (the real
compiler and the card exist only where ``chip_smoke.py`` runs)."""

import importlib
import math
import os
import stat
import time

import pytest

from aios_tpu_torch.ops import build

qmm = importlib.import_module("aios_tpu_torch.ops.quantized_matmul")

FAKE_NVCC = """#!/bin/sh
# stand-in compiler: writes the -o target, fails for sources named bad.cu
out=""; src=""
while [ $# -gt 0 ]; do
  case "$1" in
    -o) out="$2"; shift 2 ;;
    *) src="$1"; shift ;;
  esac
done
case "$src" in *bad.cu) echo "error: bad source"; exit 1 ;; esac
echo "compiled $src" > "$out"
echo "ptxas info    : Used 42 registers"
echo "$src" >> "$(dirname "$out")/calls.txt"
"""


@pytest.fixture()
def toolchain(tmp_path, monkeypatch):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("one", "two", "bad"):
        (csrc / f"{name}.cu").write_text("// kernel\n")
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD", tmp_path / "build")
    return tmp_path


def _calls(root):
    f = root / "build" / "calls.txt"
    return f.read_text().split() if f.exists() else []


def test_build_compiles_stale_sources_once_and_rebuilds_newer_ones(toolchain):
    logs = build.build(["one", "two"])
    assert sorted(logs) == ["one", "two"]
    assert "Used 42 registers" in logs["one"]
    assert build.library_path("one").exists() and build.library_path("two").exists()
    assert (toolchain / "build" / "one.log").read_text() == logs["one"]
    assert build.build(["one", "two"]) == {}  # fresh: nothing recompiles
    assert len(_calls(toolchain)) == 2
    src = toolchain / "csrc" / "two.cu"
    later = time.time() + 5
    os.utime(src, (later, later))
    assert sorted(build.build(["one", "two"])) == ["two"]
    assert len(_calls(toolchain)) == 3


def test_a_newer_header_rebuilds_every_library(toolchain):
    build.build(["one", "two"])
    hdr = toolchain / "csrc" / "common.cuh"
    hdr.write_text("// shared\n")
    later = time.time() + 5
    os.utime(hdr, (later, later))
    assert sorted(build.build(["one", "two"])) == ["one", "two"]


@pytest.mark.parametrize("name", build.SOURCES)
def test_every_registered_source_is_in_the_package(name):
    src = build.CSRC / f"{name}.cu"
    text = src.read_text()
    assert 'extern "C"' in text and "aios_error_string" in text
    for line in text.splitlines():
        if line.startswith('#include "'):
            assert (build.CSRC / line.split('"')[1]).exists(), line


def test_dense_attention_source_exports_the_four_entry_points():
    assert "dense_attention" in build.SOURCES
    text = (build.CSRC / "dense_attention.cu").read_text()
    for symbol in ("aios_decode_attention", "aios_decode_attention_int8",
                   "aios_multiquery_decode_attention",
                   "aios_multiquery_decode_attention_int8"):
        assert f'extern "C" int {symbol}(' in text, symbol


def test_failed_compile_raises_and_publishes_nothing(toolchain):
    with pytest.raises(RuntimeError, match="nvcc failed for bad"):
        build.build(["bad", "one"])
    assert not build.library_path("bad").exists()
    assert build.library_path("one").exists()  # the good one still published
    assert not list((toolchain / "build").glob("*.tmp.*"))


def test_build_without_nvcc_says_so(toolchain, monkeypatch):
    monkeypatch.setenv("PATH", str(toolchain / "empty"))
    monkeypatch.setattr(build, "DEFAULT_NVCC", toolchain / "no-cuda" / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build._nvcc()


@pytest.mark.parametrize("M,N,K", [
    (8, 2560, 2048), (8, 2048, 2048), (8, 11264, 2048), (8, 2048, 5632),
    (8, 32000, 2048), (1, 64, 96), (16, 128, 64), (17, 100, 70),
    (512, 2048, 2048), (2048, 2048, 5632),
])
def test_quantized_matmul_plan_covers_k_exactly(M, N, K):
    block_m, splits, k_per_split = qmm.plan(M, N, K, sms=132)
    assert block_m == (16 if M <= 16 else 64)
    assert k_per_split % qmm.BLOCK_K[block_m] == 0
    assert (splits - 1) * k_per_split < K <= splits * k_per_split  # no empty split
    tiles = math.ceil(M / block_m) * math.ceil(N / qmm.BLOCK_N)
    if splits > 1:  # K splits only while there are too few tiles for the card
        assert tiles < 2 * 132
