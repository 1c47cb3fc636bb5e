"""The port's kernel build and launch planning, the parts that run on the
host: a stand-in ``nvcc`` records what the build asks for (the real
compiler and the card exist only where ``chip_smoke.py`` runs)."""

import importlib
import math
import os
import re
import stat
import time

import pytest
import torch

from aios_tpu_torch.ops import build

# The shapes here are tiny: one intra-op thread is faster and leaves the
# cores to the other test workers.
torch.set_num_threads(1)

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


# (M, N, K) of every TinyLlama int8 projection at a decode step (M=8), a
# verify forward (M=64) and prefill buckets, and ragged shapes
TINYLLAMA_NK = ((2560, 2048), (2048, 2048), (11264, 2048), (2048, 5632), (32000, 2048))
PLAN_CASES = [(M, N, K) for M in (8, 16, 32, 64, 512) for N, K in TINYLLAMA_NK] + [
    (1, 64, 96), (16, 128, 64), (17, 112, 72), (33, 2048, 2048), (65, 2048, 2048),
    (128, 2560, 2048), (2048, 2048, 5632), (8192, 32000, 2048),
]


def check_plan(p, M, N, K, kt, sms=132):
    """What every plan must hold: the path and tile by M (a prefill grid
    of at most half as many 128 x 128 tiles as SMs takes 64 x 64 tiles),
    whole stages per split and no empty split, the grid covering M and N,
    a decode step keeping at least two blocks per SM streaming wherever K
    has the stages for it, splits within one wave of resident blocks,
    64-row splits of at least eight stages, prefill K whole, and ticket
    counters and scratch for every split grid."""
    streaming = M <= 64
    if streaming:
        assert (p.block_t, p.cols) == (min(r for r in (8, 16, 32, 64) if r >= M), 64)
    else:
        wide = math.ceil(M / 128) * math.ceil(N / 128)
        assert p.splits == 1
        assert (p.block_t, p.cols) == ((128, 128) if wide > sms // 2 else (64, 64))
    assert p.k_per_split % kt == 0
    assert (p.splits - 1) * p.k_per_split < K <= p.splits * p.k_per_split  # no empty split
    assert p.tiles == math.ceil(M / p.block_t) * math.ceil(N / p.cols)
    k_tiles = math.ceil(K / kt)
    blocks = p.tiles * p.splits
    if streaming:
        resident = qmm.BLOCKS_PER_SM[p.block_t] * sms
        if p.block_t <= 32:
            assert blocks >= min(2 * sms, p.tiles * k_tiles)
        elif p.splits > 1:
            assert p.k_per_split >= 8 * kt
        assert blocks <= max(p.tiles, resident)
    if p.splits > 1:
        assert p.tiles <= qmm.COUNTERS
        assert p.partial_floats == p.splits * p.tiles * p.block_t * p.cols
    else:
        assert p.partial_floats == 0


@pytest.mark.parametrize("M,N,K", PLAN_CASES)
def test_quantized_matmul_plan_covers_k_exactly(M, N, K):
    p = qmm.plan(M, N, K, sms=132)
    check_plan(p, M, N, K, qmm.KT)
    assert qmm.plan(M, N, K, sms=132) == p  # the split, and so the sum, never varies


def test_decode_plans_fill_the_card_and_prefill_plans_do_not_oversplit():
    for N, K in TINYLLAMA_NK:
        p = qmm.plan(8, N, K, sms=132)
        assert p.tiles * p.splits >= 2 * 132
    # a prefill grid that already fills the card keeps K whole
    assert qmm.plan(512, 32000, 2048, sms=132).splits == 1
    assert qmm.plan(2048, 2048, 5632, sms=132).splits == 1
    # TinyLlama's wo at M=512 has 64 tiles of 128 x 128: it takes 256 of 64 x 64
    assert qmm.plan(512, 2048, 2048, sms=132)[:4] == (64, 64, 256, 1)
    # Mistral's lm_head at M=8 has more tiles than resident blocks: K whole
    assert qmm.plan(8, 32000, 4096, sms=132, kt=128)[2:4] == (500, 1)


def test_matmul_sources_share_one_core_and_match_their_bindings():
    """K1 and K5 are thin entry files over csrc/wq_matmul.cuh, and each C
    entry takes the wrapper's 14 arguments (6 pointers, 7 ints, the stream)."""
    assert len(qmm._ARGTYPES) == 14
    for name, symbol in (("quantized_matmul", "aios_quantized_matmul"),
                         ("int4_matmul", "aios_int4_matmul")):
        text = (build.CSRC / f"{name}.cu").read_text()
        assert '#include "wq_matmul.cuh"' in text
        sig = text[text.index(f'extern "C" int {symbol}('):]
        sig = sig[:sig.index(")")]
        assert sig.count(",") + 1 == len(qmm._ARGTYPES), name
        assert "wmma::" not in text and "_reduce" not in text


def _c_args(source: str, symbol: str) -> int:
    text = (build.CSRC / source).read_text()
    sig = text[text.index(f'extern "C" int {symbol}('):]
    return sig[:sig.index(")")].count(",") + 1


def test_flash_attention_entry_matches_its_binding():
    """K2's C entry takes the wrapper's 14 arguments (4 pointers, 8 ints,
    sm_scale, the stream) and its kernel is the TMA + wgmma one over the
    shared Hopper header, with no WMMA left."""
    fa = importlib.import_module("aios_tpu_torch.ops.flash_attention")
    assert _c_args("flash_attention.cu", "aios_flash_attention") == len(fa._ARGTYPES) == 14
    text = (build.CSRC / "flash_attention.cu").read_text()
    assert '#include "hopper.cuh"' in text and "wmma::" not in text
    for used in ("tma_4d(", "WgmmaSS<", "Wgmma<D, 1>", "desc_mn_sw128(", "encode<4>("):
        assert used in text, used
    # one copy of the TMA / wgmma helpers and of the tensor-map encoder's lookup
    lookups = [p.name for p in sorted(build.CSRC.iterdir())
               if '"cuTensorMapEncodeTiled"' in p.read_text()]
    assert lookups == ["hopper.cuh"]
    assert '#include "hopper.cuh"' in (build.CSRC / "wq_matmul.cuh").read_text()


def test_decode_attention_entry_takes_the_split():
    """Every dense entry takes the split workspace after the output and the
    number of splits after the window: K8 7 pointers and 7 ints, K9 9 and 7,
    K6 8 and 8, K7 10 and 8, then sm_scale and the stream, as the wrapper
    passes them."""
    assert _c_args("dense_attention.cu", "aios_decode_attention") == 16
    assert _c_args("dense_attention.cu", "aios_decode_attention_int8") == 18
    assert _c_args("dense_attention.cu", "aios_multiquery_decode_attention") == 18
    assert _c_args("dense_attention.cu", "aios_multiquery_decode_attention_int8") == 20


def test_plan_and_kernel_agree_on_blocks_per_sm():
    """The plan splits K by the blocks resident per SM that the kernel's
    __launch_bounds__ and stage count are built for: one table each side."""
    text = (build.CSRC / "wq_matmul.cuh").read_text()
    table = re.search(r"kBlocksPerSm\[\d+\]\[2\] = \{(.*?)\};", text).group(1)
    pairs = {int(a): int(b) for a, b in re.findall(r"\{(\d+), (\d+)\}", table)}
    assert pairs == qmm.BLOCKS_PER_SM
    assert set(qmm.STREAM_ROWS) | {qmm.PREFILL_ROWS} == set(pairs)
    for case in re.findall(r"launch<P, (\d+), (\d+)>", text):
        assert int(case[0]) in pairs and int(case[1]) == (2 if int(case[0]) == 128 else 1)


@pytest.mark.parametrize("K,N,ok", [(2048, 2560, True), (5632, 2048, True), (2048, 32000, True),
                                    (2048, 40, False), (100, 64, False), (0, 64, False)])
def test_kernel_supported_names_the_launch_contract(K, N, ok):
    assert qmm.kernel_supported(K, N) is ok


@pytest.mark.parametrize("bad,match", [
    (dict(x_dtype=torch.float32), "bfloat16"),
    (dict(N=40), "N % 16"),
    (dict(K=100), "K % 8"),
    (dict(noncontig=True), "contiguous"),
])
def test_launch_contract_is_checked_before_any_launch(bad, match):
    """The checks of the shared launch helper refuse what the kernel does
    not take, before anything touches a card."""
    K, N = bad.get("K", 64), bad.get("N", 64)
    x = torch.zeros(4, K, dtype=bad.get("x_dtype", torch.bfloat16))
    if bad.get("noncontig"):
        x = torch.zeros(K, 4, dtype=torch.bfloat16).t()
    w = torch.zeros(K, N, dtype=torch.int8)
    s = torch.ones(1, N)
    before = qmm.quantized_matmul.launches
    with pytest.raises(ValueError, match=match):
        qmm.launch(qmm.quantized_matmul, "quantized_matmul", "aios_quantized_matmul",
                   x, w, s, N, K, qmm.KT)
    assert qmm.quantized_matmul.launches == before


@pytest.mark.parametrize("threads", [2, 8])
def test_launch_counts_stay_exact_across_threads(threads):
    """Replicas replay graphs on one scheduler thread each: recordings added
    and single launches counted from several threads at once lose no
    update. The stand-in wrappers yield the interpreter inside every read
    of their counter, the window a lost read-modify-write needs."""
    import threading

    class Wrapper:
        def __init__(self):
            self._n = 0

        @property
        def launches(self):
            n = self._n
            time.sleep(0)  # another thread may run between the read and the write
            return n

        @launches.setter
        def launches(self, n):
            self._n = n

    a, b = Wrapper(), Wrapper()
    with build.recording_launches() as recording:
        build.count_launch(a)
        build.count_launch(a)
        build.count_launch(b)
    assert recording == {a: 2, b: 1} and a.launches == 0
    rounds = 300

    def work():
        for _ in range(rounds):
            build.add_launches(recording)
            build.count_launch(b)

    pool = [threading.Thread(target=work) for _ in range(threads)]
    for t in pool:
        t.start()
    for t in pool:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in pool)
    assert (a.launches, b.launches) == (2 * rounds * threads, 2 * rounds * threads)
