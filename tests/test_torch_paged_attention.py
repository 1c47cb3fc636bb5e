"""The split of the port's paged decode attention kernels (K3
``paged_decode_attention``, K4 ``paged_decode_attention_int8``,
``csrc/paged_attention.cu``) and the load-time refusal of geometries no
kernel takes, on the CPU.

The CUDA kernel cannot run here, so its recurrence is written out in plain
torch (``_split_merge``): each slot's visible rows cut into shares by
``ops/split.py``'s ``split_share``, each share reading only its own page-table entries and
reduced at the kernel's rounding points, the partials merged in split
order. It is held to the JAX package's references at ``atol = rtol = 1e-5``
(f32 inputs, sums taken in another order). The kernel itself runs on the
card against the port's plain version (``chip_smoke.py``).
"""

import importlib
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aios_tpu.ops.paged_attention import (
    paged_decode_attention_int8_reference as jax_paged8_ref,
)
from aios_tpu.ops.paged_attention import paged_decode_attention_reference as jax_paged_ref
from aios_tpu_torch import ops
from aios_tpu_torch.engine import engine as engine_mod
from aios_tpu_torch.engine import model as tm
from aios_tpu_torch.engine.config import PRESETS, TINY_TEST
from aios_tpu_torch.engine.engine import TorchEngine
from aios_tpu_torch.engine.weights import init_params
from aios_tpu_torch.ops import build

# The shapes here are tiny: one intra-op thread is faster and leaves the
# cores to the other test workers.
torch.set_num_threads(1)

pattn = importlib.import_module("aios_tpu_torch.ops.paged_attention")
split = importlib.import_module("aios_tpu_torch.ops.split")

TOL = dict(atol=1e-5, rtol=1e-5)
P, MB, KH, H, D = 16, 8, 2, 8, 16
C = MB * P
UNUSED = 2**31 - 1  # a table entry no share may read: it fails as an index

# lengths (row lengths[b] is the newest token, so lengths[b] + 1 visible rows):
# with four splits 128 rows end on whole 32-row shares, 97 rows run one row
# past three, 95 rows stop one short of them; 32 rows fill one share exactly
CASES = {
    "edges": [127, 95, 96, 94, 31, 32],
    # an inactive slot (length 0), one of two rows, every other slot idle
    "short": [0, 1, 0, 0, 0, 100],
    "long": [70, 75, 80, 90, 111, 127],
}
WINDOW = 40
SINK = P


def _inputs(lengths, seed, window, quant, mb=MB):
    """Pools with shuffled physical pages; page 0 is the sacrificial page an
    inactive slot maps. Returns the operands and two page tables: the one
    the engine would hold (pages below the window trimmed to page 0) and the
    same with every entry outside a slot's visible rows marked UNUSED."""
    rng = np.random.default_rng(seed)
    Bs = len(lengths)
    need = [-(-(n + 1) // P) for n in lengths]
    N = 1 + sum(need) + 2
    free = list(rng.permutation(np.arange(1, N)))
    tables = np.zeros((Bs, mb), np.int32)
    strict = np.full((Bs, mb), UNUSED, np.int32)
    for b, n in enumerate(lengths):
        first = max(n + 1 - window, 0) // P if window else 0
        if n == 0:
            strict[b, 0] = 0  # an inactive slot reads one row of page tables[b, 0]
            continue
        for i in range(need[b]):
            page = free.pop()
            tables[b, i] = page if i >= first else 0
            if i >= first:
                strict[b, i] = page
    q = rng.normal(size=(Bs, H, D)).astype(np.float32)
    if quant:
        pools = [rng.integers(-127, 128, size=(N, P, KH, D)).astype(np.int8) for _ in range(2)]
        pools += [(rng.random((N, P, KH)) * 0.015 + 0.005).astype(np.float32)
                  for _ in range(2)]
    else:
        pools = [rng.normal(size=(N, P, KH, D)).astype(np.float32) for _ in range(2)]
    return q, pools, tables, strict, np.asarray(lengths, np.int32)


def _split_merge(q, pools, tables, lengths, window, win_starts, sink, splits, min_rows):
    """The kernel's recurrence in plain torch. Each slot's visible rows
    [c_lo, lengths[b] + 1) are cut into ``splits`` shares of at least
    ``min_rows`` (``split_share``); a share gathers its rows through its own
    page-table entries only, and reduces them to (m, l, acc) at the kernel's
    rounding points (bf16 pool: score (q . k) * sm_scale, p rounded to the
    pool dtype before P @ V; int8 pool: f32 throughout, q * sm_scale first,
    the K scale on the score, p * v_scale on v unrounded; l sums p itself).
    An empty share takes no part (its block leaves at once). The partials
    merge in split order as o = sum acc_z e^(m_z - M) / sum l_z e^(m_z - M)."""
    k_pool, v_pool, *scales = pools
    quant = bool(scales)
    Bs = q.shape[0]
    G = H // KH
    sm = 1.0 / math.sqrt(D)
    qg = q.float().reshape(Bs, KH, G, D) * (sm if quant else 1.0)
    out = torch.zeros(Bs, KH, G, D)
    for b in range(Bs):
        n = int(lengths[b])
        lo, hi = (max(n + 1 - window, 0) if window else 0), n + 1
        parts = []
        for z in range(splits):
            c_lo, c_hi = split.split_share(lo, hi, z, splits, min_rows)
            if c_lo >= c_hi:
                continue
            cols = torch.arange(c_lo, c_hi)
            pages = tables[b, cols // P].long()  # only this share's entries
            rows = cols % P
            kz = k_pool[pages, rows].float().transpose(0, 1)  # [KH, n, D]
            vz = v_pool[pages, rows].float().transpose(0, 1)
            sc = torch.einsum("kgd,knd->kgn", qg[b], kz)
            if quant:
                sc = sc * scales[0][pages, rows].T[:, None, :]
            else:
                sc = sc * sm
            if win_starts is not None:
                live = (cols < sink) | (cols >= int(win_starts[b]))
                sc = torch.where(live, sc, torch.full_like(sc, -1e30))
            m = sc.amax(-1)
            p = torch.exp(sc - m[..., None])
            if win_starts is not None:
                p = torch.where(live, p, torch.zeros_like(p))
            if quant:
                pv = p * scales[1][pages, rows].T[:, None, :]
            else:
                pv = p.to(v_pool.dtype).float()
            parts.append((m, p.sum(-1), torch.einsum("kgn,knd->kgd", pv, vz)))
        M = torch.stack([m for m, _, _ in parts]).amax(0)
        L, O = torch.zeros_like(M), torch.zeros(KH, G, D)
        for m, l_, acc in parts:
            f = torch.exp(m - M)
            L, O = L + l_ * f, O + acc * f[..., None]
        out[b] = O / torch.where(L <= 0, torch.ones_like(L), L)[..., None]
    return out.reshape(Bs, H, D)


def _win_starts(lengths):
    """Where each slot's live window starts under window+sink compression:
    half its rows past the sink row count pruned (0 keeps the slot whole)."""
    return np.asarray([0 if n < 2 * SINK else SINK + (n - SINK) // 2 for n in lengths],
                      np.int32)


def _check_split(lengths, seed, mask, window, splits, min_rows, quant, mb=MB):
    """``_split_merge`` over shuffled pages read through the strict tables
    (every entry outside a slot's visible rows an invalid index), held to
    the JAX reference and to the port's plain version."""
    window = window if mask == "window" else None
    q, pools, tables, strict, lens = _inputs(lengths, seed, window or 0, quant, mb)
    ws = _win_starts(lengths) if mask == "sink" else None
    kw = dict(window=window, win_starts=ws, sink=SINK if ws is not None else None)
    got = _split_merge(torch.from_numpy(q), [torch.from_numpy(a) for a in pools],
                       torch.from_numpy(strict), lens, window, ws, SINK, splits, min_rows)
    jargs = [jnp.asarray(a) for a in (q, *pools, tables, lens)]
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    want = (jax_paged8_ref if quant else jax_paged_ref)(*jargs, **jkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # and the port's plain version, which gathers every page of a slot
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    fn = ops.paged_decode_attention_int8 if quant else ops.paged_decode_attention
    plain = fn(*(torch.from_numpy(a) for a in (q, *pools, tables, lens)), **tkw)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


@pytest.mark.parametrize("min_rows", [0, 64], ids=["equal", "min64"])
@pytest.mark.parametrize("splits", [2, 4, 8])
@pytest.mark.parametrize("mask", ["full", "window", "sink"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_split_merge_recurrence_matches_jax(pool, case, mask, splits, min_rows):
    """K3's and K4's split-and-merge arithmetic, held to the JAX references
    in f32: shuffled pages, an inactive slot, shares that end on, just past
    and just short of a share's edge, empty shares, shares held to a least
    row count, windows and the sink mask; no share reads a table entry
    outside its own rows."""
    _check_split(CASES[case], 70 + 3 * splits + len(case) + len(mask), mask, WINDOW,
                 splits, min_rows, pool == "int8")


# slots long enough for the D = 128 builds' least share to matter: with it
# a 701-row slot split four ways fills three blocks of 256 rows, not four of
# 192; 258 rows take two blocks, 256 one, and a 400-row window two
LONG_MB = 48
LONG_LENGTHS = [700, 513, 300, 257, 255, 0]
LONG_WINDOW = 400


@pytest.mark.parametrize("splits", [2, 4, 8])
@pytest.mark.parametrize("mask", ["full", "window", "sink"])
@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_split_merge_with_the_kernels_least_share_matches_jax(pool, mask, splits):
    """The recurrence with the least share the D = 128 builds hold
    (``MIN_SHARE_ROWS_D128``) over a 768-row cache, where it leaves fewer,
    fuller shares than equal cuts would."""
    floor = split.MIN_SHARE_ROWS_D128
    assert any(split.split_share(0, n + 1, z, splits, floor)
               != split.split_share(0, n + 1, z, splits) for n in LONG_LENGTHS
               for z in range(splits))
    _check_split(LONG_LENGTHS, 90 + splits + len(mask), mask, LONG_WINDOW, splits, floor,
                 pool == "int8", LONG_MB)


@pytest.mark.parametrize("visible,min_rows,live", [(301, 0, 4), (301, 256, 2), (4096, 256, 4),
                                                   (1, 256, 1), (257, 0, 3), (256, 256, 1)])
def test_short_slots_take_fewer_blocks(visible, min_rows, live):
    """Four splits of a slot's visible rows: with a least share of 256 rows
    (the D = 128 builds) a 301-row slot fills two blocks, not four; long
    slots keep equal shares."""
    shares = [split.split_share(0, visible, z, 4, min_rows) for z in range(4)]
    assert sum(hi > lo for lo, hi in shares) == live
    assert shares[0][0] == 0 and max(hi for _, hi in shares) == visible


def test_split_plan_at_the_served_paged_shapes():
    # TinyLlama: 8 slots x 4 kv heads over 16 pages of 128 rows; Mistral-7B:
    # 8 x 8 over 64 pages
    assert split.split_plan(16 * 128, 8, 4, 132) == 8
    assert split.split_plan(64 * 128, 8, 8, 132) == 4


def test_kernel_and_wrapper_agree():
    """The C entries take what the wrappers pass (9 or 11 pointers, 9 ints,
    sm_scale and the stream), the split from the shared header, and the
    staging limit the wrappers check."""
    text = (build.CSRC / "paged_attention.cu").read_text()

    def c_args(symbol):
        sig = text[text.index(f'extern "C" int {symbol}('):]
        return sig[:sig.index(")")].count(",") + 1

    assert c_args("aios_paged_decode_attention") == len(pattn._ARGTYPES) == 20
    assert c_args("aios_paged_decode_attention_int8") == len(pattn._ARGTYPES_INT8) == 22
    assert f"constexpr int kMaxStagedPages = {pattn.MAX_STAGED_PAGES};" in text
    # the least share: none at D = 64, one pass of the eight warps at D = 128
    # (split_share's min_rows; test_split_merge_with_the_kernels_least_share),
    # one constant in the shared header, which K9 takes too
    common = (build.CSRC / "attention_common.cuh").read_text()
    assert (f"constexpr int kMinShareRows = D == 64 ? 0 : {split.MIN_SHARE_ROWS_D128};"
            in common)
    assert "constexpr int kMinShareRows" not in text
    assert "clip_to_split(c_lo, c_hi, split, splits, kMinShareRows<D>)" in text
    # one kernel per build: two blocks per SM at D = 64, the default bound at 128
    assert "__launch_bounds__(kThreads, 2) paged_decode_kernel_2" in text
    assert "#if" not in text  # no compile-time switches
    for used in ("clip_to_split(", "merge_splits<D>(", "extern __shared__ int pages[]"):
        assert used in text, used
    assert "atomicAdd" not in text  # the only atomic is merge_splits' ticket
    assert "Not yet" not in text


@pytest.mark.parametrize("patch", sorted((build.PKG / "tools" / "paged_variants").glob("*.patch")),
                         ids=lambda p: p.stem)
def test_rejected_designs_patch_the_kernel_source(patch):
    """The designs split_sweep timed and the source does not keep are
    patches of it: each hunk's old lines stand in the source file the patch
    names as they are, so the patch still applies, and it changes the
    source."""
    diff = patch.read_text()
    target = re.search(r"^\+\+\+ b/(\S+)$", diff, re.M).group(1)
    assert target.startswith("aios_tpu_torch/csrc/")
    source = (build.PKG.parent / target).read_text()
    text = source
    for hunk in diff.split("\n@@")[1:]:
        lines = hunk.split("\n")[1:]
        old = "\n".join(line[1:] for line in lines if line[:1] in (" ", "-"))
        new = "\n".join(line[1:] for line in lines if line[:1] in (" ", "+"))
        assert text.count(old) == 1, patch.name
        text = text.replace(old, new)
    assert text != source


def _operands(quant=False, D_=64, H_=8, KH_=2, MB_=4, B_=2, **bad):
    q = torch.zeros(B_, H_, D_, dtype=bad.get("q_dtype", torch.bfloat16))
    pool_dtype = torch.int8 if quant else torch.bfloat16
    k = torch.zeros(3, P, KH_, D_, dtype=bad.get("pool_dtype", pool_dtype))
    scales = ((torch.ones(3, P, KH_, dtype=bad.get("scale_dtype", torch.float32)),) * 2
              if quant else ())
    tables = torch.zeros(B_, MB_, dtype=bad.get("table_dtype", torch.int32))
    lengths = torch.zeros(B_, dtype=torch.int32)
    return q, (k, k), scales, tables, lengths


@pytest.mark.parametrize("quant", [False, True], ids=["K3", "K4"])
@pytest.mark.parametrize("bad,match", [
    (dict(D_=32), "head_dim 32"),
    (dict(H_=32, KH_=2), "H / KH <= 8"),
    (dict(q_dtype=torch.float32), "bfloat16"),
    (dict(pool_dtype=torch.float32), "pools must be"),
    (dict(table_dtype=torch.int64), "int32"),
    (dict(MB_=4096), "at most 2048 pages"),
])
def test_launch_refuses_before_any_launch(quant, bad, match):
    """The shared launch checks every operand first: a refused operand
    raises by name and counts no launch."""
    fn = ops.paged_decode_attention_int8 if quant else ops.paged_decode_attention
    entry = "aios_paged_decode_attention" + ("_int8" if quant else "")
    argtypes = pattn._ARGTYPES_INT8 if quant else pattn._ARGTYPES
    q, pools, scales, tables, lengths = _operands(quant, **bad)
    before = fn.launches
    with pytest.raises(ValueError, match=re.escape(match)):
        pattn._launch(fn, entry, argtypes, q, pools, scales, tables, lengths, None, None, None)
    assert fn.launches == before


def test_int8_launch_refuses_bad_scales_before_any_launch():
    q, pools, scales, tables, lengths = _operands(True, scale_dtype=torch.float64)
    before = ops.paged_decode_attention_int8.launches
    with pytest.raises(ValueError, match="scales must be contiguous float32"):
        pattn._launch(ops.paged_decode_attention_int8, "aios_paged_decode_attention_int8",
                      pattn._ARGTYPES_INT8, q, pools, scales, tables, lengths, None, None, None)
    assert ops.paged_decode_attention_int8.launches == before


# -- geometries no kernel takes are refused at load, on the card only ---------------


@pytest.mark.parametrize("name", sorted(PRESETS))
@pytest.mark.parametrize("paged,quant_cache", [(True, False), (True, True), (False, False),
                                               (False, True)])
@pytest.mark.parametrize("quantize", [None, "int8", "int4"])
def test_every_preset_fits_every_kernel_contract(name, paged, quant_cache, quantize):
    cfg = PRESETS[name]
    assert tm.kernel_contract_faults(cfg, paged=paged, quant_cache=quant_cache,
                                     quantize=quantize,
                                     pages_per_slot=cfg.max_context // 128) == []


@pytest.mark.parametrize("paged,quant_cache,kernels", [
    (True, False, ("paged_decode_attention (K3)", "(K6), chunked admission")),
    (True, True, ("paged_decode_attention_int8 (K4)", "(K7), chunked admission")),
    (False, False, ("(K6-K9)",)),
])
def test_tiny_test_breaks_the_attention_contracts(paged, quant_cache, kernels):
    faults = tm.kernel_contract_faults(TINY_TEST, paged=paged, quant_cache=quant_cache,
                                       quantize="int8", pages_per_slot=1)
    assert "flash_attention (K2): head_dim 16 not in (64, 128)" in faults
    for kernel in kernels:  # a paged engine admits long prompts through K6 or K7
        assert any(kernel in f and "head_dim 16" in f for f in faults)
    assert len(faults) == 1 + len(kernels)  # its matmul leaves suit K1


def test_contract_faults_name_the_group_and_the_matmul_leaves():
    cfg = PRESETS["qwen3-14b"].scaled(num_heads=40, num_kv_heads=4, intermediate_size=17404)
    faults = tm.kernel_contract_faults(cfg, paged=True, quant_cache=False, quantize="int8",
                                       pages_per_slot=4096)
    assert faults == [
        "paged_decode_attention (K3): H/KH = 40/4, needs H % KH == 0 and H/KH <= 8",
        "paged decode attention: 4096 pages per slot, at most 2048",
        "multiquery_decode_attention (K6), chunked admission and jump: H/KH = 40/4, needs "
        "H % KH == 0 and H/KH <= 8",
        "quantized_matmul (K1): w_gateup [K=5120, N=34808]: the int8 matmul kernel needs "
        "K % 8 == 0 and N % 16 == 0",
        "quantized_matmul (K1): w_down [K=17404, N=5120]: the int8 matmul kernel needs "
        "K % 8 == 0 and N % 16 == 0",
    ]  # K2 takes 10 query heads per kv head


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_contract_checks_the_leaves_quantize_params_makes(mode):
    """The leaf names and [K, N] the contract checks are those
    ``quantize_params`` stores (int8 leaves carry [L, K, N]; an int4 leaf's
    scales [L, K / group, N])."""
    params = init_params(TINY_TEST, torch.Generator().manual_seed(0), dtype=torch.float32)
    served = tm.quantize_params(params, mode=mode)
    leaves = {**served["layers"], "lm_head": served["lm_head"]}
    shapes = tm.serving_leaf_shapes(TINY_TEST)
    assert set(shapes) <= set(leaves)
    for name, (K, N) in shapes.items():
        leaf = leaves[name]
        if "q" in leaf:
            assert tuple(leaf["q"].shape[-2:]) == (K, N), name
        else:
            assert leaf["s4"].shape[-1] == N and K % leaf["s4"].shape[-2] == 0, name


def test_cuda_engine_refuses_tiny_test_at_load(monkeypatch):
    """A CUDA engine for tiny-test (head_dim 16) raises before it touches
    the device, naming the model, its head_dim and H/KH and each kernel."""
    params = init_params(TINY_TEST, torch.Generator().manual_seed(0))
    monkeypatch.setattr(engine_mod, "resolve_device", lambda device: torch.device("cuda"))
    with pytest.raises(ValueError) as err:
        TorchEngine(TINY_TEST, params, paged_pool_rows=256, quantize="int8", device="cuda")
    msg = str(err.value)
    assert msg.startswith("tiny-test (head_dim 16, H/KH 4/2) cannot be served on cuda")
    assert "flash_attention (K2)" in msg and "paged_decode_attention (K3)" in msg


def test_cpu_engine_serves_tiny_test():
    """On the CPU the plain paths take any geometry: nothing is refused."""
    params = init_params(TINY_TEST, torch.Generator().manual_seed(0))
    eng = TorchEngine(TINY_TEST, params, paged_pool_rows=256, device="cpu")
    eng.prefill(0, [256, 7, 99], temperature=0.0)
    assert eng.step(2).shape[0] == 2
    eng.close()
