"""K6 (``multiquery_decode_attention``, the tensor-core kernel of
``csrc/dense_attention.cu``) and K9's split (``decode_attention_int8``) on
the CPU.

The CUDA kernels cannot run here, so their recurrences are written out in
plain torch at the kernels' rounding points. K6 (``_mq_recurrence``): the
T * G query rows of a (slot, kv head), ordered (t, g), in blocks of 32 or
64 rows; a block's visible rows cut into its split's share
(``split_share``); each share walked in 64-row chunks whose slices go to
the warps of a tile, each warp with its own online softmax (q . k
unscaled, then ``sm_scale`` in f32, p rounded to the cache dtype for P V,
l summing the unrounded p); the warps' partials merged, then the shares'
in split order. K9 (``_int8_split``): each slot's visible rows cut into
shares of at least ``min_rows`` rows, f32 throughout (q scaled first, the
K scale on the score, p * v_scale on v unrounded). Both are held to the
JAX package (its references, and K6 to its Pallas kernel in interpret
mode) at ``atol = rtol = 1e-5``, f32 inputs. The kernels themselves run on
the card against the port's plain versions (``chip_smoke.py``).
"""

import ctypes
import functools
import importlib
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aios_tpu_torch import ops
from aios_tpu_torch.ops import build

# The shapes here are tiny: one intra-op thread is faster and leaves the
# cores to the other test workers.
torch.set_num_threads(1)

jdec = importlib.import_module("aios_tpu.ops.decode_attention")
jver = importlib.import_module("aios_tpu.ops.verify_attention")
dattn = importlib.import_module("aios_tpu_torch.ops.decode_attention")
split = importlib.import_module("aios_tpu_torch.ops.split")

TOL = dict(atol=1e-5, rtol=1e-5)
NEG = -1e30
MQ_CHUNK = 64  # kMqChunk: cache rows of a stage
WARPS = 8
TEXT = (build.CSRC / "dense_attention.cu").read_text()


def _block_rows(R: int) -> int:
    """Query rows of a K6 block for R rows a (slot, kv head): mq_tiles."""
    return 16 * (2 if R <= 32 else 4)


def _merge(parts):
    """(m, l, acc) partials merged as the kernel merges its warps' and its
    splits': M = max m, L = sum l e^(m - M), O = sum acc e^(m - M)."""
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    L, O = torch.zeros_like(M), torch.zeros_like(parts[0][2])
    for m, l_, acc in parts:
        f = torch.exp(m - M)
        L, O = L + l_ * f, O + acc * f[:, None]
    return M, L, O


def _mq_recurrence(q, k, v, lengths, strides, window, splits):
    """K6's recurrence in plain torch; q [B, T, H, D], caches [B, C, KH, D]
    -> [B, T, H, D]."""
    B_, T_, H_, D_ = q.shape
    C_, KH_ = k.shape[1], k.shape[2]
    G = H_ // KH_
    R = T_ * G
    BR = _block_rows(R)
    KW = MQ_CHUNK // (WARPS // (BR // 16))  # cache rows of a warp's slice
    sm = 1.0 / math.sqrt(D_)
    out = torch.zeros(B_, T_, H_, D_)
    for b in range(B_):
        pos = int(lengths[b]) + torch.arange(R) // G * int(strides[b])
        for kh in range(KH_):
            qr = q[b, :, kh * G:(kh + 1) * G].reshape(R, D_).float()
            for r0 in range(0, R, BR):
                nr = min(BR, R - r0)
                pr = pos[r0:r0 + nr, None]
                c_lo = max(int(pr[0]) + 1 - window, 0) if window else 0
                c_hi = min(int(pr[-1]) + 1, C_)
                if c_lo >= c_hi:  # no visible row: zeros
                    continue
                shares = []
                for z in range(splits):
                    lo, hi = split.split_share(c_lo, c_hi, z, splits) if splits > 1 else (c_lo, c_hi)
                    if lo >= hi:  # an empty share takes no part
                        continue
                    warps = []
                    for w in range(0, MQ_CHUNK, KW):
                        m, l_ = torch.full((nr,), NEG), torch.zeros(nr)
                        acc = torch.zeros(nr, D_)
                        for c0 in range(lo + w, hi, MQ_CHUNK):
                            cols = torch.arange(c0, min(c0 + KW, hi))
                            s = (qr[r0:r0 + nr] @ k[b, cols, kh].float().T) * sm
                            live = cols[None] <= pr
                            if window:
                                live = live & (cols[None] > pr - window)
                            s = torch.where(live, s, torch.full_like(s, NEG))
                            mx = torch.maximum(m, s.amax(-1))
                            alpha = torch.exp(m - mx)
                            p = torch.where(live, torch.exp(s - mx[:, None]), torch.zeros_like(s))
                            pv = p.to(v.dtype).float() @ v[b, cols, kh].float()
                            m, l_, acc = mx, l_ * alpha + p.sum(-1), acc * alpha[:, None] + pv
                        warps.append((m, l_, acc))
                    shares.append(_merge(warps))
                _, L, O = _merge(shares)
                o = O / torch.where(L <= 0, torch.ones_like(L), L)[:, None]
                rows = torch.arange(r0, r0 + nr)
                out[b, rows // G, kh * G + rows % G] = o
    return out.to(q.dtype)


# (T, H, KH): R = T * H / KH query rows a (slot, kv head)
GEOMS = {"R24": (3, 8, 1), "R32": (8, 8, 2), "R64": (8, 8, 1), "R248": (31, 8, 1)}
MQ_B, MQ_C, MQ_D = 6, 128, 16


def _mq_lengths(T):
    """Slot 0 inactive (stride 0); slot 1 at length 0; slot 2's block sees
    33 rows (two splits: 32 rows and a one-row share); slot 3 long, slot 4
    mid-cache; slot 5's staircase ends on the last cache row."""
    lengths = np.asarray([0, 0, 33 - T, 70, 50, MQ_C - T], np.int32)
    strides = np.asarray([0, 1, 1, 1, 1, 1], np.int32)
    return np.maximum(lengths, 0), strides


@functools.lru_cache(maxsize=None)
def _mq_case(geom, window):
    """Inputs of a case and the JAX package's two answers: its reference and
    its Pallas kernel in interpret mode."""
    T, H_, KH_ = GEOMS[geom]
    rng = np.random.default_rng(100 + T + H_ // KH_ + (window or 0))
    q = rng.normal(size=(MQ_B, T, H_, MQ_D)).astype(np.float32)
    k = rng.normal(size=(MQ_B, MQ_C, KH_, MQ_D)).astype(np.float32)
    v = rng.normal(size=(MQ_B, MQ_C, KH_, MQ_D)).astype(np.float32)
    lengths, strides = _mq_lengths(T)
    jargs = [jnp.asarray(a) for a in (q, k, v, lengths, strides)]
    ref = np.asarray(jver.multiquery_decode_attention_reference(*jargs, window=window))
    pallas = np.asarray(jver.multiquery_decode_attention(*jargs, window=window, block_kv=16,
                                                         interpret=True))
    return (q, k, v, lengths, strides), ref, pallas


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("window", [None, 20, 45], ids=["full", "w20", "w45"])
@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_mq_recurrence_matches_jax(geom, window, splits):
    """K6's tiles, chunks, warp slices and split-and-merge, held to the JAX
    reference and to the Pallas kernel: a ragged last tile (R = 24, and 248
    = 3 x 64 + 56), 1/2/4/8 splits, empty and one-row shares, an inactive
    slot, windows that cut a staircase (window 20 < T = 31)."""
    arrays, ref, pallas = _mq_case(geom, window)
    got = _mq_recurrence(*(torch.from_numpy(a) for a in arrays), window, splits)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    np.testing.assert_allclose(got.numpy(), pallas, **TOL)
    # and the port's plain version, which masks the whole cache
    plain = ops.multiquery_decode_attention(*(torch.from_numpy(a) for a in arrays),
                                            window=window)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


@pytest.mark.parametrize("window", [None, 20], ids=["full", "w20"])
@pytest.mark.parametrize("splits", [1, 8])
def test_mq_recurrence_saturated_slot(window, splits):
    """A staircase that runs past the cache end reads no row past it: the
    other slots stay exact and the saturated slot's rows finite; a block
    whose queries see no row at all (every query past C + window) gives 0."""
    arrays, _, _ = _mq_case("R64", window)
    q, k, v, lengths, strides = (torch.from_numpy(a) for a in arrays)
    lengths = lengths.clone()
    lengths[3] = MQ_C - 2  # rows C-2 .. C+5
    got = _mq_recurrence(q, k, v, lengths, strides, window, splits)
    want = np.asarray(jver.multiquery_decode_attention(
        *(jnp.asarray(t.numpy()) for t in (q, k, v, lengths, strides)), window=window,
        block_kv=16, interpret=True))
    keep = [b for b in range(MQ_B) if b != 3]
    np.testing.assert_allclose(got.numpy()[keep], want[keep], **TOL)
    assert torch.isfinite(got).all()
    if window:
        lengths[3] = MQ_C + window  # the whole staircase past C + window
        dark = _mq_recurrence(q, k, v, lengths, strides, window, splits)
        assert torch.equal(dark[3], torch.zeros_like(dark[3]))


# -- K9: the split over the dense cache with the least share ------------------

K9_C, K9_KH, K9_H, K9_D = 768, 2, 8, 16
# with a least share of 256 rows, 701 rows split four ways fill three blocks
# (not four of 192), 258 rows two, 256 one, and a 400-row window two
K9_LENGTHS = np.asarray([700, 513, 300, 257, 255, 0, 767], np.int32)


def _int8_split(q, kq, vq, ks, vs, lengths, window, splits, min_rows):
    """K9's recurrence in plain torch, f32 throughout; q [B, H, D]."""
    B_, H_, D_ = q.shape
    KH_ = kq.shape[2]
    G = H_ // KH_
    qs = q.float().reshape(B_, KH_, G, D_) / math.sqrt(D_)  # q scaled first
    out = torch.zeros(B_, KH_, G, D_)
    for b in range(B_):
        n = int(lengths[b])
        lo, hi = (max(n + 1 - window, 0) if window else 0), n + 1
        shares = []
        for z in range(splits):
            c_lo, c_hi = split.split_share(lo, hi, z, splits, min_rows)
            if c_lo >= c_hi:
                continue
            kz = kq[b, c_lo:c_hi].float().transpose(0, 1)  # [KH, n, D]
            vz = vq[b, c_lo:c_hi].float().transpose(0, 1)
            sc = torch.einsum("kgd,knd->kgn", qs[b], kz) * ks[b, c_lo:c_hi].T[:, None, :]
            m = sc.amax(-1)
            p = torch.exp(sc - m[..., None])
            pv = p * vs[b, c_lo:c_hi].T[:, None, :]
            shares.append((m, p.sum(-1), torch.einsum("kgn,knd->kgd", pv, vz)))
        M = torch.stack([m for m, _, _ in shares]).amax(0)
        L, O = torch.zeros_like(M), torch.zeros(KH_, G, D_)
        for m, l_, acc in shares:
            f = torch.exp(m - M)
            L, O = L + l_ * f, O + acc * f[..., None]
        out[b] = O / torch.where(L <= 0, torch.ones_like(L), L)[..., None]
    return out.reshape(B_, H_, D_)


@pytest.mark.parametrize("min_rows", [0, split.MIN_SHARE_ROWS_D128], ids=["equal", "least"])
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("window", [None, 400], ids=["full", "w400"])
def test_int8_split_recurrence_matches_jax(window, splits, min_rows):
    """K9's split with and without the least share the D = 128 builds hold,
    held to the JAX reference and the port's plain version in f32."""
    import aios_tpu.engine.model as jm

    rng = np.random.default_rng(200 + splits + (window or 0))
    q = rng.normal(size=(len(K9_LENGTHS), K9_H, K9_D)).astype(np.float32)
    shape = (len(K9_LENGTHS), K9_C, K9_KH, K9_D)
    kq, ks = (np.array(a) for a in jm.quantize_kv(jnp.asarray(rng.normal(size=shape),
                                                                 jnp.float32)))
    vq, vs = (np.array(a) for a in jm.quantize_kv(jnp.asarray(rng.normal(size=shape),
                                                                 jnp.float32)))
    arrays = (q, kq, vq, ks, vs, K9_LENGTHS)
    got = _int8_split(*(torch.from_numpy(a) for a in arrays), window, splits, min_rows)
    want = jdec.decode_attention_int8_reference(*(jnp.asarray(a) for a in arrays),
                                                window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    plain = ops.decode_attention_int8(*(torch.from_numpy(a) for a in arrays), window=window)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


@pytest.mark.parametrize("visible,live", [(8191, 4), (4096, 4), (1024, 4), (1023, 4),
                                          (301, 2), (257, 2), (256, 1), (1, 1)])
def test_k9_least_share_at_mistrals_shapes(visible, live):
    """Mistral-7B's dense step splits 4 ways (8 slots x 8 kv heads on 132
    SMs); a slot of a few hundred rows fills fewer, fuller blocks."""
    assert split.split_plan(8192, 8, 8, 132) == 4
    shares = [split.split_share(0, visible, z, 4, split.MIN_SHARE_ROWS_D128) for z in range(4)]
    assert sum(hi > lo for lo, hi in shares) == live
    assert max(hi for _, hi in shares) == visible


# -- what the kernel and the wrappers share ---------------------------------------


def test_kernel_constants_match_the_wrappers():
    """The block rows, chunk rows, tile rule and partial size in the source
    are the ones the wrappers and this file's recurrences use."""
    assert f"constexpr int kMqMaxRows = {split.MQ_BLOCK_ROWS};" in TEXT
    assert f"constexpr int kMqChunk = {MQ_CHUNK};" in TEXT
    assert "constexpr int mq_tiles(int R) { return R <= 32 ? 2 : 4; }" in TEXT
    assert _block_rows(248) == split.MQ_BLOCK_ROWS and _block_rows(32) == 32
    assert f"constexpr int kWarps = {WARPS};" in (build.CSRC / "attention_common.cuh").read_text()
    common = (build.CSRC / "attention_common.cuh").read_text()
    assert "template <int D, int R = kMaxG>" in common and "return R * (D + 2);" in common
    assert split.partial_floats(128, split.MQ_BLOCK_ROWS) == 64 * 130
    assert split.partial_floats(64) == split.MAX_GROUP * 66
    # K6 merges partials of its block's rows; K9 takes the least share
    assert "merge_row_splits<D, BR>(" in TEXT and "partial_floats<D, BR>()" in TEXT
    assert "clip_to_split(c_lo, c_hi, split, splits, E::kQuant ? kMinShareRows<D> : 0)" in TEXT
    # K6 on the tensor cores with an asynchronous ring; K7 keeps one split
    for used in ("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32", "ldmatrix.sync",
                 ".trans", "cp.async.cg.shared.global", "cp.async.wait_group"):
        assert used in TEXT, used
    # K9 holds four query rows a block where G <= 4, else eight: one tile of
    # a (slot, kv head) either way, so its workspace has B * KH groups
    assert "if (H / KH <= 4) return launch_d<T, kQRound, kSplit, 4>(DENSE_LAUNCH_ARGS);" in TEXT
    assert "constexpr int kRows = kMaxG;" in TEXT
    assert "const dim3 grid((Tq * G + kR - 1) / kR * splits, KH, B);" in TEXT
    for G in range(1, split.MAX_GROUP + 1):
        assert -(-G // (4 if G <= 4 else split.MAX_GROUP)) == 1
    assert "dispatch<int8_t, false, false>" in TEXT  # K7
    assert "dispatch<int8_t, false, true>" in TEXT  # K9
    assert "dispatch<__nv_bfloat16, true, true>" in TEXT  # K8
    assert "atomicAdd" not in TEXT  # the only atomic is merge_splits' ticket


def _c_params(symbol):
    sig = TEXT[TEXT.index(f'extern "C" int {symbol}('):]
    params = sig[sig.index("(") + 1:sig.index(")")].split(",")
    kinds = []
    for p in params:
        p = " ".join(p.split())
        kinds.append(ctypes.c_void_p if "*" in p else
                     ctypes.c_float if p.startswith("float") else ctypes.c_int)
    return kinds


ENTRIES = {  # entry: (wrapper, multi-query, int8)
    "aios_decode_attention": (ops.decode_attention, False, False),
    "aios_decode_attention_int8": (ops.decode_attention_int8, False, True),
    "aios_multiquery_decode_attention": (ops.multiquery_decode_attention, True, False),
    "aios_multiquery_decode_attention_int8": (ops.multiquery_decode_attention_int8, True, True),
}
SPLIT_ENTRIES = ("aios_decode_attention", "aios_decode_attention_int8",
                 "aios_multiquery_decode_attention")


def _operands(multi, quant, T=31, H_=8, KH_=2, D_=64, C_=256, B_=3, **bad):
    q = torch.zeros((B_, T, H_, D_) if multi else (B_, H_, D_),
                    dtype=bad.get("q_dtype", torch.bfloat16))
    dtype = bad.get("cache_dtype", torch.int8 if quant else torch.bfloat16)
    k = torch.zeros(B_, C_, KH_, D_, dtype=dtype)
    scales = (torch.ones(B_, C_, KH_),) * 2 if quant else ()
    lens = torch.zeros(B_, dtype=bad.get("index_dtype", torch.int32))
    return q, k, scales, ((lens, lens) if multi else (lens,))


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_entry_argtypes_match_the_c_signatures(entry, monkeypatch):
    """What ``launch`` passes each entry, pointer for pointer and int for
    int, is the entry's C parameter list; the split entries get a workspace
    of the groups and partial rows their kernels index: a group per (slot,
    kv head) of MAX_GROUP rows, for K6 per (tile of 64 query rows, kv
    head, slot) of MQ_BLOCK_ROWS rows."""
    wrapper, multi, quant = ENTRIES[entry]
    seen = {}

    def kernel(name, symbol, argtypes):
        seen.update(name=name, symbol=symbol, argtypes=list(argtypes))
        return lambda *args: seen.update(args=args) or 0

    def workspace(dev, stream, groups, splits, D, rows=split.MAX_GROUP):
        seen.update(workspace=(groups, splits, D, rows))
        return (4096, 8192)

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(dattn.build, "kernel", kernel)
    monkeypatch.setattr(dattn, "workspace", workspace)
    monkeypatch.setattr(dattn, "sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream())
    q, k, scales, index = _operands(multi, quant)
    before = wrapper.launches
    dattn.launch(wrapper, entry, q, k, k, scales, index, None, split=entry in SPLIT_ENTRIES)
    assert wrapper.launches == before + 1
    assert seen["symbol"] == entry and seen["name"] == "dense_attention"
    assert seen["argtypes"] == _c_params(entry)
    assert len(seen["args"]) == len(seen["argtypes"])
    plan = split.split_plan(256, 3, 2, 132)
    if entry == "aios_multiquery_decode_attention":
        # 31 queries x 4 heads = 124 rows a (slot, kv head): two blocks of 64
        assert seen["workspace"] == (3 * 2 * 2, plan, 64, split.MQ_BLOCK_ROWS)
    elif entry in SPLIT_ENTRIES:
        assert seen["workspace"] == (3 * 2, plan, 64, split.MAX_GROUP)
    else:
        assert "workspace" not in seen


@pytest.mark.parametrize("entry", SPLIT_ENTRIES[1:])
@pytest.mark.parametrize("bad,match", [
    (dict(D_=32), "head_dim 32"),
    (dict(H_=32, KH_=2), "H / KH <= 8"),
    (dict(q_dtype=torch.float32), "bfloat16"),
    (dict(cache_dtype=torch.float16), "caches must be"),
    (dict(index_dtype=torch.int64), "int32"),
])
def test_k6_and_k9_refuse_before_any_launch(entry, bad, match):
    """K6's and K9's split launches check every operand first: a refused
    operand raises by name and counts no launch."""
    wrapper, multi, quant = ENTRIES[entry]
    q, k, scales, index = _operands(multi, quant, **bad)
    before = wrapper.launches
    with pytest.raises(ValueError, match=match):
        dattn.launch(wrapper, entry, q, k, k, scales, index, None, split=True)
    assert wrapper.launches == before


def test_k6_block_rows_follow_the_tile_rule():
    """Workspace groups per (slot, kv head) for K6: ceil(R / 64) at every
    R, which is one block of 32 rows for R <= 32."""
    for T, G, blocks in [(1, 8, 1), (3, 8, 1), (4, 8, 1), (8, 4, 1), (8, 8, 1), (9, 8, 2),
                         (31, 8, 4), (31, 4, 2)]:
        R = T * G
        assert -(-R // _block_rows(R)) == blocks == -(-R // split.MQ_BLOCK_ROWS)
    assert re.search(r"grid\(\(rows \+ 16 \* MT - 1\) / \(16 \* MT\) \* splits, KH, B\)", TEXT)


@pytest.mark.parametrize("patch", sorted((build.PKG / "tools" / "dense_variants").glob("*.patch")),
                         ids=lambda p: p.stem)
def test_rejected_designs_patch_the_dense_source(patch):
    """The K6 and K9 designs split_sweep timed and the source does not keep
    are patches of ``csrc/dense_attention.cu``: each hunk's old lines stand
    in it as they are, so the patch still applies, and it changes it."""
    diff = patch.read_text()
    assert re.search(r"^\+\+\+ b/aios_tpu_torch/csrc/dense_attention\.cu$", diff, re.M)
    text = TEXT
    for hunk in diff.split("\n@@")[1:]:
        lines = hunk.split("\n")[1:]
        old = "\n".join(line[1:] for line in lines if line[:1] in (" ", "-"))
        new = "\n".join(line[1:] for line in lines if line[:1] in (" ", "+"))
        assert text.count(old) == 1, patch.name
        text = text.replace(old, new)
    assert text != TEXT
