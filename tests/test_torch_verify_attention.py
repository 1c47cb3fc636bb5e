"""K6 (``multiquery_decode_attention``) and K7
(``multiquery_decode_attention_int8``), the tensor-core kernel of
``csrc/dense_attention.cu`` over a bf16 and an int8 cache, and K9's split
(``decode_attention_int8``) on the CPU.

The CUDA kernels cannot run here, so their recurrences are written out in
plain torch at the kernels' rounding points. K6 and K7 (``_mq_recurrence``):
the T * G query rows of a (slot, kv head), ordered (t, g), in blocks of 32
or 64 rows; a block's visible rows cut into its split's share
(``split_share``, K7 with a least share); each share walked in 64-row
chunks whose slices go to the warps of a tile, each warp with its own
online softmax (q . k unscaled, then ``sm_scale`` in f32 and for K7 the K
scale; K6 rounds p to the cache dtype for P V, K7 splits w = p * v_scale
into ``K7_TERMS`` bf16 terms, each times the exact int8 V; l sums the
unrounded p); the warps' partials merged, then the shares' in split order.
K9 (``_int8_split``): each slot's visible rows cut into shares of at least
``min_rows`` rows, f32 throughout (q scaled first, the K scale on the
score, p * v_scale on v unrounded). All are held to the JAX package (its
references, and K6 and K7 to its Pallas kernel in interpret mode) at
``atol = rtol = 1e-5``, f32 inputs. The kernels themselves run on the card
against the port's plain versions (``chip_smoke.py``).
"""

import ctypes
import functools
import importlib
import math
import re
import struct

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
K7_TERMS = 3  # kMqVTerms: bf16 terms of each K7 P V weight
K7_STAGES = 4  # MqSmem<int8_t, D>::kStages: K7's ring
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


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _terms(w, n):
    """w as n bf16 terms, each the bf16 of what the earlier ones left."""
    out = []
    for _ in range(n):
        out.append(_bf16(w))
        w = w - out[-1]
    return out


def _mq_recurrence(q, k, v, lengths, strides, window, splits, scales=None, min_rows=0,
                   terms=K7_TERMS):
    """K6's recurrence in plain torch or, with ``scales`` = (k_scales,
    v_scales) and int8 caches, K7's; q [B, T, H, D], caches [B, C, KH, D]
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
                    lo, hi = (split.split_share(c_lo, c_hi, z, splits, min_rows) if splits > 1
                              else (c_lo, c_hi))
                    if lo >= hi:  # an empty share takes no part
                        continue
                    warps = []
                    for w in range(0, MQ_CHUNK, KW):
                        m, l_ = torch.full((nr,), NEG), torch.zeros(nr)
                        acc = torch.zeros(nr, D_)
                        for c0 in range(lo + w, hi, MQ_CHUNK):
                            cols = torch.arange(c0, min(c0 + KW, hi))
                            s = (qr[r0:r0 + nr] @ k[b, cols, kh].float().T) * sm
                            if scales is not None:
                                s = s * scales[0][b, cols, kh]
                            live = cols[None] <= pr
                            if window:
                                live = live & (cols[None] > pr - window)
                            s = torch.where(live, s, torch.full_like(s, NEG))
                            mx = torch.maximum(m, s.amax(-1))
                            alpha = torch.exp(m - mx)
                            p = torch.where(live, torch.exp(s - mx[:, None]), torch.zeros_like(s))
                            vr = v[b, cols, kh].float()
                            if scales is None:
                                pv = p.to(v.dtype).float() @ vr
                            else:
                                pv = sum(t @ vr for t in _terms(p * scales[1][b, cols, kh], terms))
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


# -- K7: K6's tiles and split over the int8 cache -------------------------------

# (T, H, KH) at Mistral-7B's G = 4: R = 12, 24, 32 (one 32-row block) and
# 124 (two 64-row blocks, the second ragged)
K7_GEOMS = {"R12": (3, 8, 2), "R24": (6, 8, 2), "R32": (8, 8, 2), "R124": (31, 8, 2)}
K7_B, K7_C, K7_D = 6, 768, 16


def _k7_lengths(T):
    """Slot 0 inactive (stride 0); slot 1 at length 0; slot 2's block sees
    33 rows; slot 3 long (700 + T rows: three shares of 256 with the least
    share, four of 192 without), slot 4 mid-cache; slot 5's staircase ends
    on the last cache row."""
    lengths = np.asarray([0, 0, 33 - T, 700, 300, K7_C - T], np.int32)
    strides = np.asarray([0, 1, 1, 1, 1, 1], np.int32)
    return np.maximum(lengths, 0), strides


def _k7_inputs(T, H_, KH_, seed):
    """q (bf16-exact, as the kernel receives it), the int8 caches and
    scales from the JAX package's quantizer, lengths and strides."""
    import aios_tpu.engine.model as jm

    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(K7_B, T, H_, K7_D)).astype(np.float32))
    q = q.to(torch.bfloat16).float().numpy()
    shape = (K7_B, K7_C, KH_, K7_D)
    kq, ks = (np.array(a) for a in jm.quantize_kv(jnp.asarray(rng.normal(size=shape),
                                                                 jnp.float32)))
    vq, vs = (np.array(a) for a in jm.quantize_kv(jnp.asarray(rng.normal(size=shape),
                                                                 jnp.float32)))
    return (q, kq, vq, ks, vs, *_k7_lengths(T))


@functools.lru_cache(maxsize=None)
def _k7_case(geom, window):
    """Inputs of a K7 case and the JAX package's two answers: its reference
    and its Pallas kernel in interpret mode."""
    T, H_, KH_ = K7_GEOMS[geom]
    arrays = _k7_inputs(T, H_, KH_, 300 + T + (window or 0))
    jargs = [jnp.asarray(a) for a in arrays]
    ref = np.asarray(jver.multiquery_decode_attention_int8_reference(*jargs, window=window))
    pallas = np.asarray(jver.multiquery_decode_attention_int8(*jargs, window=window,
                                                              block_kv=64, interpret=True))
    return arrays, ref, pallas


def _k7(arrays, window, splits, min_rows, terms=K7_TERMS):
    q, kq, vq, ks, vs, lengths, strides = (torch.from_numpy(a) for a in arrays)
    return _mq_recurrence(q, kq, vq, lengths, strides, window, splits, (ks, vs), min_rows,
                          terms)


@pytest.mark.parametrize("min_rows", [0, split.MIN_SHARE_ROWS_D128], ids=["equal", "least"])
@pytest.mark.parametrize("splits", [1, 2, 4])
@pytest.mark.parametrize("window", [None, 20, 300], ids=["full", "w20", "w300"])
@pytest.mark.parametrize("geom", sorted(K7_GEOMS))
def test_k7_recurrence_matches_jax(geom, window, splits, min_rows):
    """K7's tiles, chunks, warp slices and split-and-merge with its
    arithmetic (unscaled q . k_int8, then sm_scale and k_scale; w = p *
    v_scale as three bf16 terms on the exact int8 V; l from the unrounded
    p), held to the JAX int8 reference and to its Pallas kernel: 1, 2 and 4
    splits with and without the 256-row least share, empty and one-row
    shares, an inactive slot, windows that cut a staircase (20 < T = 31)."""
    arrays, ref, pallas = _k7_case(geom, window)
    got = _k7(arrays, window, splits, min_rows).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)
    plain = ops.multiquery_decode_attention_int8(*(torch.from_numpy(a) for a in arrays),
                                                 window=window)
    np.testing.assert_allclose(got, plain.numpy(), **TOL)


@pytest.mark.parametrize("window", [None, 20], ids=["full", "w20"])
@pytest.mark.parametrize("splits", [1, 4])
def test_k7_recurrence_saturated_and_inactive_slots(window, splits):
    """A staircase past the cache end reads no row past it: the other slots
    stay exact and the saturated slot's rows finite; a block that sees no
    row gives 0; the inactive slot (stride 0) returns V row 0, dequantized,
    for every query."""
    arrays, _, _ = _k7_case("R32", window)
    q, kq, vq, ks, vs, lengths, strides = arrays
    lengths = lengths.copy()
    lengths[3] = K7_C - 2  # rows C-2 .. C+5
    got = _k7((q, kq, vq, ks, vs, lengths, strides), window, splits,
              split.MIN_SHARE_ROWS_D128).numpy()
    want = np.asarray(jver.multiquery_decode_attention_int8(
        *(jnp.asarray(a) for a in (q, kq, vq, ks, vs, lengths, strides)), window=window,
        block_kv=64, interpret=True))
    keep = [b for b in range(K7_B) if b != 3]
    np.testing.assert_allclose(got[keep], want[keep], **TOL)
    assert np.isfinite(got).all()
    v0 = vq[0, 0].astype(np.float32) * vs[0, 0][:, None]  # [KH, D]
    np.testing.assert_allclose(got[0], np.broadcast_to(np.repeat(v0, 4, axis=0), got[0].shape),
                               **TOL)
    if window:
        lengths[3] = K7_C + window  # the whole staircase past C + window
        dark = _k7((q, kq, vq, ks, vs, lengths, strides), window, splits, 0)
        assert np.array_equal(dark[3].numpy(), np.zeros_like(got[3]))


def test_k7_weight_terms_reach_f32():
    """Three bf16 terms sum to w = p * v_scale within f32's rounding (each
    term is the bf16 of what the earlier ones left, an exact f32 difference);
    two leave up to 2^-16 of w, more than the 1e-5 the CPU model is held to:
    the reason the kernel takes three."""
    rng = np.random.default_rng(5)
    w = torch.from_numpy((rng.random(20000) * 10.0 ** rng.uniform(-30, 2, 20000)).astype(
        np.float32))
    rel = {n: ((sum(_terms(w, n)) - w).abs() / w).max().item() for n in (2, 3)}
    assert rel[3] <= 2.0 ** -24, rel
    assert 2.0 ** -20 < rel[2] <= 2.0 ** -16, rel
    # the terms shrink: each at most 2^-8 of the one before
    hi, mid, lo = _terms(w, 3)
    assert (mid.abs() <= hi.abs() * 2.0 ** -8).all() and (lo.abs() <= mid.abs() * 2.0 ** -8).all()


# -- the int8 -> bf16 conversion K7 shares with K1 and K5 -----------------------

CONVERT = (build.CSRC / "int8_bf16.cuh").read_text()


def _byte_perm(x: int, y: int, s: int) -> int:
    """CUDA's __byte_perm: byte i of the result is byte (s >> 4i) & 7 of
    the eight bytes of y:x."""
    pool = (y << 32 | x).to_bytes(8, "little")
    return int.from_bytes(bytes(pool[(s >> 4 * i) & 7] for i in range(4)), "little")


def _f32(bits: int) -> float:
    return struct.unpack("<f", struct.pack("<I", bits))[0]


def _bits(x: float) -> int:
    return struct.unpack("<I", struct.pack("<f", x))[0]


def _i8x4_to_bf16(u: int):
    """``i8x4_to_bf16`` step by step, its constants read from the source."""
    sel = [int(v, 16) for v in re.findall(r"__byte_perm\(u, 0x4B000000u, (0x[0-9a-fA-F]+)\)",
                                           CONVERT)]
    offset = float(re.search(r"\) - (\d+)\.f;", CONVERT).group(1))
    pack = int(re.search(r"__float_as_uint\(f1\), (0x[0-9a-fA-F]+)\)", CONVERT).group(1), 16)
    u ^= 0x80808080
    f = [np.float32(_f32(_byte_perm(u, 0x4B000000, s_))) - np.float32(offset) for s_ in sel]
    return (_byte_perm(_bits(f[0]), _bits(f[1]), pack),
            _byte_perm(_bits(f[2]), _bits(f[3]), pack))


def test_i8x4_to_bf16_is_exact_for_every_byte():
    """Every int8 value, in every byte of the word, becomes the bf16 of
    itself: the bf16x2 words K7's (and K1's) fragments take."""
    values = np.arange(-128, 128, dtype=np.int32)
    want = torch.from_numpy(values.astype(np.float32)).to(torch.bfloat16).view(torch.int16)
    want = want.numpy().astype(np.uint16)
    for j, v in enumerate(values):
        b = int(v) & 0xFF
        for pos in range(4):
            word = (b << 8 * pos) | (0x5A << 8 * ((pos + 1) % 4))
            lo, hi = _i8x4_to_bf16(word)
            halves = [lo & 0xFFFF, lo >> 16, hi & 0xFFFF, hi >> 16]
            assert halves[pos] == want[j], (int(v), pos)
            assert halves[(pos + 1) % 4] == want[90 + 128]  # 0x5A = 90


def test_gather_pairs_two_rows_for_both_column_pairs():
    """gather and gather_hi interleave two rows' bytes 0, 1 and 2, 3: one V
    word of rows 2t and 2t + 1 gives the b0 words of four n tiles."""
    assert "__byte_perm(row_a, row_b, 0x5140)" in CONVERT
    assert "__byte_perm(row_a, row_b, 0x7362)" in CONVERT
    a, b = 0x03020100, 0x13121110
    assert _byte_perm(a, b, 0x5140) == 0x11011000  # (a0, b0, a1, b1)
    assert _byte_perm(a, b, 0x7362) == 0x13031202  # (a2, b2, a3, b3)
    wq = (build.CSRC / "wq_matmul.cuh").read_text()
    assert '#include "int8_bf16.cuh"' in wq and "__byte_perm(row_a" not in wq
    assert '#include "int8_bf16.cuh"' in TEXT


def _smem_struct(dtype: str) -> dict:
    body = TEXT[TEXT.index(f"struct MqSmem<{dtype}, D> {{"):]
    body = body[:body.index("};")]
    return dict(re.findall(r"static constexpr int (\w+) = ([^;]+);", body))


@pytest.mark.parametrize("D", [64, 128])
def test_k7_shared_memory_layout(D):
    """K7's ring (read from the source): each lane's shared loads of a
    phase fall on distinct banks (K 8 bytes a lane, q 16, V D / 8 of rows
    2t, 2t + 1, 2t + 8, 2t + 9), every copy is 16-byte aligned, and the
    32-row build fits two blocks per SM."""
    env = {"D": D, "kMqChunk": MQ_CHUNK}
    for name, expr in _smem_struct("int8_t").items():  # in the order the source defines them
        env[name] = eval(expr, {}, env)
    assert env["kStages"] == K7_STAGES
    pk, pv, pq = env["kPitchK"], env["kPitchV"], env["kPitchQ"]
    assert pk % 16 == pv % 16 == pq % 16 == env["kOffScales"] % 16 == env["kStage"] % 16 == 0

    def distinct(addrs, width):  # one phase: the lanes' bytes on distinct banks
        banks = [(a + i) // 4 % 32 for a in addrs for i in range(0, width, 4)]
        assert len(set(banks)) == len(banks), addrs

    lanes = range(32)
    for phase in range(2):  # K: 8 bytes, half a warp a phase
        distinct([(ln // 4) * pk + 8 * (ln % 4) for ln in lanes[16 * phase:16 * phase + 16]], 8)
    for phase in range(4):  # q: 16 bytes, a quarter warp a phase
        distinct([(ln // 4) * pq + 16 * (ln % 4) for ln in lanes[8 * phase:8 * phase + 8]], 16)
    vb = D // 8
    per = 128 // vb  # lanes a phase
    for row in (0, 1, 8, 9):
        for phase in range(32 // per):
            distinct([(2 * (ln % 4) + row) * pv + (ln // 4) * vb
                      for ln in lanes[per * phase:per * phase + per]], vb)
    assert env["kStage"] == MQ_CHUNK * (pk + pv + 2 * 4)  # K and V rows, two scales a row
    for MT in (2, 4):  # the warps' partials fit in the ring; two 32-row blocks fit an SM
        BR, NG = 16 * MT, WARPS // MT
        assert NG * BR * D * 4 <= K7_STAGES * env["kStage"]
        static = 4 * (2 * NG * BR + 2 * BR + 8 * BR + 1)
        smem = BR * pq + K7_STAGES * env["kStage"] + static
        assert smem <= 232448 and (MT == 4 or 2 * smem <= 232448)


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
    """The block rows, chunk rows, tile rule, weight terms, least share and
    partial size in the source are the ones the wrappers and this file's
    recurrences use."""
    assert f"constexpr int kMqMaxRows = {split.MQ_BLOCK_ROWS};" in TEXT
    assert f"constexpr int kMqChunk = {MQ_CHUNK};" in TEXT
    assert f"constexpr int kMqVTerms = {K7_TERMS};" in TEXT
    assert "constexpr int mq_tiles(int R) { return R <= 32 ? 2 : 4; }" in TEXT
    assert _block_rows(248) == split.MQ_BLOCK_ROWS and _block_rows(32) == 32
    assert f"constexpr int kWarps = {WARPS};" in (build.CSRC / "attention_common.cuh").read_text()
    common = (build.CSRC / "attention_common.cuh").read_text()
    assert "template <int D, int R = kMaxG>" in common and "return R * (D + 2);" in common
    assert f"constexpr int kMinShareRows = D == 64 ? 0 : {split.MIN_SHARE_ROWS_D128};" in common
    assert split.partial_floats(128, split.MQ_BLOCK_ROWS) == 64 * 130
    assert split.partial_floats(64) == split.MAX_GROUP * 66
    # K6 and K7 merge partials of their block's rows; K9 and K7 take the
    # least share, K6 none
    assert "merge_row_splits<D, BR>(" in TEXT and "partial_floats<D, BR>()" in TEXT
    assert "clip_to_split(c_lo, c_hi, split, splits, E::kQuant ? kMinShareRows<D> : 0)" in TEXT
    assert "clip_to_split(c_lo, c_hi, split, splits, kMqMinShareRows<T, D>)" in TEXT
    assert ("constexpr int kMqMinShareRows = std::is_same<T, int8_t>::value ? kMinShareRows<D> : 0;"
            in TEXT)
    # K6 and K7 on the tensor cores with an asynchronous ring (K7's scales by
    # 4-byte copies); K7 converts its int8 fragments in registers
    for used in ("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32", "ldmatrix.sync",
                 ".trans", "cp.async.cg.shared.global", "cp.async.wait_group",
                 "cp.async.ca.shared.global [%0], [%1], 4, %2;", "i8x4_to_bf16(kr.x",
                 "gather_hi(rv[0][wd], rv[1][wd])"):
        assert used in TEXT, used
    # K9 holds four query rows a block where G <= 4, else eight: one tile of
    # a (slot, kv head) either way, so its workspace has B * KH groups
    assert "if (H / KH <= 4) return launch_d<T, kQRound, 4>(DENSE_LAUNCH_ARGS);" in TEXT
    assert "constexpr int kRows = kMaxG;" in TEXT
    assert "const dim3 grid(splits, KH, B);" in TEXT
    for G in range(1, split.MAX_GROUP + 1):
        assert -(-G // (4 if G <= 4 else split.MAX_GROUP)) == 1
    assert "dispatch_mq<int8_t>(" in TEXT  # K7
    assert "dispatch_mq<__nv_bfloat16>(" in TEXT  # K6
    assert "dispatch<int8_t, false>(" in TEXT  # K9
    assert "dispatch<__nv_bfloat16, true>(" in TEXT  # K8
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
                 "aios_multiquery_decode_attention", "aios_multiquery_decode_attention_int8")


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
    kv head) of MAX_GROUP rows, for K6 and K7 per (tile of 64 query rows,
    kv head, slot) of MQ_BLOCK_ROWS rows."""
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
    if multi:
        # 31 queries x 4 heads = 124 rows a (slot, kv head): two blocks of 64
        assert seen["workspace"] == (3 * 2 * 2, plan, 64, split.MQ_BLOCK_ROWS)
    else:
        assert seen["workspace"] == (3 * 2, plan, 64, split.MAX_GROUP)


@pytest.mark.parametrize("entry", SPLIT_ENTRIES[1:])
@pytest.mark.parametrize("bad,match", [
    (dict(D_=32), "head_dim 32"),
    (dict(H_=32, KH_=2), "H / KH <= 8"),
    (dict(q_dtype=torch.float32), "bfloat16"),
    (dict(cache_dtype=torch.float16), "caches must be"),
    (dict(index_dtype=torch.int64), "int32"),
])
def test_k6_and_k9_refuse_before_any_launch(entry, bad, match):
    """K9's, K6's and K7's split launches check every operand first: a
    refused operand raises by name and counts no launch."""
    wrapper, multi, quant = ENTRIES[entry]
    q, k, scales, index = _operands(multi, quant, **bad)
    before = wrapper.launches
    with pytest.raises(ValueError, match=match):
        dattn.launch(wrapper, entry, q, k, k, scales, index, None, split=True)
    assert wrapper.launches == before


def test_k6_block_rows_follow_the_tile_rule():
    """Workspace groups per (slot, kv head) for K6 and K7: ceil(R / 64) at
    every R, which is one block of 32 rows for R <= 32."""
    for T, G, blocks in [(1, 8, 1), (3, 8, 1), (4, 8, 1), (8, 4, 1), (8, 8, 1), (9, 8, 2),
                         (31, 8, 4), (31, 4, 2)]:
        R = T * G
        assert -(-R // _block_rows(R)) == blocks == -(-R // split.MQ_BLOCK_ROWS)
    assert re.search(r"grid\(\(rows \+ 16 \* MT - 1\) / \(16 \* MT\) \* splits, KH, B\)", TEXT)


@pytest.mark.parametrize("patch", sorted((build.PKG / "tools" / "dense_variants").glob("*.patch")),
                         ids=lambda p: p.stem)
def test_rejected_designs_patch_the_dense_source(patch):
    """The K6, K7 and K9 designs split_sweep timed and the source does not
    keep are patches of ``csrc/dense_attention.cu``: each hunk's old lines stand
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
