"""The port's dense-cache attention modules (``ops/decode_attention.py``,
``ops/verify_attention.py``) and the model steps built on them
(``decode_step``, ``verify_step``) against the JAX package on the same numpy
inputs.

Tolerances: each plain version against the Pallas kernel in interpret mode
(a small ``block_kv``) and against the JAX ``*_reference`` at
``atol = rtol = 1e-5`` (f32 throughout, sums taken in another order); model
logits at 1e-4 (two layers of such sums); cache rows the two models write
from the same input to 1e-5. Where the rows are quantized, the int8 values
are equal exactly; the f32 scales, each the absmax / 127 of a row that came
out of matmuls summed in another order, to ``rtol = 2e-6`` (measured over all
cases of this file: at most 7.5e-7, on up to 5% of the scales; the quantizer
alone, on identical f32 rows, gives identical scales:
``test_torch_kv_int8.py::test_quantize_kv_same_bytes_as_jax``). The
CUDA kernels themselves run on the card against these plain versions
(``chip_smoke.py``).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aios_tpu.engine import model as jm
from aios_tpu.engine.config import TINY_TEST as JAX_TINY
from aios_tpu_torch import ops
from aios_tpu_torch.engine import model as tm
from aios_tpu_torch.engine.config import TINY_TEST
from aios_tpu_torch.engine.weights import params_from_jax

# The shapes here are tiny: one intra-op thread is faster and leaves the
# cores to the other test workers.
torch.set_num_threads(1)

# the packages export functions under their modules' names
jdec = importlib.import_module("aios_tpu.ops.decode_attention")
jver = importlib.import_module("aios_tpu.ops.verify_attention")

TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
B, C, KH, H, D = 5, 64, 2, 8, 16
BLOCK_KV = 16


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _caches(rng, quant):
    q_shape = (B, C, KH, D)
    k = rng.normal(size=q_shape).astype(np.float32)
    v = rng.normal(size=q_shape).astype(np.float32)
    if not quant:
        return [k, v]
    kq, ks = (np.asarray(a) for a in jm.quantize_kv(jnp.asarray(k)))
    vq, vs = (np.asarray(a) for a in jm.quantize_kv(jnp.asarray(v)))
    return [kq, vq, ks, vs]


# -- K8 / K9: one query per slot ------------------------------------------------

# an empty slot, both sides of a block boundary, a long one, a full cache
LENGTHS = np.asarray([0, BLOCK_KV - 1, BLOCK_KV, 37, C - 1], np.int32)


@pytest.mark.parametrize("window", [None, 24], ids=["full", "window"])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_decode_attention_matches_jax(quant, window):
    rng = np.random.default_rng(10 + quant)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    caches = _caches(rng, quant)
    fn, ref, jfn, jref = (
        (ops.decode_attention_int8, ops.decode_attention_int8_reference,
         jdec.decode_attention_int8, jdec.decode_attention_int8_reference) if quant else
        (ops.decode_attention, ops.decode_attention_reference,
         jdec.decode_attention, jdec.decode_attention_reference))
    got = fn(*_t(q, *caches, LENGTHS), window=window)
    assert got.dtype == torch.float32 and got.shape == (B, H, D)
    # a CPU tensor takes the plain version
    np.testing.assert_array_equal(
        got.numpy(), ref(*_t(q, *caches, LENGTHS), window=window).numpy())
    jargs = [jnp.asarray(a) for a in (q, *caches, LENGTHS)]
    for want in (jfn(*jargs, window=window, block_kv=BLOCK_KV, interpret=True),
                 jref(*jargs, window=window)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# -- K8's split: each slot's rows over a cluster of blocks -----------------------

dattn = importlib.import_module("aios_tpu_torch.ops.decode_attention")
split = importlib.import_module("aios_tpu_torch.ops.split")


@pytest.mark.parametrize("C", [1, 100, 255, 256, 2048, 8192, 32768])
@pytest.mark.parametrize("B,KH", [(1, 1), (1, 4), (8, 4), (8, 8), (64, 8)])
@pytest.mark.parametrize("sms", [1, 132])
def test_split_plan_is_a_bounded_pure_function(C, B, KH, sms):
    """The number of splits comes from the shapes and the SM count alone:
    never more than eight, never more than the cache has passes of a block,
    and no more blocks than BLOCKS_PER_SM per SM once split."""
    n = split.split_plan(C, B, KH, sms)
    assert 1 <= n <= split.MAX_SPLITS
    assert n == 1 or n <= C // split.SPLIT_ROWS
    assert n == 1 or B * KH * n <= split.BLOCKS_PER_SM * sms
    assert split.split_plan(C, B, KH, sms) == n


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
@pytest.mark.parametrize("c_lo,c_hi", [(0, 1), (0, 31), (0, 32), (0, 33), (0, 256), (0, 257),
                                       (5, 300), (1905, 6001), (0, 2048), (4095, 8191)])
def test_split_shares_cover_the_visible_rows_once(c_lo, c_hi, splits):
    """The kernel's cut of a slot's visible rows: every row in exactly one
    share, shares in order and of whole warp chunks (the last may be short),
    the empty ones at the end."""
    owner = {}
    ends = []
    for z in range(splits):
        lo, hi = split.split_share(c_lo, c_hi, z, splits)
        ends.append((lo, hi))
        for c in range(lo, hi):
            assert c not in owner
            owner[c] = z
        if hi > lo and hi < c_hi:
            assert (hi - lo) % split.SPLIT_ALIGN == 0
    assert sorted(owner) == list(range(c_lo, c_hi))
    live = [hi > lo for lo, hi in ends]
    assert live == sorted(live, reverse=True)


def test_split_plan_fills_the_card_at_the_served_shapes():
    # TinyLlama's 8 slots x 4 kv heads over C = 2048, Mistral's 8 x 8 over 8192
    assert split.split_plan(2048, 8, 4, 132) == 8
    assert split.split_plan(8192, 8, 8, 132) == 4
    # a grid that already fills two blocks per SM is not split
    assert split.split_plan(8192, 64, 8, 132) == 1


def test_split_bounds_match_the_kernel():
    text = (dattn.build.CSRC / "attention_common.cuh").read_text()
    assert f"constexpr int kMaxSplits = {split.MAX_SPLITS};" in text
    assert f"constexpr int kSplitAlign = {split.SPLIT_ALIGN};" in text
    # the workspace the wrappers size holds what the kernels write there:
    # partials of kMaxG rows for the decode kernels, of K6's block rows for K6
    assert f"constexpr int kMaxG = {split.MAX_GROUP};" in text
    assert "template <int D, int R = kMaxG>" in text and "return R * (D + 2);" in text
    assert split.partial_floats(64) == split.MAX_GROUP * 66
    assert split.partial_floats(64, split.MQ_BLOCK_ROWS) == split.MQ_BLOCK_ROWS * 66


def _split_merge(q, k, v, lengths, window, splits):
    """The kernel's recurrence in plain torch: each slot's visible rows cut
    into ``splits`` shares (``split_share``), each share reduced to (m, l,
    acc) at the kernel's rounding points (q * sm_scale and p rounded to the
    operands' dtype; l sums the unrounded p; an empty share is m = -1e30,
    l = 0, acc = 0), then merged in split order as
    o = sum acc_z e^(m_z - M) / sum l_z e^(m_z - M)."""
    Bq, Hq, Dq = q.shape
    C_, KH_ = k.shape[1], k.shape[2]
    G = Hq // KH_
    qs = (q.float() / np.sqrt(Dq)).to(q.dtype).float().reshape(Bq, KH_, G, Dq)
    out = torch.zeros(Bq, KH_, G, Dq)
    for b in range(Bq):
        lo = max(int(lengths[b]) + 1 - window, 0) if window else 0
        hi = min(int(lengths[b]) + 1, C_)
        parts = []
        for z in range(splits):
            c_lo, c_hi = split.split_share(lo, hi, z, splits)
            if c_lo >= c_hi:
                parts.append((torch.full((KH_, G), -1e30), torch.zeros(KH_, G),
                              torch.zeros(KH_, G, Dq)))
                continue
            kz = k[b, c_lo:c_hi].float().transpose(0, 1)  # [KH, n, D]
            vz = v[b, c_lo:c_hi].float().transpose(0, 1)
            sc = torch.einsum("kgd,knd->kgn", qs[b], kz)
            m = sc.amax(-1)
            p = torch.exp(sc - m[..., None])
            acc = torch.einsum("kgn,knd->kgd", p.to(v.dtype).float(), vz)
            parts.append((m, p.sum(-1), acc))
        M = torch.stack([m for m, _, _ in parts]).amax(0)
        L, O = torch.zeros_like(M), torch.zeros(KH_, G, Dq)
        for m, l_, acc in parts:
            f = torch.exp(m - M)
            L, O = L + l_ * f, O + acc * f[..., None]
        out[b] = O / torch.where(L <= 0, torch.ones_like(L), L)[..., None]
    return out.reshape(Bq, Hq, Dq).to(q.dtype)


SPLIT_C = 128
SPLIT_CASES = {
    # four splits of 128 visible rows end on whole shares; 96, 97 and 98
    # rows leave the last share empty, one row or two; 32 rows fill one share
    "edges": [127, 126, 95, 96, 97, 31],
    # lengths 0 and 1, and every slot at length 0 but one
    "short": [0, 1, 0, 0, 0, 100],
    # windows that cut a long slot; with window 20 every slot's rows fit one share
    "windows": [70, 75, 80, 90, 95, 127],
}


@pytest.mark.parametrize("splits", [2, 4, 8])
@pytest.mark.parametrize("window", [None, 20, 40], ids=["full", "w20", "w40"])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_merge_recurrence_matches_jax(case, window, splits):
    """The split-and-merge arithmetic the K8 kernel runs, held to the JAX
    reference in f32: empty shares, one-row shares, windows, slots whose
    rows fit one share."""
    lengths = np.asarray(SPLIT_CASES[case], np.int32)
    Bs = len(lengths)
    rng = np.random.default_rng(60 + len(case) + (window or 0))
    q = rng.normal(size=(Bs, H, D)).astype(np.float32)
    k = rng.normal(size=(Bs, SPLIT_C, KH, D)).astype(np.float32)
    v = rng.normal(size=(Bs, SPLIT_C, KH, D)).astype(np.float32)
    got = _split_merge(*_t(q, k, v, lengths), window, splits)
    want = jdec.decode_attention_reference(*(jnp.asarray(a) for a in (q, k, v, lengths)),
                                           window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # and the port's plain version, which masks the whole cache
    plain = ops.decode_attention(*_t(q, k, v, lengths), window=window)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


def test_split_launch_refuses_before_any_launch():
    """The split launch checks the operands first: a wrong dtype or head dim
    raises by name and counts no launch."""
    q = torch.zeros(2, 8, 32, dtype=torch.bfloat16)
    k = torch.zeros(2, 64, 2, 32, dtype=torch.bfloat16)
    lens = torch.zeros(2, dtype=torch.int32)
    before = ops.decode_attention.launches
    with pytest.raises(ValueError, match="head_dim 32"):
        dattn.launch(ops.decode_attention, "aios_decode_attention", q, k, k, (), (lens,),
                     None, split=True)
    assert ops.decode_attention.launches == before


# -- K6 / K7: T queries per slot -------------------------------------------------


def _mq_inputs(rng, T):
    """Slot 1 is inactive (base 0, stride 0); slot 4's staircase ends on the
    last cache row."""
    lengths = np.asarray([3, 0, BLOCK_KV - 2, 37, C - T], np.int32)
    strides = np.asarray([1, 0, 1, 1, 1], np.int32)
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    return q, lengths, strides


@pytest.mark.parametrize("window", [None, 24], ids=["full", "window"])
@pytest.mark.parametrize("T", [1, 4, 8])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_multiquery_decode_attention_matches_jax(quant, T, window):
    rng = np.random.default_rng(20 + 2 * T + quant)
    q, lengths, strides = _mq_inputs(rng, T)
    caches = _caches(rng, quant)
    fn, ref, jfn, jref = (
        (ops.multiquery_decode_attention_int8,
         ops.multiquery_decode_attention_int8_reference,
         jver.multiquery_decode_attention_int8,
         jver.multiquery_decode_attention_int8_reference) if quant else
        (ops.multiquery_decode_attention, ops.multiquery_decode_attention_reference,
         jver.multiquery_decode_attention, jver.multiquery_decode_attention_reference))
    got = fn(*_t(q, *caches, lengths, strides), window=window)
    assert got.dtype == torch.float32 and got.shape == (B, T, H, D)
    np.testing.assert_array_equal(
        got.numpy(), ref(*_t(q, *caches, lengths, strides), window=window).numpy())
    jargs = [jnp.asarray(a) for a in (q, *caches, lengths, strides)]
    for want in (jfn(*jargs, window=window, block_kv=BLOCK_KV, interpret=True),
                 jref(*jargs, window=window)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the inactive slot sees column 0 only: every query returns V row 0
    v0 = caches[1][1, 0] * (caches[3][1, 0][:, None] if quant else 1.0)  # [KH, D]
    want0 = np.broadcast_to(np.repeat(v0, H // KH, axis=0), (T, H, D))
    np.testing.assert_allclose(got.numpy()[1], want0, **TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_saturated_slot_leaves_the_other_slots_exact(quant):
    """A slot whose staircase runs past the cache end: its own rows are
    indeterminate by contract; the JAX kernel and the port agree on every
    other slot, and the port's rows stay finite."""
    T = 4
    rng = np.random.default_rng(31 + quant)
    q, lengths, strides = _mq_inputs(rng, T)
    lengths[4] = C - 2  # rows C-2 .. C+1
    caches = _caches(rng, quant)
    fn, jfn = ((ops.multiquery_decode_attention_int8,
                jver.multiquery_decode_attention_int8) if quant else
               (ops.multiquery_decode_attention, jver.multiquery_decode_attention))
    got = fn(*_t(q, *caches, lengths, strides)).numpy()
    want = np.asarray(jfn(*(jnp.asarray(a) for a in (q, *caches, lengths, strides)),
                          block_kv=BLOCK_KV, interpret=True))
    np.testing.assert_allclose(got[:4], want[:4], **TOL)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_multiquery_at_one_query_is_decode_attention(quant):
    rng = np.random.default_rng(40 + quant)
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    caches = _caches(rng, quant)
    strides = np.ones(B, np.int32)
    mq = ops.multiquery_decode_attention_int8 if quant else ops.multiquery_decode_attention
    dec = ops.decode_attention_int8 if quant else ops.decode_attention
    got = mq(*_t(q, *caches, LENGTHS, strides), window=24)
    want = dec(*_t(q[:, 0], *caches, LENGTHS), window=24)
    np.testing.assert_allclose(got[:, 0].numpy(), want.numpy(), **TOL)


def test_int8_references_are_the_plain_references_on_dequantized_caches():
    rng = np.random.default_rng(50)
    q, lengths, strides = _mq_inputs(rng, 4)
    kq, vq, ks, vs = _t(*_caches(rng, True))
    kf, vf = kq.float() * ks[..., None], vq.float() * vs[..., None]
    got = ops.multiquery_decode_attention_int8_reference(
        *_t(q), kq, vq, ks, vs, *_t(lengths, strides), window=20)
    want = ops.multiquery_decode_attention_reference(
        *_t(q), kf, vf, *_t(lengths, strides), window=20)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    got = ops.decode_attention_int8_reference(*_t(q[:, 0]), kq, vq, ks, vs, *_t(LENGTHS))
    want = ops.decode_attention_reference(*_t(q[:, 0]), kf, vf, *_t(LENGTHS))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_wrappers_refuse_what_they_do_not_serve():
    q = torch.zeros(2, 4, 16, device="meta")
    k = torch.zeros(2, 8, 2, 16, device="meta")
    lens = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.decode_attention(q, k, k, lens)
    with pytest.raises(ValueError, match="different devices"):
        ops.multiquery_decode_attention(torch.zeros(2, 3, 4, 16), k, k, lens, lens)


# -- decode_step and verify_step over the dense cache -------------------------


@pytest.fixture(scope="module")
def jax_params():
    return jm.init_params(JAX_TINY, jax.random.PRNGKey(0), dtype=jnp.float32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_cache_close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    if want.dtype == np.int8:
        np.testing.assert_array_equal(got, want, err_msg=what)
    elif want.ndim == 4:  # [L, S, C, KH] scales
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=0, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, **TOL, err_msg=what)


def _dense_state(rng, quant, S=4, ctx=48):
    """A dense cache [L, S, C, KH, D] of random rows (quantized by the JAX
    function for an int8 cache), as numpy arrays for both sides."""
    shape = (JAX_TINY.num_layers, S, ctx, JAX_TINY.num_kv_heads, JAX_TINY.head_dim)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    if not quant:
        return [k, v]
    kq, ks = (np.asarray(a) for a in jm.quantize_kv(jnp.asarray(k)))
    vq, vs = (np.asarray(a) for a in jm.quantize_kv(jnp.asarray(v)))
    return [kq, vq, ks, vs]


def _both_sides(state):
    jstate = [jnp.asarray(a) for a in state]
    tstate = [torch.from_numpy(a.copy()) for a in state]
    return jstate, tstate


def _scales(state):
    return (state[2], state[3]) if len(state) == 4 else None


@pytest.mark.parametrize("kernels", [True, False], ids=["wrappers", "plain"])
@pytest.mark.parametrize("cache", ["f32", "int8"])
@pytest.mark.parametrize("weights", ["int8", "int4"])
def test_decode_step_matches_jax(jax_params, weights, cache, kernels):
    """Three chained decode steps, slot 1 inactive, with the port's
    ``kernels`` on (the ops wrappers, plain on the CPU) and off (the masked
    whole-cache path), against the JAX masked path."""
    jp = jm.quantize_params(jax_params, mode=weights)
    tp = params_from_jax(_np_tree(jp))
    rng = np.random.default_rng(60)
    ctx = 48
    jstate, tstate = _both_sides(_dense_state(rng, cache == "int8", ctx=ctx))
    lengths = np.asarray([20, 9, 0, ctx - 4], np.int32)
    active = np.asarray([True, False, True, True])
    tokens = rng.integers(0, TINY_TEST.vocab_size, 4)
    before = [t.clone() for t in tstate]
    for _ in range(3):
        out = jm.decode_step(
            jp, JAX_TINY, jnp.asarray(tokens, jnp.int32), jnp.asarray(lengths),
            jstate[0], jstate[1], kernels=False, cache_scales=_scales(jstate),
            active=jnp.asarray(active))
        jl, jstate = out[0], [out[1], out[2], *(out[3] if len(out) == 4 else ())]
        tl = tm.decode_step(
            tp, TINY_TEST, torch.from_numpy(tokens), torch.from_numpy(lengths),
            tstate[0], tstate[1], active=torch.from_numpy(active), kernels=kernels,
            cache_scales=_scales(tstate))
        assert tl.shape == (4, TINY_TEST.vocab_size) and tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        for got, want in zip(tstate, jstate):
            _assert_cache_close(got[:, :, : ctx - 1], want[:, :, : ctx - 1])
        tokens = np.asarray(jl).argmax(-1)
        lengths = lengths + 1
    # the inactive slot wrote nothing but the sacrificial last row
    for got, was in zip(tstate, before):
        np.testing.assert_array_equal(got[:, 1, : ctx - 1].numpy(), was[:, 1, : ctx - 1].numpy())


@pytest.mark.parametrize("kernels", [True, False], ids=["wrappers", "plain"])
@pytest.mark.parametrize("cache", ["f32", "int8"])
@pytest.mark.parametrize("weights", ["int8", "int4"])
def test_verify_step_matches_jax(jax_params, weights, cache, kernels):
    """A verify forward of T = 5 (drafts of -1 included), slot 2 inactive."""
    jp = jm.quantize_params(jax_params, mode=weights)
    tp = params_from_jax(_np_tree(jp))
    rng = np.random.default_rng(61)
    ctx, T = 48, 5
    jstate, tstate = _both_sides(_dense_state(rng, cache == "int8", ctx=ctx))
    lengths = np.asarray([20, 0, 7, ctx - 2 - T], np.int32)
    active = np.asarray([True, True, False, True])
    feed = rng.integers(0, TINY_TEST.vocab_size, (4, T))
    feed[1, 2:] = -1  # no draft there
    out = jm.verify_step(
        jp, JAX_TINY, jnp.asarray(feed, jnp.int32), jnp.asarray(lengths), jstate[0],
        jstate[1], kernels=False, cache_scales=_scales(jstate), active=jnp.asarray(active))
    jl, jstate = out[0], [out[1], out[2], *(out[3] if len(out) == 4 else ())]
    tl = tm.verify_step(
        tp, TINY_TEST, torch.from_numpy(feed), torch.from_numpy(lengths), tstate[0],
        tstate[1], active=torch.from_numpy(active), kernels=kernels,
        cache_scales=_scales(tstate))
    assert tl.shape == (4, T, TINY_TEST.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    for got, want in zip(tstate, jstate):
        # the last row takes the inactive slot's colliding writes: undefined
        _assert_cache_close(got[:, :, : ctx - 1], want[:, :, : ctx - 1])


def test_verify_step_rows_are_sequential_decode_steps(jax_params):
    """Row t of a verify forward equals the t-th of T decode steps fed the
    same tokens, and both leave the same cache rows."""
    tp = params_from_jax(_np_tree(jm.quantize_params(jax_params, mode="int8")))
    rng = np.random.default_rng(62)
    T, ctx = 4, 48
    state = _dense_state(rng, False, S=3, ctx=ctx)
    a = [torch.from_numpy(x.copy()) for x in state]
    b = [torch.from_numpy(x.copy()) for x in state]
    lengths = torch.tensor([5, 0, 30], dtype=torch.int32)
    feed = torch.from_numpy(rng.integers(0, TINY_TEST.vocab_size, (3, T)))
    vl = tm.verify_step(tp, TINY_TEST, feed, lengths, a[0], a[1])
    for t in range(T):
        dl = tm.decode_step(tp, TINY_TEST, feed[:, t], lengths + t, b[0], b[1])
        np.testing.assert_allclose(dl.numpy(), vl[:, t].numpy(), **LOGIT_TOL)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), **TOL)
