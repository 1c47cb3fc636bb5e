"""The port's int4 weights (K5's module and ``quantize_params(mode="int4")``)
against the JAX package on the same numpy inputs.

``quantize_int4`` must give the same packed bytes and scales as the JAX
function, for one matrix and for stacked layers. The products are held at
``atol = rtol = 1e-5`` on f32 inputs (float32 sums taken in another order);
x and the dequantized weights are made bf16-exact, because for f32 x the
Pallas kernel multiplies x and an f32 weight tile as they come while both
references round them to bf16 first. The Pallas kernel tiles only
128-row groups and 128-multiple N, so the group-64 leaves of the tiny model
are held to the JAX reference alone. The CUDA kernel itself runs on the card
against ``int4_matmul_reference`` (``chip_smoke.py``).
"""

import importlib
import math

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

J4 = importlib.import_module("aios_tpu.ops.int4_matmul")
T4 = importlib.import_module("aios_tpu_torch.ops.int4_matmul")
QMM = importlib.import_module("aios_tpu_torch.ops.quantized_matmul")

TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _bf16_exact(a: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.fixture(scope="module")
def jax_params():
    return jm.init_params(JAX_TINY, jax.random.PRNGKey(0), dtype=jnp.float32)


# -- quantization --------------------------------------------------------------


@pytest.mark.parametrize("shape", [(256, 384), (64, 96), (3, 128, 256), (4, 512, 384)],
                         ids=["2d", "group64", "stacked", "stacked-deep"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_int4_same_bytes_as_jax(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    w = (rng.normal(size=shape) * 0.02).astype(np.float32)
    w[..., 7] = 0.0  # an all-zero column takes the absmax > 0 guard
    wj = jnp.asarray(w, dtype)
    pj, sj = J4.quantize_int4(wj)
    wt = torch.from_numpy(np.array(wj.astype(jnp.float32))).to(getattr(torch, dtype))
    pt, st = ops.quantize_int4(wt)
    assert pt.dtype == torch.uint8 and st.dtype == torch.float32
    assert tuple(st.shape) == np.asarray(sj).shape
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("group", [128, 64])
def test_unpack_and_dequantize_match_jax(group):
    rng = np.random.default_rng(group)
    packed = rng.integers(0, 256, size=(2, 256 // 2, 96), dtype=np.uint8)
    scale = rng.uniform(1e-3, 1e-2, size=(2, 256 // group, 1, 96)).astype(np.float32)
    pt, st = torch.from_numpy(packed), torch.from_numpy(scale)
    np.testing.assert_array_equal(T4.unpack_int4(pt, group).numpy(),
                                  np.asarray(J4.unpack_int4(jnp.asarray(packed), group)))
    assert T4.infer_group(pt, st) == J4.infer_group(packed, scale) == group
    want = J4.dequantize_int4(jnp.asarray(packed), jnp.asarray(scale))
    got = ops.dequantize_int4(pt, st)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_split_half_layout():
    """Packed row r of a group holds K-row r (low nibble) and r + group/2
    (high nibble), offset-binary."""
    q = np.tile(np.arange(-7, 8), 9)[:128]  # one group of 128 K-rows, one column
    w = torch.from_numpy(q.astype(np.float32)[:, None])  # absmax 7: scale 1
    packed, scale = ops.quantize_int4(w)  # exact: the clip search keeps scale 1
    lo, hi = packed[:, 0].numpy() & 0xF, packed[:, 0].numpy() >> 4
    np.testing.assert_array_equal(lo, q[:64] + 8)
    np.testing.assert_array_equal(hi, q[64:] + 8)
    assert scale.shape == (1, 1, 1) and float(scale) == 1.0


# -- K5: the product -----------------------------------------------------------


@pytest.mark.parametrize("M", [1, 3, 8, 300])
def test_int4_matmul_matches_jax(M):
    K, N = 256, 384
    rng = np.random.default_rng(M)
    x = _bf16_exact(rng.normal(size=(M, K)).astype(np.float32))
    packed = rng.integers(0, 256, size=(K // 2, N), dtype=np.uint8)
    # power-of-two scales: every dequantized weight is bf16-exact, so the
    # Pallas kernel (which keeps an f32 weight tile for f32 x) and both
    # references compute the same products
    scale = (2.0 ** -rng.integers(5, 9, size=(K // 128, 1, N))).astype(np.float32)
    pj, sj = jnp.asarray(packed), jnp.asarray(scale)
    xj = jnp.asarray(x)
    got = ops.int4_matmul(torch.from_numpy(x), torch.from_numpy(packed),
                          torch.from_numpy(scale))
    assert got.dtype == torch.float32 and got.shape == (M, N)
    for ref in (J4.int4_matmul(xj, pj, sj, interpret=True),
                J4.int4_matmul_reference(xj, pj, sj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("K,N", [(64, 96), (64, 512), (128, 64)])
def test_int4_matmul_tiny_groups_match_jax_reference(K, N):
    rng = np.random.default_rng(K + N)
    x = rng.normal(size=(2, 5, K)).astype(np.float32)  # leading axes kept
    w = (rng.normal(size=(K, N)) * 0.02).astype(np.float32)
    pj, sj = J4.quantize_int4(jnp.asarray(w))
    got = ops.int4_matmul(torch.from_numpy(x), torch.from_numpy(np.array(pj)),
                          torch.from_numpy(np.array(sj)))
    ref = J4.int4_matmul_reference(jnp.asarray(x), pj, sj)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


MISTRAL_NK = ((6144, 4096), (4096, 4096), (28672, 4096), (4096, 14336), (32000, 4096))


@pytest.mark.parametrize("M,N,K", [(M, N, K) for M in (8, 16, 32, 64, 512) for N, K in MISTRAL_NK] + [
    (1, 64, 128), (17, 112, 384), (128, 6144, 4096), (4096, 4096, 14336),
])
def test_int4_plan_covers_k_exactly(M, N, K):
    """K1's plan with one 128-row scale group per stage: the tile by M,
    whole groups in every split and no empty split, a decode step filling
    the card with two blocks per SM, prefill K whole, counters for every
    split grid."""
    p = T4.plan(M, N, K, sms=132)
    if M <= 64:
        assert (p.block_t, p.cols) == (max(8, 1 << (M - 1).bit_length()), 64)
    else:
        assert p.splits == 1 and (p.block_t, p.cols) in ((64, 64), (128, 128))
    assert p.k_per_split % T4.GROUP == 0
    assert (p.splits - 1) * p.k_per_split < K <= p.splits * p.k_per_split  # no empty split
    assert p.tiles == math.ceil(M / p.block_t) * math.ceil(N / p.cols)
    if M == 8:
        assert p.tiles * p.splits >= 2 * 132
    if p.splits > 1:
        assert p.tiles <= QMM.COUNTERS


def test_kernel_layout_rule():
    assert T4.kernel_supported(4096, 6144, 128)
    assert T4.kernel_supported(14336, 4096, 128)
    assert not T4.kernel_supported(4096, 4104, 128)  # TMA needs 16-byte row strides
    assert not T4.kernel_supported(64, 96, 64)  # the tiny model's group-64 leaves
    assert T4.supports_int4(64, 96, T4.pick_group(64))
    assert not T4.supports_int4(100, 96, T4.pick_group(100))


# -- the model's int4 serving tree ---------------------------------------------


def test_quantize_params_int4_same_bytes_as_jax(jax_params):
    jq = dict(_flat(_numpy_tree(jm.quantize_params(jax_params, mode="int4"))))
    tq = dict(_flat(tm.quantize_params(params_from_jax(_numpy_tree(jax_params)),
                                       mode="int4")))
    assert jq.keys() == tq.keys()
    assert "layers/w_qkv/q4" in tq and "lm_head/s4" in tq
    for k, v in jq.items():
        assert tq[k].dtype == torch.from_numpy(np.empty(0, v.dtype)).dtype, k
        np.testing.assert_array_equal(tq[k].numpy(), v, err_msg=k)


def test_quantize_params_falls_back_to_int8_like_jax():
    """E=40 has no int4 group (40 % 16 != 0): the leaves that contract over
    E (w_qkv, w_gateup, lm_head) fall back to int8, wo and w_down stay
    int4, in both packages."""
    jcfg = JAX_TINY.scaled(hidden_size=40)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    jq = dict(_flat(_numpy_tree(jm.quantize_params(jp, mode="int4"))))
    tq = dict(_flat(tm.quantize_params(params_from_jax(_numpy_tree(jp)), mode="int4")))
    assert jq.keys() == tq.keys()
    assert {"layers/w_qkv/q", "layers/w_gateup/q", "lm_head/q", "layers/wo/q4",
            "layers/w_down/q4"} <= tq.keys()
    for k, v in jq.items():
        np.testing.assert_array_equal(tq[k].numpy(), v, err_msg=k)
    with pytest.raises(ValueError):
        tm.quantize_params(params_from_jax(_numpy_tree(jp)), mode="int3")


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_a_leaf_the_kernels_cannot_serve_raises_at_quantize_time(mode):
    """N = 40 suits neither kernel (TMA reads rows in 16-byte strides): off
    the CPU (here the meta device, which computes nothing) quantizing it
    raises and names the leaf, instead of its first matmul; a leaf that
    suits the kernel quantizes there, and on the CPU every shape serves."""
    with pytest.raises(ValueError, match=r"w_down \[K=128, N=40\]"):
        tm._quant_leaf(torch.empty(128, 40, device="meta"), mode, "w_down")
    assert tm._quant_leaf(torch.empty(128, 64, device="meta"), mode, "wo")
    leaf = tm._quant_leaf(torch.randn(128, 40), mode, "w_down")
    assert set(leaf) == ({"q4", "s4"} if mode == "int4" else {"q", "s"})


def test_params_from_jax_carries_an_int4_tree_byte_for_byte(jax_params):
    tree = _numpy_tree(jm.quantize_params(jax_params, mode="int4"))
    port = params_from_jax(tree)
    assert tm.is_quantized(port)
    for k, v in _flat(tree):
        t = dict(_flat(port))[k]
        assert t.numpy().dtype == v.dtype, k
        np.testing.assert_array_equal(t.numpy(), v, err_msg=k)


def test_prefill_int4_matches_jax(jax_params):
    jp = jm.quantize_params(jax_params, mode="int4")
    tp = params_from_jax(_numpy_tree(jp))
    tokens = np.random.default_rng(4).integers(0, TINY_TEST.vocab_size, (1, 32))
    jl, jk, jv = jm.prefill(jp, JAX_TINY, jnp.asarray(tokens, jnp.int32))
    tl, tk, tv = tm.prefill(tp, TINY_TEST, torch.from_numpy(tokens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **LOGIT_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **LOGIT_TOL)
