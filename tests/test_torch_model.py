"""The port's model against the JAX model on the same parameters.

Parameters come from the JAX ``init_params(TINY_TEST, PRNGKey(0), float32)``
and cross over through ``params_from_jax``; tokens and pools are made with
numpy. Everything runs in fp32 on the CPU, where both packages take their
plain attention and matmul paths: logits agree to 1e-4 (float32 sums over
two layers taken in another order) and pools to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aios_tpu.engine import model as jm
from aios_tpu.engine import paged as jpaged
from aios_tpu.engine.config import TINY_TEST as JAX_TINY
from aios_tpu_torch.engine import model as tm
from aios_tpu_torch.engine import paged as tpaged
from aios_tpu_torch.engine.config import TINY_TEST
from aios_tpu_torch.engine.weights import params_from_jax

# The shapes here are tiny: one intra-op thread is faster and leaves the
# cores to the other test workers.
torch.set_num_threads(1)

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
POOL_TOL = dict(atol=1e-5, rtol=1e-5)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_params():
    return jm.init_params(JAX_TINY, jax.random.PRNGKey(0), dtype=jnp.float32)


@pytest.fixture(scope="module")
def port_params(jax_params):
    return params_from_jax(_numpy_tree(jax_params))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_params_cross_over_unchanged(jax_params, port_params):
    jflat = dict(_flat(_numpy_tree(jax_params)))
    tflat = dict(_flat(port_params))
    assert jflat.keys() == tflat.keys()
    for k, v in jflat.items():
        np.testing.assert_array_equal(tflat[k].numpy(), v, err_msg=k)


def test_bf16_leaves_cross_over_bit_for_bit():
    a = jnp.asarray(np.linspace(-3, 3, 17, dtype=np.float32), jnp.bfloat16)
    t = params_from_jax({"w": np.asarray(a)})["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(a.astype(jnp.float32)))


def test_forward_full_matches_jax(jax_params, port_params):
    tokens = np.random.default_rng(0).integers(0, TINY_TEST.vocab_size, (2, 24))
    ref = jm.forward_full(jax_params, JAX_TINY, jnp.asarray(tokens, jnp.int32))
    got = tm.forward_full(port_params, TINY_TEST, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **LOGIT_TOL)


def test_quantize_params_same_bytes_as_jax(jax_params, port_params):
    jq = dict(_flat(_numpy_tree(jm.quantize_params(jax_params))))
    tq = dict(_flat(tm.quantize_params(port_params)))
    assert jq.keys() == tq.keys()
    for k, v in jq.items():
        np.testing.assert_array_equal(tq[k].numpy(), v, err_msg=k)
    assert tq["layers/w_qkv/q"].dtype == torch.int8


@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "int8"])
def test_prefill_matches_jax(jax_params, port_params, quantized):
    jp, tp = jax_params, port_params
    if quantized:
        jp, tp = jm.quantize_params(jp), tm.quantize_params(tp)
    tokens = np.random.default_rng(1).integers(0, TINY_TEST.vocab_size, (1, 32))
    jl, jk, jv = jm.prefill(jp, JAX_TINY, jnp.asarray(tokens, jnp.int32))
    tl, tk, tv = tm.prefill(tp, TINY_TEST, torch.from_numpy(tokens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **POOL_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **POOL_TOL)


@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "int8"])
def test_decode_step_paged_matches_jax(jax_params, port_params, quantized):
    jp, tp = jax_params, port_params
    if quantized:
        jp, tp = jm.quantize_params(jp), tm.quantize_params(tp)
    P, slots, max_blocks, num_pages = 16, 4, 8, 14
    L, KH, D = TINY_TEST.num_layers, TINY_TEST.num_kv_heads, TINY_TEST.head_dim
    ja = jpaged.PageAllocator(num_pages, P, slots, max_blocks)
    ta = tpaged.PageAllocator(num_pages, P, slots, max_blocks)
    rng = np.random.default_rng(2)
    pool_shape = (L, num_pages, P, KH, D)
    kp = rng.normal(size=pool_shape).astype(np.float32)
    vp = rng.normal(size=pool_shape).astype(np.float32)
    jk, jv = jnp.asarray(kp), jnp.asarray(vp)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    # slot 1 is inactive: it writes the sacrificial page and reads nothing
    lengths = np.asarray([20, 0, 15, 33], np.int32)
    active = np.asarray([True, False, True, True])
    tokens = rng.integers(0, TINY_TEST.vocab_size, slots)
    for _ in range(3):
        for s in np.flatnonzero(active):
            ja.ensure(int(s), int(lengths[s]) + 1)
            ta.ensure(int(s), int(lengths[s]) + 1)
        np.testing.assert_array_equal(ta.tables, ja.tables)
        jl, jk, jv = jm.decode_step_paged(
            jp, JAX_TINY, jnp.asarray(tokens, jnp.int32), jnp.asarray(lengths), jk, jv,
            jnp.asarray(ja.tables), active=jnp.asarray(active),
        )
        tl = tm.decode_step_paged(
            tp, TINY_TEST, torch.from_numpy(tokens), torch.from_numpy(lengths), tk, tv,
            torch.from_numpy(ta.tables), active=torch.from_numpy(active),
        )
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **POOL_TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **POOL_TOL)
        tokens = np.asarray(jl).argmax(-1)
        lengths = lengths + 1
