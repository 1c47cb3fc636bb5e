"""The port's kernel modules against the JAX package's kernels.

The same numpy inputs go through the Pallas kernel (interpret mode on the
CPU), its JAX ``*_reference`` and the port's wrapper, which takes its plain
PyTorch version for CPU tensors. fp32 throughout: ``atol = rtol = 1e-5``
covers float32 sums taken in another order. The CUDA kernels themselves run
only on the card, against the same plain versions (``chip_smoke.py``).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aios_tpu.ops.flash_attention import flash_attention as jax_flash
from aios_tpu.ops.flash_attention import flash_attention_reference as jax_flash_ref
from aios_tpu.ops.paged_attention import paged_decode_attention as jax_paged
from aios_tpu.ops.paged_attention import (
    paged_decode_attention_reference as jax_paged_ref,
)
from aios_tpu.ops.quantized_matmul import quantize_int8 as jax_quantize_int8
from aios_tpu.ops.quantized_matmul import quantized_matmul as jax_qmm
from aios_tpu.ops.quantized_matmul import quantized_matmul_reference as jax_qmm_ref
from aios_tpu_torch import ops

# The shapes here are tiny: one intra-op thread is faster and leaves the
# cores to the other test workers.
torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


def _close(port: torch.Tensor, *jax_outs) -> None:
    for ref in jax_outs:
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), **TOL)


# -- K1: int8-weight matmul ----------------------------------------------------


@pytest.mark.parametrize("K,N", [(128, 256), (256, 384)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_int8_same_bytes_as_jax(K, N, dtype):
    rng = np.random.default_rng(K + N)
    w = (rng.normal(size=(3, K, N)) * 0.02).astype(np.float32)
    w[1, :, 5] = 0.0  # an all-zero column takes the absmax > 0 guard
    wj = jnp.asarray(w, dtype)
    qj, sj = jax_quantize_int8(wj)
    wt = torch.from_numpy(np.array(wj.astype(jnp.float32))).to(getattr(torch, dtype))
    qt, st = ops.quantize_int8(wt)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("K,N", [(128, 256), (256, 384)])
@pytest.mark.parametrize("M", [1, 3, 8, 300])
def test_quantized_matmul_matches_jax(M, K, N):
    rng = np.random.default_rng(M * 7 + K)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(K, N)) * 0.02).astype(np.float32)
    qj, sj = jax_quantize_int8(jnp.asarray(w))
    xj = jnp.asarray(x)
    got = ops.quantized_matmul(torch.from_numpy(x), torch.from_numpy(np.array(qj)),
                               torch.from_numpy(np.array(sj)))
    _close(got, jax_qmm(xj, qj, sj, interpret=True), jax_qmm_ref(xj, qj, sj))


# -- K2: flash prefill attention ----------------------------------------------


@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("T", [128, 256])
@pytest.mark.parametrize("H,KH", [(4, 4), (8, 2)])  # G = 1 and G = 4
def test_flash_attention_matches_jax(H, KH, T, window):
    rng = np.random.default_rng(T + H + (window or 0))
    B, D = 2, 32
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    k = rng.normal(size=(B, T, KH, D)).astype(np.float32)
    v = rng.normal(size=(B, T, KH, D)).astype(np.float32)
    qj, kj, vj = (jnp.asarray(a) for a in (q, k, v))
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=True, window=window)
    _close(got,
           jax_flash(qj, kj, vj, causal=True, window=window, interpret=True),
           jax_flash_ref(qj, kj, vj, causal=True, window=window))


# ragged T and tile edges (one Pallas block of T rows where T <= 128), two
# sequences, and a window narrower than the kernel's 128-row kv tile
@pytest.mark.parametrize("T,B,window", [(1, 1, None), (63, 1, None), (65, 1, None),
                                        (127, 1, None), (200, 1, None), (200, 2, None),
                                        (127, 2, 24), (200, 1, 100)])
def test_flash_attention_ragged_lengths_match_jax(T, B, window):
    rng = np.random.default_rng(1000 + T + B)
    H, KH, D = 8, 2, 64
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    k = rng.normal(size=(B, T, KH, D)).astype(np.float32)
    v = rng.normal(size=(B, T, KH, D)).astype(np.float32)
    qj, kj, vj = (jnp.asarray(a) for a in (q, k, v))
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=True, window=window)
    want = [jax_flash_ref(qj, kj, vj, causal=True, window=window)]
    if T <= 128:  # one Pallas block of T query and T kv rows
        want.append(jax_flash(qj, kj, vj, causal=True, window=window, interpret=True))
    _close(got, *want)


@pytest.mark.parametrize("bad,match", [
    (dict(D=32), "D=32"),
    (dict(H=65 * 2, KH=2), "H / KH <= 64"),
    (dict(H=6, KH=4), "H % KH"),
    (dict(dtype=torch.float32), "bfloat16"),
    (dict(window=0), "window"),
    (dict(noncontig=True), "contiguous"),
])
def test_flash_launch_contract_is_checked_before_any_launch(bad, match):
    """What the Hopper kernel does not take (D outside 64 and 128, a GQA
    group over 64 heads, other dtypes, strided operands) is refused by name
    before anything touches a card."""
    fa = importlib.import_module("aios_tpu_torch.ops.flash_attention")
    B, T, H, KH, D = 1, 16, bad.get("H", 8), bad.get("KH", 2), bad.get("D", 64)
    dt = bad.get("dtype", torch.bfloat16)
    q = torch.zeros(B, T, H, D, dtype=dt)
    if bad.get("noncontig"):
        q = torch.zeros(B, H, T, D, dtype=dt).transpose(1, 2)
    k = torch.zeros(B, T, KH, D, dtype=dt)
    before = fa.flash_attention.launches
    with pytest.raises(ValueError, match=match):
        fa.check_launch(q, k, k.clone(), bad.get("window"))
    assert fa.flash_attention.launches == before


# -- K3: paged decode attention -----------------------------------------------

P, MB, KH_, H_, D_ = 16, 8, 2, 8, 16
# ragged: an empty (inactive) slot, both sides of a page boundary, a long one
LENGTHS = [0, P - 1, P, 37, 2 * P + 3, 5 * P + 9]


def _paged_inputs(seed):
    rng = np.random.default_rng(seed)
    B = len(LENGTHS)
    need = [-(-(n + 1) // P) for n in LENGTHS]
    N = 1 + sum(need) + 2
    free = list(rng.permutation(np.arange(1, N)))  # shuffled physical pages
    tables = np.zeros((B, MB), np.int32)
    for b, n in enumerate(need):
        if LENGTHS[b] == 0:
            continue  # unbacked: maps the sacrificial page 0, like an idle slot
        for i in range(n):
            tables[b, i] = free.pop()
    q = rng.normal(size=(B, H_, D_)).astype(np.float32)
    kp = rng.normal(size=(N, P, KH_, D_)).astype(np.float32)
    vp = rng.normal(size=(N, P, KH_, D_)).astype(np.float32)
    return q, kp, vp, tables, np.asarray(LENGTHS, np.int32)


@pytest.mark.parametrize("case", ["full", "window", "sink"])
def test_paged_decode_attention_matches_jax(case):
    q, kp, vp, tables, lengths = _paged_inputs(len(case))
    kw = {}
    if case == "window":
        kw = dict(window=48)
    elif case == "sink":
        ws = np.asarray([0, 0, 0, 24, 32, 48], np.int32)
        kw = dict(win_starts=ws, sink=P)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    args = (q, kp, vp, tables, lengths)
    got = ops.paged_decode_attention(*(torch.from_numpy(a) for a in args), **tkw)
    jargs = [jnp.asarray(a) for a in args]
    _close(got, jax_paged(*jargs, interpret=True, **jkw), jax_paged_ref(*jargs, **jkw))


def test_gather_pages_is_the_logical_view():
    q, kp, vp, tables, lengths = _paged_inputs(3)
    view = ops.gather_pages(torch.from_numpy(kp), torch.from_numpy(tables))
    assert view.shape == (len(LENGTHS), MB * P, KH_, D_)
    b, col = 5, 5 * P + 9
    np.testing.assert_array_equal(view[b, col].numpy(), kp[tables[b, col // P], col % P])
