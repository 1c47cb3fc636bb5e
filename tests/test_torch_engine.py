"""TorchEngine and the port's ContinuousBatcher against TPUEngine and the JAX
batcher on the same int8 weights (TINY_TEST, fp32 KV pool, 16-row pages), and
the port's sampler against the distribution it should draw from."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aios_tpu.engine import model as jm
from aios_tpu.engine.batching import ContinuousBatcher as JaxBatcher
from aios_tpu.engine.batching import Request as JaxRequest
from aios_tpu.engine.config import TINY_TEST as JAX_TINY
from aios_tpu.engine.engine import TPUEngine
from aios_tpu_torch.engine import sampling
from aios_tpu_torch.engine.batching import ContinuousBatcher, Request
from aios_tpu_torch.engine.config import TINY_TEST
from aios_tpu_torch.engine.engine import TorchEngine
from aios_tpu_torch.engine.weights import params_from_jax

# The shapes here are tiny: one intra-op thread is faster and leaves the
# cores to the other test workers.
torch.set_num_threads(1)

POOL_ROWS = 256


@pytest.fixture(scope="module")
def jax_params():
    return jm.init_params(JAX_TINY, jax.random.PRNGKey(0), dtype=jnp.float32)


def _engines(jax_params, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("paged_pool_rows", POOL_ROWS)
    # the JAX engine's prefix index is off, and so is the port's
    common = dict(max_context=128, quantize="int8", page_size=16, prefix_cache=False, **kw)
    jax_eng = TPUEngine(JAX_TINY, jax_params, cache_dtype=jnp.float32, **common)
    port = TorchEngine(TINY_TEST, params_from_jax(jax.tree.map(np.asarray, jax_params)),
                       cache_dtype=torch.float32, device="cpu", **common)
    return jax_eng, port


@pytest.fixture(scope="module")
def engines(jax_params):
    return _engines(jax_params)


# prompt lengths in three different prefill buckets (16, 32, 64)
PROMPTS = [[256, 7, 99, 3, 41], [256] + list(range(60, 80)),
           [256] + [(i * 37) % 256 for i in range(40)]]


@pytest.mark.parametrize("prompt", PROMPTS, ids=["bucket16", "bucket32", "bucket64"])
def test_generate_greedy_matches_jax_engine(engines, prompt):
    jax_eng, port = engines
    want = jax_eng.generate(prompt, max_new_tokens=17, temperature=0.0)
    got = port.generate(prompt, max_new_tokens=17, temperature=0.0)
    assert got == want
    assert port.allocator.pages_in_use() == 0  # released


def test_prefill_writes_the_same_pool_rows_as_jax(engines):
    jax_eng, port = engines
    prompt = PROMPTS[2]
    first_j = jax_eng.prefill(1, prompt)
    first_t = port.prefill(1, prompt)
    try:
        assert first_t == first_j
        np.testing.assert_array_equal(port.allocator.tables, jax_eng.allocator.tables)
        pages = port.allocator.tables[1, : port.allocator.blocks_for(len(prompt))]
        for name, pool in (("k", port.k_pool), ("v", port.v_pool)):
            got = pool[:, pages].reshape(TINY_TEST.num_layers, -1, 2, 16)[:, : len(prompt)]
            want = np.asarray(jax_eng.state[name])[:, pages].reshape(got.shape[0], -1, 2, 16)
            np.testing.assert_allclose(got.numpy(), want[:, : len(prompt)],
                                       atol=1e-5, rtol=1e-5)
    finally:
        jax_eng.release(1)
        port.release(1)


def _serve_four(batcher, make_request, engine_lock):
    """Submit four greedy requests while holding the engine lock, so the
    scheduler admits all four before its first decode dispatch whatever the
    thread timing; return each stream and whether it was aborted."""
    prompts = [[256 - i] + [(i * 31 + j) % 250 for j in range(9 + 4 * i)] for i in range(4)]
    with engine_lock:
        handles = [batcher.submit(make_request(prompt_ids=p, max_tokens=40,
                                               temperature=0.0)) for p in prompts]
    out = []
    for h in handles:
        toks = []
        t = threading.Thread(target=lambda h=h, toks=toks: toks.extend(h))
        t.start()
        t.join(timeout=300)
        assert not t.is_alive()
        out.append((toks, h.aborted))
    return out


def test_batcher_streams_and_eviction_match_jax(jax_params):
    # 14 usable pages: four requests growing to 40 tokens need 18, so the
    # third 16-step dispatch exhausts the pool and evicts the longest stream
    jax_eng, port = _engines(jax_params, num_slots=4, paged_pool_rows=14 * 16)
    jb = JaxBatcher(jax_eng)
    tb = ContinuousBatcher(port)
    try:
        want = _serve_four(jb, JaxRequest, jax_eng._lock)
        got = _serve_four(tb, Request, port._lock)
    finally:
        jb.shutdown()
        tb.shutdown()
    assert jb.pool_evictions >= 1
    assert tb.pool_evictions == jb.pool_evictions
    assert got == want
    assert sum(aborted for _, aborted in got) == tb.pool_evictions


def test_sampling_matches_the_filtered_distribution():
    """Temperature 0.7 and top_p 0.95 over one fixed logits row: the
    frequencies of 40000 seeded draws lie within total-variation 0.02 of the
    analytic temperature-scaled, nucleus-filtered distribution (the
    sampling error alone is about 0.006), and nothing outside the nucleus
    is ever drawn."""
    logits = torch.tensor([2.0, 1.5, 1.2, 0.3, 0.0, -0.5, -1.0, -3.0, -4.0, -6.0])
    n, temp, top_p = 40000, 0.7, 0.95
    probs = torch.softmax(logits / temp, -1).double()
    keep = (torch.cumsum(probs, 0) - probs) < top_p  # logits are sorted
    expected = torch.where(keep, probs, torch.zeros_like(probs))
    expected /= expected.sum()
    gen = torch.Generator().manual_seed(0)
    toks = sampling.sample(logits.expand(n, -1), gen, torch.full((n,), temp),
                           torch.full((n,), top_p))
    freq = torch.bincount(toks, minlength=logits.numel()).double() / n
    assert (freq[~keep] == 0).all()
    assert 0.5 * (freq - expected).abs().sum().item() < 0.02


def test_greedy_sampling_is_argmax():
    logits = torch.randn(6, 300, generator=torch.Generator().manual_seed(1))
    toks = sampling.sample(logits, torch.Generator().manual_seed(2), torch.zeros(6),
                           torch.ones(6))
    assert torch.equal(toks, logits.argmax(-1))
