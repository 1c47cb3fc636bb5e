"""Mixture-of-experts in the port against the JAX package, on ``tiny-moe``
(4 experts, 2 a token, expert width 32): routing, the gate matrix and the
load-balancing loss; the dense, gather and dispatch FFNs on dense f32, dense
bf16 and int8 leaves; the expert entry's plain twin in its three row
layouts against the JAX expert einsums; the serving leaves in int8 and int4
mode; the layer-by-layer synthetic load; ``forward_full`` logits; the engine
impl gates and ``AIOS_TPU_MOE_IMPL``; the contract faults and leaf shapes of
the full-size presets; the plan and C signature of the expert launch.

Tolerances: routing weights and probabilities 1e-6 (the same f32 softmax),
f32 FFN outputs 1e-5 (sums in another order), bf16 2e-2 (bf16 rounding at
the same places, sums in another order), logits 1e-4; int8 bytes and scales
equal. Router probabilities of seeded random f32 inputs do not tie, so
``torch.topk`` and ``jax.lax.top_k`` pick the same experts in the same
order (they may order exact ties differently). The CUDA expert entry itself
runs on the card against its plain twin (``chip_smoke.py``)."""

import ast
import importlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aios_tpu.engine import model as jm
from aios_tpu.engine import moe as jmoe
from aios_tpu.engine.config import TINY_MOE as JAX_TINY_MOE
from aios_tpu_torch.engine import model as tm
from aios_tpu_torch.engine import moe as tmoe
from aios_tpu_torch.engine import weights as tw
from aios_tpu_torch.engine.config import (MIXTRAL_8X7B, PRESETS, QWEN3_30B_A3B, TINY_MOE,
                                          TINY_TEST)
from aios_tpu_torch.engine.engine import TorchEngine
qmm = importlib.import_module("aios_tpu_torch.ops.quantized_matmul")

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)
LOGITS = dict(atol=1e-4, rtol=1e-4)
IMPLS = ("dense", "gather", "dispatch")


@pytest.fixture(scope="module")
def jax_params():
    return jm.init_params(JAX_TINY_MOE, jax.random.PRNGKey(0), dtype=jnp.float32)


@pytest.fixture(scope="module")
def torch_params(jax_params):
    return tw.params_from_jax(jax.tree.map(np.asarray, jax_params))


def _layer(tree, i=0):
    return {k: ({kk: vv[i] for kk, vv in v.items()} if isinstance(v, dict) else v[i])
            for k, v in tree["layers"].items()}


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _hidden(n, seed=0, shape=None):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape or (1, n, TINY_MOE.hidden_size)).astype(np.float32)


def _leaves(kind, jax_params, torch_params, dtype):
    """(JAX layer 0, port layer 0) of ``kind``: the dense f32 tree, it cast to
    ``dtype``, or the int8 serving leaves (router and norms cast too)."""
    jp, tp = jax_params, torch_params
    if kind == "int8":
        jp, tp = jm.quantize_params(jp), tm.quantize_params(tp)
    jl, tl = _layer(jp), _layer(tp)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32

    def cast(leaf, to):
        if isinstance(leaf, dict):
            return leaf
        return leaf.astype(to) if hasattr(leaf, "astype") else leaf.to(to)

    return ({k: cast(v, jdt) for k, v in jl.items()},
            {k: cast(v, dtype) for k, v in tl.items()})


@pytest.mark.parametrize("norm", [True, False])
@pytest.mark.parametrize("n", [1, 7, 64])
def test_route_gate_matrix_and_aux_match_jax(torch_params, jax_params, norm, n):
    cfg_t, cfg_j = TINY_MOE.scaled(norm_topk_prob=norm), JAX_TINY_MOE.scaled(norm_topk_prob=norm)
    h = _hidden(n, seed=n)[0]
    w = _layer(jax_params)["w_router"]
    jp, jw, ji = jmoe.route(jnp.asarray(h), w, cfg_j)
    tp, tw_, ti = tmoe.route(torch.from_numpy(h), _layer(torch_params)["w_router"], cfg_t)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tw_.numpy(), np.asarray(jw), atol=1e-6, rtol=1e-6)
    # on the same weights the gate matrices are equal
    np.testing.assert_array_equal(tmoe.gate_matrix(tw_, ti, 4).numpy(),
                                  np.asarray(jmoe.gate_matrix(jnp.asarray(tw_.numpy()), ji, 4)))
    np.testing.assert_allclose(float(tmoe.load_balance_aux(tp, ti, 4)),
                               float(jmoe.load_balance_aux(jp, ji, 4)), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("kind,dtype", [("dense", torch.float32), ("dense", torch.bfloat16),
                                        ("int8", torch.float32), ("int8", torch.bfloat16)],
                         ids=["dense-f32", "dense-bf16", "int8-f32", "int8-bf16"])
@pytest.mark.parametrize("shape", [(1, 1), (2, 5), (1, 40)], ids=["one", "2x5", "40"])
def test_ffn_paths_match_jax(torch_params, jax_params, impl, kind, dtype, shape):
    jl, tl = _leaves(kind, jax_params, torch_params, dtype)
    h = _hidden(0, seed=sum(shape), shape=(*shape, TINY_MOE.hidden_size))
    jh = jnp.asarray(h).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    want, want_aux = getattr(jmoe, f"moe_ffn_{impl}")(jh, jl, JAX_TINY_MOE)
    got, got_aux = getattr(tmoe, f"moe_ffn_{impl}")(torch.from_numpy(h).to(dtype), tl, TINY_MOE)
    assert got.dtype == dtype and got.shape == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want), **(F32 if dtype == torch.float32 else BF16))
    np.testing.assert_allclose(float(got_aux), float(want_aux), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("kind", ["dense", "int8"])
def test_dispatch_equals_dense_at_full_capacity_and_drops_only_overflow(
        torch_params, jax_params, kind):
    """At capacity N*k no pick is dropped: dispatch equals dense. At a small
    capacity exactly the picks queued past it are dropped: the output equals
    the dense path over the kept picks' gates only, and equals JAX's."""
    _, tl = _leaves(kind, jax_params, torch_params, torch.float32)
    jl, _ = _leaves(kind, jax_params, torch_params, torch.float32)
    h = torch.from_numpy(_hidden(24, seed=3))
    N, k = 24, TINY_MOE.num_experts_per_tok
    dense, _ = tmoe.moe_ffn_dense(h, tl, TINY_MOE)
    full, _ = tmoe.moe_ffn_dispatch(h, tl, TINY_MOE, capacity=N * k)
    np.testing.assert_allclose(full.numpy(), dense.numpy(), **F32)
    cap = 8
    small, _ = tmoe.moe_ffn_dispatch(h, tl, TINY_MOE, capacity=cap)
    want, _ = jmoe.moe_ffn_dispatch(jnp.asarray(h.numpy()), jl, JAX_TINY_MOE, capacity=cap)
    np.testing.assert_allclose(small.numpy(), np.asarray(want), **F32)
    # the kept picks: queue position below the capacity, in token-major order
    _, weights, idx = tmoe.route(h[0], tl["w_router"], TINY_MOE)
    seen, kept = {}, torch.zeros(N, k, dtype=torch.bool)
    for n in range(N):
        for j in range(k):
            e = int(idx[n, j])
            kept[n, j] = seen.get(e, 0) < cap
            seen[e] = seen.get(e, 0) + 1
    assert not kept.all()
    gates = tmoe.gate_matrix(torch.where(kept, weights, torch.zeros_like(weights)), idx, 4)
    z = tmoe._gate_up(h[0], tl, TINY_MOE, lambda x, w: tmoe._expert_einsum(x, w))
    z = z * gates.t()[..., None]
    ref = tmoe._expert_einsum(z, tl["we_down"]).sum(0) if kind == "int8" else torch.einsum(
        "xnf,xfe->ne", z, tl["we_down"])
    np.testing.assert_allclose(small[0].numpy(), ref.numpy(), **F32)


@pytest.mark.parametrize("kind", ["dense", "int8"])
def test_dense_path_in_token_slices_equals_one_pass(torch_params, jax_params, monkeypatch,
                                                    kind):
    """Past DENSE_TOKEN_CHUNK tokens the dense path runs the experts slice by
    slice (bounding a long prompt's intermediates); the output is the one
    pass's, and JAX's."""
    jl, tl = _leaves(kind, jax_params, torch_params, torch.float32)
    h = _hidden(0, seed=8, shape=(2, 21, 64))
    whole, aux = tmoe.moe_ffn_dense(torch.from_numpy(h), tl, TINY_MOE)
    monkeypatch.setattr(tmoe, "DENSE_TOKEN_CHUNK", 8)
    sliced, aux_s = tmoe.moe_ffn_dense(torch.from_numpy(h), tl, TINY_MOE)
    np.testing.assert_allclose(sliced.numpy(), whole.numpy(), atol=1e-6, rtol=1e-6)
    assert float(aux_s) == float(aux)
    want, _ = jmoe.moe_ffn_dense(jnp.asarray(h), jl, JAX_TINY_MOE)
    np.testing.assert_allclose(sliced.numpy(), np.asarray(want), **F32)


def _jax_pick_einsum(x, leaf, picks):
    y = jnp.einsum("pi,pio->po", x, leaf["q"][picks], preferred_element_type=jnp.float32)
    return y * leaf["s"][picks, 0, :]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_expert_reference_layouts_match_the_jax_einsums(dtype, jax_params):
    """The expert entry's plain twin, shared, per-expert and per-pick, against
    ``_expert_einsum`` ("ne,xef->xnf", "xce,xef->xcf") and the gather's
    ``pick_einsum`` on the same int8 leaves; the wrapper on CPU tensors is
    the twin."""
    leaf = jm.quantize_params(jax_params)["layers"]["we_gateup"]
    jleaf = {k: v[1] for k, v in leaf.items()}
    tleaf = {k: torch.from_numpy(np.array(v)) for k, v in jleaf.items()}
    rng = np.random.default_rng(5)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    tol = F32 if dtype == torch.float32 else BF16
    shared = rng.standard_normal((9, 64)).astype(np.float32)
    queues = rng.standard_normal((4, 6, 64)).astype(np.float32)
    rows = rng.standard_normal((10, 64)).astype(np.float32)
    picks = rng.integers(0, 4, 10).astype(np.int32)
    cases = [
        (jmoe._expert_einsum("ne,xef->xnf", jnp.asarray(shared).astype(jdt), jleaf),
         (torch.from_numpy(shared).to(dtype),), None),
        (jmoe._expert_einsum("xce,xef->xcf", jnp.asarray(queues).astype(jdt), jleaf),
         (torch.from_numpy(queues).to(dtype),), None),
        (_jax_pick_einsum(jnp.asarray(rows).astype(jdt), jleaf, jnp.asarray(picks))
         .astype(jdt), (torch.from_numpy(rows).to(dtype),), torch.from_numpy(picks)),
    ]
    for want, (x,), p in cases:
        got = qmm.quantized_matmul_experts_reference(x, tleaf["q"], tleaf["s"], p)
        assert got.dtype == dtype
        np.testing.assert_allclose(_np(got), _np(want), **tol)
        wrapped = qmm.quantized_matmul_experts(x, tleaf["q"], tleaf["s"], p)
        assert torch.equal(wrapped, got)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_params_moe_bytes_and_scales_equal_jax(jax_params, torch_params, mode):
    """Fused we_gateup and we_down, int8 in both modes (as JAX forces the
    expert stacks), the router left dense: every serving leaf's bytes and
    scales equal JAX's."""
    want = jax.tree.map(np.asarray, jm.quantize_params(jax_params, mode=mode))
    got = tm.quantize_params(torch_params, mode=mode)
    assert set(got["layers"]) == set(want["layers"])
    for key in ("we_gateup", "we_down"):
        assert set(got["layers"][key]) == {"q", "s"}
        assert got["layers"][key]["q"].dtype == torch.int8
    assert not isinstance(got["layers"]["w_router"], dict)
    for key, leaf in want["layers"].items():
        if isinstance(leaf, dict):
            for k, v in leaf.items():
                np.testing.assert_array_equal(got["layers"][key][k].numpy(), v, err_msg=key)
        else:
            np.testing.assert_array_equal(got["layers"][key].numpy(), leaf, err_msg=key)
    for k, v in want["lm_head"].items():
        np.testing.assert_array_equal(got["lm_head"][k].numpy(), v)
    assert tm.quantized_mode(got) == mode


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("tied", [False, True])
def test_layer_by_layer_serving_init_equals_quantizing_the_whole_tree(mode, tied):
    """``init_serving_params`` (the synthetic load of an MoE preset) equals
    ``quantize_params(init_params(...))`` from the same seed, bit for bit."""
    cfg = TINY_MOE.scaled(num_layers=3, tie_word_embeddings=tied)
    whole = tm.quantize_params(tw.init_params(cfg, torch.Generator().manual_seed(7),
                                              device="cpu"), mode=mode)
    layered = tw.init_serving_params(cfg, torch.Generator().manual_seed(7), mode=mode,
                                     device="cpu")
    flat_w, flat_l = dict(_flatten(whole)), dict(_flatten(layered))
    assert flat_w.keys() == flat_l.keys()
    for k, v in flat_w.items():
        assert flat_l[k].dtype == v.dtype and torch.equal(flat_l[k], v), k
    with pytest.raises(ValueError, match="not a mixture-of-experts"):
        tw.init_serving_params(TINY_TEST, torch.Generator(), device="cpu")


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
def test_forward_full_logits_match_jax(jax_params, torch_params, monkeypatch, impl, quant):
    jp = jm.quantize_params(jax_params) if quant else jax_params
    tp = tm.quantize_params(torch_params) if quant else torch_params
    tokens = np.random.default_rng(11).integers(0, 512, (2, 13)).astype(np.int32)
    monkeypatch.setenv("AIOS_TPU_MOE_IMPL", impl)  # both packages read it
    want = jm.forward_full(jp, JAX_TINY_MOE, jnp.asarray(tokens))
    got = tm.forward_full(tp, TINY_MOE, torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)


def test_impl_precedence_env_then_static_then_dense(monkeypatch):
    monkeypatch.delenv("AIOS_TPU_MOE_IMPL", raising=False)
    assert tmoe.resolve_impl(None) == "dense"
    assert tmoe.resolve_impl("gather") == "gather"
    monkeypatch.setenv("AIOS_TPU_MOE_IMPL", "dense")
    assert tmoe.resolve_impl("gather") == "dense"
    monkeypatch.setenv("AIOS_TPU_MOE_IMPL", "dispatch")
    assert tmoe.resolve_impl(None) == "dispatch"
    monkeypatch.setenv("AIOS_TPU_MOE_IMPL", "")  # empty means unset
    assert tmoe.resolve_impl("gather") == "gather"


def test_env_overrides_the_static_gather_as_in_jax(torch_params, monkeypatch):
    """The JAX ``test_env_var_overrides_engine_gather``: AIOS_TPU_MOE_IMPL=
    dense beats a caller's ``moe_impl="gather"`` in ``_mlp``."""
    lp = _layer(torch_params)
    h = torch.from_numpy(_hidden(1, seed=7))
    called = {}
    for name in ("moe_ffn_dense", "moe_ffn_gather"):
        real = getattr(tmoe, name)

        def spy(*a, _real=real, _name=name, **k):
            called[_name] = True
            return _real(*a, **k)

        monkeypatch.setattr(tmoe, name, spy)
    monkeypatch.setenv("AIOS_TPU_MOE_IMPL", "dense")
    tm._mlp(h, lp, TINY_MOE, moe_impl="gather")
    assert called == {"moe_ffn_dense": True}
    monkeypatch.delenv("AIOS_TPU_MOE_IMPL")
    called.clear()
    tm._mlp(h, lp, TINY_MOE, moe_impl="gather")
    assert called == {"moe_ffn_gather": True}


def test_engine_selects_gather_only_when_sparse_and_opted_in(torch_params, monkeypatch):
    """The JAX engine's static choice: gather with AIOS_TPU_MOE_GATHER on and
    slots*k < X, else dense (None); a dense model never gathers."""
    monkeypatch.delenv("AIOS_TPU_MOE_GATHER", raising=False)
    kw = dict(max_context=64, cache_dtype=torch.float32, device="cpu")
    assert TorchEngine(TINY_MOE, torch_params, num_slots=1, **kw)._moe_impl is None
    monkeypatch.setenv("AIOS_TPU_MOE_GATHER", "1")
    assert TorchEngine(TINY_MOE, torch_params, num_slots=1, **kw)._moe_impl == "gather"
    assert TorchEngine(TINY_MOE, torch_params, num_slots=2, **kw)._moe_impl is None  # 2*2 >= 4
    dense = tw.init_params(TINY_TEST, torch.Generator().manual_seed(0), dtype=torch.float32,
                           device="cpu")
    assert TorchEngine(TINY_TEST, dense, num_slots=1, **kw)._moe_impl is None


def test_verify_shaped_dispatches_fall_back_to_dense(torch_params, monkeypatch):
    """The JAX ``test_verify_gather_gating``: a speculative round feeds K+1
    tokens a slot, and S*(K+1)*k >= X sends it dense; decode keeps
    gathering."""
    monkeypatch.setenv("AIOS_TPU_MOE_GATHER", "1")
    seen = []
    for name in ("verify_step", "verify_step_paged", "decode_step", "decode_step_paged"):
        real = getattr(tm, name)

        def spy(*a, _real=real, _name=name, **kw):
            seen.append((_name, kw.get("moe_impl")))
            return _real(*a, **kw)

        monkeypatch.setattr(tm, name, spy)
    for pool in (None, 4 * 64):
        eng = TorchEngine(TINY_MOE, torch_params, num_slots=1, max_context=64,
                          cache_dtype=torch.float32, device="cpu", paged_pool_rows=pool,
                          page_size=16, prefix_cache=False)
        assert eng._moe_impl == "gather" and eng._verify_moe_impl(1) == "gather"
        eng.prefill(0, [1, 2, 3, 4], temperature=0.0)
        seen.clear()
        eng.spec_step(1, draft_len=3)  # 1*(3+1)*2 = 8 >= 4 experts -> dense
        eng.step(1)
        paged = "_paged" if pool else ""
        assert seen == [(f"verify_step{paged}", None), (f"decode_step{paged}", "gather")]


def test_greedy_streams_gather_equal_dense(torch_params, monkeypatch):
    """The JAX ``test_engine_auto_selects_gather_only_when_sparse``: a
    gathering engine's greedy stream equals a dense one's."""
    kw = dict(max_context=64, cache_dtype=torch.float32, device="cpu")
    monkeypatch.setenv("AIOS_TPU_MOE_GATHER", "1")
    e1 = TorchEngine(TINY_MOE, torch_params, num_slots=1, **kw)
    e2 = TorchEngine(TINY_MOE, torch_params, num_slots=4, **kw)
    assert (e1._moe_impl, e2._moe_impl) == ("gather", None)
    prompt = [1, 2, 3, 4, 5]
    assert (e1.generate(prompt, max_new_tokens=16, temperature=0.0)
            == e2.generate(prompt, max_new_tokens=16, temperature=0.0))


def test_config_parity_with_jax():
    from aios_tpu.engine import config as jcfg
    import dataclasses

    for name, cfg in {**PRESETS, "tiny-moe": TINY_MOE}.items():
        want = jcfg.TINY_MOE if name == "tiny-moe" else jcfg.PRESETS[name]
        for f in dataclasses.fields(cfg):
            if hasattr(want, f.name):
                assert getattr(cfg, f.name) == getattr(want, f.name), (name, f.name)
        assert (cfg.moe, cfg.expert_dim, cfg.num_params(), cfg.active_params()) == (
            want.moe, want.expert_dim, want.num_params(), want.active_params()), name


def test_full_size_presets_fit_the_kernel_contracts():
    """Qwen3-30B-A3B's expert leaves [2048, 1536] and [768, 2048] and
    Mixtral's [4096, 28672] and [14336, 4096] take K1's expert entry, and
    their attention (G = 8 and 4 at D = 128) K2, K3 and K6; an expert width
    the entry cannot take is a named fault."""
    shapes = tm.serving_leaf_shapes(QWEN3_30B_A3B)
    assert (shapes["we_gateup"], shapes["we_down"]) == ((2048, 1536), (768, 2048))
    assert "w_gateup" not in shapes and shapes["w_qkv"] == (2048, 4096 + 2 * 512)
    shapes = tm.serving_leaf_shapes(MIXTRAL_8X7B)
    assert (shapes["we_gateup"], shapes["we_down"]) == ((4096, 28672), (14336, 4096))
    for cfg in (QWEN3_30B_A3B, MIXTRAL_8X7B):
        for quantize in ("int8", "int4"):
            assert tm.kernel_contract_faults(cfg, paged=True, quant_cache=False,
                                             quantize=quantize, pages_per_slot=256) == []
    bad = TINY_MOE.scaled(hidden_size=128, num_heads=2, num_kv_heads=1, head_dim=64,
                          moe_intermediate_size=100)
    faults = tm.kernel_contract_faults(bad, paged=True, quant_cache=False, quantize="int8",
                                       pages_per_slot=1)
    need = "the int8 matmul kernel needs K % 8 == 0 and N % 16 == 0"
    assert [f for f in faults if "expert" in f] == [
        f"quantized_matmul_experts (K1's expert entry): we_gateup [K=128, N=200]: {need}",
        f"quantized_matmul_experts (K1's expert entry): we_down [K=100, N=128]: {need}"]


def test_serving_weight_bytes_counts_the_streamed_experts(torch_params):
    q = tm.quantize_params(torch_params)
    total = tm.serving_weight_bytes(q)
    experts = sum(t.numel() * t.element_size() for key in ("we_gateup", "we_down")
                  for t in q["layers"][key].values())
    assert tm.serving_weight_bytes(q, picks=4) == total  # X picks stream every expert
    assert tm.serving_weight_bytes(q, picks=2) == total - experts // 2
    assert tm.serving_weight_bytes(q, picks=8) == total + experts  # duplicates stream again


@pytest.mark.parametrize("M,batches", [(8, 128), (1, 64), (1, 8), (512, 128), (8, 8),
                                       (512, 8), (64, 2)])
def test_expert_plan_counts_every_batch(M, batches):
    """The plan of an expert launch sees batches x tiles: a decode step over
    128 experts fills the card without splitting K, one slot's 8 picks
    split it, and a split launch never needs more ticket counters than
    there are."""
    N, K = 1536, 2048
    p = qmm.plan(M, N, K, 132, qmm.KT, batches)
    one = qmm.plan(M, N, K, 132, qmm.KT)
    assert p.tiles == batches * one.tiles or p.block_t != one.block_t
    if p.splits > 1:
        assert p.tiles <= qmm.COUNTERS
    if (M, batches) == (8, 128):
        assert (p.block_t, p.splits) == (8, 1)
    if (M, batches) == (1, 8):
        assert p.splits == 2
    assert qmm.plan(M, N, K, 132, qmm.KT, 1) == one


def test_expert_entry_c_signature_matches_the_wrapper():
    """``aios_quantized_matmul_experts`` takes what the wrapper declares:
    seven pointers, ten ints, then the stream."""
    src = (ROOT / "aios_tpu_torch/csrc/quantized_matmul.cu").read_text()
    head = src[src.index("int aios_quantized_matmul_experts("):]
    params = [p.strip() for p in head[head.index("(") + 1:head.index(")")].split(",")]
    kinds = ["void*" in p.replace(" ", "") or "void *" in p for p in params]
    assert len(params) == len(qmm._EXPERT_ARGTYPES) == 18
    assert kinds == [t is not qmm.ctypes.c_int for t in qmm._EXPERT_ARGTYPES]


def test_expert_wrapper_layouts_and_mixed_devices():
    """The CPU wrapper's three output layouts; operands on two devices are
    refused rather than routed."""
    q = torch.zeros(4, 64, 32, dtype=torch.int8)
    s = torch.ones(4, 1, 32)
    x = torch.zeros(3, 64)
    with pytest.raises(ValueError, match="different devices"):
        qmm.quantized_matmul_experts(x, q, s.to("meta"))
    assert qmm.quantized_matmul_experts(x, q, s).shape == (4, 3, 32)
    assert qmm.quantized_matmul_experts(x, q, s, torch.tensor([0, 3, 1],
                                                              dtype=torch.int32)).shape == (3, 32)
    assert qmm.quantized_matmul_experts(torch.zeros(4, 2, 64), q, s).shape == (4, 2, 32)


def test_moe_module_reads_nothing_back():
    """Graph safety by construction: the MoE module never reads a device
    value back or sizes a tensor from data (no .item, .tolist, nonzero,
    repeat_interleave or bool indexing helpers)."""
    tree = ast.parse((ROOT / "aios_tpu_torch/engine/moe.py").read_text())
    calls = {n.func.attr for n in ast.walk(tree)
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)}
    assert not calls & {"item", "tolist", "nonzero", "repeat_interleave", "masked_select",
                        "unique", "cpu", "numpy"}
