"""Serving mixture-of-experts models on the port against the JAX package:
``resolve_preset`` against the JAX manager's ``_resolve_preset`` over every
preset, the tiny names and fuzzy names; the paged engine's and the batcher's
greedy streams (whole-prompt, chunked and a prefix hit, on the dense path and
with ``AIOS_TPU_MOE_GATHER=1``) against the JAX engine's on ``tiny-moe``; a
tiny MoE GGUF written here loads to the JAX loader's tensors and serves; and
``LoadModel("tiny-moe", "synthetic://tiny-moe")`` over gRPC on the CPU.

Greedy streams are compared for equality (f32 weights and caches on both
sides); GGUF leaves bit for bit in bf16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aios_tpu.engine import model as jm
from aios_tpu.engine import weights as jw
from aios_tpu.engine.batching import ContinuousBatcher as JaxBatcher
from aios_tpu.engine.config import TINY_MOE as JAX_TINY_MOE
from aios_tpu.engine.engine import TPUEngine
from aios_tpu.runtime.model_manager import ModelManager as JaxManager
from aios_tpu_torch import rpc, services
from aios_tpu_torch.engine import weights as tw
from aios_tpu_torch.engine.batching import ContinuousBatcher
from aios_tpu_torch.engine.config import PRESETS, TINY_MOE
from aios_tpu_torch.engine.engine import TorchEngine
from aios_tpu_torch.proto_gen import common_pb2, runtime_pb2
from aios_tpu_torch.runtime import model_manager as tmm
from aios_tpu_torch.runtime.service import serve

torch.set_num_threads(1)

CTX, PAGE = 256, 32


@pytest.fixture(scope="module")
def jax_params():
    return jm.init_params(JAX_TINY_MOE, jax.random.PRNGKey(3), dtype=jnp.float32)


@pytest.fixture(scope="module")
def torch_params(jax_params):
    return tw.params_from_jax(jax.tree.map(np.asarray, jax_params))


NAMES = sorted(PRESETS) + ["tiny-test", "tiny", "tiny-moe", "TINY-MOE", "Qwen3-30B-A3B",
                           "qwen3", "mistral", "TinyLlama-Chat", "deepseek", "mixtral",
                           "qwen3-30b", "llama-3-8b-qwen3"]


@pytest.mark.parametrize("name", NAMES)
def test_resolve_preset_matches_the_jax_manager(name):
    """The port once resolved ``qwen3-30b-a3b`` to Qwen3-14B (its family's
    fuzzy match) and raised on ``mixtral-8x7b`` and ``tiny-moe``; now the
    exact names win, as in JAX."""
    want = JaxManager._resolve_preset(name)
    got = tmm.resolve_preset(name)
    assert got.name == want.name
    if name.lower() in PRESETS or name.lower() == "tiny-moe":
        assert got.name == name.lower()


def test_resolve_preset_raises_like_jax():
    with pytest.raises(KeyError):
        JaxManager._resolve_preset("gpt-neo")
    with pytest.raises(KeyError, match="no preset matches"):
        tmm.resolve_preset("gpt-neo")


def _pair(jax_params, torch_params, num_slots):
    kw = dict(num_slots=num_slots, max_context=CTX, paged_pool_rows=6 * CTX, page_size=PAGE)
    je = TPUEngine(JAX_TINY_MOE, jax_params, cache_dtype=jnp.float32, **kw)
    te = TorchEngine(TINY_MOE, torch_params, cache_dtype=torch.float32, device="cpu", **kw)
    assert te.paged
    return je, te


@pytest.mark.parametrize("gather", [False, True], ids=["dense", "gather"])
def test_paged_engine_greedy_streams_equal_jax(jax_params, torch_params, monkeypatch, gather):
    """One slot (1*2 < 4 experts, so the gather opt-in takes): a whole-prompt
    admission, multi-step paged decode, then the same prompt again through
    the prefix index; the streams equal the JAX engine's."""
    if gather:
        monkeypatch.setenv("AIOS_TPU_MOE_GATHER", "1")
    je, te = _pair(jax_params, torch_params, num_slots=1)
    assert te._moe_impl == ("gather" if gather else None)
    assert je._moe_impl == te._moe_impl
    prompt = [int(t) for t in np.random.default_rng(4).integers(1, 500, 90)]
    got = [te.generate(prompt, max_new_tokens=20, temperature=0.0) for _ in range(2)]
    want = [je.generate(prompt, max_new_tokens=20, temperature=0.0) for _ in range(2)]
    assert te.prefix_rows_reused == je.prefix_rows_reused == 64
    assert got == want


@pytest.mark.parametrize("gather", [False, True], ids=["dense", "gather"])
def test_batcher_chunked_streams_equal_jax(jax_params, torch_params, monkeypatch, gather):
    """Two prompts longer than the 64-row chunk through the continuous
    batcher at once (chunked admission between decode dispatches), with 1
    slot under gather; greedy streams equal the JAX batcher's."""
    if gather:
        monkeypatch.setenv("AIOS_TPU_MOE_GATHER", "1")
    slots = 1 if gather else 2
    je, te = _pair(jax_params, torch_params, num_slots=slots)
    rng = np.random.default_rng(9)
    prompts = [[int(t) for t in rng.integers(1, 500, n)] for n in (150, 100)]
    outs = []
    for batcher in (ContinuousBatcher(te, prefill_chunk=64), JaxBatcher(je, prefill_chunk=64)):
        try:
            outs.append([batcher.generate(p, max_tokens=10, temperature=0.0) for p in prompts])
        finally:
            batcher.shutdown()
    assert te.prefill_chunks > 0
    assert outs[0] == outs[1]


def _write_moe_gguf(path, arch="qwen3moe", seed=0):
    """A tiny mixture-of-experts GGUF in llama.cpp's layout, written with the
    port's writer: Q8_0 matrices, F32 norms, a router ``ffn_gate_inp`` [X, E]
    and expert stacks ``ffn_{gate,up,down}_exps`` [X, out, in]."""
    from aios_tpu_torch.engine import gguf as tg

    cfg = TINY_MOE
    E, X, Fm, H, KH, D = (cfg.hidden_size, cfg.num_experts, cfg.expert_dim, cfg.num_heads,
                          cfg.num_kv_heads, cfg.head_dim)
    rng = np.random.default_rng(seed)
    V = 300
    md = {"general.architecture": arch, "general.name": "Tiny MoE",
          f"{arch}.block_count": 2, f"{arch}.context_length": 128,
          f"{arch}.embedding_length": E, f"{arch}.feed_forward_length": 128,
          f"{arch}.attention.head_count": H, f"{arch}.attention.head_count_kv": KH,
          f"{arch}.attention.key_length": D, f"{arch}.attention.layer_norm_rms_epsilon": 1e-6,
          f"{arch}.rope.freq_base": 10000.0, f"{arch}.expert_count": X,
          f"{arch}.expert_used_count": 2, f"{arch}.expert_feed_forward_length": Fm,
          "tokenizer.ggml.tokens": [f"t{i}" for i in range(V)]}
    tensors = {}

    def mat(name, *shape):
        w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
        tensors[name] = (shape, tg.Q8_0, tg.quantize_q8_0(w.reshape(-1, shape[-1])).tobytes())

    def norm(name, n):
        tensors[name] = ((n,), tg.F32, rng.uniform(0.8, 1.2, n).astype(np.float32).tobytes())

    mat("token_embd.weight", V, E)
    for i in range(2):
        p = f"blk.{i}."
        norm(p + "attn_norm.weight", E)
        norm(p + "ffn_norm.weight", E)
        norm(p + "attn_q_norm.weight", D)
        norm(p + "attn_k_norm.weight", D)
        mat(p + "attn_q.weight", H * D, E)
        mat(p + "attn_k.weight", KH * D, E)
        mat(p + "attn_v.weight", KH * D, E)
        mat(p + "attn_output.weight", E, H * D)
        mat(p + "ffn_gate_inp.weight", X, E)
        mat(p + "ffn_gate_exps.weight", X, Fm, E)
        mat(p + "ffn_up_exps.weight", X, Fm, E)
        mat(p + "ffn_down_exps.weight", X, E, Fm)
    norm("output_norm.weight", E)
    mat("output.weight", V, E)
    tg.write_gguf(path, md, tensors)
    return path


def _bits(t):
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy()
    return np.asarray(t).view(np.int16)


@pytest.mark.parametrize("row_block", [1 << 24, 64 * 32], ids=["whole", "expert-blocks"])
def test_moe_gguf_loads_to_the_jax_tensors(tmp_path, monkeypatch, row_block):
    """``params_from_gguf`` on a MoE file: the router transposed, the expert
    stacks swapped to [X, in, out], bit for bit the JAX loader's leaves in
    bf16, whole and a couple of experts a row block."""
    monkeypatch.setattr(tw, "ROW_BLOCK_ELEMENTS", row_block)
    path = _write_moe_gguf(tmp_path / "moe.gguf")
    jp, jc = jw.params_from_gguf(str(path))
    jp = jw.map_params(jp, lambda a: a.astype(jnp.bfloat16))
    tp, tc = tw.params_from_gguf(str(path), "cpu")
    assert (tc.num_experts, tc.num_experts_per_tok, tc.expert_dim, tc.qk_norm) == (
        jc.num_experts, jc.num_experts_per_tok, jc.expert_dim, jc.qk_norm) == (4, 2, 32, True)
    assert set(tp["layers"]) == set(jp["layers"])
    assert tp["layers"]["we_down"].shape == (2, 4, 32, 64)
    for k, v in jp["layers"].items():
        np.testing.assert_array_equal(_bits(tp["layers"][k]), _bits(v), err_msg=k)
    for k in ("embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(_bits(tp[k]), _bits(jp[k]), err_msg=k)


@pytest.fixture()
def runtime():
    manager = tmm.ModelManager(num_slots=2, device="cpu")
    server, _, port = serve(address="127.0.0.1:0", manager=manager, block=False)
    channel = rpc.insecure_channel(f"127.0.0.1:{port}")
    yield services.AIRuntimeStub(channel), manager
    manager.close()
    channel.close()
    server.stop(grace=None)


def test_load_model_tiny_moe_serves_over_grpc(runtime, tmp_path):
    """``LoadModel("tiny-moe", "synthetic://tiny-moe")`` on the CPU: READY,
    the MoE config (not a dense preset), and Infer and StreamInfer answer;
    then a MoE GGUF by path serves as well."""
    stub, manager = runtime
    st = stub.LoadModel(runtime_pb2.LoadModelRequest(model_name="tiny-moe",
                                                     model_path="synthetic://tiny-moe"))
    assert st.status == "ready"
    m = manager.get("tiny-moe")
    assert m.config.name == "tiny-moe" and m.config.num_experts == 4
    assert "w_router" in m.engine.params["layers"]
    r = stub.Infer(runtime_pb2.InferRequest(prompt="Route the experts.", max_tokens=6))
    assert r.tokens_used > 0 and r.model_used == "tiny-moe"
    chunks = list(stub.StreamInfer(runtime_pb2.InferRequest(prompt="Stream it.", max_tokens=5)))
    assert chunks and chunks[-1].done
    listed = {x.model_name: x.status for x in stub.ListModels(common_pb2.Empty()).models}
    assert listed == {"tiny-moe": "ready"}
    path = _write_moe_gguf(tmp_path / "tiny-moe.gguf")
    st = stub.LoadModel(runtime_pb2.LoadModelRequest(model_name="moe-file", model_path=str(path)))
    assert st.status == "ready" and manager.get("moe-file").config.num_experts == 4
    r = stub.Infer(runtime_pb2.InferRequest(prompt="t1 t2", max_tokens=4, model="moe-file"))
    assert r.tokens_used > 0 and r.model_used == "moe-file"


def test_admission_bytes_counts_experts_and_logits():
    """The budget's admission transient: the largest whole-prompt bucket's
    logits (bf16 and f32), the prompt's K/V twice and a MoE model's dense
    expert intermediates over one slice of DENSE_TOKEN_CHUNK rows.
    Qwen3-30B-A3B at context 32768 prefills 8192-row buckets."""
    q = tmm.PRESETS["qwen3-30b-a3b"]
    N = 8192
    experts = 128 * 1024 * 768 * 10
    kv = 4 * 48 * N * 4 * 128 * 2
    assert tmm.admission_bytes(q, 32768) == N * 151936 * 6 + experts + kv
    dense = tmm.PRESETS["qwen3-14b"]
    assert tmm.admission_bytes(dense, 8192) == N * 151936 * 6 + 4 * 40 * N * 8 * 128 * 2
    assert tmm.admission_bytes(TINY_MOE, 128) == 128 * 512 * 6 + 4 * 128 * 32 * 10 + (
        4 * 2 * 128 * 2 * 16 * 2)


def test_auto_pool_leaves_room_for_the_admission_transient(monkeypatch, caplog):
    """An ``auto`` pool that would not leave room for the admission transient
    is cut to whole pages that do (never below one slot's context); a pool
    that fits is left at (slots + 1) x context rows."""
    weights = tmm.model_mod.serving_weight_bytes(
        tw.init_params(TINY_MOE, torch.Generator().manual_seed(0), device="cpu"))
    row = tmm._kv_row_bytes(TINY_MOE, torch.bfloat16)
    card = (weights + tmm.admission_bytes(TINY_MOE, 128) + 200 * row) / 0.85
    monkeypatch.setattr(tmm, "_chip_hbm_bytes", lambda device: card)
    manager = tmm.ModelManager(num_slots=2, device="cpu")
    try:
        m = manager.load_model("tiny-moe", "synthetic://tiny-moe")
        assert m.engine.allocator.num_pages - 1 == 1  # 200 rows fit: one 128-row page
        assert "leaves no room for the admission transient" in caplog.text
    finally:
        manager.close()
    monkeypatch.setattr(tmm, "_chip_hbm_bytes", lambda device: 16e9)
    manager = tmm.ModelManager(num_slots=2, device="cpu")
    try:
        m = manager.load_model("tiny-moe", "synthetic://tiny-moe")
        assert m.engine.allocator.num_pages - 1 == 3  # (2 + 1) x 128 rows
    finally:
        manager.close()
