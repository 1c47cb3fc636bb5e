"""Serving GGUF files with the port on the CPU (``device="cpu"``) against the
JAX package on the same files: the loaded bf16 parameters and the int8
serving bytes bit for bit, prefill logits, a greedy stream through the
gRPC service, ``autoload``, the files LoadModel refuses, and the lm_head
padded for vocabs the matmul kernels cannot take as they are."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from aios_tpu.engine import gguf as jg
from aios_tpu.engine import model as jm
from aios_tpu.engine import weights as jw
from aios_tpu.engine.engine import TPUEngine
from aios_tpu.engine.tokenizer import gguf_tokenizer as jax_gguf_tokenizer
from aios_tpu.engine.tokenizer import render_chat as jax_render_chat
from aios_tpu.runtime import model_manager as jax_mm
from aios_tpu_torch import rpc, services
from aios_tpu_torch.engine import model as tm
from aios_tpu_torch.engine import weights as tw
from aios_tpu_torch.engine.config import TINY_TEST
from aios_tpu_torch.engine.tokenizer import ByteLevelBPE, SentencePieceBPE
from aios_tpu_torch.proto_gen import common_pb2, runtime_pb2
from aios_tpu_torch.runtime import model_manager as tmm
from aios_tpu_torch.runtime.service import serve

# The shapes here are tiny: one intra-op thread is faster and leaves the
# cores to the other test workers.
torch.set_num_threads(1)

E, F, L, H, KH, D = 64, 128, 2, 4, 2, 16


def _sp_vocab(rng, n_pieces=300):
    chars = ["▁"] + list("abcdefghijklmnopqrstuvwxyz.,!?")
    pieces, seen = list(chars), set(chars)
    while len(pieces) < n_pieces:
        a, b = rng.integers(0, len(pieces), 2)
        if len(pieces[a] + pieces[b]) <= 8 and pieces[a] + pieces[b] not in seen:
            seen.add(pieces[a] + pieces[b])
            pieces.append(pieces[a] + pieces[b])
    return {"tokenizer.ggml.model": "llama",
            "tokenizer.ggml.tokens": (["<unk>", "<s>", "</s>"]
                                      + [f"<0x{i:02X}>" for i in range(256)] + pieces),
            "tokenizer.ggml.scores": [0.0] * 259 + [-float(i // 2) for i in range(n_pieces)],
            "tokenizer.ggml.token_type": [2, 3, 3] + [6] * 256 + [1] * n_pieces,
            "tokenizer.ggml.bos_token_id": 1, "tokenizer.ggml.eos_token_id": 2}


def _bpe_vocab(rng, n_merges=120):
    from aios_tpu.engine.tokenizer import _bytes_to_unicode

    b2u = _bytes_to_unicode()
    tokens = [b2u[b] for b in range(256)]
    seen, merges = set(tokens), []
    letters = [b2u[b] for b in b"etaoinshrdlu "]
    while len(merges) < n_merges:
        left, right = (letters[i] for i in rng.integers(0, len(letters), 2))
        if left + right not in seen:
            seen.add(left + right)
            tokens.append(left + right)
            merges.append(f"{left} {right}")
    specials = ["<|endoftext|>", "<|im_start|>", "<|im_end|>"]
    return {"tokenizer.ggml.model": "gpt2", "tokenizer.ggml.pre": "qwen2",
            "tokenizer.ggml.tokens": tokens + specials, "tokenizer.ggml.merges": merges,
            "tokenizer.ggml.token_type": [1] * len(tokens) + [3] * 3,
            "tokenizer.ggml.eos_token_id": len(tokens) + 2}


def _permute_hf_to_gguf(w, n_heads):
    """convert_hf_to_gguf's q/k row permutation."""
    return (w.reshape(n_heads, 2, w.shape[0] // n_heads // 2, w.shape[1])
            .swapaxes(1, 2).reshape(w.shape))


def write_model(path, arch="llama", seed=0, tied=False, vocab="sp", types=None,
                extra_md=None, std=0.02):
    """A small GGUF in llama.cpp's layout, written by the JAX package's
    writer: Q8_0 matrices (``types`` maps a tensor name to F32, F16, Q4_0 or
    a raw ggml type), F32 norms, q/k permuted for llama, q/k norms for
    qwen3, no output.weight when ``tied``."""
    rng = np.random.default_rng(seed)
    md = {"general.architecture": arch, "general.name": f"Test {arch.title()} Tiny",
          f"{arch}.block_count": L, f"{arch}.context_length": 128,
          f"{arch}.embedding_length": E, f"{arch}.feed_forward_length": F,
          f"{arch}.attention.head_count": H, f"{arch}.attention.head_count_kv": KH,
          f"{arch}.attention.key_length": D,
          f"{arch}.attention.layer_norm_rms_epsilon": 1e-5,
          f"{arch}.rope.freq_base": 10000.0}
    md.update(_sp_vocab(rng) if vocab == "sp" else _bpe_vocab(rng))
    md.update(extra_md or {})
    V = len(md["tokenizer.ggml.tokens"])
    types = types or {}
    tensors = {}

    def mat(name, rows, cols, heads=None):
        w = (rng.standard_normal((rows, cols)) * std).astype(np.float32)
        if heads is not None and arch == "llama":
            w = _permute_hf_to_gguf(w, heads)
        t = types.get(name, jg.Q8_0)
        raw = {jg.F32: lambda: w.tobytes(), jg.F16: lambda: w.astype(np.float16).tobytes(),
               jg.Q4_0: lambda: jg.quantize_q4_0(w).tobytes(),
               jg.Q8_0: lambda: jg.quantize_q8_0(w).tobytes()}.get(
            t, lambda: rng.integers(0, 256, rows * cols // 256 * 84, np.uint8).tobytes())()
        tensors[name] = ((rows, cols), t, raw)

    def norm(name, n):
        tensors[name] = ((n,), jg.F32, rng.uniform(0.8, 1.2, n).astype(np.float32).tobytes())

    mat("token_embd.weight", V, E)
    for i in range(L):
        p = f"blk.{i}."
        norm(p + "attn_norm.weight", E)
        norm(p + "ffn_norm.weight", E)
        if arch == "qwen3":
            norm(p + "attn_q_norm.weight", D)
            norm(p + "attn_k_norm.weight", D)
        mat(p + "attn_q.weight", H * D, E, heads=H)
        mat(p + "attn_k.weight", KH * D, E, heads=KH)
        mat(p + "attn_v.weight", KH * D, E)
        mat(p + "attn_output.weight", E, H * D)
        mat(p + "ffn_gate.weight", F, E)
        mat(p + "ffn_up.weight", F, E)
        mat(p + "ffn_down.weight", E, F)
    norm("output_norm.weight", E)
    if not tied:
        mat("output.weight", V, E)
    jg.write_gguf(path, md, tensors)
    return path


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _bits(a):
    """The bits of a numpy or torch array, bf16 as uint16."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.uint16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


FILES = {
    "llama": dict(arch="llama"),
    "llama-mixed-types": dict(arch="llama", types={"blk.0.attn_q.weight": jg.F32,
                                                   "blk.0.attn_k.weight": jg.F16,
                                                   "blk.1.ffn_up.weight": jg.Q4_0}),
    "qwen3": dict(arch="qwen3", vocab="bpe"),
    "tied": dict(arch="llama", tied=True),
}


@pytest.mark.parametrize("case", sorted(FILES))
@pytest.mark.parametrize("row_block", [1 << 24, 64], ids=["whole", "row-blocks"])
def test_params_from_gguf_bf16_bit_exact_with_jax(tmp_path, monkeypatch, case, row_block):
    """The JAX loader's leaves cast to bf16 (its manager's map_params) and
    the port's, from one file, bit for bit; with small row blocks too."""
    monkeypatch.setattr(tw, "ROW_BLOCK_ELEMENTS", row_block)
    path = write_model(tmp_path / f"{case}.gguf", **FILES[case])
    jp, jc = jw.params_from_gguf(str(path))
    jp = jw.map_params(jp, lambda a: a.astype(jnp.bfloat16))
    timings = {}
    tp, tc = tw.params_from_gguf(str(path), "cpu", timings=timings)
    assert set(timings) == {"dequantize_s", "upload_s"}
    assert ("lm_head" in tp) == (not FILES[case].get("tied"))
    want, got = dict(_flat(jp)), dict(_flat(tp))
    assert want.keys() == got.keys()
    for k, v in want.items():
        assert got[k].dtype == torch.bfloat16, k
        np.testing.assert_array_equal(_bits(got[k]), _bits(v), err_msg=k)
    assert (tc.name, tc.num_heads, tc.num_kv_heads, tc.head_dim, tc.vocab_size, tc.qk_norm) \
        == (jc.name, jc.num_heads, jc.num_kv_heads, jc.head_dim, jc.vocab_size, jc.qk_norm)


def test_params_from_gguf_takes_a_parsed_file_and_the_spec_fixture(tmp_path):
    """The independent encoder's llama.cpp-layout file: the same leaves as
    the JAX loader, read from an already parsed GGUFFile."""
    import test_gguf_spec_fixture as spec

    from aios_tpu_torch.engine.gguf import GGUFFile

    path = tmp_path / "fixture.gguf"
    spec._write_tiny_llama_gguf(path, np.random.default_rng(7))
    jp, _ = jw.params_from_gguf(str(path))
    tp, _ = tw.params_from_gguf(GGUFFile(path), "cpu", dtype=torch.float32)
    for k, v in dict(_flat(jp)).items():
        np.testing.assert_array_equal(dict(_flat(tp))[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("case", ["llama", "qwen3", "tied"])
def test_int8_serving_bytes_equal_jax(tmp_path, case):
    path = write_model(tmp_path / f"{case}.gguf", **FILES[case])
    jp, _ = jw.params_from_gguf(str(path))
    jp = jw.map_params(jp, lambda a: a.astype(jnp.bfloat16))
    tp, _ = tw.params_from_gguf(str(path), "cpu")
    jq = dict(_flat(jax.tree.map(np.asarray, jm.quantize_params(jp, mode="int8"))))
    tq = dict(_flat(tm.quantize_params(tp, mode="int8")))
    assert jq.keys() == tq.keys()
    for k, v in jq.items():
        np.testing.assert_array_equal(_bits(tq[k]), _bits(v), err_msg=k)


@pytest.mark.parametrize("case", ["llama", "qwen3", "tied"])
def test_prefill_logits_match_jax_on_a_gguf(tmp_path, case):
    path = write_model(tmp_path / f"{case}.gguf", **FILES[case])
    jp, jc = jw.params_from_gguf(str(path))
    tp, tc = tw.params_from_gguf(str(path), "cpu", dtype=torch.float32)
    tokens = np.random.default_rng(1).integers(0, tc.vocab_size, (1, 24))
    jl, _, _ = jm.prefill(jp, jc, jnp.asarray(tokens, jnp.int32))
    tl, _, _ = tm.prefill(tp, tc, torch.from_numpy(tokens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)


class _Recorded:
    """A request handle whose tokens are kept as the service reads them."""

    def __init__(self, handle, into):
        self._handle, self._into = handle, into

    def __iter__(self):
        for t in self._handle:
            self._into.append(t)
            yield t

    def __getattr__(self, name):
        return getattr(self._handle, name)


@pytest.fixture()
def runtime(tmp_path):
    manager = tmm.ModelManager(num_slots=2, device="cpu")
    server, _, port = serve(address="127.0.0.1:0", manager=manager, block=False)
    channel = rpc.insecure_channel(f"127.0.0.1:{port}")
    yield services.AIRuntimeStub(channel), manager
    manager.close()
    channel.close()
    server.stop(grace=None)


@pytest.mark.parametrize("case", ["llama", "qwen3"])
def test_greedy_infer_over_grpc_equals_the_jax_engine(tmp_path, runtime, case):
    """LoadModel of a GGUF path, then one Infer at a temperature the sampler
    takes as greedy: the ids the service streamed equal the JAX engine's
    greedy stream on the same file (bf16 weights and cache, as both
    managers serve on the CPU), the prompt templated and tokenized alike."""
    stub, manager = runtime
    path = write_model(tmp_path / f"{case}.gguf", **FILES[case])
    st = stub.LoadModel(runtime_pb2.LoadModelRequest(model_name="m", model_path=str(path)))
    assert st.status == "ready"
    m = manager.get("m")
    assert isinstance(m.tokenizer, SentencePieceBPE if case == "llama" else ByteLevelBPE)
    got = []
    submit = m.submit
    m.submit = lambda req, **kw: _Recorded(submit(req, **kw), got)
    prompt = "the cat sat on a mat, then it ran!"
    r = stub.Infer(runtime_pb2.InferRequest(prompt=prompt, max_tokens=12, temperature=1e-5))
    assert r.model_used == "m"

    jp, jc = jw.params_from_gguf(str(path))
    jp = jw.map_params(jp, lambda a: a.astype(jnp.bfloat16))
    eng = TPUEngine(jc, jp, num_slots=2, max_context=128, cache_dtype=jnp.bfloat16,
                    paged_pool_rows=3 * 128, page_size=128, prefix_cache=False)
    tok = jax_gguf_tokenizer(jg.GGUFFile(path).metadata)
    ids = tok.encode(jax_render_chat(jc.name, prompt))
    assert m.tokenizer.encode(jax_render_chat(m.config.name, prompt)) == ids
    want = eng.generate(ids, max_new_tokens=12, temperature=0.0, stop_tokens=(tok.eos_id,))
    assert got == want
    assert r.text == tok.decode([t for t in want if t != tok.eos_id])
    assert r.tokens_used == len(ids) + len([t for t in want if t != tok.eos_id])


def test_load_refusals_leave_the_model_in_error(tmp_path, runtime):
    """A corrupt header, a mixture-of-experts header without its expert
    tensors, a ggml type with no dequantizer and a directory: LoadModel
    answers error with the reason, the model lists as error, and nothing
    falls back to synthetic weights."""
    stub, manager = runtime
    good = write_model(tmp_path / "good.gguf")
    (tmp_path / "corrupt.gguf").write_bytes(good.read_bytes()[:40])
    write_model(tmp_path / "moe.gguf", extra_md={"llama.expert_count": 8})
    write_model(tmp_path / "q2k.gguf", types={"blk.0.ffn_down.weight": jg.Q2_K})
    (tmp_path / "hf").mkdir()
    cases = {"corrupt": "unpack", "moe": "no tensor blk.0.ffn_gate_inp.weight",
             "q2k": "ggml type Q2_K",
             "hf": "HF checkpoint directories", "missing": "not found"}
    for name, why in cases.items():
        path = tmp_path / (name if name in ("hf", "missing") else f"{name}.gguf")
        with pytest.raises(Exception) as err:
            stub.LoadModel(runtime_pb2.LoadModelRequest(model_name=name, model_path=str(path)))
        assert err.value.code().name == "INTERNAL" and why in err.value.details(), name
        assert manager.get(name).state == "error" and why in manager.get(name).error
    listed = {x.model_name: x.status for x in stub.ListModels(common_pb2.Empty()).models}
    assert listed == dict.fromkeys(cases, "error")


def test_autoload_names_contexts_and_skips_a_corrupt_file(tmp_path, monkeypatch):
    """Two files and a corrupt one in AIOS_MODEL_DIR: both load under their
    lower-cased stems in sorted order at the context JAX picks by size, the
    corrupt one is skipped."""
    d = tmp_path / "models"
    d.mkdir()
    write_model(d / "TinyLlama-Test.Q8_0.gguf", seed=1)
    write_model(d / "Qwen3-Test.gguf", arch="qwen3", vocab="bpe", seed=2)
    (d / "broken.gguf").write_bytes(b"GGUF\x03\x00\x00\x00")
    (d / "notes.txt").write_text("not a model")
    monkeypatch.setenv("AIOS_MODEL_DIR", str(d))
    manager = tmm.ModelManager(num_slots=2, device="cpu")
    try:
        names = manager.autoload()
        assert names == ["qwen3-test", "tinyllama-test.q8_0"]
        assert manager.get("broken").state == "error"
        for name, stem in zip(names, ["Qwen3-Test", "TinyLlama-Test.Q8_0"]):
            size = (d / f"{stem}.gguf").stat().st_size
            want = jax_mm._context_for_file_size(size)
            assert manager.get(name).engine.max_context == want == 2048
        assert manager.select_for_level("strategic").name == "qwen3-test"
        assert manager.select_for_level("operational").name == "tinyllama-test.q8_0"
        assert manager.autoload(str(tmp_path / "nowhere")) == []
    finally:
        manager.close()


@pytest.mark.parametrize("n_bytes", [0, 2 * 10**9, 2 * 10**9 + 1, 8 * 10**9,
                                     8 * 10**9 + 1, 30 * 10**9])
def test_context_for_file_size_matches_jax(n_bytes):
    assert tmm._context_for_file_size(n_bytes) == jax_mm._context_for_file_size(n_bytes)


# -- a vocab the matmul kernels cannot take as it is ------------------------------------


def test_padded_head_logits_equal_the_unpadded_plain_path():
    """V = 32002: the head padded to 32016 zero columns; logits [..., :V]
    bit-equal to the unpadded head's, the padding's real columns quantized
    as before."""
    cfg = TINY_TEST.scaled(vocab_size=32002)
    gen = torch.Generator().manual_seed(0)
    params = tw.init_params(cfg, gen, dtype=torch.bfloat16, device="cpu")
    plain = tm.quantize_params(params)  # the CPU's default: no padding
    padded = tm.quantize_params(params, pad_head=True)
    assert plain["lm_head"]["q"].shape[-1] == 32002
    assert padded["lm_head"]["q"].shape[-1] == 32016
    torch.testing.assert_close(padded["lm_head"]["q"][:, :32002], plain["lm_head"]["q"],
                               rtol=0, atol=0)
    assert not padded["lm_head"]["q"][:, 32002:].any()
    x = torch.randn(2, 5, cfg.hidden_size, generator=gen).to(torch.bfloat16)
    want = tm._final_logits(x, plain, cfg)
    got = tm._final_logits(x, padded, cfg)
    assert got.shape == want.shape == (2, 5, 32002)
    assert torch.equal(got, want)
    tokens = torch.randint(0, 32002, (1, 9), generator=gen)
    assert torch.equal(tm.forward_full(padded, cfg, tokens), tm.forward_full(plain, cfg, tokens))


@pytest.mark.parametrize("vocab", [32001, 32002, 32000, 151936, 128256])
def test_contract_faults_no_longer_report_the_head(vocab):
    cfg = tmm.PRESETS["tinyllama-1.1b"].scaled(vocab_size=vocab)
    assert tm.serving_leaf_shapes(cfg)["lm_head"] == (2048, -(-vocab // 16) * 16)
    for quantize in ("int8", "int4"):
        assert tm.kernel_contract_faults(cfg, paged=True, quant_cache=False,
                                         quantize=quantize, pages_per_slot=16) == []
