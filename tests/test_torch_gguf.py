"""The port's GGUF reader, dequantizers, quantizers and writers
(``aios_tpu_torch/engine/gguf.py``) and ``from_gguf_metadata`` against the
JAX package's on the same inputs: values and bytes bit for bit, configs
field for field."""

import dataclasses
import struct

import numpy as np
import pytest
import torch

from aios_tpu.engine import config as jcfg
from aios_tpu.engine import gguf as jg
from aios_tpu_torch.engine import config as tcfg
from aios_tpu_torch.engine import gguf as tg

# The shapes here are tiny: one intra-op thread is faster and leaves the
# cores to the other test workers.
torch.set_num_threads(1)

# (ggml type, byte offsets of the f16 scale fields in a block)
QUANT_SCALES = {
    tg.Q4_0: (0,), tg.Q4_1: (0, 2), tg.Q5_0: (0,), tg.Q5_1: (0, 2), tg.Q8_0: (0,),
    tg.Q4_K: (0, 2), tg.Q5_K: (0, 2), tg.Q6_K: (208,),
}
PLAIN = {tg.F32: np.float32, tg.F16: np.float16, tg.F64: np.float64, tg.I8: np.int8,
         tg.I16: np.int16, tg.I32: np.int32, tg.I64: np.int64}


def _random_raw(ggml_type: int, n_blocks: int, seed: int) -> np.ndarray:
    """Random bytes of ``n_blocks`` blocks with finite values: the f16
    scales of a block type drawn as f16 numbers, the plain types as numbers
    of their own dtype."""
    rng = np.random.default_rng(seed)
    elems, nbytes = tg.BLOCK_LAYOUT[ggml_type]
    if ggml_type in PLAIN:
        dt = np.dtype(PLAIN[ggml_type])
        if dt.kind == "f":
            return (rng.standard_normal(n_blocks) * 3).astype(dt).view(np.uint8)
        info = np.iinfo(dt)
        return rng.integers(info.min, info.max, n_blocks, dtype=dt).view(np.uint8)
    if ggml_type == tg.BF16:  # the high halves of f32 numbers
        x = (rng.standard_normal(n_blocks) * 3).astype(np.float32)
        return (x.view(np.uint32) >> 16).astype(np.uint16).view(np.uint8)
    blocks = rng.integers(0, 256, (n_blocks, nbytes), dtype=np.uint8)
    for col in QUANT_SCALES[ggml_type]:
        d = (rng.standard_normal(n_blocks) * 0.1).astype(np.float16)
        blocks[:, col:col + 2] = d.view(np.uint8).reshape(-1, 2)
    return blocks.reshape(-1)


@pytest.mark.parametrize("ggml_type", sorted(tg.BLOCK_LAYOUT),
                         ids=lambda t: tg.GGML_TYPE_NAMES.get(t, str(t)))
def test_dequantize_bit_exact_with_jax(ggml_type):
    """Every type the JAX table takes, on random blocks: the same f32 bits."""
    elems, _ = tg.BLOCK_LAYOUT[ggml_type]
    n_blocks = 37 if elems == 1 else 7
    raw = _random_raw(ggml_type, n_blocks * elems if elems == 1 else n_blocks, seed=ggml_type)
    want = jg.dequantize(raw, ggml_type, n_blocks * elems)
    got = tg.dequantize(raw, ggml_type, n_blocks * elems)
    assert got.dtype == np.float32 and got.shape == want.shape == (n_blocks * elems,)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("ggml_type", [tg.Q2_K, tg.Q3_K, 16, 17, 18, 19, 20])
def test_types_jax_does_not_dequantize_raise(ggml_type):
    """Q2_K, Q3_K and the IQ types: NotImplementedError, as in JAX."""
    raw = np.zeros(4096, np.uint8)
    for fn in (jg.dequantize, tg.dequantize):
        with pytest.raises(NotImplementedError, match="dequantization for ggml type"):
            fn(raw, ggml_type, 256)


@pytest.mark.parametrize("quantize", ["quantize_q8_0", "quantize_q4_0"])
def test_quantizers_byte_for_byte(quantize):
    rng = np.random.default_rng(3)
    v = rng.standard_normal(32 * 41).astype(np.float32) * 0.05
    v[:32] = 0.0  # an all-zero block
    got = getattr(tg, quantize)(v)
    want = getattr(jg, quantize)(v)
    np.testing.assert_array_equal(got, want)


METADATA = {
    "general.architecture": "llama",
    "general.name": "Tiny Test",
    "llama.block_count": 2,
    "llama.rope.freq_base": 10000.0,
    "llama.attention.layer_norm_rms_epsilon": 1e-5,
    "tokenizer.ggml.tokens": ["<unk>", "<s>", "</s>", "▁hi", "中文"],
    "tokenizer.ggml.scores": [0.0, 0.0, 0.0, -1.5, -2.0],
    "tokenizer.ggml.token_type": [2, 3, 3, 1, 1],
    "some.flag": True,
    "empty.list": [],
}


def _tensors(seed: int):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((8, 64)).astype(np.float32)
    h = rng.standard_normal((4, 32)).astype(np.float16)
    q = jg.quantize_q8_0(rng.standard_normal(3 * 64).astype(np.float32))
    k = _random_raw(tg.Q4_K, 2, seed)
    return {
        "blk.0.attn_q.weight": (w.shape, tg.F32, w.tobytes()),
        "blk.0.attn_k.weight": (h.shape, tg.F16, h.tobytes()),
        "blk.0.ffn_up.weight": ((3, 64), tg.Q8_0, q.tobytes()),
        "blk.0.ffn_down.weight": ((2, 256), tg.Q4_K, k.tobytes()),
        "output_norm.weight": ((5,), tg.F32, np.arange(5, dtype=np.float32).tobytes()),
    }


@pytest.mark.parametrize("alignment", [32, 64])
def test_write_gguf_byte_for_byte(tmp_path, alignment):
    tensors = _tensors(0)
    jg.write_gguf(tmp_path / "jax.gguf", METADATA, tensors, alignment=alignment)
    tg.write_gguf(tmp_path / "port.gguf", METADATA, tensors, alignment=alignment)
    assert (tmp_path / "port.gguf").read_bytes() == (tmp_path / "jax.gguf").read_bytes()


@pytest.mark.parametrize("alignment", [32, 64])
def test_write_gguf_stream_same_bytes(tmp_path, alignment):
    """The streaming writer asks for one tensor at a time, in file order,
    and writes what ``write_gguf`` writes."""
    tensors = _tensors(1)
    asked = []

    def produce(name):
        asked.append(name)
        return np.frombuffer(tensors[name][2], np.uint8)

    tg.write_gguf(tmp_path / "whole.gguf", METADATA, tensors, alignment=alignment)
    tg.write_gguf_stream(tmp_path / "stream.gguf", METADATA,
                         {n: (shape, t) for n, (shape, t, _) in tensors.items()}, produce,
                         alignment=alignment)
    assert asked == list(tensors)
    assert (tmp_path / "stream.gguf").read_bytes() == (tmp_path / "whole.gguf").read_bytes()


def test_write_gguf_stream_refuses_a_wrong_size(tmp_path):
    with pytest.raises(ValueError, match="255 bytes, expected 256"):
        tg.write_gguf_stream(tmp_path / "x.gguf", {}, {"t": ((64,), tg.F32)},
                             lambda name: b"\x00" * 255)


def _spec_fixture(tmp_path, which: str):
    """A file from the independent spec-derived encoder of
    tests/test_gguf_spec_fixture.py."""
    import test_gguf_spec_fixture as spec

    path = tmp_path / f"{which}.gguf"
    getattr(spec, f"_write_tiny_{which}_gguf")(path, np.random.default_rng(5))
    return path


@pytest.mark.parametrize("which", ["llama", "qwen3"])
def test_gguf_file_matches_jax_on_the_spec_fixture(tmp_path, which):
    path = _spec_fixture(tmp_path, which)
    jf, tf = jg.GGUFFile(path), tg.GGUFFile(path)
    assert tf.version == jf.version == 3
    assert tf.architecture == jf.architecture
    assert tf.data_offset == jf.data_offset
    assert tf.metadata == jf.metadata
    assert list(tf.tensors) == list(jf.tensors)
    for name, info in jf.tensors.items():
        assert dataclasses.astuple(tf.tensors[name]) == dataclasses.astuple(info)
        want = jf.load_tensor(name)
        got = tf.load_tensor(name)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_gguf_file_refuses_what_jax_refuses(tmp_path):
    (tmp_path / "bad.gguf").write_bytes(b"GGML" + b"\x00" * 60)
    (tmp_path / "v1.gguf").write_bytes(b"GGUF" + struct.pack("<IQQ", 1, 0, 0))
    for name, match in (("bad", "not a GGUF file"), ("v1", "unsupported")):
        for cls in (jg.GGUFFile, tg.GGUFFile):
            with pytest.raises(ValueError, match=match):
                cls(tmp_path / f"{name}.gguf")


# -- configs from metadata --------------------------------------------------------------


def _md(arch: str, **extra):
    md = {
        "general.architecture": arch,
        "general.name": f"Some {arch.title()} Model 7B",
        f"{arch}.block_count": 3,
        f"{arch}.context_length": 4096,
        f"{arch}.embedding_length": 256,
        f"{arch}.feed_forward_length": 512,
        f"{arch}.attention.head_count": 8,
        f"{arch}.attention.head_count_kv": 2,
        f"{arch}.attention.layer_norm_rms_epsilon": 1e-5,
        f"{arch}.rope.freq_base": 10000.0,
        "tokenizer.ggml.tokens": [f"t{i}" for i in range(300)],
    }
    md.update(extra)
    return md


CONFIG_CASES = {
    "llama": _md("llama"),
    "mistral-window": _md("llama", **{"general.name": "Mistral 7B Instruct v0.2",
                                      "llama.attention.sliding_window": 4096,
                                      "llama.context_length": 32768}),
    "qwen3": _md("qwen3", **{"qwen3.attention.key_length": 128,
                             "qwen3.attention.layer_norm_rms_epsilon": 1e-6,
                             "qwen3.rope.freq_base": 1000000.0,
                             "general.name": "Qwen3 14B"}),
    "llama-bpe": _md("llama", **{"general.name": "DeepSeek R1 Distill Llama 8B",
                                 "llama.rope.freq_base": 500000.0,
                                 "tokenizer.ggml.model": "gpt2",
                                 "tokenizer.ggml.pre": "llama-bpe"}),
    "no-vocab": {k: v for k, v in _md("llama", **{"llama.vocab_size": 1234}).items()
                 if k != "tokenizer.ggml.tokens"},
    "no-name": {k: v for k, v in _md("llama").items() if k != "general.name"},
}


@pytest.mark.parametrize("case", sorted(CONFIG_CASES))
def test_from_gguf_metadata_field_for_field(case):
    md = CONFIG_CASES[case]
    got = tcfg.from_gguf_metadata(md)
    want = jcfg.from_gguf_metadata(md)
    for f in dataclasses.fields(tcfg.ModelConfig):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    if case == "qwen3":
        assert got.qk_norm and got.head_dim == 128 and got.name == "qwen3-14b"
    if case == "mistral-window":
        assert got.sliding_window == 4096 and got.name == "mistral-7b-instruct-v0.2"


@pytest.mark.parametrize("arch", ["llama", "qwen3moe"])
def test_from_gguf_metadata_refuses_moe(arch):
    """A mixture-of-experts file is no longer refused: its expert keys give
    the JAX package's config, field for field (expert count, picks per
    token, expert width, renormalization off)."""
    md = _md(arch, **{f"{arch}.expert_count": 8, f"{arch}.expert_used_count": 2,
                      f"{arch}.expert_feed_forward_length": 96,
                      f"{arch}.expert_weights_norm": False})
    got, want = tcfg.from_gguf_metadata(md), jcfg.from_gguf_metadata(md)
    assert want.num_experts == 8
    for f in dataclasses.fields(tcfg.ModelConfig):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert (got.moe, got.expert_dim, got.num_experts_per_tok, got.norm_topk_prob) == (
        True, 96, 2, False)
