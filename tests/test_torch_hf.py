"""HF checkpoint directories on the port, on the CPU, against the JAX package
and transformers: ``from_hf_config``, the port's safetensors reader and
writer against the ``safetensors`` package and ``save_pretrained``'s files,
``params_from_hf_state_dict``, logits against transformers' fp32 models,
``HFTokenizer`` on ``tokenizer.json`` against the JAX ``HFTokenizer``
(``AutoTokenizer``), and ``LoadModel`` of a directory against the JAX
manager's load of the same directory."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.numpy
import safetensors.torch
import torch
from tokenizers import AddedToken, Regex, Tokenizer, decoders, models, normalizers
from tokenizers import pre_tokenizers
from transformers import PreTrainedTokenizerFast

from aios_tpu.engine import config as jc
from aios_tpu.engine import weights as jw
from aios_tpu.engine.engine import TPUEngine
from aios_tpu.engine.tokenizer import HFTokenizer as JaxHFTokenizer
from aios_tpu.runtime import model_manager as jax_mm
from aios_tpu_torch.engine import config as tc
from aios_tpu_torch.engine import model as tm
from aios_tpu_torch.engine import safetensors as tst
from aios_tpu_torch.engine import weights as tw
from aios_tpu_torch.engine.engine import TorchEngine
from aios_tpu_torch.engine.tokenizer import HFTokenizer, _bytes_to_unicode
from aios_tpu_torch.runtime import model_manager as tmm

# The shapes here are tiny: one intra-op thread is faster and leaves the
# cores to the other test workers.
torch.set_num_threads(1)

HF_CONFIGS = {
    "llama": {"model_type": "llama", "vocab_size": 640, "hidden_size": 64,
              "intermediate_size": 96, "num_hidden_layers": 2, "num_attention_heads": 4,
              "num_key_value_heads": 2, "max_position_embeddings": 128,
              "rms_norm_eps": 1e-5, "rope_theta": 10000.0, "tie_word_embeddings": False},
    "mistral": {"model_type": "mistral", "vocab_size": 640, "hidden_size": 64,
                "intermediate_size": 96, "num_hidden_layers": 2, "num_attention_heads": 4,
                "num_key_value_heads": 2, "max_position_embeddings": 128,
                "sliding_window": 8, "rms_norm_eps": 1e-6, "rope_theta": 1e6},
    "qwen3": {"model_type": "qwen3", "vocab_size": 640, "hidden_size": 64,
              "intermediate_size": 96, "num_hidden_layers": 2, "num_attention_heads": 4,
              "num_key_value_heads": 2, "head_dim": 32, "max_position_embeddings": 128,
              "rms_norm_eps": 1e-6, "rope_theta": 1e6, "tie_word_embeddings": True},
    "mixtral": {"model_type": "mixtral", "vocab_size": 640, "hidden_size": 64,
                "intermediate_size": 48, "num_hidden_layers": 2, "num_attention_heads": 4,
                "num_key_value_heads": 2, "max_position_embeddings": 128,
                "num_local_experts": 4, "num_experts_per_tok": 2, "rms_norm_eps": 1e-5,
                "rope_theta": 1e6},
    "qwen3_moe": {"model_type": "qwen3_moe", "vocab_size": 640, "hidden_size": 64,
                  "intermediate_size": 96, "moe_intermediate_size": 32,
                  "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
                  "head_dim": 16, "max_position_embeddings": 128, "num_experts": 4,
                  "num_experts_per_tok": 2, "norm_topk_prob": False,
                  "decoder_sparse_step": 1, "mlp_only_layers": [], "rms_norm_eps": 1e-6,
                  "rope_theta": 1e6,
                  "tie_word_embeddings": False},
}

HF_CLASSES = {"llama": ("LlamaConfig", "LlamaForCausalLM"),
              "mistral": ("MistralConfig", "MistralForCausalLM"),
              "qwen3": ("Qwen3Config", "Qwen3ForCausalLM"),
              "mixtral": ("MixtralConfig", "MixtralForCausalLM"),
              "qwen3_moe": ("Qwen3MoeConfig", "Qwen3MoeForCausalLM")}

QWEN_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
              r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")

TEXTS = ["hello world", " leading space", "  two  spaces   here ", "line\nbreak\n\nagain",
         "tab\there", "日本語のテキスト", "emoji 😀🎉 ok", "<s>special</s> tokens <unk>",
         "Caps And 'quotes' it's", "", " ", "\n", "mixed 123 numbers 4567",
         "<|im_start|>user\nhi<|im_end|>", "a<s>b", "zzz?!.,", "é café naïve"]


def hf_model(kind: str, seed: int = 0):
    """A tiny transformers model of ``kind`` with seeded random weights, its
    norms off 1 so that a swapped norm shows, in eval mode."""
    import transformers

    cfg_cls, model_cls = (getattr(transformers, n) for n in HF_CLASSES[kind])
    torch.manual_seed(seed)
    model = model_cls(cfg_cls(**HF_CONFIGS[kind], attn_implementation="eager")).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                p.uniform_(0.8, 1.2)
    return model


def _merged(rng, base, n, maxlen=6):
    """``base`` symbols and ``n`` merges of two existing tokens into a new one
    (a well-formed ranked merge list)."""
    vocab, seen, merges = list(base), set(base), []
    while len(merges) < n:
        a, b = (vocab[i] for i in rng.integers(0, len(vocab), 2))
        if len(a + b) <= maxlen and a + b not in seen:
            seen.add(a + b)
            vocab.append(a + b)
            merges.append((a, b))
    return vocab, merges


def llama_tokenizer(seed: int = 0, metaspace: bool = False) -> PreTrainedTokenizerFast:
    """A Llama/Mistral-style ``tokenizer.json``: ranked BPE merges, byte
    fallback, ``<unk>`` fused; a ``▁`` Prepend + Replace normalizer (TinyLlama)
    or a Metaspace pre-tokenizer (``prepend_scheme="first"``)."""
    rng = np.random.default_rng(seed)
    specials = ["<unk>", "<s>", "</s>"]
    chars = ["▁"] + list("abcdefghijklmnopqrstuvwxyz.,!?'ABCT\n")
    pieces, merges = _merged(rng, chars, 260)
    vocab = {t: i for i, t in enumerate(specials + [f"<0x{i:02X}>" for i in range(256)]
                                        + pieces)}
    tok = Tokenizer(models.BPE(vocab=vocab, merges=merges, unk_token="<unk>", fuse_unk=True,
                               byte_fallback=True))
    if metaspace:
        tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="first",
                                                     split=False)
        tok.decoder = decoders.Metaspace(replacement="▁", prepend_scheme="first", split=False)
    else:
        tok.normalizer = normalizers.Sequence([normalizers.Prepend("▁"),
                                               normalizers.Replace(" ", "▁")])
        tok.decoder = decoders.Sequence([decoders.Replace("▁", " "), decoders.ByteFallback(),
                                         decoders.Fuse(), decoders.Strip(" ", 1, 0)])
    tok.add_special_tokens([AddedToken(t, special=True, normalized=False) for t in specials])
    return PreTrainedTokenizerFast(tokenizer_object=tok, bos_token="<s>", eos_token="</s>",
                                   unk_token="<unk>")


def qwen_tokenizer(seed: int = 1) -> PreTrainedTokenizerFast:
    """A Qwen-style byte-level BPE: NFC, the Qwen2 regex Split, ByteLevel,
    ChatML specials, no BOS."""
    rng = np.random.default_rng(seed)
    b2u = _bytes_to_unicode()
    base = [b2u[b] for b in range(256)]
    pieces, merges = _merged(rng, [b2u[b] for b in b"etaoinshrdlu \n"], 200)
    vocab = {t: i for i, t in enumerate(base + [t for t in pieces if t not in base])}
    tok = Tokenizer(models.BPE(vocab=vocab, merges=merges))
    tok.normalizer = normalizers.NFC()
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(QWEN_SPLIT), behavior="isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    tok.add_special_tokens([AddedToken(t, special=True, normalized=False)
                            for t in ("<|endoftext|>", "<|im_start|>", "<|im_end|>")])
    return PreTrainedTokenizerFast(tokenizer_object=tok, eos_token="<|im_end|>",
                                   pad_token="<|endoftext|>")


TOKENIZERS = {"llama": llama_tokenizer, "metaspace": lambda: llama_tokenizer(metaspace=True),
              "qwen": qwen_tokenizer}


def hf_dir(path, kind: str = "llama", tokenizer: str = "llama", seed: int = 0,
           shard: str = None):
    """``save_pretrained`` of a tiny model and a tokenizer into ``path``."""
    model = hf_model(kind, seed)
    kw = {"max_shard_size": shard} if shard else {}
    model.save_pretrained(path, safe_serialization=True, **kw)
    TOKENIZERS[tokenizer]().save_pretrained(path)
    return model


def same_config(port, jax_cfg) -> bool:
    """Every field of the port's config equal to the JAX config's (the JAX
    one also holds knobs the port has not ported)."""
    return all(getattr(jax_cfg, k) == v for k, v in port.__dict__.items())


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


# -- config -------------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(HF_CONFIGS))
def test_from_hf_config_equals_jax(kind):
    hf = HF_CONFIGS[kind]
    assert same_config(tc.from_hf_config(hf, name="m"), jc.from_hf_config(hf, name="m"))


# -- safetensors --------------------------------------------------------------------


@pytest.mark.parametrize("shard", [None, "40KB"])
def test_reader_loads_save_pretrained_files(tmp_path, shard):
    """One file, or shards of about 40 kB each: the port's reader gives the
    ``safetensors`` package's tensors bit for bit, the model's state dict
    less the tied head that ``save_pretrained`` drops."""
    model = hf_model("qwen3")
    model.save_pretrained(tmp_path, safe_serialization=True,
                          **({"max_shard_size": shard} if shard else {}))
    files = sorted(tmp_path.glob("*.safetensors"))
    assert (len(files) > 1) == bool(shard)
    got = tst.load_dir(tmp_path)
    want = {}
    for f in files:
        want.update(safetensors.torch.load_file(f))
    assert got.keys() == want.keys() and "lm_head.weight" not in got
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    sd = model.state_dict()
    for k, v in got.items():
        assert torch.equal(v, sd[k]), k


def test_safetensors_package_reads_the_port_writer_bit_for_bit(tmp_path):
    g = torch.Generator().manual_seed(0)
    tensors = {
        "bf16": torch.randn(3, 5, generator=g).bfloat16(),
        "f16": torch.randn(7, generator=g).half(), "f32": torch.randn(2, 3, 4, generator=g),
        "i8": torch.randint(-128, 127, (9,), generator=g, dtype=torch.int8),
        "u8": torch.randint(0, 255, (2, 3), generator=g, dtype=torch.uint8),
        "i32": torch.randint(-99, 99, (4,), generator=g, dtype=torch.int32),
        "i64": torch.arange(5), "scalar": torch.tensor(3.5), "empty": torch.zeros(0, 4),
    }
    path = tmp_path / "x.safetensors"
    n = tst.save_file(tensors, path, metadata={"format": "pt"})
    assert n == path.stat().st_size and (8 + int.from_bytes(path.read_bytes()[:8], "little")) % 8 == 0
    back = safetensors.torch.load_file(path)
    assert back.keys() == tensors.keys()
    for k, v in tensors.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    with safetensors.torch.safe_open(path, "pt") as f:
        assert f.metadata() == {"format": "pt"}
    mine = tst.load_file(path)
    for k, v in tensors.items():
        assert torch.equal(mine[k], v), k


def test_reader_refuses_a_torn_file(tmp_path):
    path = tmp_path / "x.safetensors"
    tst.save_file({"a": torch.ones(64)}, path)
    (tmp_path / "torn.safetensors").write_bytes(path.read_bytes()[:-8])
    with pytest.raises(ValueError, match="data offsets"):
        tst.load_file(tmp_path / "torn.safetensors")


# -- params -------------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(HF_CONFIGS))
def test_params_from_hf_state_dict_equal_jax(kind):
    model = hf_model(kind)
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    if HF_CONFIGS[kind].get("tie_word_embeddings"):
        sd.pop("lm_head.weight", None)
    jcfg = jc.from_hf_config(HF_CONFIGS[kind])
    want = dict(_flat(jax.tree.map(np.asarray, jw.params_from_hf_state_dict(sd, jcfg))))
    got = dict(_flat(tw.params_from_hf_state_dict(sd, tc.from_hf_config(HF_CONFIGS[kind]),
                                                  device="cpu")))
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    # the leaves own their storage: nothing aliases the caller's arrays
    assert not np.shares_memory(got["embed"].numpy(), sd["model.embed_tokens.weight"])


@pytest.mark.parametrize("kind", sorted(HF_CONFIGS))
def test_logits_match_transformers_fp32(kind):
    model = hf_model(kind)
    cfg = tc.from_hf_config(HF_CONFIGS[kind])
    params = tw.params_from_hf_state_dict(model.state_dict(), cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 24)))
    with torch.no_grad():
        want = model(tokens).logits.float()
        got = tm.forward_full(params, cfg, tokens)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=1e-4)


# -- tokenizer ----------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(TOKENIZERS))
def test_tokenizer_ids_and_text_equal_jax(tmp_path, kind):
    """The ids of every text with and without BOS, BOS/EOS and the vocab
    size, and the decode of each encoding and of 200 random id runs (bytes
    that split a character included), equal to the JAX ``HFTokenizer``'s."""
    TOKENIZERS[kind]().save_pretrained(tmp_path)
    want, got = JaxHFTokenizer(str(tmp_path)), HFTokenizer(str(tmp_path))
    assert (got.bos_id, got.eos_id, got.vocab_size) == (want.bos_id, want.eos_id,
                                                        want.vocab_size)
    for text in TEXTS:
        for bos in (True, False):
            assert got.encode(text, bos) == want.encode(text, bos), (text, bos)
        ids = want.encode(text)
        assert got.decode(ids) == want.decode(ids), text
    rng = np.random.default_rng(0)
    for _ in range(200):
        ids = [int(i) for i in rng.integers(0, want.vocab_size, 12)]
        assert got.decode(ids) == want.decode(ids), ids


def test_tokenizer_refuses_what_it_does_not_implement(tmp_path):
    tok = llama_tokenizer()
    tok.backend_tokenizer.pre_tokenizer = pre_tokenizers.Digits(individual_digits=True)
    tok.save_pretrained(tmp_path)
    with pytest.raises(ValueError, match="pre-tokenizer 'Digits'"):
        HFTokenizer(str(tmp_path))


# -- LoadModel ----------------------------------------------------------------------


def jax_load(path, name="m"):
    """The JAX manager's (config, params, tokenizer) of a directory."""
    return jax_mm.ModelManager(num_slots=2)._load_weights(name, str(path), 0)


def assert_loaded_equal(m, jcfg, jparams, jtok, texts=("the cat sat on a mat",)):
    """A served model's config, bf16 leaves and tokenizer ids equal to the
    JAX manager's load, bit for bit."""
    assert same_config(m.config, jcfg)
    want = dict(_flat(jax.tree.map(np.asarray, jparams)))
    got = dict(_flat(m.engine.params))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == torch.bfloat16, k
        np.testing.assert_array_equal(got[k].float().numpy(), v.astype(np.float32), err_msg=k)
    for text in texts:
        assert m.tokenizer.encode(text) == jtok.encode(text)


def greedy_pair(jcfg, jparams, tcfg, tparams, prompts, n=10):
    """Greedy streams of the JAX engine and the port's over the same leaves
    cast to f32 with f32 caches (an f32 near-tie is ~1e-7 of a logit, not
    bf16's 4e-3, so the streams are decided alike)."""
    eng = TPUEngine(jcfg, jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jparams),
                    num_slots=2, max_context=128, cache_dtype=jnp.float32,
                    paged_pool_rows=3 * 128, page_size=128, prefix_cache=False)
    teng = TorchEngine(tcfg, _map(tparams, lambda t: t.float()), num_slots=2, max_context=128,
                       cache_dtype=torch.float32, paged_pool_rows=3 * 128, page_size=128,
                       prefix_cache=False, device="cpu")
    return ([eng.generate(p, max_new_tokens=n, temperature=0.0) for p in prompts],
            [teng.generate(p, max_new_tokens=n, temperature=0.0) for p in prompts])


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


@pytest.mark.parametrize("kind,tokenizer", [("llama", "llama"), ("qwen3", "qwen")])
def test_load_model_of_an_hf_dir_gives_the_jax_streams(tmp_path, kind, tokenizer):
    """``LoadModel`` of the directory against the JAX manager's load of it:
    the same config, bf16 leaves and tokenizer ids bit for bit, and greedy
    streams of the JAX engine and the port's over those leaves equal (in
    f32: the two packages round bf16 sums taken in another order, 1 ulp of
    a logit, so bf16 streams may part at a near-tie)."""
    hf_dir(tmp_path, kind, tokenizer)
    jcfg, jparams, jtok = jax_load(tmp_path)
    manager = tmm.ModelManager(num_slots=2, device="cpu")
    try:
        m = manager.load_model("m", str(tmp_path), context_length=128)
        assert m.state == "ready" and isinstance(m.tokenizer, HFTokenizer)
        assert_loaded_equal(m, jcfg, jparams, jtok)
        prompts = [jtok.encode(t) for t in ("the cat sat on a mat", "hello there, world!")]
        want, got = greedy_pair(jcfg, jparams, m.config, m.engine.params, prompts)
        assert got == want
        assert len(m.batcher.generate(prompts[0], max_tokens=10, temperature=0.0)) == 10
    finally:
        manager.close()


def test_a_tokenizer_wider_than_the_model_is_refused_per_request(tmp_path):
    """A prompt id past the model's vocab (a tokenizer with more ids than
    the model has rows) fails the request on the caller's thread; the
    scheduler keeps serving."""
    manager = tmm.ModelManager(num_slots=2, device="cpu")
    try:
        m = manager.load_model("m", "synthetic://tiny-test", context_length=128)
        with pytest.raises(ValueError, match="outside the model's vocab of 512"):
            m.batcher.generate([1, 600, 2], max_tokens=4, temperature=0.0)
        assert len(m.batcher.generate([1, 2, 3], max_tokens=4, temperature=0.0)) == 4
    finally:
        manager.close()


def test_load_model_of_a_sharded_dir_with_a_tied_head(tmp_path):
    hf_dir(tmp_path, "qwen3", "qwen", shard="40KB")
    manager = tmm.ModelManager(num_slots=2, device="cpu")
    try:
        m = manager.load_model("m", str(tmp_path))
        assert m.config.tie_word_embeddings and "lm_head" not in m.engine.params
        assert json.loads((tmp_path / "config.json").read_text())["tie_word_embeddings"]
        assert len(m.batcher.generate([1, 2, 3], max_tokens=4, temperature=0.0)) == 4
    finally:
        manager.close()
