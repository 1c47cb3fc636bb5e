"""Model configurations for the Llama-family decoder (the dense presets).

A copy of the parts of ``aios_tpu/engine/config.py`` the port serves: the
``ModelConfig`` geometry fields, ``jump_ahead``, ``replicas``,
``draft_model`` and ``prefix_host_bytes``, the dense presets, the tiny test
config and ``from_gguf_metadata``. The other serving knobs that ride on the
JAX package's config (megagraph, compression, MoE) belong to features the
port has not reached yet, so a GGUF file of a mixture-of-experts model is
refused.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    max_context: int = 4096
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    sliding_window: Optional[int] = None
    tie_word_embeddings: bool = False
    qk_norm: bool = False  # Qwen3-style per-head RMSNorm on q/k
    # grammar jump-ahead for constrained decoding (batching.py
    # _jump_tick): chains of grammar-FORCED tokens emit host-side and
    # append their K/V in ONE multi-token dispatch instead of one masked
    # dispatch each. AIOS_TPU_JUMP_AHEAD overrides at load time.
    jump_ahead: bool = True
    # serving replicas per managed model (serving/): N engine+batcher
    # replicas behind one cache-aware router; AIOS_TPU_REPLICAS overrides
    replicas: int = 1
    # draft-model speculation source (AIOS_TPU_DRAFT_MODEL overrides): a
    # preset name or a .gguf path, paired by the model manager
    draft_model: str = ""
    # host-RAM spill tier behind the prefix cache (paged.HostPageStore):
    # evicted prefix pages' K/V is copied to host memory within this byte
    # budget and restored on a later chain hit instead of being prefilled
    # again. 0 = off; AIOS_TPU_PREFIX_HOST_BYTES overrides at load time.
    prefix_host_bytes: int = 0

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def scaled(self, **overrides) -> "ModelConfig":
        return replace(self, **overrides)


TINYLLAMA_1_1B = ModelConfig(
    name="tinyllama-1.1b",
    vocab_size=32000,
    hidden_size=2048,
    intermediate_size=5632,
    num_layers=22,
    num_heads=32,
    num_kv_heads=4,
    head_dim=64,
    max_context=2048,
    rope_theta=10000.0,
)

MISTRAL_7B = ModelConfig(
    name="mistral-7b",
    vocab_size=32000,
    hidden_size=4096,
    intermediate_size=14336,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    max_context=8192,
    rope_theta=10000.0,
    sliding_window=4096,
)

DEEPSEEK_R1_8B = ModelConfig(
    # DeepSeek-R1-Distill-Llama-8B: Llama-3.1-8B geometry
    name="deepseek-r1-8b",
    vocab_size=128256,
    hidden_size=4096,
    intermediate_size=14336,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    max_context=8192,
    rope_theta=500000.0,
)

QWEN3_14B = ModelConfig(
    name="qwen3-14b",
    vocab_size=151936,
    hidden_size=5120,
    intermediate_size=17408,
    num_layers=40,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    max_context=8192,
    rope_theta=1000000.0,
    rms_norm_eps=1e-6,
    qk_norm=True,
)

PRESETS: Dict[str, ModelConfig] = {
    c.name: c for c in (TINYLLAMA_1_1B, MISTRAL_7B, DEEPSEEK_R1_8B, QWEN3_14B)
}

# Tiny variant for tests (same code paths, trivial sizes). vocab 512 covers
# the ByteTokenizer's 258 ids (bos=256, eos=257).
TINY_TEST = ModelConfig(
    name="tiny-test",
    vocab_size=512,
    hidden_size=64,
    intermediate_size=128,
    num_layers=2,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    max_context=128,
)


def from_gguf_metadata(md: Dict[str, Any]) -> ModelConfig:
    """Build a config from GGUF metadata keys (llama/mistral/qwen archs), as
    the JAX package's ``from_gguf_metadata`` does. A mixture-of-experts file
    (``expert_count`` > 0) raises ValueError: the port has no MoE layer yet
    (ROADMAP.md, Queue 1 item 13)."""
    arch = md.get("general.architecture", "llama")

    def key(suffix: str, default=None):
        return md.get(f"{arch}.{suffix}", default)

    num_experts = int(key("expert_count", 0) or 0)
    if num_experts > 0:
        raise ValueError(
            f"{arch} file with expert_count={num_experts}: mixture-of-experts models "
            "are not served by the PyTorch port yet (ROADMAP.md, Queue 1 item 13)")
    heads = int(key("attention.head_count"))
    kv_heads = int(key("attention.head_count_kv", heads))
    hidden = int(key("embedding_length"))
    head_dim = int(key("attention.key_length", hidden // heads))
    vocab = int(md.get("tokenizer.ggml.tokens and vocab", 0)) or len(
        md.get("tokenizer.ggml.tokens", [])
    ) or int(key("vocab_size", 32000))
    return ModelConfig(
        name=md.get("general.name", arch).lower().replace(" ", "-"),
        vocab_size=vocab,
        hidden_size=hidden,
        intermediate_size=int(key("feed_forward_length")),
        num_layers=int(key("block_count")),
        num_heads=heads,
        num_kv_heads=kv_heads,
        head_dim=head_dim,
        max_context=int(key("context_length", 4096)),
        rope_theta=float(key("rope.freq_base", 10000.0)),
        rms_norm_eps=float(key("attention.layer_norm_rms_epsilon", 1e-5)),
        sliding_window=(
            int(key("attention.sliding_window")) if key("attention.sliding_window") else None
        ),
        qk_norm=arch.startswith("qwen3"),
    )
