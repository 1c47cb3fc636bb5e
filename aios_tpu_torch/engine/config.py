"""Model configurations for the Llama-family decoder, dense and
mixture-of-experts.

A copy of the parts of ``aios_tpu/engine/config.py`` the port serves: the
``ModelConfig`` geometry fields with the mixture-of-experts ones
(``num_experts``, ``num_experts_per_tok``, ``moe_intermediate_size``,
``norm_topk_prob``), the serving knobs (``jump_ahead``, ``replicas``,
``draft_model``, ``prefix_host_bytes``, the decode loop's
``decode_pipeline``, ``unified_step`` and ``mega_ticks``, and window+sink
compression's ``kv_compress_after``, ``kv_sink_pages`` and
``kv_window_pages``), the presets (the dense tiers, Qwen3-30B-A3B and
Mixtral-8x7B), the tiny test configs, ``from_gguf_metadata`` and
``from_hf_config``. The sequence-sharded prefill's floor waits for the
multi-card port.
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
    # Mixture-of-experts (0 experts = dense FFN). The router picks
    # num_experts_per_tok experts per token; their gate weights are softmax
    # probabilities renormalized over the selected set when norm_topk_prob.
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_intermediate_size: Optional[int] = None
    norm_topk_prob: bool = True
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
    # pipelined decode loop (batching.py): decode dispatch N+1 is issued
    # before dispatch N's tokens are emitted, so the host's emit and retire
    # overlap the card's work. AIOS_TPU_DECODE_PIPELINE overrides.
    decode_pipeline: bool = False
    # unified decode step: one graph serves every decode chunk size (the
    # port's single-tick graph already does; the knob keeps the JAX
    # stack's contract). AIOS_TPU_UNIFIED_STEP overrides.
    unified_step: bool = False
    # multi-tick decode megagraph (engine.py mega_step): up to this many
    # decode ticks a dispatch in one CUDA graph, sampling, stop, budget
    # and context-cap checks on the device, and an early exit when no slot
    # needs another tick. 0 = off. AIOS_TPU_MEGA_TICKS overrides.
    mega_ticks: int = 0
    # window+sink KV compression: past this many rows a slot's pages are
    # pruned to kv_sink_pages leading pages plus a kv_window_pages trailing
    # window, the middle returns to the pool and every attention masks it.
    # 0 = off (exact attention). Paged, unreplicated pools of models
    # without a sliding window only. AIOS_TPU_KV_COMPRESS_AFTER overrides.
    kv_compress_after: int = 0
    # leading pages kept under compression (the attention sinks; >= 1);
    # AIOS_TPU_KV_SINK_PAGES overrides
    kv_sink_pages: int = 1
    # trailing window pages kept under compression (>= 1);
    # AIOS_TPU_KV_WINDOW_PAGES overrides
    kv_window_pages: int = 8

    @property
    def moe(self) -> bool:
        return self.num_experts > 0

    @property
    def expert_dim(self) -> int:
        return self.moe_intermediate_size or self.intermediate_size

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def scaled(self, **overrides) -> "ModelConfig":
        return replace(self, **overrides)

    def num_params(self) -> int:
        """Approximate parameter count (embeddings + blocks + head)."""
        e = self.vocab_size * self.hidden_size
        attn = self.hidden_size * self.q_dim * 2 + self.hidden_size * self.kv_dim * 2
        if self.moe:
            mlp = self.hidden_size * self.num_experts + (
                self.num_experts * 3 * self.hidden_size * self.expert_dim)
        else:
            mlp = 3 * self.hidden_size * self.intermediate_size
        norms = 2 * self.hidden_size
        head = 0 if self.tie_word_embeddings else e
        return e + self.num_layers * (attn + mlp + norms) + self.hidden_size + head

    def active_params(self) -> int:
        """Params touched per token (MoE: only the routed experts' FFNs), the
        number that sets decode FLOPs; ``num_params`` sets the footprint."""
        if not self.moe:
            return self.num_params()
        e = self.vocab_size * self.hidden_size
        attn = self.hidden_size * self.q_dim * 2 + self.hidden_size * self.kv_dim * 2
        mlp = self.hidden_size * self.num_experts + (
            self.num_experts_per_tok * 3 * self.hidden_size * self.expert_dim)
        head = 0 if self.tie_word_embeddings else e
        return e + self.num_layers * (attn + mlp) + head


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

QWEN3_30B_A3B = ModelConfig(
    # the mixture-of-experts tier: 30B parameters on the card, about 3B
    # active per token
    name="qwen3-30b-a3b",
    vocab_size=151936,
    hidden_size=2048,
    intermediate_size=6144,
    num_layers=48,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    max_context=32768,
    rope_theta=1000000.0,
    rms_norm_eps=1e-6,
    qk_norm=True,
    num_experts=128,
    num_experts_per_tok=8,
    moe_intermediate_size=768,
)

MIXTRAL_8X7B = ModelConfig(
    name="mixtral-8x7b",
    vocab_size=32000,
    hidden_size=4096,
    intermediate_size=14336,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    max_context=32768,
    rope_theta=1000000.0,
    num_experts=8,
    num_experts_per_tok=2,
)

PRESETS: Dict[str, ModelConfig] = {
    c.name: c for c in (TINYLLAMA_1_1B, MISTRAL_7B, DEEPSEEK_R1_8B, QWEN3_14B,
                        QWEN3_30B_A3B, MIXTRAL_8X7B)
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

TINY_MOE = ModelConfig(
    name="tiny-moe",
    vocab_size=512,
    hidden_size=64,
    intermediate_size=128,
    num_layers=2,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    max_context=128,
    num_experts=4,
    num_experts_per_tok=2,
    moe_intermediate_size=32,
)


def from_gguf_metadata(md: Dict[str, Any]) -> ModelConfig:
    """Build a config from GGUF metadata keys (llama/mistral/qwen archs, and
    their mixture-of-experts variants through ``expert_count``,
    ``expert_used_count``, ``expert_feed_forward_length`` and
    ``expert_weights_norm``), as the JAX package's ``from_gguf_metadata``
    does."""
    arch = md.get("general.architecture", "llama")

    def key(suffix: str, default=None):
        return md.get(f"{arch}.{suffix}", default)

    heads = int(key("attention.head_count"))
    kv_heads = int(key("attention.head_count_kv", heads))
    hidden = int(key("embedding_length"))
    head_dim = int(key("attention.key_length", hidden // heads))
    vocab = int(md.get("tokenizer.ggml.tokens and vocab", 0)) or len(
        md.get("tokenizer.ggml.tokens", [])
    ) or int(key("vocab_size", 32000))
    num_experts = int(key("expert_count", 0) or 0)
    return ModelConfig(
        num_experts=num_experts,
        num_experts_per_tok=int(key("expert_used_count", 2) or 2),
        moe_intermediate_size=(
            int(key("expert_feed_forward_length"))
            if key("expert_feed_forward_length")
            else None
        ),
        norm_topk_prob=bool(key("expert_weights_norm", True)),
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


def from_hf_config(hf: Dict[str, Any], name: str = "hf-model") -> ModelConfig:
    """Build a config from a HuggingFace ``config.json`` dict
    (Llama/Mistral/Qwen3/Mixtral/Qwen3-MoE), field for field as the JAX
    package's ``from_hf_config``."""
    heads = hf["num_attention_heads"]
    # num_local_experts (mixtral) / num_experts (qwen3_moe)
    num_experts = hf.get("num_local_experts") or hf.get("num_experts") or 0
    return ModelConfig(
        name=name,
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=heads,
        num_kv_heads=hf.get("num_key_value_heads", heads),
        head_dim=hf.get("head_dim") or hf["hidden_size"] // heads,
        max_context=hf.get("max_position_embeddings", 4096),
        rope_theta=hf.get("rope_theta", 10000.0),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
        sliding_window=hf.get("sliding_window"),
        tie_word_embeddings=hf.get("tie_word_embeddings", False),
        qk_norm=hf.get("model_type", "") in ("qwen3", "qwen3_moe"),
        num_experts=num_experts,
        num_experts_per_tok=hf.get("num_experts_per_tok", 2),
        moe_intermediate_size=hf.get("moe_intermediate_size"),
        # mixtral always renormalizes the top-k weights; qwen3_moe gates it
        norm_topk_prob=hf.get("norm_topk_prob", True),
    )
