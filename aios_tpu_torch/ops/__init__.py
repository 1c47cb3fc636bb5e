"""Hand-written CUDA kernels for the decode and prefill path, each beside its
plain PyTorch version.

  * ``quantized_matmul`` — int8-weight x bf16-activation matmul with
    per-output-channel scales; every projection and the lm_head of int8
    serving. ``quantized_matmul_experts`` is the same kernel's
    expert-batched entry: the stacked int8 experts of a mixture-of-experts
    layer, the expert of each row batch read on the device.
  * ``flash_attention`` — blockwise causal GQA attention for prefill.
  * ``paged_decode_attention`` — one query per slot over the paged KV pool;
    ``paged_decode_attention_int8`` the same over an int8 pool + scales.
  * ``int4_matmul`` — group-wise int4-weight x bf16-activation matmul; every
    projection and the lm_head of int4 serving.
  * ``decode_attention`` — one query per slot over the dense slot cache;
    ``decode_attention_int8`` the same over an int8 cache + scales.
  * ``multiquery_decode_attention`` — T queries per slot over the dense slot
    cache, the attention of a speculative verify forward;
    ``multiquery_decode_attention_int8`` the same over an int8 cache; both
    take window+sink compression's sink predicate.
  * ``mega_gate`` — the decode megagraph's gate: whether tick i of a
    dispatch runs, set into the tick's conditional graph node
    (``mega_graph.mega_tick``); the JAX loop's ``cond``, not a Pallas kernel.

There is no gate: each wrapper runs its plain ``*_reference`` twin for CPU
tensors and its kernel for CUDA tensors (or raises). Callers that want the
plain version on the card call it by name. Each wrapper counts its kernel
launches in a ``launches`` attribute. The kernels build from ``csrc/`` at
first use (``build.build_all`` builds them all at once).
"""

from __future__ import annotations

from .build import build_all
from .decode_attention import (
    decode_attention,
    decode_attention_int8,
    decode_attention_int8_reference,
    decode_attention_reference,
)
from .flash_attention import flash_attention, flash_attention_reference
from .mega_graph import mega_gate, mega_gate_reference
from .int4_matmul import (
    dequantize_int4,
    int4_matmul,
    int4_matmul_reference,
    quantize_int4,
)
from .paged_attention import (
    gather_pages,
    paged_decode_attention,
    paged_decode_attention_int8,
    paged_decode_attention_int8_reference,
    paged_decode_attention_reference,
)
from .quantized_matmul import (
    dequantize,
    quantize_int8,
    quantized_matmul,
    quantized_matmul_experts,
    quantized_matmul_experts_reference,
    quantized_matmul_reference,
)
from .verify_attention import (
    multiquery_decode_attention,
    multiquery_decode_attention_int8,
    multiquery_decode_attention_int8_reference,
    multiquery_decode_attention_reference,
)

KERNELS = (quantized_matmul, flash_attention, paged_decode_attention,
           paged_decode_attention_int8, int4_matmul, multiquery_decode_attention,
           multiquery_decode_attention_int8, decode_attention, decode_attention_int8,
           quantized_matmul_experts, mega_gate)

__all__ = [
    "KERNELS",
    "build_all",
    "decode_attention",
    "decode_attention_int8",
    "decode_attention_int8_reference",
    "decode_attention_reference",
    "dequantize",
    "dequantize_int4",
    "flash_attention",
    "flash_attention_reference",
    "gather_pages",
    "int4_matmul",
    "int4_matmul_reference",
    "mega_gate",
    "mega_gate_reference",
    "multiquery_decode_attention",
    "multiquery_decode_attention_int8",
    "multiquery_decode_attention_int8_reference",
    "multiquery_decode_attention_reference",
    "paged_decode_attention",
    "paged_decode_attention_int8",
    "paged_decode_attention_int8_reference",
    "paged_decode_attention_reference",
    "quantize_int4",
    "quantize_int8",
    "quantized_matmul",
    "quantized_matmul_experts",
    "quantized_matmul_experts_reference",
    "quantized_matmul_reference",
]
