"""The Llama-family decoder in PyTorch: the port of ``aios_tpu/engine/model.py``
for the paged and the dense-cache serving paths.

Params are a plain dict of tensors in the JAX package's layout (E=hidden,
Q=heads*head_dim, K=kv_heads*head_dim, F=intermediate, L=layers, V=vocab,
D=head_dim), layer leaves stacked on a leading [L] axis:

  embed      [V, E]
  layers/attn_norm [L, E]   layers/ffn_norm [L, E]
  layers/wq  [L, E, Q]      layers/wk [L, E, K]   layers/wv [L, E, K]
  layers/wo  [L, Q, E]
  layers/w_gate [L, E, F]   layers/w_up [L, E, F] layers/w_down [L, F, E]
  layers/q_norm [L, D]      layers/k_norm [L, D]      (only if cfg.qk_norm)

or, for a mixture-of-experts config (X experts of width F = expert_dim), in
place of the three FFN leaves:

  layers/w_router [L, E, X]
  layers/we_gate [L, X, E, F]  layers/we_up [L, X, E, F]  layers/we_down [L, X, F, E]

  final_norm [E]
  lm_head    [E, V]                                   (absent if tied)

On CUDA ``quantize_params`` pads the serving lm_head's columns with zeros to
a multiple of ``HEAD_PAD`` (the matmul kernels' N % 16), so a vocab such as
32002 is served; the logits are cut back to [..., :V].

``quantize_params`` turns the matmul weights into int8 serving leaves
{"q": int8, "s": f32}, or group-wise int4 leaves {"q4": packed uint8, "s4":
f32}, with fused ``w_qkv`` and ``w_gateup`` (MoE: ``we_gateup``; the expert
stacks stay int8 in int4 mode and the router stays dense). The KV cache is
a paged pool [L, N, P, KH, D] or a dense slot cache [L, S, C, KH, D], bf16 (or f32 in
tests), or int8 with per-(row, kv head) f32 scales beside it
(``cache_scales``). ``prefill_chunk`` and ``prefill_chunk_paged`` admit a
long prompt a chunk at a time into either cache; ``verify_step`` and
``verify_step_paged`` score T tokens of every slot in one forward. Every entry
point takes ``kernels``: True runs the ops wrappers (the CUDA kernels on
CUDA tensors, their plain twins on CPU tensors), False calls the plain
``*_reference`` functions by name — how a caller holds the kernel path
against the plain path on the card. The forwards also take ``moe_impl``, the
path of an MoE sublayer (``moe.resolve_impl``: ``AIOS_TPU_MOE_IMPL`` first,
then this static choice, then dense).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import ops
from ..ops.decode_attention import HEAD_DIMS as DENSE_HEAD_DIMS
from ..ops.decode_attention import MAX_GROUP as DENSE_MAX_GROUP
from ..ops.flash_attention import HEAD_DIMS as FLASH_HEAD_DIMS
from ..ops.flash_attention import MAX_GROUP as FLASH_MAX_GROUP
from ..ops.paged_attention import HEAD_DIMS as PAGED_HEAD_DIMS
from ..ops.paged_attention import MAX_GROUP as PAGED_MAX_GROUP
from ..ops.paged_attention import MAX_STAGED_PAGES
from ..ops.int4_matmul import kernel_supported, pick_group, supports_int4
from ..ops.quantized_matmul import kernel_supported as int8_kernel_supported
from . import moe
from .config import ModelConfig

Params = Dict[str, object]

QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "we_gate", "we_up",
              "we_down")
# serving leaf -> the dense leaves it concatenates; a tree has the FFN leaves
# of one kind, dense (w_*) or experts (we_*)
FUSED = {"w_qkv": ("wq", "wk", "wv"), "wo": ("wo",), "w_gateup": ("w_gate", "w_up"),
         "w_down": ("w_down",), "we_gateup": ("we_gate", "we_up"), "we_down": ("we_down",)}
EXPERT_LEAVES = ("we_gateup", "we_down")  # int8 in every mode: the expert entry takes them
_RECIP_127 = float(torch.tensor(1 / 127, dtype=torch.float32))  # f32(1/127)
HEAD_PAD = 16  # the serving lm_head's columns, padded on CUDA (K1/K5: N % 16 == 0)


def matmul(x: torch.Tensor, w, kernels: bool = True) -> torch.Tensor:
    """x @ w for a dense weight, an int8 leaf {"q", "s"} or an int4 leaf
    {"q4", "s4"}."""
    if isinstance(w, dict):
        if "q4" in w:
            fn = ops.int4_matmul if kernels else ops.int4_matmul_reference
            return fn(x.contiguous(), w["q4"], w["s4"])
        fn = ops.quantized_matmul if kernels else ops.quantized_matmul_reference
        return fn(x.contiguous(), w["q"], w["s"])
    return x @ w


def _leaf_format(K: int, N: int, mode: str, cpu: bool) -> Tuple[str, Optional[str]]:
    """How a [K, N] serving leaf is stored, and why no kernel would serve it
    (None when one does). An int4 leaf needs a storage layout for its
    [K, N] and, off the CPU, one the kernel serves (128-row groups);
    anything else falls back to int8, as in the JAX package. On the CPU
    every leaf takes the plain path, so storage eligibility is enough (keeps
    tiny test geometries on int4). Off the CPU an int8 leaf must suit the
    int8 kernel (K % 8 == 0, N % 16 == 0)."""
    if mode == "int4":
        group = pick_group(K)
        if supports_int4(K, N, group) and (cpu or kernel_supported(K, N, group)):
            return "int4", None
    if cpu or int8_kernel_supported(K, N):
        return "int8", None
    return "int8", (f"[K={K}, N={N}]: the int8 matmul kernel needs "
                    f"K % 8 == 0 and N % 16 == 0")


def _quant_leaf(w: torch.Tensor, mode: str, name: str) -> Dict[str, torch.Tensor]:
    """One serving leaf, stored as ``_leaf_format`` says (an expert stack
    int8 in every mode, as the JAX package forces it); a leaf no kernel
    would serve raises, naming ``name``."""
    K, N = w.shape[-2], w.shape[-1]
    if name in EXPERT_LEAVES:
        mode = "int8"
    fmt, fault = _leaf_format(K, N, mode, w.device.type == "cpu")
    if fault:
        raise ValueError(f"{name} {fault}")
    if fmt == "int4":
        p, s = ops.quantize_int4(w, pick_group(K))
        return {"q4": p, "s4": s}
    q, s = ops.quantize_int8(w, axis=-2)
    return {"q": q, "s": s}


def serving_leaf_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, int]]:
    """[K, N] of each leaf ``quantize_params`` makes for ``cfg`` on CUDA: the
    concatenations of FUSED (for an MoE config each expert's [K, N] of
    ``we_gateup`` and ``we_down``) and the lm_head, [E, V] padded to
    HEAD_PAD."""
    E, F = cfg.hidden_size, cfg.intermediate_size
    Fm = cfg.expert_dim
    dense = {"wq": (E, cfg.q_dim), "wk": (E, cfg.kv_dim), "wv": (E, cfg.kv_dim),
             "wo": (cfg.q_dim, E), "w_gate": (E, F), "w_up": (E, F), "w_down": (F, E),
             "we_gate": (E, Fm), "we_up": (E, Fm), "we_down": (Fm, E)}
    ffn = ("we_gateup", "we_down") if cfg.moe else ("w_gateup", "w_down")
    shapes = {key: (dense[parts[0]][0], sum(dense[k][1] for k in parts))
              for key, parts in FUSED.items() if key in ("w_qkv", "wo") + ffn}
    shapes["lm_head"] = (E, -(-cfg.vocab_size // HEAD_PAD) * HEAD_PAD)
    return shapes


def kernel_contract_faults(cfg: ModelConfig, *, paged: bool, quant_cache: bool,
                           quantize: Optional[str], pages_per_slot: int = 0) -> List[str]:
    """Every way ``cfg`` breaks the contract of a CUDA kernel on the path it
    would be served on: K2 for prefill; K3 (bf16 pool) or K4 (int8 pool)
    for a paged decode, over at most ``pages_per_slot`` pages a slot, and
    K6 or K7 for its chunked admission and its jump-ahead dispatches
    (``verify_step_paged``), or K6-K9 for the dense cache; and
    with ``quantize`` ("int8" or "int4")
    K1/K5 for each serving leaf, as ``_quant_leaf`` would store it (K1's
    expert entry for an MoE config's expert stacks). The
    limits are the ones the wrappers check. Empty when every kernel takes
    it; the plain paths on the CPU serve any geometry."""
    D, H, KH = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    faults = []

    def attention(kernel: str, head_dims, max_group: int) -> None:
        if D not in head_dims:
            faults.append(f"{kernel}: head_dim {D} not in {head_dims}")
        if H % KH or H // KH > max_group:
            faults.append(f"{kernel}: H/KH = {H}/{KH}, needs H % KH == 0 and "
                          f"H/KH <= {max_group}")

    attention("flash_attention (K2)", FLASH_HEAD_DIMS, FLASH_MAX_GROUP)
    if paged:
        attention("paged_decode_attention_int8 (K4)" if quant_cache
                  else "paged_decode_attention (K3)",
                  PAGED_HEAD_DIMS, PAGED_MAX_GROUP)
        if pages_per_slot > MAX_STAGED_PAGES:
            faults.append(f"paged decode attention: {pages_per_slot} pages per slot, at "
                          f"most {MAX_STAGED_PAGES}")
        # chunked admission attends a chunk over the slot's gathered pages,
        # a jump every slot's forced run over its own
        attention("multiquery_decode_attention_int8 (K7), chunked admission and jump"
                  if quant_cache else
                  "multiquery_decode_attention (K6), chunked admission and jump",
                  DENSE_HEAD_DIMS, DENSE_MAX_GROUP)
    else:
        attention("decode_attention and multiquery_decode_attention (K6-K9)",
                  DENSE_HEAD_DIMS, DENSE_MAX_GROUP)
    if quantize:
        for name, (K, N) in serving_leaf_shapes(cfg).items():
            expert = name in EXPERT_LEAVES
            fault = _leaf_format(K, N, "int8" if expert else quantize, cpu=False)[1]
            if fault:
                kernel = ("quantized_matmul_experts (K1's expert entry)" if expert
                          else "quantized_matmul (K1)")
                faults.append(f"{kernel}: {name} {fault}")
    return faults


def quantize_params(params: Params, include_head: bool = True,
                    mode: str = "int8", pad_head: Optional[bool] = None) -> Params:
    """Serving leaves, the JAX package's ``quantize_params`` with fusion:
    wq|wk|wv concatenate into one [E, Q+2K] ``w_qkv`` and w_gate|w_up into
    one [E, 2F] ``w_gateup`` (4 weight matmuls per layer instead of 7; an
    MoE tree's we_gate|we_up into [X, E, 2F] ``we_gateup`` beside
    ``we_down``, int8 in either mode, its router left as it is), and
    a tied lm_head becomes its own quantized [E, V] matrix. ``mode`` is
    "int8" (per-column int8) or "int4" (group-wise int4, int8 for a leaf
    that cannot take it). Same bytes and scales as the JAX function for the
    same input. ``pad_head`` (None: on CUDA only) appends zero columns to the
    head up to a multiple of HEAD_PAD; its real columns quantize as before,
    each column on its own."""
    if mode not in ("int8", "int4"):
        raise ValueError(f"unknown weight quantization mode {mode!r}")
    out = dict(params)
    src = params["layers"]
    layers = {k: v for k, v in src.items() if k not in QUANT_KEYS}
    # one fused matrix at a time, so only one concatenated copy exists
    for key, parts in FUSED.items():
        if parts[0] not in src:  # the other kind of FFN
            continue
        w = torch.cat([src[k] for k in parts], dim=-1) if len(parts) > 1 else src[key]
        layers[key] = _quant_leaf(w, mode, key)
    out["layers"] = layers
    if include_head:
        head = params.get("lm_head")
        if head is None:
            head = params["embed"].T
        if pad_head is None:
            pad_head = head.device.type == "cuda"
        if pad_head and head.shape[-1] % HEAD_PAD:
            head = F.pad(head, (0, -head.shape[-1] % HEAD_PAD))
        out["lm_head"] = _quant_leaf(head, mode, "lm_head")
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def serving_weight_bytes(params: Params, picks: Optional[int] = None) -> int:
    """Bytes of weight data a decode step streams (every layer leaf and the
    lm_head, scales included; the embedding gather reads one row): the JAX
    package's ``serving_weight_bytes``, which is also the footprint, since
    the dense MoE path streams every expert. ``picks`` counts the expert
    stacks as the gather path streams them instead: ``picks`` expert blocks
    a layer (N*k, duplicates streamed again)."""
    layers = params["layers"]
    total = sum(t.numel() * t.element_size()
                for t in (*_leaves(layers), *_leaves(params.get("lm_head", {}))))
    if picks is not None:
        for key in EXPERT_LEAVES + ("we_gate", "we_up"):
            for t in _leaves(layers.get(key, {})):
                X = t.shape[1]  # [L, X, ...]
                total -= t.numel() * t.element_size() * (X - picks) // X
    return total


def is_quantized(params: Params) -> bool:
    """Whether the layers hold serving leaves (int8 {"q", "s"} or int4
    {"q4", "s4"})."""
    return any(isinstance(v, dict) and ("q" in v or "q4" in v)
               for v in params["layers"].values())


def quantized_mode(params: Params) -> Optional[str]:
    """"int4" when any layer leaf is int4, "int8" when they are int8, None
    for dense layers."""
    if not is_quantized(params):
        return None
    return "int4" if any(isinstance(v, dict) and "q4" in v
                         for v in params["layers"].values()) else "int8"


def layer_params(params: Params) -> List[Dict[str, object]]:
    """Per-layer views of the stacked [L, ...] leaves (no copies)."""
    L = params["layers"]["attn_norm"].shape[0]
    return [
        {
            k: ({kk: vv[i] for kk, vv in v.items()} if isinstance(v, dict) else v[i])
            for k, v in params["layers"].items()
        }
        for i in range(L)
    ]


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with fp32 accumulation, output in x.dtype."""
    xf = x.to(torch.float32)
    scale = torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * weight


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin for the given absolute positions, shaped positions.shape +
    (head_dim,), in the half-rotation (HF transformers) convention."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    inv_freq = 1.0 / (theta ** exponent)
    angles = positions.to(torch.float32)[..., None] * inv_freq
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate q or k. x: [B, T, H, D]; cos/sin: [B, T, D]."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    return (x.to(torch.float32) * cos + rotated.to(torch.float32) * sin).to(x.dtype)


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Masked grouped-query attention with an fp32 softmax, the plain path
    of the dense-cache steps. q [B, T, H, D], k/v [B, S, KH, D], mask bool
    [B, T, S] -> [B, T, H, D]."""
    B, T, H, D = q.shape
    KH = k.shape[2]
    qg = q.reshape(B, T, KH, H // KH, D)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k).to(torch.float32)
    scores = scores / math.sqrt(D)
    scores = torch.where(mask[:, None, None, :, :], scores,
                         torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v)
    return out.reshape(B, T, H, D)


# ---------------------------------------------------------------------------
# One transformer block
# ---------------------------------------------------------------------------


def _project_qkv(x, lp, cfg: ModelConfig, cos, sin, kernels: bool = True):
    B, T, _ = x.shape
    h = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
    if "w_qkv" in lp:  # fused serving layout (quantize_params)
        Q, KV = cfg.q_dim, cfg.kv_dim
        qkv = matmul(h, lp["w_qkv"], kernels)
        q, k, v = qkv[..., :Q], qkv[..., Q:Q + KV], qkv[..., Q + KV:]
    else:
        q = matmul(h, lp["wq"], kernels)
        k = matmul(h, lp["wk"], kernels)
        v = matmul(h, lp["wv"], kernels)
    q = q.reshape(B, T, cfg.num_heads, cfg.head_dim)
    k = k.reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, T, cfg.num_kv_heads, cfg.head_dim).contiguous()
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"], cfg.rms_norm_eps)
        k = rms_norm(k, lp["k_norm"], cfg.rms_norm_eps)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _mlp(x, lp, cfg: ModelConfig, kernels: bool = True, moe_impl: Optional[str] = None):
    """The FFN sublayer: dense SwiGLU, or for a layer with a router the
    mixture-of-experts FFN on the path ``moe.resolve_impl(moe_impl)``
    names."""
    h = rms_norm(x, lp["ffn_norm"], cfg.rms_norm_eps)
    if "w_router" in lp:
        return moe.moe_ffn(h, lp, cfg, kernels, moe_impl)
    if "w_gateup" in lp:  # fused serving layout (quantize_params)
        F_ = cfg.intermediate_size
        gu = matmul(h, lp["w_gateup"], kernels)
        gate_pre, up = gu[..., :F_], gu[..., F_:]
    else:
        gate_pre = matmul(h, lp["w_gate"], kernels)
        up = matmul(h, lp["w_up"], kernels)
    gate = F.silu(gate_pre.to(torch.float32)).to(h.dtype)
    return matmul(gate * up, lp["w_down"], kernels)


def apply_block(x, lp, cfg: ModelConfig, cos, sin, attention, kernels: bool = True,
                moe_impl: Optional[str] = None):
    """One transformer block on [B, T, E]; returns (x', (k, v)).
    ``attention(q, k, v)`` maps [B, T, H, D] queries to [B, T, H, D]."""
    B, T = x.shape[0], x.shape[1]
    q, k, v = _project_qkv(x, lp, cfg, cos, sin, kernels)
    attn = attention(q, k, v)
    x = x + matmul(attn.reshape(B, T, -1), lp["wo"], kernels)
    x = x + _mlp(x, lp, cfg, kernels, moe_impl)
    return x, (k, v)


def _final_logits(x, params: Params, cfg: ModelConfig, kernels: bool = True):
    """Final RMSNorm + (possibly tied, possibly int8, possibly padded)
    lm_head; fp32 logits [..., V]."""
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    return matmul(x, head, kernels)[..., :cfg.vocab_size].to(torch.float32)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _forward_with_kv(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                     kernels: bool = True, moe_impl: Optional[str] = None):
    B, T = tokens.shape
    x = params["embed"][tokens]
    positions = torch.arange(T, device=tokens.device).expand(B, T)
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    attn_fn = ops.flash_attention if kernels else ops.flash_attention_reference

    def attention(q, k, v):
        return attn_fn(q, k, v, causal=True, window=cfg.sliding_window)

    ks, vs = [], []
    for lp in layer_params(params):
        x, (k, v) = apply_block(x, lp, cfg, cos, sin, attention, kernels, moe_impl)
        ks.append(k)
        vs.append(v)
    return _final_logits(x, params, cfg, kernels), torch.stack(ks), torch.stack(vs)


def forward_full(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 kernels: bool = True, moe_impl: Optional[str] = None) -> torch.Tensor:
    """Full-sequence causal forward; logits [B, T, V] in fp32."""
    return _forward_with_kv(params, cfg, tokens, kernels, moe_impl)[0]


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            kernels: bool = True, moe_impl: Optional[str] = None):
    """Causal forward returning (logits [B,T,V], k [L,B,T,KH,D], v [...]);
    the engine scatters the K/V rows into the page pool."""
    return _forward_with_kv(params, cfg, tokens, kernels, moe_impl)


def decode_step_paged(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B] — one new token per slot
    lengths: torch.Tensor,  # [B] int32 — logical rows already in each slot
    k_pool: torch.Tensor,  # [L, N, P, KH, D] — shared page pool
    v_pool: torch.Tensor,
    tables: torch.Tensor,  # [B, MB] int32 — logical block -> physical page
    active: torch.Tensor = None,  # [B] bool
    kernels: bool = True,
    cache_scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    moe_impl: Optional[str] = None,
    win_starts: Optional[torch.Tensor] = None,  # [B] int32 live-window start
    sink_rows: int = 0,  # sink rows (window+sink KV compression)
) -> torch.Tensor:
    """One batched decode step over the paged cache; returns logits [B, V]
    in fp32.

    Unlike the JAX function, which returns updated pools, this writes each
    slot's new K/V row INTO ``k_pool``/``v_pool`` in place: row
    ``lengths[b]`` goes to page ``tables[b, lengths[b] // P]`` at offset
    ``lengths[b] % P``. Inactive slots write the sacrificial page 0 (offset
    P-1) and attend zero rows. The caller must have backed row
    ``lengths[b]`` of every active slot (PageAllocator.ensure).

    ``cache_scales`` — (k_scales, v_scales) [L, N, P, KH] f32 — marks an
    int8 pool: rows quantize on write (values and scales in place) and
    attention streams the int8 pages with the scales folded into both
    products (``paged_decode_attention_int8``).

    ``win_starts`` and ``sink_rows`` (window+sink KV compression, the JAX
    function's operands) mask each active slot's pruned middle: slot b
    attends only rows < sink_rows or >= win_starts[b] (K3's and K4's sink
    predicate); its pruned blocks map the sacrificial page. An inactive
    slot's start is taken as 0."""
    B = tokens.shape[0]
    P = k_pool.shape[2]
    if active is None:
        active = torch.ones(B, dtype=torch.bool, device=tokens.device)
    zero = torch.zeros_like(lengths)
    sink = {}
    if win_starts is not None:
        sink = dict(win_starts=torch.where(active, win_starts, zero), sink=sink_rows)
    read_lengths = torch.where(active, lengths, zero)
    blk = (read_lengths // P).long()
    pages = torch.where(active, tables.gather(1, blk[:, None])[:, 0], zero).long()
    offs = torch.where(active, read_lengths % P, torch.full_like(lengths, P - 1)).long()

    x = params["embed"][tokens][:, None, :]  # [B, 1, E]
    cos, sin = rope_tables(lengths[:, None], cfg.head_dim, cfg.rope_theta)
    if cache_scales is not None:
        attn_fn = (ops.paged_decode_attention_int8 if kernels
                   else ops.paged_decode_attention_int8_reference)
    else:
        attn_fn = (ops.paged_decode_attention if kernels
                   else ops.paged_decode_attention_reference)
    for i, lp in enumerate(layer_params(params)):
        q, k_new, v_new = _project_qkv(x, lp, cfg, cos, sin, kernels)
        k_l, v_l = k_pool[i], v_pool[i]
        if cache_scales is not None:
            k_s, v_s = cache_scales[0][i], cache_scales[1][i]
            scatter_quant(k_l, k_s, pages, offs, k_new[:, 0])
            scatter_quant(v_l, v_s, pages, offs, v_new[:, 0])
            pools = (k_l, v_l, k_s, v_s)
        else:
            k_l[pages, offs] = k_new[:, 0].to(k_l.dtype)
            v_l[pages, offs] = v_new[:, 0].to(v_l.dtype)
            pools = (k_l, v_l)
        attn = attn_fn(q[:, 0].contiguous(), *pools, tables, read_lengths,
                       window=cfg.sliding_window, **sink)
        x = x + matmul(attn.reshape(B, 1, -1), lp["wo"], kernels)
        x = x + _mlp(x, lp, cfg, kernels, moe_impl)
    return _final_logits(x[:, 0], params, cfg, kernels)


def verify_step_paged(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, T] — [last_token, T-1 drafted or forced tokens]
    lengths: torch.Tensor,  # [B] int32 — logical rows already in each slot
    k_pool: torch.Tensor,  # [L, N, P, KH, D] — shared page pool
    v_pool: torch.Tensor,
    tables: torch.Tensor,  # [B, MB] int32 — logical block -> physical page
    active: torch.Tensor = None,  # [B] bool
    kernels: bool = True,
    cache_scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    moe_impl: Optional[str] = None,
    win_starts: Optional[torch.Tensor] = None,  # [B] int32 live-window start
    sink_rows: int = 0,  # sink rows (window+sink KV compression)
) -> torch.Tensor:
    """``verify_step`` over the PAGED pool; returns logits [B, T, V] in
    fp32.

    Unlike the JAX function, which returns updated pools, this writes the T
    rows ``lengths[b] .. lengths[b]+T-1`` of every slot IN PLACE through its
    page table (rows past the slot's C = MB*P clamp to C-1); an inactive
    slot writes all T to the sacrificial page 0, row P-1. An int8 pool
    (``cache_scales``, [L, N, P, KH] f32) quantizes them on write
    (``scatter_quant``). Then each slot's logical view [B, C, KH, D] (int8:
    and its [B, C, KH] scales) is gathered through ``tables``, as the JAX
    function gathers it, and query t of slot b attends over the columns
    ``<= lengths[b] + t`` inside the sliding window (an inactive slot over
    column 0 only): ``multiquery_decode_attention`` (K6) or its int8 twin
    (K7) with B slots, lengths ``where(active, lengths, 0)`` and strides
    ``active``; without ``kernels`` their ``*_reference``. The caller must
    have BACKED rows ``lengths[b] .. lengths[b]+T-1`` of every active slot.
    Rows clamped at the cache end collide, as in ``verify_step``: callers
    must not consume the tokens of a saturated slot. ``win_starts`` and
    ``sink_rows`` mask each active slot's pruned middle, as in
    ``decode_step_paged``, through K6's and K7's sink predicate (the verify
    rows themselves land past the live window's start)."""
    B, T = tokens.shape
    MB = tables.shape[1]
    P, KH, D = k_pool.shape[2], k_pool.shape[3], k_pool.shape[4]
    C = MB * P
    dev = tokens.device
    if active is None:
        active = torch.ones(B, dtype=torch.bool, device=dev)
    positions = lengths[:, None] + torch.arange(T, device=dev, dtype=lengths.dtype)[None, :]
    rows = positions.clamp(max=C - 1).long()
    pages = torch.where(active[:, None], tables.long().gather(1, rows // P),
                        torch.zeros_like(rows))
    offs = torch.where(active[:, None], rows % P, torch.full_like(rows, P - 1))
    read_base = torch.where(active, lengths, torch.zeros_like(lengths))
    strides = active.to(torch.int32)
    sink = {}
    if win_starts is not None:
        sink = dict(win_starts=torch.where(active, win_starts, torch.zeros_like(win_starts)),
                    sink=sink_rows)
    t = tables.long()
    x = params["embed"][tokens]  # [B, T, E]
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    if cache_scales is not None:
        attn_fn = (ops.multiquery_decode_attention_int8 if kernels
                   else ops.multiquery_decode_attention_int8_reference)
    else:
        attn_fn = (ops.multiquery_decode_attention if kernels
                   else ops.multiquery_decode_attention_reference)
    for i, lp in enumerate(layer_params(params)):
        q, k_new, v_new = _project_qkv(x, lp, cfg, cos, sin, kernels)
        k_l, v_l = k_pool[i], v_pool[i]
        if cache_scales is not None:
            k_s, v_s = cache_scales[0][i], cache_scales[1][i]
            scatter_quant(k_l, k_s, pages, offs, k_new)
            scatter_quant(v_l, v_s, pages, offs, v_new)
            views = (k_l[t].reshape(B, C, KH, D), v_l[t].reshape(B, C, KH, D),
                     k_s[t].reshape(B, C, KH), v_s[t].reshape(B, C, KH))
        else:
            k_l[pages, offs] = k_new.to(k_l.dtype)
            v_l[pages, offs] = v_new.to(v_l.dtype)
            views = (k_l[t].reshape(B, C, KH, D), v_l[t].reshape(B, C, KH, D))
        attn = attn_fn(q.contiguous(), *views, read_base, strides, window=cfg.sliding_window,
                       **sink)
        x = x + matmul(attn.reshape(B, T, -1), lp["wo"], kernels)
        x = x + _mlp(x, lp, cfg, kernels, moe_impl)
    return _final_logits(x, params, cfg, kernels)


def _dense_attend(q, caches, read_base, strides, mask, cfg: ModelConfig,
                  kernels: bool):
    """Attention of T queries per slot over one layer of the dense cache.
    ``caches`` is (k, v) or (k, v, k_scales, v_scales). With ``kernels`` the
    ops wrappers read only the rows each query can see; without, the whole
    cache (dequantized when int8) goes through ``gqa_attention`` under
    ``mask`` [B, T, C]."""
    if not kernels:
        if len(caches) == 4:
            k = dequantize_kv(caches[0], caches[2], q.dtype)
            v = dequantize_kv(caches[1], caches[3], q.dtype)
        else:
            k, v = caches
        return gqa_attention(q, k, v, mask)
    if strides is None:  # a decode step: one query per slot
        fn = ops.decode_attention_int8 if len(caches) == 4 else ops.decode_attention
        return fn(q[:, 0].contiguous(), *caches, read_base,
                  window=cfg.sliding_window)[:, None]
    fn = (ops.multiquery_decode_attention_int8 if len(caches) == 4
          else ops.multiquery_decode_attention)
    return fn(q.contiguous(), *caches, read_base, strides, window=cfg.sliding_window)


def _dense_plan(cfg: ModelConfig, lengths, active, T: int, C: int, kernels: bool,
                multi: bool):
    """Where a dense-cache forward of T tokens per slot writes and reads:
    (positions [B, T], plan), plan = (slots, write_rows, read_base, strides,
    mask).
    Inactive slots write the sacrificial last row and expose only column 0.
    ``mask`` [B, T, C] is built for the plain path only."""
    B = lengths.shape[0]
    if active is None:
        active = torch.ones(B, dtype=torch.bool, device=lengths.device)
    positions = lengths[:, None] + torch.arange(T, device=lengths.device,
                                                dtype=lengths.dtype)[None, :]
    write_rows = torch.where(active[:, None], positions.clamp(max=C - 1),
                             torch.full_like(positions, C - 1)).long()
    read_base = torch.where(active, lengths, torch.zeros_like(lengths))
    strides = active.to(torch.int32) if multi else None
    mask = None
    if not kernels:
        qpos = torch.where(active[:, None], positions, torch.zeros_like(positions))
        cols = torch.arange(C, device=lengths.device)[None, None, :]
        mask = cols <= qpos[..., None]  # [B, T, C]
        if cfg.sliding_window is not None:
            mask = mask & (cols > qpos[..., None] - cfg.sliding_window)
    slots = torch.arange(B, device=lengths.device)[:, None]
    return positions, (slots, write_rows, read_base, strides, mask)


def _dense_attention_sublayer(x, lp, cfg: ModelConfig, cos, sin, caches, plan,
                              kernels: bool):
    """The attention sublayer of one layer over its dense cache ``caches`` =
    (k, v) or (k, v, k_scales, v_scales), each [B, C, ...]: project x
    [B, T, E], write the T new K/V rows of every slot in place, attend, and
    return the output projection [B, T, E] (the residual is the caller's)."""
    B, T = x.shape[0], x.shape[1]
    slots, write_rows, read_base, strides, mask = plan
    q, k_new, v_new = _project_qkv(x, lp, cfg, cos, sin, kernels)
    if len(caches) == 4:
        scatter_quant(caches[0], caches[2], slots, write_rows, k_new)
        scatter_quant(caches[1], caches[3], slots, write_rows, v_new)
    else:
        caches[0][slots, write_rows] = k_new.to(caches[0].dtype)
        caches[1][slots, write_rows] = v_new.to(caches[1].dtype)
    attn = _dense_attend(q, caches, read_base, strides, mask, cfg, kernels)
    return matmul(attn.reshape(B, T, -1), lp["wo"], kernels)


def _dense_forward(params: Params, cfg: ModelConfig, tokens, lengths, k_cache,
                   v_cache, active, kernels: bool, cache_scales, multi: bool,
                   logits: bool = True, moe_impl: Optional[str] = None):
    """The body ``decode_step`` (T = 1) and ``verify_step`` share: write the
    T new K/V rows of every slot into the dense cache in place, attend, and
    return logits [B, T, V], or None without ``logits`` (no final norm and
    lm_head)."""
    T, C = tokens.shape[1], k_cache.shape[2]
    positions, plan = _dense_plan(cfg, lengths, active, T, C, kernels, multi)
    x = params["embed"][tokens]  # [B, T, E]
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    for i, lp in enumerate(layer_params(params)):
        caches = (k_cache[i], v_cache[i])
        if cache_scales is not None:
            caches += (cache_scales[0][i], cache_scales[1][i])
        x = x + _dense_attention_sublayer(x, lp, cfg, cos, sin, caches, plan, kernels)
        x = x + _mlp(x, lp, cfg, kernels, moe_impl)
    return _final_logits(x, params, cfg, kernels) if logits else None


def decode_step(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B] — one new token per slot
    lengths: torch.Tensor,  # [B] int32 — tokens already in each slot's cache
    k_cache: torch.Tensor,  # [L, B, C, KH, D] — dense slot cache
    v_cache: torch.Tensor,
    active: torch.Tensor = None,  # [B] bool
    kernels: bool = True,
    cache_scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    moe_impl: Optional[str] = None,
) -> torch.Tensor:
    """One batched decode step over the dense slot cache; returns logits
    [B, V] in fp32.

    Unlike the JAX function, which returns updated caches, this writes each
    slot's new K/V row INTO ``k_cache``/``v_cache`` (and the scales) in
    place at row ``lengths[b]``, then attends over rows [0, lengths[b]]
    inside the sliding window. Inactive slots write the sacrificial last
    cache row and attend over the single row 0, so they cost no cache
    traffic and cannot touch rows another admission has written.

    ``kernels`` True runs ``ops.decode_attention`` (``_int8`` for an int8
    cache), which reads only the valid rows; False masks the whole cache
    (dequantized for int8) through ``gqa_attention``. ``cache_scales`` —
    (k_scales, v_scales) [L, B, C, KH] f32 — marks an int8 cache: rows
    quantize on write."""
    return _dense_forward(params, cfg, tokens[:, None], lengths, k_cache, v_cache,
                          active, kernels, cache_scales, multi=False,
                          moe_impl=moe_impl)[:, 0]


def verify_step(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, T] — [last_token, draft_0 .. draft_{T-2}]
    lengths: torch.Tensor,  # [B] int32 — tokens already in each slot's cache
    k_cache: torch.Tensor,  # [L, B, C, KH, D] — dense slot cache
    v_cache: torch.Tensor,
    active: torch.Tensor = None,  # [B] bool
    kernels: bool = True,
    cache_scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    logits: bool = True,
    moe_impl: Optional[str] = None,
) -> Optional[torch.Tensor]:
    """Batched multi-token decode for speculative verification; returns
    logits [B, T, V] in fp32, or None when ``logits`` is False: the draft's
    bulk ingest writes K/V rows only and stops before the final norm and
    lm_head (the JAX function computes the logits and its caller discards
    them).

    The T tokens of a slot are its pending last token followed by T-1 draft
    tokens (-1 where there is no draft: it embeds as the last vocabulary row
    and can never be accepted). All T K/V rows are written in place at rows
    ``lengths[b] .. lengths[b]+T-1`` and query t attends causally over the
    columns ``<= lengths[b]+t`` (its own row included), inside the sliding
    window, so the caller can accept the longest draft prefix that matches
    the model's own predictions (``engine/spec.py``). ``active``,
    ``kernels`` and ``cache_scales`` as in ``decode_step``; the kernel path
    runs ``ops.multiquery_decode_attention`` (``_int8``).

    Rows written past ``C-2`` collapse onto the last cache row, where the
    winner of the duplicate writes is undefined: callers clamp draft counts
    so accepted rows stay ``<= C-2``, and rows of rejected drafts are masked
    by ``lengths`` afterwards. A slot already at ``lengths == C-1`` is
    saturated: all its writes collide on the last row and its outputs are
    indeterminate, so callers must not consume its tokens."""
    return _dense_forward(params, cfg, tokens, lengths, k_cache, v_cache, active,
                          kernels, cache_scales, multi=True, logits=logits,
                          moe_impl=moe_impl)


# ---------------------------------------------------------------------------
# Chunked admission: one chunk of a prompt against the cache
# ---------------------------------------------------------------------------


def _start_index(start, device) -> torch.Tensor:
    """A chunk's start row as the [1] int32 ``lengths`` operand of the
    multi-query attention (a host int is copied in; a device tensor is used
    as it is, so that nothing is read back)."""
    if isinstance(start, torch.Tensor):
        return start.reshape(1).to(device=device, dtype=torch.int32)
    return torch.tensor([int(start)], dtype=torch.int32, device=device)


def _chunk_forward(params: Params, cfg: ModelConfig, tokens, start, layer_io,
                   kernels: bool, moe_impl: Optional[str] = None, win_start=None,
                   sink_rows: int = 0):
    """The body both chunk forwards share. Token t of ``tokens`` [1, Tc] sits
    at row ``start + t``; per layer, ``layer_io(i, k_new, v_new)`` writes the
    chunk's K/V rows [Tc, KH, D] into layer i of the cache and returns that
    layer's view of the slot, (k, v) or (k, v, k_scales, v_scales) each
    [1, C, ...]; chunk row t then attends over the rows ``<= start + t``
    inside the sliding window: ``multiquery_decode_attention`` (K6) or its
    int8 twin (K7) with B = 1, lengths = [start], strides = [1], T = Tc,
    which is the visibility of the JAX ``blockwise_cache_attention``; a
    ``win_start`` ([1] int32, window+sink compression mid-admission) hides
    the rows [sink_rows, win_start) as its ``live_from`` does. Returns
    logits [1, Tc, V] in fp32."""
    Tc = tokens.shape[1]
    dev = tokens.device
    sink = {} if win_start is None else dict(win_starts=win_start, sink=sink_rows)
    positions = start.long()[:, None] + torch.arange(Tc, device=dev)[None, :]
    strides = torch.ones(1, dtype=torch.int32, device=dev)
    x = params["embed"][tokens]  # [1, Tc, E]
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    for i, lp in enumerate(layer_params(params)):
        q, k_new, v_new = _project_qkv(x, lp, cfg, cos, sin, kernels)
        caches = layer_io(i, k_new[0], v_new[0])
        if len(caches) == 4:
            fn = (ops.multiquery_decode_attention_int8 if kernels
                  else ops.multiquery_decode_attention_int8_reference)
        else:
            fn = (ops.multiquery_decode_attention if kernels
                  else ops.multiquery_decode_attention_reference)
        attn = fn(q.contiguous(), *caches, start, strides, window=cfg.sliding_window, **sink)
        x = x + matmul(attn.reshape(1, Tc, -1), lp["wo"], kernels)
        x = x + _mlp(x, lp, cfg, kernels, moe_impl)
    return _final_logits(x, params, cfg, kernels)


def prefill_chunk(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [1, Tc] — one chunk of one prompt
    slot,  # int or [1] int64 tensor: the destination slot of the dense cache
    start,  # int or [1] int32 tensor: the row of tokens[0, 0]
    k_cache: torch.Tensor,  # [L, S, C, KH, D] — dense slot cache
    v_cache: torch.Tensor,
    kernels: bool = True,
    cache_scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    moe_impl: Optional[str] = None,
) -> torch.Tensor:
    """One chunk of an incremental prefill against the dense slot cache;
    returns logits [1, Tc, V] in fp32 (the caller samples the row of the
    prompt's last token on the final chunk).

    Unlike the JAX function, which returns updated caches, this writes the
    chunk's K/V rows [start, start+Tc) of ``slot`` (and, int8, their
    scales) IN PLACE, then attends each chunk row over the slot's own rows
    ``k_cache[i][slot:slot+1]`` written so far (``_chunk_forward``). Rows of
    a chunk that would run past the cache end collapse onto the last row;
    the engine never issues one (its chunk divides the context).

    A device ``slot`` (a captured admission's operand, never read back)
    writes through tensor indices and reads the slot's rows per layer by
    ``index_select``: one copy of [1, C, KH, D] each for K and V (and of
    the scales), as ``prefill_chunk_paged`` gathers its view; a host int
    reads views of the cache."""
    dev = tokens.device
    C = k_cache.shape[2]
    start = _start_index(start, dev)
    rows = (start.long() + torch.arange(tokens.shape[1], device=dev)).clamp(max=C - 1)
    if isinstance(slot, torch.Tensor):
        def own(t):
            return t.index_select(0, slot)
    else:
        def own(t):
            return t[slot:slot + 1]

    def layer_io(i, k_new, v_new):
        if cache_scales is not None:
            k_s, v_s = cache_scales[0][i], cache_scales[1][i]
            scatter_quant(k_cache[i], k_s, slot, rows, k_new)
            scatter_quant(v_cache[i], v_s, slot, rows, v_new)
            return own(k_cache[i]), own(v_cache[i]), own(k_s), own(v_s)
        k_cache[i][slot, rows] = k_new.to(k_cache.dtype)
        v_cache[i][slot, rows] = v_new.to(v_cache.dtype)
        return own(k_cache[i]), own(v_cache[i])

    return _chunk_forward(params, cfg, tokens, start, layer_io, kernels, moe_impl)


def page_rows(pages: torch.Tensor, P: int, rows: int) -> torch.Tensor:
    """The page of each of the first ``rows`` rows that ``pages`` [nb] hold,
    P rows a page: a broadcast, not ``repeat_interleave``, whose output
    size some PyTorch builds read back from the device (no capture takes
    that)."""
    return pages[:, None].expand(pages.shape[0], P).reshape(-1)[:rows]


def chunk_write_rows(table_row: torch.Tensor, start: torch.Tensor, Tc: int,
                     P: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pages, offsets) [Tc] of a chunk's rows in the page pool, as the JAX
    ``prefill_chunk_paged`` writes them. Chunk and page sizes are powers of
    two, so a chunk either spans Tc/P whole pages from a page-aligned
    ``start`` or sits inside one page. The table is padded with
    sacrificial entries first, so that a final bucket whose padding runs
    past the slot's last block (a prefix match de-aligns chunk starts)
    writes its overflow rows on page 0."""
    dev = table_row.device
    if Tc >= P:
        nb = Tc // P
        ext = torch.cat([table_row, table_row.new_zeros(nb)]).long()
        blocks = start.long() // P + torch.arange(nb, device=dev)
        return page_rows(ext[blocks], P, Tc), torch.arange(Tc, device=dev) % P
    page = table_row.long()[start.long() // P]  # [1]
    return page.expand(Tc), start.long() % P + torch.arange(Tc, device=dev)


def prefill_chunk_paged(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [1, Tc] — one chunk of one prompt
    start,  # int or [1] int32 tensor: the row of tokens[0, 0]
    k_pool: torch.Tensor,  # [L, N, P, KH, D] — shared page pool
    v_pool: torch.Tensor,
    table_row: torch.Tensor,  # [MB] int32 — the slot's block -> page map
    kernels: bool = True,
    cache_scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    moe_impl: Optional[str] = None,
    win_start: Optional[torch.Tensor] = None,  # [1] int32 live-window start
    sink_rows: int = 0,  # sink rows (window+sink KV compression)
) -> torch.Tensor:
    """One chunk of an incremental prefill against the PAGED pool; returns
    logits [1, Tc, V] in fp32.

    Unlike the JAX function, which returns updated pools, this writes the
    chunk's K/V rows at ``chunk_write_rows`` IN PLACE (int8: quantized,
    with their scales, through ``scatter_quant``), then gathers the slot's
    logical view [1, MB*P, KH, D] through ``table_row`` (a copy, as the JAX
    function does; int8: the bytes and the [1, MB*P, KH] scales, which K7
    folds in f32) and attends each chunk row over it
    (``_chunk_forward``). The caller must have backed rows
    [0, start+Tc) that hold prompt tokens; unbacked blocks map the
    sacrificial page, which no visible row reads. A final bucket may run
    past the slot's MB*P rows (a de-aligned start after a prefix match):
    its overflow rows land on page 0 and its queries past the end are
    saturated, their outputs unconsumed. A ``win_start`` (a prompt that
    crossed the compression threshold mid-admission) masks the pruned
    rows [sink_rows, win_start), whose blocks map the sacrificial page."""
    dev = tokens.device
    P, KH, D = k_pool.shape[2], k_pool.shape[3], k_pool.shape[4]
    MB = table_row.shape[0]
    start = _start_index(start, dev)
    pages, offs = chunk_write_rows(table_row, start, tokens.shape[1], P)
    t = table_row.long()

    def layer_io(i, k_new, v_new):
        k_l, v_l = k_pool[i], v_pool[i]
        if cache_scales is not None:
            k_s, v_s = cache_scales[0][i], cache_scales[1][i]
            scatter_quant(k_l, k_s, pages, offs, k_new)
            scatter_quant(v_l, v_s, pages, offs, v_new)
            return (k_l[t].reshape(1, MB * P, KH, D), v_l[t].reshape(1, MB * P, KH, D),
                    k_s[t].reshape(1, MB * P, KH), v_s[t].reshape(1, MB * P, KH))
        k_l[pages, offs] = k_new.to(k_l.dtype)
        v_l[pages, offs] = v_new.to(v_l.dtype)
        return k_l[t].reshape(1, MB * P, KH, D), v_l[t].reshape(1, MB * P, KH, D)

    return _chunk_forward(params, cfg, tokens, start, layer_io, kernels, moe_impl,
                          win_start=win_start, sink_rows=sink_rows)


# ---------------------------------------------------------------------------
# The int8 KV pool
# ---------------------------------------------------------------------------


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the head dim: x [..., D] -> (int8 [..., D], f32
    [...]). Scale absmax / 127 (1.0 for an all-zero row), round half to
    even, clip to +-127: the bytes and scales of the JAX package's
    ``quantize_kv`` as its engine runs it, compiled, where XLA turns the
    division by 127 into a product with the f32 reciprocal."""
    xf = x.to(torch.float32)
    absmax = xf.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax * _RECIP_127, torch.ones_like(absmax))
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return (q.to(torch.float32) * scale[..., None].to(torch.float32)).to(dtype)


def scatter_quant(pool: torch.Tensor, scales: torch.Tensor, pages: torch.Tensor,
                  offs: torch.Tensor, rows: torch.Tensor) -> None:
    """Quantize rows [..., KH, D] and write values and scales IN PLACE into
    an int8 page pool [N, P, KH, D] and its scales [N, P, KH] at
    (pages, offs), or into one layer of a dense cache [S, C, KH, D] at
    (slots, rows): the write side of every int8 cache path."""
    q, s = quantize_kv(rows)
    pool[pages, offs] = q
    scales[pages, offs] = s


def gather_dequant(pool: torch.Tensor, scales: torch.Tensor, tables: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """Dequantized logical views [..., MB*P, KH, D] of the slots whose page
    tables are ``tables`` [..., MB]: the read-side twin of
    ``scatter_quant``."""
    t = tables.long()
    out = dequantize_kv(pool[t], scales[t], dtype)
    MB = tables.shape[-1]
    P, KH, D = pool.shape[1], pool.shape[2], pool.shape[3]
    return out.reshape(*tables.shape[:-1], MB * P, KH, D)


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                  dtype: torch.dtype, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The paged KV pool, [L, N, P, KH, D] each for k and v; with (slots,
    context) for (num_pages, page_size), the dense slot cache
    [L, S, C, KH, D]."""
    shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def init_kv_scales(cfg: ModelConfig, num_pages: int, page_size: int,
                   device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The f32 scales of an int8 pool, [L, N, P, KH] each for k and v (of a
    dense cache, [L, S, C, KH]), starting at 1.0 so that never-written rows
    stay finite."""
    shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads)
    return (torch.ones(shape, dtype=torch.float32, device=device),
            torch.ones(shape, dtype=torch.float32, device=device))

