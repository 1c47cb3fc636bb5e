"""Mixture-of-experts FFN: router and experts, the port of
``aios_tpu/engine/moe.py``.

Three implementations of the same top-k routed SwiGLU experts:

  * ``moe_ffn_dense``: every expert processes every token and per-token gates
    (zero for unselected experts) scale the outputs. Exact and dropless; a
    decode step streams every expert's weights once, which is the serving
    path's cost whatever the routing (at 8 slots the routed set spans most
    experts anyway).
  * ``moe_ffn_gather``: each of the N*k (token, pick) pairs runs through the
    one expert it picked, so a step streams N*k expert blocks instead of X.
    Exact and dropless, the dense path's math reordered.
  * ``moe_ffn_dispatch``: GShard capacity-based dispatch and combine: tokens
    queue for their experts in ``capacity`` slots each, the experts run over
    their queues, and picks past an expert's capacity are dropped.

Every expert product goes through ``_expert_einsum`` (every expert over
shared rows, or each over its own queue) or ``pick_einsum`` (each row through
its picked expert): on an int8 leaf {"q": [X, in, out], "s": [X, 1, out]} the
kernel's expert entry ``ops.quantized_matmul_experts`` on CUDA (its plain
twin on the CPU, or by name with ``kernels=False``), which applies each
expert's scale before anything sums over experts; on dense leaves plain
einsums. Routing, picks and queue positions stay on the device (no
``.item()``, no ``nonzero``, no shape read from the data), so every path
captures into a CUDA graph; the capacity and the P = N*k picks are static.

``torch.topk`` and ``jax.lax.top_k`` may order exact ties of router
probabilities differently; softmax outputs of f32 logits from random inputs
do not tie, and the tests' inputs are such.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .. import ops
from .config import ModelConfig

# Tokens the dense path runs through the experts at once. Its [X, N, 2F],
# [X, N, F] and [X, N, E] intermediates grow with N (12 GB at Qwen3-30B-A3B's
# 8192-row whole-prompt bucket, held in the admission graphs' pool), so
# longer inputs go through in slices of this many rows. Tokens are
# independent, and the expert entry's tile and summation order are the same
# for every slice of more than 64 rows (128 x 128 tiles, K whole), so the
# slicing changes no bit of the kernel path.
DENSE_TOKEN_CHUNK = 1024

def resolve_impl(moe_impl: Optional[str], n_tok: int = 0, allow_dispatch: bool = False) -> str:
    """The path an MoE sublayer takes, with the JAX ``_mlp_aux``'s
    precedence: ``AIOS_TPU_MOE_IMPL`` (the operator's override), then the
    caller's static choice ``moe_impl``, then auto, which is dense on every
    serving path and, on the training forward (``allow_dispatch``), the
    capacity dispatch at 1024 tokens or more. A value that names no path is
    dense, as in JAX."""
    impl = os.environ.get("AIOS_TPU_MOE_IMPL") or moe_impl or "auto"
    if impl == "auto" and allow_dispatch and n_tok >= 1024:
        return "dispatch"
    return impl if impl in ("gather", "dispatch") else "dense"


def _expert_einsum(x: torch.Tensor, w, kernels: bool = True) -> torch.Tensor:
    """Every expert's product over rows of x: shared rows x [N, in] ->
    [X, N, out] (the JAX spec "ne,xef->xnf"), or each expert's own rows x
    [X, C, in] -> [X, C, out] ("xce,xef->xcf"). ``w`` is a dense [X, in,
    out] stack or an int8 leaf, whose per-(expert, column) scale multiplies
    the f32 sums before the cast to x's dtype."""
    if isinstance(w, dict):
        fn = ops.quantized_matmul_experts if kernels else ops.quantized_matmul_experts_reference
        return fn(x.contiguous(), w["q"], w["s"])
    if x.dim() == 2:
        return torch.einsum("ne,xef->xnf", x, w)
    return torch.bmm(x, w)


def pick_einsum(x: torch.Tensor, w, picks: torch.Tensor, kernels: bool = True) -> torch.Tensor:
    """Row p of x [P, in] through expert ``picks[p]`` -> [P, out] (the JAX
    ``pick_einsum``, "pi,pio->po" over the gathered experts)."""
    if isinstance(w, dict):
        fn = ops.quantized_matmul_experts if kernels else ops.quantized_matmul_experts_reference
        return fn(x.contiguous(), w["q"], w["s"], picks)
    return torch.einsum("pi,pio->po", x, w[picks.long()])


def route(h: torch.Tensor, w_router, cfg: ModelConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing of h [N, E] by w_router [E, X]: (probs [N, X] f32, the
    softmax in f32 over f32 logits; weights [N, k] f32, renormalized over the
    top-k set when ``cfg.norm_topk_prob``; idx [N, k] int32)."""
    logits = h.to(torch.float32) @ w_router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    if cfg.norm_topk_prob:
        weights = weights / weights.sum(dim=-1, keepdim=True)
    return probs, weights, idx.to(torch.int32)


def gate_matrix(weights: torch.Tensor, idx: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Scatter the top-k (weights, idx) into a full [N, X] gate matrix (a
    token's picks are distinct experts, so each entry is one weight or 0)."""
    out = weights.new_zeros(weights.shape[0], num_experts)
    return out.scatter(1, idx.long(), weights)


def load_balance_aux(probs: torch.Tensor, idx: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Switch-transformer load-balancing loss of one layer:
    X * sum_x(fraction of picks routed to x * mean router prob of x); 1.0
    under perfect balance."""
    counts = F.one_hot(idx.long(), num_experts).to(torch.float32).sum(dim=(0, 1))
    frac = counts / torch.clamp(counts.sum(), min=1.0)
    return num_experts * torch.sum(frac * probs.mean(dim=0))


def _gate_up(x: torch.Tensor, lp, cfg: ModelConfig, einsum) -> torch.Tensor:
    """silu(x W_gate) * (x W_up) through ``einsum`` (the fused ``we_gateup``
    leaf or separate ones), silu in f32 and cast to x's dtype, where JAX
    rounds it. The f32 copy is taken once and activated in place, which
    keeps the peak of a long prompt's [X, N, F] low."""
    if "we_gateup" in lp:  # fused serving layout (model.quantize_params)
        gu = einsum(x, lp["we_gateup"])
        g, u = gu[..., :cfg.expert_dim], gu[..., cfg.expert_dim:]
    else:
        g, u = einsum(x, lp["we_gate"]), einsum(x, lp["we_up"])
    a = g.to(torch.float32, copy=True)
    F.silu(a, inplace=True)
    return a.to(x.dtype).mul_(u)


def _aux(want: bool, probs, idx, cfg: ModelConfig) -> Optional[torch.Tensor]:
    return load_balance_aux(probs, idx, cfg.num_experts) if want else None


def moe_ffn_dense(h: torch.Tensor, lp, cfg: ModelConfig, kernels: bool = True,
                  aux: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Exact dropless MoE FFN of h [B, T, E]; returns (out [B, T, E], aux
    f32, or None without ``aux``: the serving forwards skip it). The gates
    scale each (expert, token) row in x's dtype before the down projection;
    over int8 leaves the down projection keeps the expert axis ([X, N, E])
    and sums it in f32."""
    B, T, E = h.shape
    N = B * T
    flat = h.reshape(N, E)
    probs, weights, idx = route(flat, lp["w_router"], cfg)
    gates = gate_matrix(weights, idx, cfg.num_experts).to(h.dtype)  # [N, X]
    C = DENSE_TOKEN_CHUNK
    if N > C:
        out = torch.cat([_dense_experts(flat[i:i + C], gates[i:i + C], lp, cfg, kernels)
                         for i in range(0, N, C)])
    else:
        out = _dense_experts(flat, gates, lp, cfg, kernels)
    return out.reshape(B, T, E), _aux(aux, probs, idx, cfg)


def _dense_experts(flat: torch.Tensor, gates: torch.Tensor, lp, cfg: ModelConfig,
                   kernels: bool) -> torch.Tensor:
    """Every expert over the rows of flat [N, E], gated by gates [N, X] in
    x's dtype before the down projection -> [N, E]."""
    z = _gate_up(flat, lp, cfg, lambda x, w: _expert_einsum(x, w, kernels))  # [X, N, F]
    z.mul_(gates.t()[..., None])
    if isinstance(lp["we_down"], dict):
        y = _expert_einsum(z, lp["we_down"], kernels)  # [X, N, E]
        return y.sum(dim=0, dtype=torch.float32).to(flat.dtype)
    return torch.einsum("xnf,xfe->ne", z, lp["we_down"])


def moe_ffn_gather(h: torch.Tensor, lp, cfg: ModelConfig, kernels: bool = True,
                   aux: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Gathered-expert MoE FFN for small token counts; returns (out, aux).
    Each token runs once per pick through its picked expert (P = N*k rows),
    and the picks' outputs sum in f32 weighted by the routing weights."""
    B, T, E = h.shape
    N, k = B * T, cfg.num_experts_per_tok
    flat = h.reshape(N, E)
    probs, weights, idx = route(flat, lp["w_router"], cfg)
    picks = idx.reshape(N * k)
    x_pick = flat[:, None, :].expand(N, k, E).reshape(N * k, E)  # token repeated per pick
    z = _gate_up(x_pick, lp, cfg, lambda x, w: pick_einsum(x, w, picks, kernels))  # [P, F]
    y_pick = pick_einsum(z, lp["we_down"], picks, kernels)  # [P, E]
    out = torch.sum(y_pick.reshape(N, k, E).to(torch.float32) * weights[..., None],
                    dim=1).to(h.dtype)
    return out.reshape(B, T, E), _aux(aux, probs, idx, cfg)


def dispatch_capacity(N: int, cfg: ModelConfig, capacity_factor: float = 1.25) -> int:
    """The static per-expert queue length: ceil(N*k/X * capacity_factor), at
    least 8, rounded up to a multiple of 8 and at most N*k."""
    k, X = cfg.num_experts_per_tok, cfg.num_experts
    capacity = max(8, int(-(-N * k * capacity_factor // X)))
    return min(-(-capacity // 8) * 8, N * k)


def moe_ffn_dispatch(h: torch.Tensor, lp, cfg: ModelConfig, capacity_factor: float = 1.25,
                     capacity: Optional[int] = None, kernels: bool = True,
                     aux: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Capacity-based GShard dispatch MoE FFN; returns (out, aux). Picks
    queue for their expert in (token-major, pick-minor) order; a pick past
    its expert's ``capacity`` (default ``dispatch_capacity``) contributes
    zero."""
    B, T, E = h.shape
    N = B * T
    X, k = cfg.num_experts, cfg.num_experts_per_tok
    flat = h.reshape(N, E)
    probs, weights, idx = route(flat, lp["w_router"], cfg)
    if capacity is None:
        capacity = dispatch_capacity(N, cfg, capacity_factor)
    # the queue position of each pick: how many earlier picks chose its expert
    onehot = F.one_hot(idx.long(), X).to(torch.int32).reshape(N * k, X)
    pos = torch.cumsum(onehot, dim=0) - onehot
    pos = torch.sum(pos * onehot, dim=-1).reshape(N, k)
    keep = pos < capacity
    # overflow picks one-hot off the end: an all-zero row
    slot_oh = F.one_hot(torch.where(keep, pos, torch.full_like(pos, capacity)).long(),
                        capacity + 1)[..., :capacity].to(h.dtype)  # [N, k, cap]
    exp_oh = F.one_hot(idx.long(), X).to(h.dtype)  # [N, k, X]
    combine = torch.einsum("nk,nkx,nkc->nxc", weights.to(h.dtype), exp_oh, slot_oh)
    dispatch = torch.einsum("nkx,nkc->nxc", exp_oh, slot_oh)
    xe = torch.einsum("nxc,ne->xce", dispatch, flat)  # [X, cap, E]
    z = _gate_up(xe, lp, cfg, lambda x, w: _expert_einsum(x, w, kernels))
    ye = _expert_einsum(z, lp["we_down"], kernels)  # [X, cap, E]
    out = torch.einsum("nxc,xce->ne", combine, ye)
    return out.reshape(B, T, E), _aux(aux, probs, idx, cfg)


def moe_ffn(h: torch.Tensor, lp, cfg: ModelConfig, kernels: bool = True,
            moe_impl: Optional[str] = None, with_aux: bool = False):
    """The MoE sublayer on the path ``resolve_impl`` names: the serving
    forwards' out, without the aux loss (no serving path reads it), or with
    ``with_aux`` (the training forward) (out, aux)."""
    impl = resolve_impl(moe_impl, h.shape[0] * h.shape[1], allow_dispatch=with_aux)
    if impl == "dispatch":
        out = moe_ffn_dispatch(h, lp, cfg, kernels=kernels, aux=with_aux)
    elif impl == "gather":
        out = moe_ffn_gather(h, lp, cfg, kernels, aux=with_aux)
    else:
        out = moe_ffn_dense(h, lp, cfg, kernels, aux=with_aux)
    return out if with_aux else out[0]
