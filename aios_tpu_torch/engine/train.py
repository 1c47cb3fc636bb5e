"""Training on one card: next-token cross-entropy and AdamW, the port of
``aios_tpu/engine/train.py``.

The same model code trains: ``model.forward_full(..., kernels=False,
with_aux=True)``, the plain PyTorch path named in the call (the CUDA kernels
have no backward, as the Pallas flash kernel has none in JAX), each block
recomputed in the backward pass (``remat``) so that activation memory stays
flat in depth. The update is optax's chain written as tensor functions, in
place on the state's tensors: ``clip_by_global_norm(grad_clip)`` (a gradient
under the limit passes unscaled), AdamW (``b1``, ``b2``, ``eps`` 1e-8, the
bias corrections at the incremented count, weight decay on every leaf) and
``warmup_cosine_decay_schedule`` evaluated at the count before the update,
so the first step's rate is 0. Training under a mesh (ring or Ulysses
sequence parallelism, TP/DP, the pipeline) needs several cards and waits
for the port of ``parallel/`` (ROADMAP Queue 1).

``train_loop`` resumes after a crash from the port's ``CheckpointManager``
exactly as the JAX loop does from orbax: the incoming params only give
shapes, dtypes and the device when a checkpoint exists.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from . import model
from .config import ModelConfig

TrainState = Dict  # {"params": tree, "opt_state": {"count", "mu", "nu"}, "step": int}

PARALLEL_TODO = ("training under a mesh (ring or Ulysses sequence parallelism, TP/DP, "
                 "the pipeline) waits for the port of parallel/ (ROADMAP Queue 1)")


def token_cross_entropy(logits: torch.Tensor, tokens: torch.Tensor,
                        loss_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Next-token NLL: (masked nll sum, mask sum). Position t's label is
    tokens[t+1]; the last column is ignored."""
    labels = tokens[:, 1:].long()
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    ll = torch.gather(logp, -1, labels[..., None])[..., 0]
    mask = loss_mask[:, :-1]
    return -(ll * mask).sum(), mask.sum()


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros_like(tree, requires_grad=False)


@dataclass(frozen=True)
class Optimizer:
    """optax's ``chain(clip_by_global_norm, adamw)`` over a warmup-cosine
    schedule, as ``make_optimizer`` builds it in the JAX package."""

    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    eps: float = 1e-8

    def schedule(self, count: int) -> float:
        """``warmup_cosine_decay_schedule(0, learning_rate, warmup_steps,
        max(total_steps, warmup_steps + 1))`` at update ``count``."""
        if count < self.warmup_steps:
            return self.learning_rate * count / self.warmup_steps
        decay = max(self.total_steps, self.warmup_steps + 1) - self.warmup_steps
        t = min(count - self.warmup_steps, decay)
        return self.learning_rate * 0.5 * (1 + math.cos(math.pi * t / decay))

    def init(self, params) -> Dict:
        return {"count": 0, "mu": _zeros_like(params), "nu": _zeros_like(params)}

    @torch.no_grad()
    def update_(self, grads: List[torch.Tensor], state: Dict, params: List[torch.Tensor]
                ) -> torch.Tensor:
        """One update of ``params`` (leaves in ``_leaves`` order) in place;
        returns the gradients' global norm before clipping."""
        gnorm = torch.sqrt(sum(g.float().pow(2).sum() for g in grads))
        if not gnorm.item() < self.grad_clip:
            for g in grads:
                g.div_(gnorm).mul_(self.grad_clip)
        count = state["count"]
        lr = self.schedule(count)
        inc = torch.tensor(count + 1, dtype=torch.float32)
        bc1 = float(1 - torch.tensor(self.b1, dtype=torch.float32) ** inc)
        bc2 = float(1 - torch.tensor(self.b2, dtype=torch.float32) ** inc)
        for p, g, m, v in zip(params, grads, _leaves(state["mu"]), _leaves(state["nu"])):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            u = (v / bc2).sqrt_().add_(self.eps)
            u = (m / bc1).div_(u).add_(p, alpha=self.weight_decay)
            p.add_(u, alpha=-lr)
        state["count"] = count + 1
        return gnorm


def make_optimizer(learning_rate: float = 3e-4, weight_decay: float = 0.1, b1: float = 0.9,
                   b2: float = 0.95, grad_clip: float = 1.0, warmup_steps: int = 100,
                   total_steps: int = 10_000) -> Optimizer:
    return Optimizer(learning_rate, weight_decay, b1, b2, grad_clip, warmup_steps, total_steps)


def make_train_step(cfg: ModelConfig, mesh=None, optimizer: Optional[Optimizer] = None,
                    remat: bool = True, seq_parallel: str = "ring",
                    moe_aux_coef: float = 0.01) -> Tuple[Callable, Callable]:
    """Returns (init_state, train_step). Batches are dicts {"tokens": [B, T]
    int, "loss_mask": [B, T] float} on the params' device; position t's
    label is tokens[t+1]. ``train_step(state, batch)`` updates the state's
    tensors in place and returns (state, {"loss", "grad_norm" (before
    clipping), "moe_aux"}). A mesh raises: one card has none."""
    optimizer = optimizer or make_optimizer()
    if seq_parallel not in ("ring", "ulysses"):
        raise ValueError(f"seq_parallel must be 'ring' or 'ulysses', got {seq_parallel!r}")
    if mesh is not None:
        raise NotImplementedError(PARALLEL_TODO)

    def loss_fn(params, tokens, loss_mask):
        logits, aux = model.forward_full(params, cfg, tokens, kernels=False, with_aux=True,
                                         remat=remat)
        nll, denom = token_cross_entropy(logits, tokens, loss_mask)
        return nll / torch.clamp(denom, min=1.0) + moe_aux_coef * aux, aux

    def init_state(params) -> TrainState:
        """The state over ``params`` (their tensors, updated in place)."""
        return {"params": params, "opt_state": optimizer.init(params), "step": 0}

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        params = _leaves(state["params"])
        for p in params:
            p.requires_grad_(True)
        dev = params[0].device
        loss, aux = loss_fn(state["params"], torch.as_tensor(batch["tokens"], device=dev),
                            torch.as_tensor(batch["loss_mask"], device=dev))
        grads = list(torch.autograd.grad(loss, params))
        gnorm = optimizer.update_(grads, state["opt_state"], params)
        del grads
        state["step"] += 1
        return state, {"loss": loss.detach(), "grad_norm": gnorm, "moe_aux": aux.detach()}

    return init_state, train_step


def train_loop(cfg: ModelConfig, params, batches: Iterable[Dict], *, mesh=None,
               optimizer: Optional[Optimizer] = None, checkpoint_dir: Optional[str] = None,
               save_every: int = 100, max_steps: Optional[int] = None,
               on_metrics: Optional[Callable[[int, Dict], None]] = None) -> TrainState:
    """Run train steps over ``batches`` with crash-safe checkpoint/resume:
    if ``checkpoint_dir`` holds a checkpoint, training restarts from its
    exact {params, opt_state, step} (the incoming ``params`` only give
    shapes, dtypes and the device); a save every ``save_every`` steps and
    one at the end."""
    init_state, train_step = make_train_step(cfg, mesh, optimizer)
    state = init_state(params)
    manager = None
    if checkpoint_dir is not None:
        from .checkpoint import CheckpointManager

        manager = CheckpointManager(checkpoint_dir)
        if manager.latest_step() is not None:
            state = manager.restore(like=state)
    step = int(state["step"])
    for batch in batches:
        if max_steps is not None and step >= max_steps:
            break
        state, metrics = train_step(state, batch)
        step += 1
        if on_metrics is not None:
            on_metrics(step, metrics)
        if manager is not None and step % save_every == 0:
            manager.save(step, state)
    if manager is not None:
        manager.save(step, state)
        manager.close()
    return state
