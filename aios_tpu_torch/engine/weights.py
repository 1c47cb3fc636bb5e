"""Parameters for the port: carried across from the JAX package, or made
synthetically on the target device.

``params_from_jax`` takes the JAX package's parameter tree already turned
into numpy by the caller (this package imports no JAX) and keeps its layout:
stacked [L, ...] layer leaves, quantized {"q", "s"} leaves as they are, so
both packages multiply the same int8 bytes. ``init_params`` is the torch twin
of the JAX ``init_params`` (scaled-normal init) for synthetic models; the
two draw different numbers from the same seed.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from .config import ModelConfig

Device = Optional[Union[str, torch.device]]


def tensor_from_numpy(a: np.ndarray, device: Device = None) -> torch.Tensor:
    """numpy -> torch, including ``ml_dtypes.bfloat16`` arrays (which
    ``torch.from_numpy`` refuses): their bits travel as uint16. Copies, so
    the tensor never aliases a read-only buffer."""
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device) if device is not None else t


def params_from_jax(tree: Dict, device: Device = None) -> Dict:
    """The JAX package's parameter pytree (numpy leaves) as the port's
    parameters on ``device``."""
    return {
        k: params_from_jax(v, device) if isinstance(v, dict) else tensor_from_numpy(v, device)
        for k, v in tree.items()
    }


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.bfloat16, device: Device = None) -> Dict:
    """Random params (scaled-normal init, 0.02) made on ``device`` from
    ``generator`` (which must live on the same device type)."""
    device = torch.device(device) if device is not None else generator.device

    def normal(*shape):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return (w * 0.02).to(dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    L, E, F, D = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    layers = {
        "attn_norm": ones(L, E),
        "ffn_norm": ones(L, E),
        "wq": normal(L, E, cfg.q_dim),
        "wk": normal(L, E, cfg.kv_dim),
        "wv": normal(L, E, cfg.kv_dim),
        "wo": normal(L, cfg.q_dim, E),
        "w_gate": normal(L, E, F),
        "w_up": normal(L, E, F),
        "w_down": normal(L, F, E),
    }
    if cfg.qk_norm:
        layers["q_norm"] = ones(L, D)
        layers["k_norm"] = ones(L, D)
    params = {
        "embed": normal(cfg.vocab_size, E),
        "layers": layers,
        "final_norm": ones(E),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = normal(E, cfg.vocab_size)
    return params
