"""Parameters for the port: read from a GGUF file, carried across from the
JAX package, or made synthetically on the target device.

``params_from_gguf`` is the twin of the JAX ``params_from_gguf`` followed by
the JAX manager's cast to bf16: the same values (each element dequantized
to f32 by the copied dequantizers, then rounded to bf16), the same llama.cpp
q/k unpermute and (in, out) layout. It fills each stacked bf16 leaf on the
target device a block of rows at a time (a whole tensor for q/k, which the
unpermute reorders), the blocks dequantized on a few host threads a bounded
number ahead of the copies, so the host never holds the model in f32.
``params_from_jax`` takes the JAX package's parameter tree already turned
into numpy by the caller (this package imports no JAX) and keeps its layout:
stacked [L, ...] layer leaves, quantized {"q", "s"} leaves as they are, so
both packages multiply the same int8 bytes. ``params_from_hf_state_dict`` is the twin of
the JAX function of that name: a transformers state dict (Llama, Mistral,
Qwen3 and both mixture-of-experts namings) as the port's stacked params.
``init_params`` is the torch twin
of the JAX ``init_params`` (scaled-normal init) for synthetic models; the
two draw different numbers from the same seed. ``init_serving_params`` makes
the same random model as ``init_params`` followed by
``model.quantize_params``, one layer at a time, so that a mixture-of-experts
model never holds its whole bf16 tree (the job ``init_quantized_params`` does
for the JAX package).
"""

from __future__ import annotations

import functools
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Deque, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from . import gguf as gguf_mod
from . import model as model_mod
from .config import ModelConfig, from_gguf_metadata

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


def _normal(generator: torch.Generator, dtype: torch.dtype, device: torch.device):
    def normal(*shape):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return (w * 0.02).to(dtype)
    return normal


def _moe_layer(cfg: ModelConfig, normal) -> Dict[str, torch.Tensor]:
    """One MoE layer's random matrices, in the order both initializers draw
    them."""
    E, X, Fm = cfg.hidden_size, cfg.num_experts, cfg.expert_dim
    return {"wq": normal(E, cfg.q_dim), "wk": normal(E, cfg.kv_dim),
            "wv": normal(E, cfg.kv_dim), "wo": normal(cfg.q_dim, E),
            "w_router": normal(E, X), "we_gate": normal(X, E, Fm),
            "we_up": normal(X, E, Fm), "we_down": normal(X, Fm, E)}


def _norms(cfg: ModelConfig, dtype: torch.dtype, device: torch.device) -> Dict:
    L, E, D = cfg.num_layers, cfg.hidden_size, cfg.head_dim
    norms = {"attn_norm": torch.ones(L, E, dtype=dtype, device=device),
             "ffn_norm": torch.ones(L, E, dtype=dtype, device=device)}
    if cfg.qk_norm:
        norms["q_norm"] = torch.ones(L, D, dtype=dtype, device=device)
        norms["k_norm"] = torch.ones(L, D, dtype=dtype, device=device)
    return norms


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.bfloat16, device: Device = None) -> Dict:
    """Random params (scaled-normal init, 0.02) made on ``device`` from
    ``generator`` (which must live on the same device type). An MoE config
    draws its matrices layer by layer (``_moe_layer``), the order
    ``init_serving_params`` follows."""
    device = torch.device(device) if device is not None else generator.device
    normal = _normal(generator, dtype, device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    L, E, F, D = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    if cfg.moe:
        drawn = [_moe_layer(cfg, normal) for _ in range(L)]
        layers = {**_norms(cfg, dtype, device),
                  **{k: torch.stack([d[k] for d in drawn]) for k in drawn[0]}}
        del drawn
        params = {"embed": normal(cfg.vocab_size, E), "layers": layers, "final_norm": ones(E)}
        if not cfg.tie_word_embeddings:
            params["lm_head"] = normal(E, cfg.vocab_size)
        return params
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


# ---------------------------------------------------------------------------
# GGUF
# ---------------------------------------------------------------------------

ROW_BLOCK_ELEMENTS = 1 << 24  # f32 elements dequantized per block of rows
EXPERTS = "experts"  # a job's transpose of an expert stack [X, out, in] -> [X, in, out]
DEQUANT_THREADS = 8  # numpy releases the GIL inside the dequantizers' array ops


def _unpermute_llamacpp(w: np.ndarray, n_heads: int) -> np.ndarray:
    """Invert convert_hf_to_gguf's q/k row permutation (interleaved -> HF)."""
    out_dim, in_dim = w.shape
    half = out_dim // n_heads // 2
    return (
        w.reshape(n_heads, half, 2, in_dim)
        .swapaxes(1, 2)
        .reshape(out_dim, in_dim)
    )


def _row_blocks(f: gguf_mod.GGUFFile, name: str,
                heads: Optional[int] = None) -> Iterator[Tuple[int, int, Callable]]:
    """(r0, r1, a function returning rows r0:r1 of the tensor as f32) in
    blocks of about ROW_BLOCK_ELEMENTS; a row holds whole ggml blocks, so
    each block of rows dequantizes exactly as the whole tensor would. With
    ``heads`` one block, the whole tensor llama.cpp-unpermuted."""
    info = f.tensors[name]
    if info.ggml_type not in gguf_mod.BLOCK_LAYOUT:
        kind = gguf_mod.GGML_TYPE_NAMES.get(info.ggml_type, info.ggml_type)
        raise NotImplementedError(f"{name}: dequantization for ggml type {kind}")
    rows = info.shape[0] if info.shape else 1
    cols = info.n_elements // rows
    elems, nbytes = gguf_mod.BLOCK_LAYOUT[info.ggml_type]
    if heads is not None or cols % elems:  # the whole tensor at once
        def whole():
            w = f.load_tensor(name).reshape(rows, cols)
            return w if heads is None else _unpermute_llamacpp(w, heads)
        yield 0, rows, whole
        return
    raw, row_bytes = f.tensor_bytes(name), cols // elems * nbytes
    step = max(1, ROW_BLOCK_ELEMENTS // cols)
    for r0 in range(0, rows, step):
        r1 = min(rows, r0 + step)
        yield r0, r1, functools.partial(_dequantize_rows, raw[r0 * row_bytes:r1 * row_bytes],
                                        info.ggml_type, r1 - r0, cols)


def _dequantize_rows(raw: np.ndarray, ggml_type: int, rows: int, cols: int) -> np.ndarray:
    return gguf_mod.dequantize(raw, ggml_type, rows * cols).reshape(rows, cols)


def _fill(f: gguf_mod.GGUFFile, jobs: List[tuple], device: torch.device,
          spent: Dict[str, float]) -> None:
    """Copy each job's tensor (dest, name, transpose, heads) into its leaf:
    blocks of rows dequantize on a thread pool, at most 2 x DEQUANT_THREADS
    blocks ahead of the copies (bounding the host's f32), and are copied in
    order, transposed (out, in) -> (in, out) where asked. ``transpose`` ==
    EXPERTS marks an expert stack [X, out, in]: its rows are whole experts,
    each swapped to dest's [in, out]."""
    def blocks():
        for dest, name, transpose, heads in jobs:
            if name not in f.tensors:
                raise ValueError(f"{f.path}: no tensor {name}")
            for r0, r1, fn in _row_blocks(f, name, heads):
                yield dest, transpose, r0, r1, fn

    todo = blocks()
    with ThreadPoolExecutor(DEQUANT_THREADS) as pool:
        pending: Deque = deque()

        def submit():
            nxt = next(todo, None)
            if nxt is not None:
                pending.append((nxt, pool.submit(nxt[-1])))

        for _ in range(2 * DEQUANT_THREADS):
            submit()
        while pending:
            (dest, transpose, r0, r1, _), fut = pending.popleft()
            submit()
            t0 = time.perf_counter()
            rows = fut.result()
            t1 = time.perf_counter()
            if not rows.flags.writeable:  # an F32 tensor is a view of the file
                rows = rows.copy()
            src = torch.from_numpy(rows).to(device)
            if dest.dim() == 1:
                dest.copy_(src.reshape(dest.shape))
            elif transpose == EXPERTS:
                n_in, n_out = dest.shape[1], dest.shape[2]
                dest[r0:r1].copy_(src.reshape(r1 - r0, n_out, n_in).transpose(1, 2))
            elif transpose:
                dest[:, r0:r1].copy_(src.T)
            else:
                dest[r0:r1].copy_(src)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            spent["dequantize_s"] += t1 - t0
            spent["upload_s"] += time.perf_counter() - t1


def params_from_gguf(path: Union[str, gguf_mod.GGUFFile], device: Device = None,
                     dtype: torch.dtype = torch.bfloat16,
                     timings: Optional[Dict[str, float]] = None) -> Tuple[Dict, ModelConfig]:
    """Load a GGUF model file (a path, or the file already parsed) into the
    port's stacked params on ``device`` (None: the CUDA device). Returns
    (params, config). ``timings``, when given, gains the seconds the copies
    waited on parsing and dequantizing (``dequantize_s``) and the seconds of
    the copies to the device (``upload_s``)."""
    device = resolve_device(device)
    spent = {"dequantize_s": 0.0, "upload_s": 0.0}
    t0 = time.perf_counter()
    f = path if isinstance(path, gguf_mod.GGUFFile) else gguf_mod.GGUFFile(path)
    cfg = from_gguf_metadata(f.metadata)
    heads = ((cfg.num_heads, cfg.num_kv_heads) if f.architecture in ("llama", "mistral")
             else (None, None))
    spent["dequantize_s"] += time.perf_counter() - t0

    def empty(*shape):
        return torch.empty(shape, dtype=dtype, device=device)

    L, E, F, D = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    layers = {
        "attn_norm": empty(L, E), "ffn_norm": empty(L, E),
        "wq": empty(L, E, cfg.q_dim), "wk": empty(L, E, cfg.kv_dim),
        "wv": empty(L, E, cfg.kv_dim), "wo": empty(L, cfg.q_dim, E),
    }
    # leaf <- GGUF tensor, (out, in) -> (in, out), q/k unpermuted over heads
    sources = [("attn_norm", "attn_norm", False, None), ("ffn_norm", "ffn_norm", False, None),
               ("wq", "attn_q", True, heads[0]), ("wk", "attn_k", True, heads[1]),
               ("wv", "attn_v", True, None), ("wo", "attn_output", True, None)]
    if cfg.moe:
        # the router [X, E] -> [E, X]; expert stacks [X, out, in] -> [X, in, out]
        X, Fm = cfg.num_experts, cfg.expert_dim
        layers.update(w_router=empty(L, E, X), we_gate=empty(L, X, E, Fm),
                      we_up=empty(L, X, E, Fm), we_down=empty(L, X, Fm, E))
        sources += [("w_router", "ffn_gate_inp", True, None),
                    ("we_gate", "ffn_gate_exps", EXPERTS, None),
                    ("we_up", "ffn_up_exps", EXPERTS, None),
                    ("we_down", "ffn_down_exps", EXPERTS, None)]
    else:
        layers.update(w_gate=empty(L, E, F), w_up=empty(L, E, F), w_down=empty(L, F, E))
        sources += [("w_gate", "ffn_gate", True, None), ("w_up", "ffn_up", True, None),
                    ("w_down", "ffn_down", True, None)]
    if cfg.qk_norm:
        layers["q_norm"] = empty(L, D)
        layers["k_norm"] = empty(L, D)
        sources += [("q_norm", "attn_q_norm", False, None),
                    ("k_norm", "attn_k_norm", False, None)]
    jobs = [(layers[leaf][i], f"blk.{i}.{name}.weight", transpose, h)
            for i in range(L) for leaf, name, transpose, h in sources]
    params = {"embed": empty(cfg.vocab_size, E), "layers": layers, "final_norm": empty(E)}
    jobs += [(params["embed"], "token_embd.weight", False, None),
             (params["final_norm"], "output_norm.weight", False, None)]
    if "output.weight" in f.tensors:
        params["lm_head"] = empty(E, cfg.vocab_size)
        jobs.append((params["lm_head"], "output.weight", True, None))
    _fill(f, jobs, device, spent)
    if timings is not None:
        for k, v in spent.items():
            timings[k] = timings.get(k, 0.0) + v
    return params, cfg


# ---------------------------------------------------------------------------
# HF transformers state dicts (safetensors checkpoint directories)
# ---------------------------------------------------------------------------


def params_from_hf_state_dict(sd: Dict, cfg: ModelConfig, dtype: torch.dtype = torch.float32,
                              device: Device = None) -> Dict:
    """A transformers Llama/Mistral/Qwen3 (``q_norm``/``k_norm``) state dict,
    or a mixture-of-experts one (``mlp.experts.N.{gate,up,down}_proj`` or
    Mixtral's ``block_sparse_moe.experts.N.{w1,w3,w2}``), as the port's
    stacked params in ``dtype`` on ``device`` (None: the CUDA device):
    [out, in] matrices transposed to [in, out], ``lm_head`` only when the
    dict has one (tied embeddings have none). Values may be torch tensors
    or numpy arrays; each is cast on the device and copied into its
    preallocated [L, ...] leaf."""
    device = resolve_device(device)

    def get(name: str, copy: bool = False) -> torch.Tensor:
        v = sd[name]
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.ascontiguousarray(v))
        return v.to(device=device, dtype=dtype, copy=copy)

    def empty(*shape):
        return torch.empty(shape, dtype=dtype, device=device)

    L, E, F, D = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    layers = {"attn_norm": empty(L, E), "ffn_norm": empty(L, E),
              "wq": empty(L, E, cfg.q_dim), "wk": empty(L, E, cfg.kv_dim),
              "wv": empty(L, E, cfg.kv_dim), "wo": empty(L, cfg.q_dim, E)}
    # leaf <- HF name within the layer, transposed
    sources = [("attn_norm", "input_layernorm", False),
               ("ffn_norm", "post_attention_layernorm", False),
               ("wq", "self_attn.q_proj", True), ("wk", "self_attn.k_proj", True),
               ("wv", "self_attn.v_proj", True), ("wo", "self_attn.o_proj", True)]
    experts = []
    if cfg.moe:
        X, Fm = cfg.num_experts, cfg.expert_dim
        layers.update(w_router=empty(L, E, X), we_gate=empty(L, X, E, Fm),
                      we_up=empty(L, X, E, Fm), we_down=empty(L, X, Fm, E))
        # qwen3_moe: mlp.gate + mlp.experts.N.{gate,up,down}_proj;
        # mixtral: block_sparse_moe.gate + its experts.N.{w1,w3,w2}
        if "model.layers.0.mlp.gate.weight" in sd:
            sources.append(("w_router", "mlp.gate", True))
            experts = [("we_gate", "mlp.experts.{}.gate_proj"),
                       ("we_up", "mlp.experts.{}.up_proj"),
                       ("we_down", "mlp.experts.{}.down_proj")]
        else:
            sources.append(("w_router", "block_sparse_moe.gate", True))
            experts = [("we_gate", "block_sparse_moe.experts.{}.w1"),
                       ("we_up", "block_sparse_moe.experts.{}.w3"),
                       ("we_down", "block_sparse_moe.experts.{}.w2")]
    else:
        layers.update(w_gate=empty(L, E, F), w_up=empty(L, E, F), w_down=empty(L, F, E))
        sources += [("w_gate", "mlp.gate_proj", True), ("w_up", "mlp.up_proj", True),
                    ("w_down", "mlp.down_proj", True)]
    if cfg.qk_norm:
        layers["q_norm"] = empty(L, D)
        layers["k_norm"] = empty(L, D)
        sources += [("q_norm", "self_attn.q_norm", False),
                    ("k_norm", "self_attn.k_norm", False)]
    for i in range(L):
        p = f"model.layers.{i}."
        for leaf, name, transpose in sources:
            w = get(f"{p}{name}.weight")
            layers[leaf][i].copy_(w.T if transpose else w)
        for leaf, name in experts:
            for j in range(cfg.num_experts):
                layers[leaf][i, j].copy_(get(f"{p}{name.format(j)}.weight").T)
    # copies: a leaf never aliases the caller's arrays or a file's map
    params = {"embed": get("model.embed_tokens.weight", copy=True), "layers": layers,
              "final_norm": get("model.norm.weight", copy=True)}
    if "lm_head.weight" in sd:
        params["lm_head"] = get("lm_head.weight").T.contiguous()
    return params


def init_serving_params(cfg: ModelConfig, generator: torch.Generator, mode: str = "int8",
                        dtype: torch.dtype = torch.bfloat16, device: Device = None) -> Dict:
    """``model.quantize_params(init_params(cfg, generator, dtype, device),
    mode=mode)`` for an MoE config, made one layer at a time: each layer's
    matrices are drawn in ``init_params``' order and quantized into
    preallocated [L, ...] serving leaves before the next layer is drawn, so
    the peak is the serving bytes plus about one layer in ``dtype`` (with
    its f32 quantization temporaries). Each leaf is quantized as a [1, ...]
    stack, which takes the stacked arithmetic of ``quantize_params``; the
    result equals it bit for bit on the same device."""
    if not cfg.moe:
        raise ValueError(f"{cfg.name} is not a mixture-of-experts config")
    device = torch.device(device) if device is not None else generator.device
    normal = _normal(generator, dtype, device)
    L, E = cfg.num_layers, cfg.hidden_size
    layers: Dict = dict(_norms(cfg, dtype, device))
    for i in range(L):
        drawn = _moe_layer(cfg, normal)
        one = model_mod.quantize_params(
            {"layers": {k: v[None] for k, v in drawn.items()}}, include_head=False,
            mode=mode)["layers"]
        del drawn
        for key, leaf in one.items():
            if i == 0:
                layers[key] = ({k: torch.empty((L, *t.shape[1:]), dtype=t.dtype, device=device)
                                for k, t in leaf.items()} if isinstance(leaf, dict)
                               else torch.empty((L, *leaf.shape[1:]), dtype=leaf.dtype,
                                                device=device))
            if isinstance(leaf, dict):
                for k, t in leaf.items():
                    layers[key][k][i].copy_(t[0])
            else:
                layers[key][i].copy_(leaf[0])
        del one
    params = {"embed": normal(cfg.vocab_size, E), "layers": layers,
              "final_norm": torch.ones(E, dtype=dtype, device=device)}
    head = params["embed"].T if cfg.tie_word_embeddings else normal(E, cfg.vocab_size)
    params["lm_head"] = model_mod.quantize_params(
        {"layers": {}, "embed": params["embed"], "lm_head": head}, mode=mode)["lm_head"]
    return params
