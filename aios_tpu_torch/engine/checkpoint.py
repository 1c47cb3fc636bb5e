"""Weight and train-state checkpoints, the port of
``aios_tpu/engine/checkpoint.py`` on the port's own storage.

Orbax is not on the card, so every tree of tensors is one safetensors file
of the port's writer (``engine/safetensors.py``), its nested keys joined by
dots (``layers.w_qkv.q``), fsync'd with its directory before anything
that names it is written:

  * serving weights: ``save_params`` writes ``params.safetensors`` into a
    directory; ``save_model_checkpoint`` adds ``aios_model.json`` (the JAX
    package's keys: ``config``, ``tokenizer``, ``serving_quantized``,
    ``prepared_tp``; ``format`` is the port's own, ``FORMAT``) and, for an
    HF tokenizer, a copy of its files under ``tokenizer/``. The metadata is
    written last, so a directory is a model checkpoint only once it is
    whole. ``python -m aios_tpu_torch.prepare_model`` makes one, and
    ``LoadModel`` restores its leaves as they are (a quantized one with no
    quantize pass);
  * train state: ``CheckpointManager`` keeps ``<step>/state.safetensors``
    per step, each written into a temporary directory that is renamed to
    its step only when whole, so a crash mid-save never becomes the
    ``latest_step``; it keeps the newest ``max_to_keep``, and, as orbax
    does, skips a save at or below the latest step.

A JAX checkpoint (``format`` ``"aios-tpu-model-v1"``, orbax's ``params/``)
is refused by name, with the command that prepares its source for the port.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Dict, List, Optional, Union

import torch

from ..device import resolve_device
from . import model as model_mod
from . import safetensors
from .config import ModelConfig
from .tokenizer import BaseTokenizer, HFTokenizer, tokenizer_from_dict, tokenizer_to_dict

PARAMS_NAME = "params.safetensors"
STATE_NAME = "state.safetensors"
MODEL_META_NAME = "aios_model.json"
FORMAT = "aios-tpu-torch-model-v1"
JAX_FORMAT = "aios-tpu-model-v1"
REPREPARE = "python -m aios_tpu_torch.prepare_model SOURCE OUT [--quantize int8|int4]"

Device = Optional[Union[str, torch.device]]


def _abs(path: str) -> str:
    return os.path.abspath(os.path.expanduser(path))


def _fsync(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write(tree: Dict, path: str) -> None:
    """``tree`` as one safetensors file at ``path``, on the disk with its
    directory entry before anything that names it (the step directory's
    rename, the model metadata) is written."""
    safetensors.save_file(_flatten(tree), path)
    _fsync(path)
    _fsync(os.path.dirname(path))


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        if "." in k:
            raise ValueError(f"checkpoint key {prefix}{k!r} holds a dot")
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        elif isinstance(v, torch.Tensor):
            out[prefix + k] = v
        elif isinstance(v, (bool, int, float)):
            out[prefix + k] = torch.tensor(v)
        else:
            raise TypeError(f"checkpoint leaf {prefix}{k} is a {type(v).__name__}")
    return out


def _unflatten(flat: Dict[str, torch.Tensor]) -> Dict:
    tree: Dict = {}
    for key, v in flat.items():
        *path, leaf = key.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _restore(flat: Dict[str, torch.Tensor], like: Any, device: Device, where: str) -> Dict:
    """The stored tree onto ``like``'s dtypes and devices (a Python number
    in ``like`` comes back as one), or, without ``like``, as stored on
    ``device`` (None: the CUDA device)."""
    if like is None:
        dev = resolve_device(device)
        return _unflatten({k: v.to(dev, copy=True) for k, v in flat.items()})
    want = _flatten(like)
    missing = sorted(set(want) - set(flat))
    if missing:
        raise KeyError(f"{where}: no {', '.join(missing[:4])} in the checkpoint")
    out = {}
    for key, ref in want.items():
        got = flat[key]
        if tuple(got.shape) != tuple(ref.shape):
            raise ValueError(f"{where}: {key} is {tuple(got.shape)}, expected "
                             f"{tuple(ref.shape)}")
        out[key] = got.to(device=ref.device, dtype=ref.dtype, copy=True)
    tree = _unflatten(out)

    def numbers(node, ref):  # Python scalars of ``like`` come back as such
        for k, r in ref.items():
            if isinstance(r, dict):
                numbers(node[k], r)
            elif isinstance(r, (bool, int, float)):
                node[k] = type(r)(node[k].item())
    numbers(tree, like)
    return tree


class CheckpointManager:
    """Step-indexed checkpoints of a tree of tensors (the train state)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = _abs(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        for name in os.listdir(self.directory):
            if name.startswith(".tmp-"):  # a save torn by an earlier crash
                shutil.rmtree(os.path.join(self.directory, name), ignore_errors=True)

    def all_steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory) if n.isdigit()
                      and os.path.isfile(os.path.join(self.directory, n, STATE_NAME)))

    def save(self, step: int, tree: Any, wait: bool = True) -> bool:
        """Write ``tree`` as step ``step``; False (nothing written) when a
        step at or above it is already saved. Writes are synchronous, so
        ``wait`` is accepted for the JAX API only."""
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        try:
            _write(tree, os.path.join(tmp, STATE_NAME))
            os.replace(tmp, os.path.join(self.directory, str(int(step))))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        _fsync(self.directory)
        if self.max_to_keep:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)
        return True

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, like: Any = None, device: Device = None):
        """A saved step (the latest by default) onto ``like``'s dtypes and
        devices, or as stored on ``device`` (None: the CUDA device)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self.directory, str(int(step)), STATE_NAME)
        return _restore(safetensors.load_file(path), like, device, path)

    def close(self) -> None:
        """Nothing is pending: every save is complete when it returns."""


def save_params(directory: str, params: Dict) -> None:
    """One-shot serving-weight checkpoint (no step indexing)."""
    directory = _abs(directory)
    os.makedirs(directory, exist_ok=True)
    _write(params, os.path.join(directory, PARAMS_NAME))


def load_params(directory: str, like: Any = None, device: Device = None) -> Dict:
    """Serving weights onto ``like``'s dtypes and devices, or as stored on
    ``device`` (None: the CUDA device)."""
    path = os.path.join(_abs(directory), PARAMS_NAME)
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    return _restore(safetensors.load_file(path), like, device, path)


def is_checkpoint_dir(path: str) -> bool:
    return os.path.isfile(os.path.join(_abs(path), PARAMS_NAME))


def _unservable_int4(params: Dict) -> List[str]:
    """int4 leaves K5's launch contract refuses: the stored group (K over
    the scales' groups, not ``pick_group(K)``) must be 128 and N % 16 == 0."""
    from ..ops.int4_matmul import kernel_supported

    leaves = {**params["layers"], "lm_head": params.get("lm_head")}
    return [key for key, v in leaves.items() if isinstance(v, dict) and "q4" in v
            for K, N in ((v["q4"].shape[-2] * 2, v["q4"].shape[-1]),)
            if not kernel_supported(K, N, K // v["s4"].shape[-3])]


def save_model_checkpoint(directory: str, cfg: ModelConfig, params: Dict,
                          tokenizer: BaseTokenizer, tp: int = 1) -> None:
    """Params, config and tokenizer in one directory (the port's prepared
    checkpoint). Refuses int4 leaves that K5 cannot serve before anything
    is written, and a tensor-parallel layout (``tp`` > 1)."""
    if tp != 1:
        raise ValueError(f"prepared_tp {tp}: the tensor-parallel layout waits for the "
                         "port of parallel/ (ROADMAP Queue 1); the port prepares tp=1")
    quantized = model_mod.quantized_mode(params)
    if quantized == "int4":
        bad = _unservable_int4(params)
        if bad:
            raise ValueError(
                "refusing to persist int4 leaves the CUDA int4 kernel cannot serve "
                f"({', '.join(bad)}): quantize with quantize_params(..., target='cuda') "
                "(prepare_model does this) so that ineligible dims fall back to int8")
    directory = _abs(directory)
    os.makedirs(directory, exist_ok=True)
    meta_path = os.path.join(directory, MODEL_META_NAME)
    if os.path.exists(meta_path):  # a half-rewritten directory is no checkpoint
        os.remove(meta_path)
    save_params(directory, params)
    if isinstance(tokenizer, HFTokenizer):
        # self-contained: the HF tokenizer's files travel with the weights
        tokenizer.save(os.path.join(directory, "tokenizer"))
        tok_meta = {"type": "hf", "path": "tokenizer"}
    else:
        tok_meta = tokenizer_to_dict(tokenizer)
    meta = {"format": FORMAT, "config": dataclasses.asdict(cfg), "tokenizer": tok_meta,
            "serving_quantized": quantized, "prepared_tp": 1}
    tmp = meta_path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(meta, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, meta_path)
    _fsync(directory)


def _meta(directory: str) -> Optional[dict]:
    path = os.path.join(_abs(directory), MODEL_META_NAME)
    if not os.path.isfile(path):
        return None
    with open(path) as fh:
        return json.load(fh)


def is_model_checkpoint(path: str) -> bool:
    """A prepared checkpoint of either package: its metadata names a format
    (``load_model_checkpoint`` refuses the JAX one by name)."""
    meta = _meta(path)
    return meta is not None and "format" in meta


def load_model_checkpoint(directory: str, device: Device = None):
    """(cfg, params, tokenizer) from a prepared model directory, the params
    as stored on ``device`` (None: the CUDA device)."""
    directory = _abs(directory)
    meta = _meta(directory)
    if meta is None:
        raise FileNotFoundError(os.path.join(directory, MODEL_META_NAME))
    if meta.get("format") != FORMAT:
        raise ValueError(
            f"{directory} is a {meta.get('format')!r} checkpoint"
            + (" (the JAX package's, orbax-backed)" if meta.get("format") == JAX_FORMAT
               else "")
            + f", which the PyTorch port does not read; prepare its source for the port: "
            f"{REPREPARE}")
    cfg = ModelConfig(**meta["config"])
    params = load_params(directory, device=device)
    tok_meta = dict(meta["tokenizer"])
    if tok_meta.get("type") == "hf" and not os.path.isabs(tok_meta.get("path", "")):
        tok_meta["path"] = os.path.join(directory, tok_meta["path"])
    return cfg, params, tokenizer_from_dict(tok_meta)
