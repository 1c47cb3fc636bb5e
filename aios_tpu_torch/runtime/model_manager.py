"""Model lifecycle and intelligence-level routing for the PyTorch runtime.

The port of ``aios_tpu/runtime/model_manager.py``: a model is a
``ReplicaPool`` (``serving/``) of ``TorchEngine`` + ``ContinuousBatcher``
replicas with a tokenizer, in one of the states loading/ready/error/
unloading, and requests resolve by exact or partial name or by the
reference's intelligence-level ladders. ``ManagedModel.submit`` goes through
the pool: admission, cache-aware routing, one replica's batcher, failover.

Replicas: ``ServingConfig.from_env`` is read once per ``LoadModel``
(``AIOS_TPU_REPLICAS``, quotas, queue bound, deadlines, failover); replica 0
quantizes the weights and replicas 1..N-1 are built over its serving
leaves, so the replicas of one card share one copy of the weights, while
each owns its page pool, prefix index, CUDA graphs and graph stream. A
``LoadModel`` of a READY name with another source, context or replica
count hot-swaps it: the new pool serves at once and the old one drains on
a thread, then frees its memory; a failed reload keeps the READY entry
serving. A CUDA error in any replica's scheduler is not a crash the pool
respawns: the card's context is poisoned, so the model goes to ``error``
and its requests end without a retry hint.

Memory budget: each load estimates what it pins on the card as the JAX
manager does (serving weights, dense leaves times the quantization factor,
plus each replica's KV pool), against 0.85 of the card's memory
(``AIOS_TPU_HBM_GB``, else ``torch.cuda.mem_get_info``'s total; the JAX
default of 16 GB on the CPU or where neither can be read) less the
co-resident models (a still-READY same-name entry during a hot swap
included), and warns when over budget; one card has no sp axis to shard
the cache over. Unlike the JAX replicas, the port's share their weights, so
the weights count once. ``hbm_chip_bytes``, which later loads are budgeted
against, also adds each replica's admission graph pool as measured after
its captures, memory the JAX estimate does not see (687,865,856 B for
TinyLlama, 9,114,222,592 B for Mistral-7B on the card). Before the load the
budget also counts that pool's largest transient, estimated from the
shapes (``admission_bytes``: the f32 logits of the largest whole-prompt
bucket and, for a mixture-of-experts model, the dense expert path's
intermediates over one slice of its rows), and an ``auto`` pool that would leave no
room for it is cut down to the rows that do fit (with a warning; never
below one slot's context).

Serving defaults: int8 weights on CUDA (dense on the CPU, where int8 would
only add a dequantize to every matmul), a bf16 KV cache, and a paged pool
sized ``auto`` = (num_slots + 1) x context rows in pages of 128 rows.
``quantize`` ("int8", "int4", or False for dense) and ``kv_cache`` ("bf16"
or "int8") override them; left as None they come from the JAX stack's
variables ``AIOS_TPU_QUANTIZE`` and ``AIOS_TPU_KV_CACHE``, which its boot
config sets from the ``[models]`` keys ``quantize`` and ``kv_cache``.
``paged_kv`` is "auto", a row count, or "off"/0 for the dense slot cache;
None reads ``AIOS_TPU_PAGED_KV`` as the JAX stack parses it and, where that
is unset, stays at ``auto``, the JAX boot config's default (the JAX
``ModelManager`` alone would serve dense there). A context the pool cannot
page (not a multiple of 16, or an int8 cache and not a multiple of 128) is
served from the dense cache. Over the pool the prompt-prefix index is on
(``prefix_cache``; None reads ``AIOS_TPU_PREFIX_CACHE``, on unless 0/false/
off, as the JAX ``ModelManager`` does), a radix tree unless
``AIOS_TPU_PREFIX_RADIX`` is 0, and every batcher admits a prompt longer
than 512 tokens in 512-token chunks with decode dispatches between them.
``AIOS_TPU_PREFIX_HOST_BYTES`` (else the config's ``prefix_host_bytes``; off
by default) gives each replica's index a host-RAM tier of that many bytes of
its own, and ``AIOS_TPU_HOST_RESTORE_MIN_PAGES`` its restore floor; an
invalid value warns and is ignored, as in the JAX manager. The tier's device
staging counts in the budget. The decode loop's knobs are read by each
engine and batcher as the JAX stack reads them: ``AIOS_TPU_DECODE_PIPELINE``
(the pipelined loop), ``AIOS_TPU_UNIFIED_STEP``, ``AIOS_TPU_MEGA_TICKS``
(the megagraph; its buckets are captured at load) and window+sink
compression's ``AIOS_TPU_KV_COMPRESS_AFTER``, ``AIOS_TPU_KV_SINK_PAGES`` and
``AIOS_TPU_KV_WINDOW_PAGES`` (logged when armed). Each serving knob of the
JAX stack that the port does not honour yet (``UNPORTED_KNOBS``: the
fleet's, multihost's and the sequence-parallel ones) and that is set logs a
warning naming it; so does each knob that does not carry over to the port
(``NOT_CARRIED_KNOBS``: the Pallas and crossover gates), with its reason.
``speculative`` turns on speculative decode
dispatches over either cache (None reads ``AIOS_TPU_SPECULATIVE``). A model
paired with a draft (``AIOS_TPU_DRAFT_MODEL``, else the config's
``draft_model``: a preset name such as ``tinyllama``, a ``.gguf`` path or a
directory)
serves speculatively whatever that knob says, through the batcher's ladder
draft -> n-gram: the draft is loaded once as an int4 ``spec.DraftModel``
shared read-only by the replicas, each of which keeps its own dense draft
cache; its weights count once in the budget and its cache once per replica.
A pairing that cannot serve (an unknown source, a file or directory that
does not load, another vocabulary or tokenizer, a geometry no kernel takes)
logs and serves with n-gram speculation, as the JAX manager does; a
CUDA error while the draft loads propagates.
Every batcher knows its model's tokenizer and so serves grammar-constrained
requests (``json_schema``, ``json_mode``); under ``AIOS_TPU_JSON_MODE=force``
(``json_mode_forced``) ``LoadModel`` also captures the masked step's graph
and the jump graphs, since every non-streaming Infer is then constrained.
``synthetic://<preset>`` sources build random weights on the target device
from a seeded generator (a mixture-of-experts preset with quantized serving
one layer at a time straight into its serving leaves,
``weights.init_serving_params``, so that Qwen3-30B-A3B never holds its
61 GB bf16 tree); presets resolve by ``resolve_preset``, the JAX manager's
order; a ``.gguf`` path loads the file's weights
(``weights.params_from_gguf``), its config from the metadata and its own
tokenizer (SentencePiece or byte-level BPE, bytes when it carries none), as
the JAX manager does; a directory is a prepared checkpoint
(``prepare_model``: its leaves restored as stored, so an int8 or int4 one
skips the quantize pass, ``quantize_seconds`` 0) or else an HF checkpoint
directory (``config.json``, ``*.safetensors`` read by the port's own
reader, cast to bf16 on the device, and ``HFTokenizer`` on its
``tokenizer.json``). ``autoload`` scans ``AIOS_MODEL_DIR`` for ``*.gguf`` at
startup, naming each model by its file stem and sizing its context by file
size. On CUDA a model lists READY only once its engine
has built its kernels and captured the CUDA graphs its batcher dispatches
(``TorchEngine.warmup``, the batcher's attach); a failed build or capture
leaves it in ``error`` and fails ``LoadModel``, as does a file that does
not parse, a ggml type with no dequantizer or a geometry no kernel takes
(a mixture-of-experts model's expert stacks included). With
``AIOS_TPU_AUTOSCALE`` each pool gets the SLO autoscaler
(``serving/autoscale.py``), whose scale-ups share replica 0's weights.
"""

from __future__ import annotations

import json
import logging
import os
import resource
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Union

import torch

from ..analysis.locks import make_lock
from ..device import DEVICE_FAULT_REASON, is_device_fault, resolve_device
from ..engine import checkpoint as ckpt_mod
from ..engine import model as model_mod
from ..engine import spec as spec_mod
from ..engine.batching import ContinuousBatcher
from ..engine.config import PRESETS, TINY_MOE, TINY_TEST, ModelConfig, from_hf_config
from ..engine.engine import DEFAULT_BUCKETS, SPILL_STAGING_BYTES, TorchEngine
from ..engine.gguf import GGUFFile
from ..engine.moe import DENSE_TOKEN_CHUNK
from ..engine.safetensors import load_dir
from ..engine.tokenizer import BaseTokenizer, ByteTokenizer, HFTokenizer, gguf_tokenizer
from ..engine.weights import (init_params, init_serving_params, params_from_gguf,
                              params_from_hf_state_dict)
from ..serving import ReplicaPool, ServingConfig

log = logging.getLogger("aios.torch.runtime.models")

STATE_LOADING = "loading"
STATE_READY = "ready"
STATE_ERROR = "error"
STATE_UNLOADING = "unloading"

# Routing ladders per intelligence level (the reference's model_manager.rs).
LEVEL_LADDERS: Dict[str, List[str]] = {
    "reactive": [],
    "operational": ["tinyllama", "deepseek", "mistral"],
    "tactical": ["deepseek", "qwen3", "mistral", "tinyllama"],
    "strategic": ["qwen3", "deepseek", "mistral"],
}

PAGE_SIZE = 128

# Serving knobs that the JAX stack honours and the port does not yet: each one
# that is set logs a warning naming it when a ModelManager is built. A slice
# that ports a knob deletes it here. A name ending in "*" is a prefix. Every
# row of docs/CONFIG.md is read by the port or named here or in
# NOT_CARRIED_KNOBS (the analyzer's knob-docs rule).
UNPORTED_KNOBS = (
    # multi-card serving and sequence-parallel prefill (parallel/)
    "AIOS_TPU_SEQ_PREFILL_MIN", "AIOS_TPU_MESH", "AIOS_TPU_SEQ_PREFILL_IMPL",
    "AIOS_TPU_SEQ_SHARD_KV",
    # multihost process groups
    "AIOS_TPU_COORDINATOR", "AIOS_TPU_MULTIHOST", "AIOS_TPU_NUM_PROCESSES",
    "AIOS_TPU_PROCESS_ID",
)

# Knobs of the JAX stack that do not carry over to the port, each with its
# reason: they pick between a Pallas kernel and an XLA path, and the port has
# one hand-written kernel per path and no switch. Each one that is set logs a
# warning naming it and its reason when a ModelManager is built.
NOT_CARRIED_KNOBS = {
    "AIOS_TPU_NO_PALLAS": "it forces the JAX reference kernels; the port has no kernel "
                          "switch (call a *_reference function by name for the plain path)",
    "AIOS_TPU_PALLAS_QMM": "it picks the Pallas int8 matmul over XLA's mixed dot; every "
                           "int8 projection of the port runs its own kernel",
    "AIOS_TPU_RAGGED_MIN_C": "it is the cache length where the ragged Pallas decode kernel "
                             "beats XLA's fused read; every decode of the port runs its own "
                             "kernel",
    "AIOS_TPU_INT8_RAGGED": "it routes int8-KV decode through the ragged Pallas kernels; "
                            "the port's int8 decode always runs its own kernels",
}


def _set(knobs) -> List[str]:
    """The names among ``knobs`` that are set (non-empty), sorted; a name
    ending in "*" is a prefix."""
    found = set()
    for name, value in os.environ.items():
        if not value:
            continue
        for knob in knobs:
            if name == knob or (knob.endswith("*") and name.startswith(knob[:-1])):
                found.add(name)
    return sorted(found)


def unported_knobs_set() -> List[str]:
    """The names in ``UNPORTED_KNOBS`` that are set (non-empty), sorted."""
    return _set(UNPORTED_KNOBS)


def not_carried_knobs_set() -> List[str]:
    """The names in ``NOT_CARRIED_KNOBS`` that are set (non-empty), sorted."""
    return _set(NOT_CARRIED_KNOBS)


def _env_int(name: str, least: int) -> Optional[int]:
    """A non-negative integer knob the JAX manager's way: unset is None, a
    value that is not a number or is below ``least`` logs a warning and is
    ignored (None); ``1e9`` reads as 10**9."""
    raw = os.environ.get(name, "")
    if not raw:
        return None
    try:
        v = int(float(raw))
        if v < least:
            raise ValueError(f"must be >= {least}")
        return v
    except ValueError:
        log.warning("%s=%r ignored (expected an integer >= %d)", name, raw, least)
        return None


def json_mode_forced() -> bool:
    """AIOS_TPU_JSON_MODE=force: every non-streaming Infer is grammar-
    constrained to one JSON object (the reference's response_format
    behaviour); read by the service per request and here at load."""
    return os.environ.get("AIOS_TPU_JSON_MODE", "").lower() in ("force", "1", "on")


@dataclass
class ManagedModel:
    name: str
    config: ModelConfig
    # replica 0's engine and batcher, for single-replica callers and
    # HealthCheck; the POOL is the serving entry point
    engine: Optional[TorchEngine]
    batcher: Optional[ContinuousBatcher]
    tokenizer: BaseTokenizer
    state: str = STATE_LOADING
    loaded_at: int = 0
    last_used: int = 0
    request_count: int = 0
    error: str = ""
    model_path: str = ""
    context_length: int = 0
    # seconds of the load: dequantize_s (parse and dequantize), upload_s,
    # init_s (a synthetic MoE model made in its serving leaves), quantize_s
    # and capture_s (every replica's captures)
    load_timings: Dict[str, float] = field(default_factory=dict)
    # estimated card memory this model pins (weights, KV pools, admission
    # graph pools, the draft's weights and caches); co-resident loads are
    # budgeted against it
    hbm_chip_bytes: float = 0.0
    # the paired draft's part of it: its weights once, its bf16 cache once
    # a replica (0 without a draft)
    draft_chip_bytes: float = 0.0
    # the replica pool fronting this model; None only for error entries
    pool: Optional[ReplicaPool] = None

    def touch(self) -> None:
        self.last_used = int(time.time())
        self.request_count += 1

    def submit(self, req, tenant: str = "anonymous", deadline_s: Optional[float] = None):
        """Serving entry point: through the pool (admission, routing,
        failover). Raises serving.AdmissionError when the request is shed."""
        return self.pool.submit(req, tenant=tenant, deadline_s=deadline_s)


def _bf16_dense(tree):
    """Every dense floating leaf in bf16, the serving dtype of every source
    (a checkpoint prepared with ``--dtype f32`` included); quantized leaves
    ({"q", "s"}, {"q4", "s4"}) as they are."""
    if isinstance(tree, dict):
        if "q" in tree or "q4" in tree:
            return tree
        return {k: _bf16_dense(v) for k, v in tree.items()}
    return tree.to(torch.bfloat16) if tree.is_floating_point() else tree


def _context_for_file_size(n_bytes: int) -> int:
    """Context length by GGUF file size, as the reference's auto-loader
    chooses ctx/threads (runtime/src/main.rs:86-98)."""
    gb = n_bytes / 1e9
    if gb > 8:
        return 8192
    if gb > 2:
        return 4096
    return 2048


def resolve_preset(name: str) -> ModelConfig:
    """A preset by name, as the JAX manager's ``_resolve_preset`` resolves
    it: the tiny test configs, then an exact preset name, and only then the
    first preset that contains the name, is contained in it or shares its
    family (``qwen3`` is Qwen3-14B, but ``qwen3-30b-a3b`` is itself)."""
    low = name.lower()
    if low in ("tiny-test", "tiny"):
        return TINY_TEST
    if low == "tiny-moe":
        return TINY_MOE
    if low in PRESETS:  # an exact name wins before any fuzzy match
        return PRESETS[low]
    for key, cfg in PRESETS.items():
        if low in key or key in low or key.split("-")[0] in low:
            return cfg
    raise KeyError(f"no preset matches {name!r}")


def _quantize_mode(quantize: Union[bool, str, None], device: torch.device):
    """The serving weight mode: "int8", "int4" or False (dense); None reads
    the JAX stack's variable, then defaults by device."""
    if quantize is None:
        env = os.environ.get("AIOS_TPU_QUANTIZE", "").lower()
        if env in ("0", "false", "off"):
            return False
        if env in ("1", "true", "int8"):
            return "int8"
        if env == "int4":
            return "int4"
        if env:
            log.warning("unrecognized AIOS_TPU_QUANTIZE=%r (expected 0/1/int8/"
                        "int4); using the auto default", env)
        return "int8" if device.type == "cuda" else False
    if quantize not in (False, "int8", "int4"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    return quantize


def _paged_rows(paged_kv: Union[int, str, None]) -> Union[int, str, None]:
    """The pool's size: "auto", a positive row count, or None for the dense
    slot cache. ``paged_kv`` None reads AIOS_TPU_PAGED_KV with the JAX
    stack's parsing (anything unrecognized warns and serves dense), and
    unset means "auto"."""
    from_env = paged_kv is None
    if from_env:
        paged_kv = os.environ.get("AIOS_TPU_PAGED_KV", "").lower() or "auto"
    if isinstance(paged_kv, str):
        low = paged_kv.lower()
        if low == "auto":
            return "auto"
        if low in ("0", "off", "false"):
            return None
        try:
            rows = int(low)
        except ValueError:
            rows = -1
    else:
        rows = int(paged_kv)
        if rows == 0:
            return None
    if rows > 0:
        return rows
    if not from_env:
        raise ValueError(f"unknown paged_kv {paged_kv!r} (expected a positive row "
                         "count, 'auto', or 0/'off')")
    log.warning("AIOS_TPU_PAGED_KV=%r ignored (expected a positive row count, "
                "'auto', or 0/off)", paged_kv)
    return None


def _chip_hbm_bytes(device: torch.device) -> float:
    """The card's memory: AIOS_TPU_HBM_GB, else the CUDA device's total,
    else the JAX manager's default (16 GB), which the CPU takes."""
    env = os.environ.get("AIOS_TPU_HBM_GB", "")
    if env:
        try:
            return float(env) * 1e9
        except ValueError:
            log.warning("AIOS_TPU_HBM_GB=%r ignored (not a number)", env)
    if device.type == "cuda":
        return float(torch.cuda.mem_get_info(device)[1])
    return 16e9


def _kv_row_bytes(cfg: ModelConfig, cache_dtype: torch.dtype) -> float:
    """Bytes one KV row (k and v, every layer) takes."""
    item = 1 if cache_dtype == torch.int8 else 2
    return 2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim * item


def admission_bytes(cfg: ModelConfig, ctx: int) -> float:
    """The transient peak of the largest whole-prompt prefill the engine
    captures at context ``ctx`` (its bucket N, the largest of
    ``DEFAULT_BUCKETS`` up to ``ctx``), estimated from the shapes: the
    logits (the lm_head's bf16 [N, V] and their f32 copy), the prompt's K/V
    rows of every layer twice (the per-layer rows and their stack) and, for
    a mixture-of-experts model, the dense expert path's peak over one slice
    of ``moe.DENSE_TOKEN_CHUNK`` rows (the fused gate|up output [X, n, 2F]
    bf16, its f32 gate copy and the bf16 product [X, n, F]). They add up: a
    graph's private pool keeps blocks of every size it has held."""
    N = max((b for b in DEFAULT_BUCKETS if b <= ctx), default=ctx)
    logits = N * cfg.vocab_size * (2 + 4)
    n = min(N, DENSE_TOKEN_CHUNK)
    experts = cfg.num_experts * n * cfg.expert_dim * (4 + 4 + 2) if cfg.moe else 0
    kv = 2 * 2 * cfg.num_layers * N * cfg.num_kv_heads * cfg.head_dim * 2
    return float(logits + experts + kv)


def _cache_dtype(kv_cache: Optional[str]) -> torch.dtype:
    """The KV pool's dtype: bf16 by default, int8 on request."""
    if kv_cache is None:
        env = os.environ.get("AIOS_TPU_KV_CACHE", "").lower()
        if env == "int8":
            return torch.int8
        if env and env not in ("bf16", "bfloat16"):
            log.warning("unrecognized AIOS_TPU_KV_CACHE=%r (expected 'int8'); "
                        "using bf16", env)
        return torch.bfloat16
    if kv_cache not in ("int8", "bf16", "bfloat16"):
        raise ValueError(f"unknown kv_cache {kv_cache!r} (expected 'bf16' or 'int8')")
    return torch.int8 if kv_cache == "int8" else torch.bfloat16


class ModelManager:
    """Registry of co-resident models on one device."""

    def __init__(self, num_slots: int = 8,
                 device: Optional[Union[str, torch.device]] = None,
                 quantize: Union[bool, str, None] = None,
                 kv_cache: Optional[str] = None,
                 paged_kv: Union[int, str, None] = None,
                 speculative: Optional[bool] = None,
                 prefix_cache: Optional[bool] = None) -> None:
        self.device = resolve_device(device)
        self.models: Dict[str, ManagedModel] = {}
        self.num_slots = num_slots
        self.quantize = _quantize_mode(quantize, self.device)
        self.cache_dtype = _cache_dtype(kv_cache)
        self.paged_pool_rows = _paged_rows(paged_kv)
        if speculative is None:
            speculative = os.environ.get(
                "AIOS_TPU_SPECULATIVE", "").lower() in ("1", "true", "on")
        self.speculative = bool(speculative)
        if prefix_cache is None:
            prefix_cache = os.environ.get("AIOS_TPU_PREFIX_CACHE", "1").lower() not in (
                "0", "false", "off")
        self.prefix_cache = bool(prefix_cache)
        # the prefix cache's host tier: AIOS_TPU_PREFIX_HOST_BYTES (None
        # defers to the model config's prefix_host_bytes; 0 forces it off)
        # and the restore floor AIOS_TPU_HOST_RESTORE_MIN_PAGES (default 1)
        self.prefix_host_bytes = _env_int("AIOS_TPU_PREFIX_HOST_BYTES", 0)
        self.host_restore_min_pages = _env_int("AIOS_TPU_HOST_RESTORE_MIN_PAGES", 1)
        for knob in unported_knobs_set():
            log.warning("%s is set but the PyTorch port does not honour it yet; serving "
                        "without it", knob)
        for knob in not_carried_knobs_set():
            log.warning("%s is set but does not carry over to the PyTorch port (%s); "
                        "serving without it", knob, NOT_CARRIED_KNOBS[knob])
        self._lock = make_lock("model_manager")
        self._loading = threading.local()  # the timings of this thread's load

    @property
    def backend(self) -> str:
        return f"torch-{self.device.type}"

    # -- loading ----------------------------------------------------------------

    def load_model(self, name: str, path: str = "", context_length: int = 0) -> ManagedModel:
        with self._lock:
            existing = self.models.get(name)
        if existing is not None and existing.state == STATE_READY:
            want = ServingConfig.from_env(existing.config.replicas).replicas
            have = len(existing.pool.replicas)
            if (existing.model_path == path
                    and existing.context_length == (context_length or 0)
                    and have == want):
                return existing
            # another source, geometry or replica count: build the new pool,
            # swap it in, and drain the old one in the background
            log.info("%s: reload with changed config; hot-swapping the pool", name)
        t0 = time.time()
        timings: Dict[str, float] = {}
        self._loading.timings = timings
        try:
            cfg, params, tokenizer = self._load_weights(name, path, context_length)
            serving_cfg = ServingConfig.from_env(cfg.replicas,
                                                 draft_model_default=cfg.draft_model)
            n_replicas = max(1, serving_cfg.replicas)
            ctx = context_length or cfg.max_context
            # a paired draft is loaded once (its leaves shared by every
            # replica engine, each with its own dense draft cache) and
            # implies speculative serving: the draft exists for nothing else
            draft, spec_on, draft_bytes = None, self.speculative, 0.0
            if serving_cfg.draft_model:
                draft = self._build_draft(serving_cfg.draft_model, cfg, ctx, tokenizer)
                if draft is not None:
                    spec_on = True
                    draft_bytes = (draft.weight_bytes() + _kv_row_bytes(
                        draft.cfg, torch.bfloat16) * self.num_slots * ctx * n_replicas)
            kw = {}  # empty: the dense slot cache
            rows = self.paged_pool_rows
            if rows is not None:
                if rows == "auto":
                    rows = (self.num_slots + 1) * ctx
                int8 = self.cache_dtype == torch.int8
                # the host tier: the variable wins over the model config
                host_bytes = self.prefix_host_bytes
                if host_bytes is None:
                    host_bytes = cfg.prefix_host_bytes
                tier = dict(prefix_host_bytes=host_bytes,
                            host_restore_min_pages=self.host_restore_min_pages)
                if ctx % PAGE_SIZE == 0:
                    kw = dict(paged_pool_rows=rows, page_size=PAGE_SIZE,
                              prefix_cache=self.prefix_cache, **tier)
                elif ctx % 16 == 0 and not int8:
                    kw = dict(paged_pool_rows=rows, page_size=16,
                              prefix_cache=self.prefix_cache, **tier)
                else:
                    log.warning("AIOS_TPU_PAGED_KV ignored for %s: context %d needs "
                                "a multiple of %d; serving dense", name, ctx,
                                PAGE_SIZE if int8 else 16)
            weight_bytes, kv_bytes = self._budget(name, cfg, params, ctx, kw, n_replicas,
                                                  draft_bytes,
                                                  auto=self.paged_pool_rows == "auto")
            # the batcher's admission chunk: warmup captures its graphs, and
            # with forced JSON mode the masked step and the jump buckets
            chunk = TorchEngine.prefill_chunk_default
            engines: List[TorchEngine] = []
            try:
                for i in range(n_replicas):
                    # replica 0 makes the serving leaves; the others are
                    # built over them (quantize=None over quantized leaves),
                    # so the replicas share one copy of the weights
                    engine = TorchEngine(
                        cfg, params if i == 0 else engines[0].params,
                        num_slots=self.num_slots,
                        max_context=ctx,
                        cache_dtype=self.cache_dtype,
                        quantize=self.quantize if i == 0 else None,
                        track_history=spec_on,
                        device=self.device,
                        draft=draft,
                        **kw,
                    )
                    if i == 0:
                        del params  # the dense leaves, once quantized
                    engine.warmup(prefill_chunk=chunk, masked_step=json_mode_forced())
                    engines.append(engine)
            except BaseException:
                # a failed replica must not strand its siblings' memory
                for e in engines:
                    e.close()
                raise
            timings.update(quantize_s=engines[0].quantize_seconds,
                           capture_s=sum(e.graphs.capture_seconds for e in engines))
            # the engines resolve the compression knobs (a variable over the
            # config): the load log is where an operator sees the policy
            if engines[0].kv_compress_armed:
                log.info("%s: window+sink KV compression armed (threshold %d rows; %d sink "
                         "+ %d window pages/slot)", name, engines[0].kv_compress_after,
                         engines[0].kv_sink_pages, engines[0].kv_window_pages)

            def batcher_factory(eng, _tok=tokenizer, _spec=spec_on, _chunk=chunk):
                # the pool's spawn and crash-respawn path; the ladder reads
                # eng.draft, so a respawned replica keeps its draft rung
                return ContinuousBatcher(eng, speculative=_spec, prefill_chunk=_chunk,
                                         tokenizer=_tok)

            try:
                pool = ReplicaPool(name, engines, batcher_factory, serving_cfg)
            except BaseException:
                # the pool shuts its partial batchers down; the engines are ours
                for e in engines:
                    e.close()
                raise
            engine = engines[0]
            managed = ManagedModel(
                name=name,
                config=cfg,
                engine=engine,
                batcher=pool.replicas[0].batcher,
                tokenizer=tokenizer,
                state=STATE_READY,
                loaded_at=int(time.time()),
                model_path=path,
                context_length=context_length or 0,
                load_timings=timings,
                # one copy of the weights, a KV pool and an admission graph
                # pool (measured) per replica; the draft's weights once, its
                # cache and ingest graph pool (measured) per replica
                hbm_chip_bytes=weight_bytes + kv_bytes * n_replicas + draft_bytes
                + sum(e.admission_pool_bytes + e.draft_pool_bytes + e.host_staging_bytes()
                      for e in engines),
                draft_chip_bytes=draft_bytes,
                pool=pool,
            )

            def _sync_batcher(idx, b, _m=managed):
                # keep the replica-0 snapshot fresh across crash-respawns
                if idx == 0:
                    _m.batcher = b

            pool.on_respawn = _sync_batcher
            pool.on_device_fault = lambda exc, _m=managed: self._device_lost(_m, exc)
            # the SLO autoscaler (AIOS_TPU_AUTOSCALE): a per-pool controller
            # scales replicas off the windowed burn rate and walks the
            # degrade ladder at the ceiling. Its engines are built over
            # replica 0's live serving leaves, so a scale-up adds only its
            # own pool and graphs; the controller builds and warms them
            # outside every pool lock (each engine captures on its own
            # stream while the other replicas replay)
            from ..serving.autoscale import AutoscaleController
            from ..serving.autoscale import enabled as autoscale_enabled

            if autoscale_enabled():
                def engine_factory(_cfg=cfg, _ctx=ctx, _kw=kw, _spec=spec_on,
                                   _draft=draft, _pool=pool, _chunk=chunk):
                    eng = TorchEngine(
                        _cfg, _pool.replicas[0].engine.params,
                        num_slots=self.num_slots, max_context=_ctx,
                        cache_dtype=self.cache_dtype, quantize=None,
                        track_history=_spec, device=self.device, draft=_draft, **_kw,
                    )
                    eng.warmup(prefill_chunk=_chunk, masked_step=json_mode_forced())
                    return eng

                AutoscaleController(pool, engine_factory=engine_factory, start=True)
                log.info("%s: SLO autoscaler attached (ceiling %d replicas)", name,
                         pool.autoscaler.cfg.max_replicas)
        except Exception as exc:
            # a failed hot swap must not clobber the model still serving:
            # keep the READY entry; register an error entry only when there
            # was nothing working to preserve
            with self._lock:
                cur = self.models.get(name)
                if cur is None or cur.state != STATE_READY:
                    self.models[name] = ManagedModel(
                        name=name, config=TINY_TEST, engine=None, batcher=None,
                        tokenizer=ByteTokenizer(), state=STATE_ERROR, error=str(exc),
                    )
            if cur is not None and cur.state == STATE_READY:
                log.error("model %s reload failed (%s); the previous pool keeps "
                          "serving", name, exc)
            else:
                log.error("model %s failed to load: %s", name, exc)
            raise
        with self._lock:
            old = self.models.get(name)
            self.models[name] = managed
        if old is not None and old is not managed and old.state == STATE_READY:
            self._retire_async(old)
        pool_bytes = sum(t.numel() * t.element_size() for t in
                         (engine.k_pool, engine.v_pool, engine.k_scales, engine.v_scales)
                         if t is not None)
        log.info("model %s ready in %.1fs (ctx=%d, %d slots, %d replica%s sharing one copy "
                 "of the weights, %s, weights %s, "
                 "%s %s of %d B a replica, prefix index %s (host tier %s), "
                 "chunked admission %s, "
                 "speculative %s (proposers %s; draft %s: %d B of weights, a %d B cache "
                 "and %d graphs a replica, ingest pool %d B), "
                 "%d graphs captured a replica (%d of admission, in a shared pool of %d B), "
                 "split workspace %d B a stream; budgeted %d B; parse and dequantize %.2fs, "
                 "upload %.2fs, quantize %.2fs, capture %.2fs, process peak RSS %d MB)", name,
                 time.time() - t0, ctx, self.num_slots, n_replicas,
                 "" if n_replicas == 1 else "s", self.device,
                 self.quantize or "dense", self.cache_dtype,
                 "page pool" if engine.paged else "dense cache", pool_bytes,
                 type(engine.prefix_index).__name__ if engine.prefix_index else "off",
                 f"{engine.host_store.max_bytes} B, device staging up to "
                 f"{engine.host_staging_bytes()} B, restore floor "
                 f"{engine.host_restore_min_pages} page(s)"
                 if engine.host_store is not None else "off",
                 managed.batcher.prefill_chunk or "off", managed.batcher.speculative,
                 "/".join(managed.batcher.spec_proposers),
                 draft.cfg.name if draft is not None else "none",
                 draft.weight_bytes() if draft is not None else 0,
                 sum(t.numel() * t.element_size() for t in engine.draft_state.values())
                 if engine.draft_state is not None else 0,
                 engine.draft_graphs(), engine.draft_pool_bytes,
                 engine.graphs.captures, engine.admission_graphs(),
                 engine.admission_pool_bytes, engine.workspace_bytes(),
                 int(managed.hbm_chip_bytes),
                 timings.get("dequantize_s", 0.0), timings.get("upload_s", 0.0),
                 timings["quantize_s"], timings["capture_s"],
                 resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024)
        return managed

    def _budget(self, name: str, cfg: ModelConfig, params, ctx: int, kw: dict,
                n_replicas: int, draft_bytes: float = 0.0, auto: bool = False):
        """The JAX manager's per-chip estimate for this load, (serving weight
        bytes, one replica's KV bytes), and its warning when they do not fit
        0.85 of the card beside the co-resident models, the paired draft's
        ``draft_bytes`` and each replica's admission transient
        (``admission_bytes``). The replicas share the weights, so those
        count once. An ``auto`` pool (``kw["paged_pool_rows"]``) that does
        not fit is cut, in place, to the whole pages that do, never below
        one slot's context."""
        factor = 1.0 if model_mod.is_quantized(params) else {
            "int8": 0.5, "int4": 0.25}.get(self.quantize, 1.0)
        weight_bytes = model_mod.serving_weight_bytes(params) * factor
        row_bytes = _kv_row_bytes(cfg, self.cache_dtype)
        transient = admission_bytes(cfg, ctx) * n_replicas
        with self._lock:
            resident = sum(mm.hbm_chip_bytes for mm in self.models.values()
                           if mm.name != name or mm.state == STATE_READY)
        budget = (_chip_hbm_bytes(self.device) * 0.85 - weight_bytes - resident - draft_bytes
                  - transient)
        rows = kw.get("paged_pool_rows")
        if auto and rows and row_bytes * rows * n_replicas > budget:
            page = kw["page_size"]
            fit = int(max(budget, 0.0) // (row_bytes * n_replicas)) // page * page
            cut = max(fit, -(-ctx // page) * page)
            if cut < rows:
                log.warning("%s: the auto page pool of %d rows (%.1f GB a replica) leaves no "
                            "room for the admission transient (~%.1f GB a replica); serving "
                            "%d rows", name, rows, row_bytes * rows / 1e9,
                            transient / n_replicas / 1e9, cut)
                kw["paged_pool_rows"] = rows = cut
        kv_bytes = row_bytes * (rows or self.num_slots * ctx)
        if kw.get("prefix_cache") and kw.get("prefix_host_bytes"):
            # the host tier's device staging (TorchEngine.host_staging_bytes):
            # the spill backlog's cap and one slot's restore
            page = row_bytes * kw["page_size"]
            pages = -(-kw["paged_pool_rows"] // kw["page_size"])
            kv_bytes += max(16 * page, min(pages * page, SPILL_STAGING_BYTES)) + (
                ctx // kw["page_size"]) * page
        if kv_bytes * n_replicas > max(budget, 0.0):
            log.warning("%s: KV cache needs ~%.1f GB/chip (budget ~%.1f GB) and the "
                        "seq-sharded degradation is unavailable (no sp axis on one "
                        "card) — loading anyway and HBM may overflow", name,
                        kv_bytes * n_replicas / 1e9, max(budget, 0.0) / 1e9)
        return weight_bytes, kv_bytes

    def _build_draft(self, source: str, cfg: ModelConfig, ctx: int,
                     tokenizer: BaseTokenizer) -> Optional[spec_mod.DraftModel]:
        """The paired draft model (a preset name such as "tinyllama", a
        ``.gguf`` path or a directory) as an int4 ``spec.DraftModel``, or None when the
        pairing cannot serve (the JAX manager's ``_build_draft``): lenient
        like every serving knob, a config error logs and serves with n-gram
        speculation. A CUDA error raises."""
        def vocab_mismatch(dcfg: ModelConfig) -> bool:
            if dcfg.vocab_size == cfg.vocab_size:
                return False
            log.warning("%s: draft model %s vocab (%d) does not match the serving vocab "
                        "(%d); they must share one tokenizer; serving with n-gram "
                        "speculation", cfg.name, dcfg.name, dcfg.vocab_size, cfg.vocab_size)
            return True

        try:
            p = Path(source)
            if source.endswith(".gguf") or "/" in source or p.exists():
                dcfg, dparams, dtok = self._load_weights(p.stem.lower() or "draft", source, 0)
            else:
                # a preset's vocabulary is known before its weights are made
                if vocab_mismatch(resolve_preset(source)):
                    return None
                dcfg, dparams, dtok = self._load_weights(source, "", 0)
        except Exception as exc:  # noqa: BLE001 - the lenient knob, config errors only
            if is_device_fault(exc):
                raise
            log.warning("%s: draft model %r failed to load (%s); serving with n-gram "
                        "speculation", cfg.name, source, exc)
            return None
        if vocab_mismatch(dcfg):
            return None
        # equal vocabulary SIZES do not make one tokenizer (32000 is every
        # Llama-family size): a mismatch would propose garbage ids forever
        try:
            probe = 'The quick brown fox ran 42 {"tool": "call"}'
            if dtok.encode(probe) != tokenizer.encode(probe):
                log.warning("%s: draft model %s tokenizes differently (same vocab size, "
                            "another tokenizer); serving with n-gram speculation",
                            cfg.name, dcfg.name)
                return None
        except Exception as exc:  # noqa: BLE001 - the lenient knob
            log.warning("%s: draft tokenizer probe failed (%s); pairing on vocab size "
                        "alone", cfg.name, exc)
        if self.device.type == "cuda":
            faults = model_mod.kernel_contract_faults(dcfg, paged=False, quant_cache=False,
                                                      quantize="int4")
            if faults:
                log.warning("%s: draft model %s cannot be served on %s (%s); serving with "
                            "n-gram speculation", cfg.name, dcfg.name, self.device,
                            "; ".join(faults))
                return None
        draft = spec_mod.DraftModel(dcfg, dparams, quantize="int4")
        del dparams
        log.info("%s: paired draft model %s (%d B of serving weights, ctx %d)", cfg.name,
                 dcfg.name, draft.weight_bytes(), ctx)
        return draft

    def _load_weights(self, name: str, path: str, context_length: int):
        """Resolve (config, params, tokenizer) from a model source; a GGUF
        file adds its dequantize and upload seconds to the timings of the
        load running on this thread."""
        if path.startswith("synthetic://") or not path:
            cfg = resolve_preset(path.removeprefix("synthetic://") or name)
            if context_length:
                cfg = cfg.scaled(max_context=context_length)
            gen = torch.Generator(device=self.device)
            gen.manual_seed(0)
            if cfg.moe and self.quantize:
                # straight into the serving leaves, a layer at a time
                t0 = time.perf_counter()
                params = init_serving_params(cfg, gen, mode=self.quantize,
                                             dtype=torch.bfloat16, device=self.device)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                getattr(self._loading, "timings", {})["init_s"] = time.perf_counter() - t0
                return cfg, params, ByteTokenizer()
            params = init_params(cfg, gen, dtype=torch.bfloat16, device=self.device)
            return cfg, params, ByteTokenizer()
        p = Path(path)
        if p.is_file() and p.suffix == ".gguf":
            timings = getattr(self._loading, "timings", {})
            t0 = time.perf_counter()
            f = GGUFFile(p)
            timings["dequantize_s"] = time.perf_counter() - t0
            params, cfg = params_from_gguf(f, self.device, timings=timings)
            tokenizer = (gguf_tokenizer(f.metadata) if "tokenizer.ggml.tokens" in f.metadata
                         else ByteTokenizer())
            if context_length:
                cfg = cfg.scaled(max_context=context_length)
            return cfg, params, tokenizer
        if p.is_dir():
            return self._load_dir(name, p, context_length)
        raise FileNotFoundError(f"model path not found: {path}")

    def _load_dir(self, name: str, p: Path, context_length: int):
        """A prepared checkpoint (its leaves restored as stored, quantized
        ones with no quantize pass after, the dense ones in bf16 as from
        every other source; ``context_length`` scales its config), else an
        HF checkpoint directory: ``config.json``, every ``*.safetensors``
        in sorted order cast to bf16 on the device, and ``tokenizer.json``:
        the JAX manager's order and casts. The seconds of reading and
        placing the weights go to the load's ``upload_s``."""
        timings = getattr(self._loading, "timings", {})
        t0 = time.perf_counter()
        if ckpt_mod.is_model_checkpoint(str(p)):
            cfg, params, tokenizer = ckpt_mod.load_model_checkpoint(str(p), self.device)
            params = _bf16_dense(params)
            if context_length:
                cfg = cfg.scaled(max_context=context_length)
        elif (p / "config.json").is_file():
            with open(p / "config.json") as fh:
                cfg = from_hf_config(json.load(fh), name=name)
            params = params_from_hf_state_dict(load_dir(p), cfg, dtype=torch.bfloat16,
                                               device=self.device)
            tokenizer = HFTokenizer(str(p))
        else:
            raise FileNotFoundError(
                f"{p} holds neither a prepared checkpoint ({ckpt_mod.MODEL_META_NAME}) nor "
                "the config.json that HF checkpoint directories carry")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        timings["upload_s"] = time.perf_counter() - t0
        return cfg, params, tokenizer

    def autoload(self, model_dir: Optional[str] = None) -> List[str]:
        """Scan AIOS_MODEL_DIR for *.gguf and load each (main.rs:65-132): in
        sorted order, under the file's lower-cased stem, at the context its
        size gives; a file that fails is skipped. Returns the names loaded."""
        model_dir = model_dir or os.environ.get("AIOS_MODEL_DIR", "/var/lib/aios/models")
        loaded: List[str] = []
        d = Path(model_dir)
        if not d.is_dir():
            return loaded
        for f in sorted(d.glob("*.gguf")):
            name = f.stem.lower()
            ctx = _context_for_file_size(f.stat().st_size)
            try:
                self.load_model(name, str(f), context_length=ctx)
                loaded.append(name)
            except Exception:
                continue
        return loaded

    # -- unloading --------------------------------------------------------------

    def unload_model(self, name: str) -> bool:
        with self._lock:
            managed = self.models.pop(name, None)
        if managed is None:
            return False
        managed.state = STATE_UNLOADING
        # the pool shuts every replica down and closes its engine, freeing
        # its memory now rather than at a gc pass; after a device fault no
        # CUDA call can succeed, and the memory goes with the process
        if managed.pool is not None and managed.pool.device_fault is None:
            managed.pool.shutdown()
        managed.engine = None
        managed.batcher = None
        return True

    @staticmethod
    def _device_lost(managed: ManagedModel, exc: BaseException) -> None:
        """A CUDA error in one of the model's schedulers: the context is
        poisoned, so the model leaves service in ``error`` (the pool already
        refuses work) and HealthCheck stops reading its engines. Only a new
        process can serve again."""
        managed.state = STATE_ERROR
        managed.error = f"{DEVICE_FAULT_REASON}: {exc!r}"
        managed.engine = None
        managed.batcher = None

    def _retire_async(self, old: ManagedModel) -> None:
        """Hot-swap retirement: the new pool already serves; the old one
        drains its streams (30 s at most) on a thread, then frees its
        memory. The old entry's engine and batcher are nulled at once, so
        that HealthCheck never reads a closing engine."""
        old.state = STATE_UNLOADING
        pool = old.pool
        old.engine = None
        old.batcher = None
        threading.Thread(target=pool.shutdown, kwargs={"drain_timeout": 30.0},
                         name=f"retire-{old.name}", daemon=True).start()

    def close(self) -> None:
        for name in list(self.models):
            self.unload_model(name)

    # -- resolution -------------------------------------------------------------

    def get(self, name: str) -> Optional[ManagedModel]:
        return self.models.get(name)

    def ready_models(self) -> List[ManagedModel]:
        return [m for m in list(self.models.values()) if m.state == STATE_READY]

    def find_by_partial_name(self, name: str) -> Optional[ManagedModel]:
        """Case-insensitive substring match."""
        low = name.lower()
        exact = self.models.get(name)
        if exact is not None and exact.state == STATE_READY:
            return exact
        for m in self.ready_models():
            if low in m.name.lower() or m.name.lower() in low:
                return m
        return None

    def select_for_level(self, level: str) -> Optional[ManagedModel]:
        """Routing ladder; None for reactive or when nothing matches."""
        for candidate in LEVEL_LADDERS.get(level.lower(), []):
            m = self.find_by_partial_name(candidate)
            if m is not None:
                return m
        return None
