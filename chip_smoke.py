#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``aios_tpu_torch``) on one NVIDIA GPU.

Phases, each printing its lines:
  1. device — the card's name and power limit; TF32 off for every reference;
  2. build  — compile every kernel from ``aios_tpu_torch/csrc`` with nvcc;
  3. kernels — each kernel against its plain PyTorch version on the same
     inputs at the shapes the main paths give it (TinyLlama-1.1B for K1-K3,
     K6 and K8, Mistral-7B for K2, K4, K5 and K6-K9), with its time (CUDA
     events, median of 20 runs, the L2 flushed and the stream held before
     each so that host overhead is not counted), the plain version's time,
     one PyTorch library call's time and the bound; K1 and K5 at M = 1, 8,
     16, 32, 64, 128 and 512 (every tile the wrappers' plan can pick;
     bit-identical repeats at 8, 16, 32, 64 and 512), timed at the model's
     largest bucket, and summed per decode step, verify forward and prefill
     forward; K2 also at ragged T (1, 63, 65, 127, 200, 1000), B = 2 and a
     window narrower than its kv tile, bit-identical on repeat at T = 512
     and 4096, beside the fastest fused SDPA backend (``is_causal`` where
     the window hides nothing);
     K3, K4, K8 and K9 also at lengths on and beside their split shares
     (K3/K4 windowed too, K8 and K9 with one live slot, K9 with a window
     whose slots fit one share and windows deep in the cache); K6 also at
     T = 3 (24 query rows a kv head, a ragged 16-row tile) and at the
     lengths of a served window (~300 rows); K7 also at T = 31, at the
     lengths of a served window and at lengths on and beside its split
     shares (a window whose slots fit one share, one live slot, windows
     deep in the cache); K6 and K7 also at a chunk of an admission (B = 1,
     T = 512, C = 2048 and 8192), K6 with a chunk whose last queries run
     past the cache end; K2 (T = 512, 2048), K3 (8 ragged slots, C = 8192)
     and K6 (T = 8 and a 512-row chunk) also at Qwen3-14B's heads (H = 40,
     KH = 8, D = 128: a GQA group of 5), and K2 (T = 512, 2048, 8192), K3 (C =
     32768) and K6 (T = 8, and 512-row chunks at rows 1024 and 30720 of C =
     32768) at Qwen3-30B-A3B's (H = 32, KH = 4, D = 128: a group of 8); every
     decode-attention kernel bit-identical on repeat; K1's expert entry
     (``quantized_matmul_experts``) in its three row layouts at
     Qwen3-30B-A3B's dense decode (8 rows over 128 experts), its gather at 8
     slots (64 picks) and at 1 (8 picks), its 512-row chunk, and Mixtral-8x7B's
     stacks at M = 8 and 512, each within TOL of its plain twin and
     bit-identical on repeat, beside ``torch.matmul``/``torch.bmm`` on the
     dequantized bf16 stack, summed per decode step, gather step and chunk;
  4. serve TinyLlama — ``ModelManager`` + ``serve()`` on 127.0.0.1; LoadModel
     ``synthetic://tiny-test`` (head_dim 16, which no attention kernel takes)
     is refused with status error; LoadModel
     ``synthetic://tinyllama-1.1b`` at full width (int8 weights, bf16 pool),
     three Infer and one StreamInfer over gRPC (the 960- and 1800-byte
     prompts admitted in 512-row chunks through K6), and proof that K1-K3
     and K6 launched meanwhile, exact counts; a 1536-token preamble with two
     tails over gRPC, the second reusing its rows from the prefix index,
     the hit's first-token logits bit-identical to a cold chunked
     admission's; a hit whose final bucket runs past the cache end against
     its plain version;
  5. numerics — its prefill and decode-step logits through the kernels
     against the plain path, two identical greedy streams, TTFT, the decode
     rate, the step's graph replay against its eager body (identical tokens,
     bit-identical logits, exact launches), sampled replays that draw fresh
     noise, and a decode window timed and profiled through the graph and
     through the eager body (kernels and device time per op of the latter);
     an 1800-token prompt's chunks through the kernels against the plain
     chunks on the same pool state (exact launches per chunk) and against a
     whole-prompt prefill; the same prompt admitted while 7 streams decode,
     chunked and whole-prompt: decode dispatches between the chunks, the
     streams' longest inter-token gap, TTFT;
  6. serve Mistral-7B — after TinyLlama is unloaded, a second server with
     ``ModelManager(quantize="int4", kv_cache="int8")`` loads
     ``synthetic://mistral-7b`` at full width (int4 weights, int8 pool,
     context 8192, sliding window 4096) and answers three Infer and one
     StreamInfer; the launch counts must be exactly K5 = 129 and K2 = 32 per
     whole-prompt prefill, K5 = 129 and K7 = 32 per admission chunk, K5 =
     129 and K4 = 32 per decode step, K1 = K3 = 0;
  7. Mistral numerics — kernel against plain logits for a prefill and a
     decode step over the int8 pool, a greedy request that decodes past the
     4096-row window with trimmed pages returned (twice on the engine and
     once through the batcher, all three whole-prompt and identical), TTFT
     per bucket, the 8-slot decode rate and phase 5's graph checks and
     profiles; the 4090-token prompt's chunks through the kernels and
     through the plain path, each on its own pool, exact launches per chunk;
     its chunked admission through the batcher against whole-prompt (exact
     launches, TTFT); a 7000-token prompt that trims pages during its
     admission;
  8. serve TinyLlama dense — ``ModelManager(quantize="int8", kv_cache="bf16",
     paged_kv="off", speculative=True)``: the same window over the dense slot
     cache with n-gram speculation (per round 89 K1 and 22 K6, no K8), then
     again with ``degrade_spec`` set (per step 89 K1 and 22 K8), exact
     counts, each admission chunk 89 K1 and 22 K6;
  9. dense numerics — ``decode_step`` and ``verify_step`` through the
     kernels against the plain path (every sublayer on the same input, and
     the free-running logits), row t of a verify forward against the t-th
     of T decode steps, the invariants of a speculative round, a
     teacher-forced verify that accepts its own predictions, greedy
     speculative streams through the batcher (twice, identical), the
     acceptance rate, the 8-slot decode rate with and without speculation,
     and phase 5's graph checks and profiles for the round and the step; a
     512-row chunk over the dense cache against the plain path, and a long
     prompt admitted in chunks, then decoded in rounds, exact launches;
  10. serve Mistral-7B dense and its numerics — the same with
     ``ModelManager(quantize="int4", kv_cache="int8", paged_kv="off",
     speculative=True)`` at context 8192 (per round 129 K5 and 32 K7, per
     plain step 129 K5 and 32 K9, per admission chunk 129 K5 and 32 K7) and
     a greedy request past the window;
  11. serve GGUF files — with the serving defaults (int8 weights, bf16 pool),
     LoadModel answers error, with the reason, for a corrupt header, a
     mixture-of-experts header without its expert tensors and a Q2_K
     tensor; then three files, written
     one tensor at a time from a seeded generator with the port's streaming
     writer into a temporary directory, each deleted after its turn: (a)
     TinyLlama-1.1B at full width and depth in llama.cpp's layout (q/k
     permuted; layer 0's attn_q/attn_k in F32, layer 1's FFN in Q4_0, the
     rest Q8_0) with a 32000-piece SentencePiece vocab, (b)
     DeepSeek-R1-Distill-Llama-8B and (c) Qwen3-14B at full width with 2
     layers, byte-level BPE vocabs of 128256 and 151936 (``llama-bpe``,
     ``qwen2``). For each: ``params_from_gguf`` on the card equals the CPU's
     load bit for bit (and (a)'s F32 tensors come back bit for bit after
     the unpermute); LoadModel by path, its timings (parse and dequantize,
     upload, quantize, capture) and the process's peak RSS; three Infer and
     one StreamInfer over gRPC with exact launches (per dispatch 4L+1 K1,
     and L K2, K6 or K3); prefill and decode-step logits through the kernels
     against the plain path within E2E_TOL; two identical greedy streams.
     (a) also: a prompt of at least 1800 tokens admitted in 512-row chunks,
     its encode time, and ``manager.autoload`` of its directory (the name
     from the stem, context 2048 by file size); (b) and (c):
     decode(encode(s)) == s on every served prompt and one request's
     first-token logits; and a 2-layer TinyLlama-width file with 32002
     tokens, its lm_head padded to 32016 columns, serves a request;
  12. constrained decoding (``phase_constrained``) — (a)'s TinyLlama file
     loaded without and then with ``AIOS_TPU_JSON_MODE=force`` (the masked
     step's graph and both jump graphs captured at load, capture seconds
     both ways), then four Infer at once (two with the orchestrator's
     tool-call schema over a dozen tool names, one with a schema of enums,
     integers, booleans and a nested object, one plain under forced JSON
     mode) beside an unconstrained StreamInfer, greedy and at temperature
     0.7: every reply parses, the schema replies end in a terminal state of
     their schema's machine with catalog tool names, exact launches per
     prefill, chunk, masked or plain step and jump; malformed and
     unsupported schemas answer INVALID_ARGUMENT; one tool-call Infer with
     jump-ahead on and off (wall, dispatches); greedy requests with
     jump-ahead on and off (agreement, streams part only at free choices of
     the grammar; dispatches); the engine checks of ``_constrained_dispatches`` (the masked
     step and each jump bucket replayed against their eager bodies bit for
     bit with exact launches, the jump's ``verify_step_paged`` at T = 5 and
     17 through the kernels against the plain path (logits and written
     rows), a jump's K/V rows against masked steps
     forcing the same tokens, layer 0 within TOL and every layer within the
     logits' drift tolerance, host wall and device busy per
     dispatch, the page gather of a jump timed alone); (b)'s DeepSeek file
     answers a tool-call request; the host time of a JsonMaskCache and a
     fresh state's row at vocab 32000, 128256 and 151936; Mistral-7B paged
     (int4 weights, int8 pool, window 4096): a tool-call request a slot, one
     with a 4100-token prompt, jump-ahead on and off (a regression gate of
     >= 2x fewer dispatches on the enum-heavy tool-call shape over its byte
     vocabulary; the orchestrator's tool-call schema reported only), a jump
     past the window that writes only live blocks, and the engine checks;
     phases 9 and 10 run the engine checks over the dense cache too. The
     launches of the engine checks are gated there and not added to the
     kernels line, which counts only the served windows, the DeepSeek
     request and Mistral's batcher run;
  13. the serving front door (``phase_serving``) — TinyLlama-1.1B at full
     width (int8 weights, bf16 pool, 8 slots a replica) through gRPC and its
     ``ReplicaPool``: a 16 x 129-token wave on one replica; a hot swap to
     ``AIOS_TPU_REPLICAS=2`` while a stream is live (the stream ends whole,
     the new pool serves the next request, the old engines' bytes are
     released within 30 s up to their admission graph pool); the two
     replicas share every weight tensor (equal data_ptrs) and the second
     adds its page pool and graphs, not the weights; each replica's step
     replay against its eager body; a 1536-token preamble routed
     ``least_loaded``, the request sharing it ``prefix`` to the replica
     holding it (a prefix hit there), a new task id ``least_loaded`` and
     its repeat ``sticky``; the wave on two replicas with exact launches
     summed over both (and with the flight recorder on and off); a greedy
     64-token StreamInfer across an injected ``pool.scheduler_crash`` ends
     whole with one respawn and one resumed failover (its re-admission a
     prefix hit through K6), beside the fault-free stream; then, reloaded
     with ``AIOS_TPU_FAILOVER_RETRIES=0``, a tenant quota and a queue bound
     of 1: the crash as UNAVAILABLE with ``retry-after-ms``, an agent's
     second request RESOURCE_EXHAUSTED (quota), a burst shedding
     ``queue_full``, and a request under a 100 ms deadline behind a busy
     replica shed ``deadline`` without a slot. Its counted windows add to
     the kernels line;
  14. speculation over the page pool and the draft rung
     (``phase_spec_paged``) — TinyLlama-1.1B paged (int8 weights, bf16
     pool, speculative) loaded with ``AIOS_TPU_DRAFT_MODEL=deepseek``: the
     128,256-vocab draft is refused with a warning and the n-gram rung
     serves; the paged round's replay against its eager body (89 K1 and 22
     K6 a round) and its host wall and device busy against a plain step;
     then an engine over the same leaves with ``DraftModel(cfg, params,
     "int8")``: each ingest width's replay and the fused draft round's
     against their eager bodies (draft cache, lengths, tokens and logits
     bit for bit, exact launches), the draft round's cost, and 8 greedy
     129-token requests with the draft (acceptance >= 0.5) and without
     (dispatches, tok/s, the streams' agreement). Mistral-7B paged (int4
     weights, int8 pool, window 4096) with ``AIOS_TPU_DRAFT_MODEL=tinyllama``
     through LoadModel and gRPC: the int4 TinyLlama draft pairs, its cache
     is 1,476,395,008 B and its weights and cache are in the budget, the
     draft graphs are in HealthCheck's captures; 3 Infer + 1 StreamInfer
     (the n-gram rung: sampled requests), then 8 greedy requests of 129
     tokens through the draft rung (K5, K6, K7 and K8 launched); the
     n-gram round's replay against its eager body (129 K5 and 32 K7), both
     rounds' cost, and a 4340-row slot whose rounds back 32 rows first and
     return the block below the window. The served window and the greedy
     wave add to the kernels line. Phase 3 also checks K8 over the draft's
     cache (TinyLlama's heads, C = 8192), K6 at its ingest widths (B = 8, T
     = 32 and 512), K6 and K7 at T = 8 over gathered pages, and K5 at
     TinyLlama's shapes (M = 8, 64; 4096 timed);
  15. the prefix cache's host tier (``phase_host_tier``) — TinyLlama-1.1B
     paged (int8 weights, bf16 pool) and Mistral-7B paged (int4 weights,
     int8 pool, window 4096), each loaded through LoadModel with
     ``AIOS_TPU_PREFIX_HOST_BYTES`` = 2 GiB and a 128-page pool: a 1585-token
     prompt (1574 on Mistral's template) whose 1536-row preamble is 12 pages,
     cold, as a pool hit, then after distinct prompts have spilled those
     pages (``host_tier_spills`` >= 12, none dropped, the index's peek 0,
     the worker drained) restored: exactly 1536 rows restored and none
     reused, the 12 restored pages equal to the spilled bytes, the
     first-token logits and a 9-token greedy stream equal to the pool hit's
     bit for bit; TTFT cold / hit / restored through the batcher (3 each,
     exact launches), the restore's probe, staging, issue and device ms,
     the link's GB/s both ways, a spill's gather, copy and worker ms a
     page, the peak spill staging, crc32 on 1 and 8 threads; with
     ``host_store.corrupt`` and with ``host_store.restore_fail`` a counted
     recompute with the cold stream (the failed restore's pages given
     back); ``export_prefix`` through ``pack_entry`` / ``unpack_entry`` into
     a second engine's store, restored there with the pool hit's logits bit
     for bit; ``prefix_digest`` sizes. The batcher's runs add to the
     kernels line.
  16. mixture-of-experts (``phase_moe``) — after every earlier model is
     unloaded, ``LoadModel`` of ``synthetic://qwen3-30b-a3b`` at full width and
     depth (48 layers, 128 experts of 768, top-8; int8 weights made a layer at
     a time, bf16 pool sized auto at context 32768): load seconds, serving
     and pool bytes, peak device memory; 3 Infer + 1 StreamInfer and a wave
     of 8 greedy requests through the pool, every dispatch a graph replay,
     exact launches (per dispatch 97 K1 and 96 expert launches, 48 K2, K3 or
     K6); layer 0's attention, router and FFN and every layer's sublayers
     through the kernels against the plain path (E2E_TOL), the free-running
     logits (DRIFT_TOL); TTFT of a 1001-token prompt; the step's replay
     against its eager body and its profile; then the served model
     unloaded, an engine over the same leaves with ``AIOS_TPU_MOE_GATHER=1``
     (context 4096): its first decode step's logits and greedy streams
     against the dense engine's, and the same wave through its batcher. The
     served windows and waves add to the kernels line.
  17. the decode loop's modes and window+sink compression
     (``phase_decode_loop``, run before phase 16) — TinyLlama-1.1B (int8
     weights, bf16 pool) loaded through ``LoadModel`` once a mode: the sync
     loop, ``AIOS_TPU_DECODE_PIPELINE``, ``AIOS_TPU_UNIFIED_STEP``,
     ``AIOS_TPU_MEGA_TICKS=8`` without and with the pipeline (its four
     buckets captured at load), 8 greedy requests through the pool each,
     token for token the sync loop's, with tok/s, the host gap a dispatch,
     mega dispatches and k, and the host wall and device time a tick of a
     16-tick dispatch over 8 slots (and what 7 skipped ticks cost); on the
     megagraph, a wave whose budgets and a stop id end windows early and
     one under ``pool.megatick_abort``; Mistral-7B (int4, int8 pool) sync
     and with the megagraph pipelined, identical; TinyLlama with
     compression (1 sink + 8 window pages, threshold 1152) over the bf16
     and then the int8 pool: a 1001-token prompt decoded to 1951 rows
     (resident pages per dispatch, every page back after), the first
     logits after a prune through the kernels against the plain path under
     the same mask, and a 1900-token prompt pruned mid-admission (K6/K7's
     ``_sink`` entries) that registers only its sink block. Phase 3 checks
     the gate (``mega_gate``) against its plain version and K6/K7 with the
     sink predicate (``SINK_CASES``). Its served runs add to the kernels
     line.

Every served decode and admission dispatch is a CUDA graph replay: each
served window also holds that ``LoadModel`` captured the planned graphs
(the step, with speculation the round, and the admission graphs: a
whole-prompt prefill per bucket the pool backs, the 512-row mid chunk and
each final bucket up to it, all in one shared pool whose bytes the
LoadModel lines print) and that none is captured while serving, with one
replay per dispatched step, round, prefill and chunk; the exact launch
counts are counted through the replays. For TinyLlama and Mistral paged
and TinyLlama dense each admission graph kind (a bucket, mid chunks, a
final chunk, and over the pool a prefix hit's tail) is held against its
eager twin (``prefill_eager``, ``ChunkedPrefill(eager=True)``) on the same
state: the same first token, the first-token logits row and every cache
byte written bit-identical, exact launches per replay; sampled first
tokens draw fresh noise; and device busy and host wall per bucket (512,
2048) and per 512-row mid chunk are timed both ways, with the host's issue
time of a mid chunk.

Then one ``{"kernels": [...]}`` line and, last, the result line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed phase exits non-zero without the result line; so does a machine
without CUDA.

Run from the repository root:  python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import functools
import json
import logging
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# NVIDIA H100 SXM data sheet: HBM3 rate and dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
TOL = 2e-2  # bf16 outputs and p, fp32 sums taken in another order
E2E_TOL = 5e-2  # 22 layers of such differences, relative to max |logit|
# a 32-layer Mistral prefill compounds them further, layer by layer, so each
# of its layers is held to E2E_TOL on the same input and the free-running
# drift of the whole prefill only to this
DRIFT_TOL = 1.5e-1

TINYLLAMA_KN = {  # (K, N) of each int8 matmul; launches per decode step
    "w_qkv": ((2048, 2560), 22),
    "wo": ((2048, 2048), 22),
    "w_gateup": ((2048, 11264), 22),
    "w_down": ((5632, 2048), 22),
    "lm_head": ((2048, 32000), 1),
}
H, KH, D, P = 32, 4, 64, 128
MISTRAL_KN = {  # (K, N) of each int4 matmul; launches per decode step
    "w_qkv": ((4096, 6144), 32),
    "wo": ((4096, 4096), 32),
    "w_gateup": ((4096, 28672), 32),
    "w_down": ((14336, 4096), 32),
    "lm_head": ((4096, 32000), 1),
}
M_H, M_KH, M_D, M_L, M_WINDOW = 32, 8, 128, 32, 4096
Q_H, Q_KH, Q_D = 40, 8, 128  # Qwen3-14B's heads: a GQA group of 5
A_H, A_KH, A_D, A_L = 32, 4, 128, 48  # Qwen3-30B-A3B's heads (a GQA group of 8) and layers

KERNEL_META = {
    "quantized_matmul": dict(
        source="aios_tpu_torch/csrc/quantized_matmul.cu",
        replaces="aios_tpu/ops/quantized_matmul.py:86",
    ),
    "flash_attention": dict(
        source="aios_tpu_torch/csrc/flash_attention.cu",
        replaces="aios_tpu/ops/flash_attention.py:180",
    ),
    "paged_decode_attention": dict(
        source="aios_tpu_torch/csrc/paged_attention.cu",
        replaces="aios_tpu/ops/paged_attention.py:248",
    ),
    "paged_decode_attention_int8": dict(
        source="aios_tpu_torch/csrc/paged_attention.cu",
        replaces="aios_tpu/ops/paged_attention.py:248",
    ),
    "int4_matmul": dict(
        source="aios_tpu_torch/csrc/int4_matmul.cu",
        replaces="aios_tpu/ops/int4_matmul.py:209",
    ),
    "multiquery_decode_attention": dict(
        source="aios_tpu_torch/csrc/dense_attention.cu",
        replaces="aios_tpu/ops/verify_attention.py:237",
    ),
    "multiquery_decode_attention_int8": dict(
        source="aios_tpu_torch/csrc/dense_attention.cu",
        replaces="aios_tpu/ops/verify_attention.py:237",
    ),
    "decode_attention": dict(
        source="aios_tpu_torch/csrc/dense_attention.cu",
        replaces="aios_tpu/ops/decode_attention.py:254",
    ),
    "decode_attention_int8": dict(
        source="aios_tpu_torch/csrc/dense_attention.cu",
        replaces="aios_tpu/ops/decode_attention.py:254",
    ),
    # K1's expert-batched entry: the JAX package's expert products are XLA
    # einsums (no Pallas kernel), _expert_einsum and the gather's pick_einsum
    "quantized_matmul_experts": dict(
        source="aios_tpu_torch/csrc/quantized_matmul.cu",
        replaces="aios_tpu/engine/moe.py:39",
    ),
    # the megagraph's gate: the JAX package's device loop is a lax.while_loop
    # whose cond XLA evaluates between ticks (no Pallas kernel)
    "mega_gate": dict(
        source="aios_tpu_torch/csrc/mega_graph.cu",
        replaces="aios_tpu/engine/engine.py:1438",
    ),
}
TINYLLAMA_KERNELS = ("quantized_matmul", "flash_attention", "paged_decode_attention",
                     "multiquery_decode_attention")


class PhaseError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def expect(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseError(what)


# -- timing ------------------------------------------------------------------

_flush_buf = None
HOLD_CYCLES = 4_000_000  # about 2 ms of SM clock


def _flush_l2() -> None:
    """Overwrite 256 MB (five times the 50 MB L2) so the next launch finds
    its operands cold, as on the serving path."""
    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    _flush_buf.zero_()


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``iters`` runs (CUDA events). Before
    each run the L2 is flushed and the stream is held for about 2 ms, so the
    host has enqueued the whole run before the device reaches it: the events
    bracket device time, not the host's time to issue the launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        _flush_l2()
        torch.cuda._sleep(HOLD_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 1: device -----------------------------------------------------------


def phase_device() -> str:
    expect(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    expect(smi.returncode == 0 and smi.stdout.strip(), f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0].strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(card)
    log(
        f"[device] {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda} python={sys.version.split()[0]} "
        f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}"
    )
    return card


# -- phase 2: build ------------------------------------------------------------


def phase_build() -> None:
    from aios_tpu_torch.ops import build

    t0 = time.perf_counter()
    logs = build.build(build.SOURCES)
    build.build_all()
    secs = time.perf_counter() - t0
    for name, out in logs.items():
        for line in out.splitlines():
            if any(w in line for w in ("registers", "spill", "Performance Loss")):
                log(f"[build] {name}: {line.strip()}")
    log(f"[build] {len(build.SOURCES)} kernel libraries ready in {secs:.2f} s "
        f"({len(logs)} compiled now)")


# -- phase 3: kernels against their plain versions -----------------------------


def _report(name, what, ms, plain, lib, bnd, err, ok):
    log(
        f"[kernel] {name} {what}: ok={ok} max_abs_err={err:.3e} kernel_ms={ms:.4f} "
        f"plain_ms={plain:.4f} library_ms={'null' if lib is None else f'{lib:.4f}'} "
        f"bound_ms={bnd[0]:.4f} ({bnd[1]})"
    )


def _add_forward(acc, per_step, ms, plain, lib, nbytes, flops) -> None:
    """Add one projection's numbers, times its launches per forward pass."""
    acc["ms"] += per_step * ms
    acc["plain_ms"] = None if plain is None else acc["plain_ms"] + per_step * plain
    acc["library_ms"] += per_step * lib
    acc["bytes"] += per_step * nbytes
    acc["flops"] += per_step * flops


def _log_forward(name, what, launches, M, acc):
    bnd = bound_ms(acc["bytes"], acc["flops"])
    plain = "not timed" if acc["plain_ms"] is None else f"{acc['plain_ms']:.4f}"
    log(
        f"[kernel] {name} {what} ({launches} launches, M={M}): "
        f"kernel_ms={acc['ms']:.4f} plain_ms={plain} "
        f"library_ms={acc['library_ms']:.4f} bound_ms={bnd[0]:.4f} ({bnd[1]}) "
        f"x{acc['ms'] / bnd[0]:.2f} of bound, x{acc['ms'] / acc['library_ms']:.2f} of "
        f"torch.matmul; bytes={acc['bytes']:.4e}"
    )
    return bnd


# M of one forward of each kind: a decode step over 8 slots, the verify
# forward of a speculative round (8 slots x 8 query rows), a prefill bucket
FORWARDS = {8: "one decode step", 64: "one verify forward", 512: "one prefill forward"}
# every tile of the plan: 8/16/32/64 streaming rows, 64 x 64 and 128 x 128 prefill
CHECKED_M = (1, 8, 16, 32, 64, 128, 512)
REPEATED = (8, 16, 32, 64, 512)  # launched twice: the split-K sum must repeat bit for bit


def _check_weight_matmul(gen, name, kn, largest, make, checked=CHECKED_M,
                         forwards=FORWARDS, tag: str = "") -> dict:
    """K1 or K5 (``name``) against its plain version at every projection
    ``kn`` of one model, at every M of ``checked``, each within TOL of
    max|ref|; at M in REPEATED a second launch on the same inputs must give
    the same bits. At ``largest`` (the model's largest prefill bucket) only
    the kernel and ``torch.matmul`` on the bf16 dequantized weight are
    timed. ``make(K, N)`` returns (weight, scales, bf16 weight, weight and
    scale bytes). One line per shape, then one per forward in ``forwards``
    and at ``largest``."""
    from aios_tpu_torch import ops

    fn = getattr(ops, name)
    ref_fn = getattr(ops, f"{name}_reference")
    launches = sum(per for _, per in kn.values())
    worst = 0.0
    fwd = {M: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0, "flops": 0.0}
           for M in (*forwards, largest)}
    for M in (*checked, largest):
        for key, ((K, N), per_step) in kn.items():
            x = torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16)
            w, s, w_bf16, wbytes = make(K, N)
            y = fn(x, w, s)
            plain = None
            if M != largest:
                ref = ref_fn(x, w, s)
                torch.cuda.synchronize()
                err = (y.float() - ref.float()).abs().max().item()
                scale = ref.float().abs().max().item()
                ok = bool(torch.isfinite(y).all()) and err <= TOL * scale
                expect(ok, f"{name} {key} M={M}: err {err} vs max|ref| {scale}")
                if M in REPEATED:
                    expect(torch.equal(fn(x, w, s), y),
                           f"{name} {key} M={M}: a second launch gave other bits")
                plain = time_ms(lambda: ref_fn(x, w, s))
                worst = max(worst, err)
                del ref
            ms = time_ms(lambda: fn(x, w, s))
            lib = time_ms(lambda: torch.matmul(x, w_bf16))
            nbytes = M * K * 2 + wbytes + M * N * 2
            flops = 2.0 * M * N * K
            bnd = bound_ms(nbytes, flops)
            what = f"{tag}{key} M={M} K={K} N={N}"
            if M == largest:
                log(f"[kernel] {name} {what}: kernel_ms={ms:.4f} library_ms={lib:.4f} "
                    f"bound_ms={bnd[0]:.4f} ({bnd[1]}) (timed only)")
            else:
                _report(name, what + (", repeat bit-identical" if M in REPEATED else ""),
                        ms, plain, lib, bnd, err, ok)
            if M in fwd:
                _add_forward(fwd[M], per_step, ms, plain, lib, nbytes, flops)
            del x, w, s, w_bf16, y
    bnds = {M: _log_forward(name, tag + forwards.get(M, "one prefill forward"), launches, M,
                            acc)
            for M, acc in fwd.items()}
    step = fwd[8]
    return dict(max_abs_err=worst, ms=step["ms"], plain_ms=step["plain_ms"],
                library_ms=step["library_ms"], bound_ms=bnds[8][0], bound_by=bnds[8][1],
                measured_at=f"one decode step: {launches} launches at M=8")


def check_quantized_matmul(gen) -> dict:
    def make(K, N):
        w_q = torch.randint(-127, 128, (K, N), generator=gen, device="cuda").to(torch.int8)
        s = torch.rand(1, N, generator=gen, device="cuda") * (0.04 / 127) + 1e-5
        return w_q, s, (w_q.float() * s).to(torch.bfloat16), K * N + N * 4

    return _check_weight_matmul(gen, "quantized_matmul", TINYLLAMA_KN, 2048, make)


def _sdpa_calls(q, k, v, window):
    """SDPA on the [B, H, T, D] layout computing what flash_attention
    computes: ``is_causal`` where the window hides nothing (T <= window), an
    explicit mask only where it bites. Returns what was asked and one call
    per backend (flash, memory-efficient, cuDNN) that takes these inputs."""
    import warnings

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    T = q.shape[2]
    if window is None or T <= window:
        kw, what = dict(is_causal=True), "is_causal"
    else:
        rows = torch.arange(T, device="cuda")[:, None]
        cols = torch.arange(T, device="cuda")[None, :]
        kw, what = dict(attn_mask=(cols <= rows) & (cols > rows - window)), "explicit mask"
    calls = []
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION):
        def call(backend=backend):
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # the backends say why they refuse
                call()
        except RuntimeError:
            continue
        calls.append((backend.name.lower(), call))
    expect(calls, "no fused SDPA backend takes the flash_attention inputs")
    return what, calls


# (geometry, B, T, window, timed): the shapes the prefill buckets give K2
# (TinyLlama and Mistral heads), ragged and tile-edge lengths, two
# sequences and a window narrower than a 128-row kv tile
FLASH_CASES = [
    *(((H, KH, D), 1, T, w, True) for T, w in ((128, None), (512, None), (2048, None),
                                                 (512, 128), (512, 100))),
    *(((M_H, M_KH, M_D), 1, T, w, True) for T, w in ((512, None), (1024, 256), (2048, None),
                                                       (4096, M_WINDOW))),
    *(((H, KH, D), 1, T, None, False) for T in (1, 63, 65, 127, 200, 1000)),
    ((H, KH, D), 2, 200, None, False),
    ((M_H, M_KH, M_D), 2, 1000, 256, False),
    *(((Q_H, Q_KH, Q_D), 1, T, None, True) for T in (512, 2048)),
    *(((A_H, A_KH, A_D), 1, T, None, True) for T in (512, 2048, 8192)),
]
FLASH_REPEATED = (512, 4096)  # launched twice: the bits must repeat (Qwen3's every T)


def check_flash_attention(gen) -> dict:
    from aios_tpu_torch.ops import flash_attention, flash_attention_reference

    worst = 0.0
    headline = None
    for (h, kh, d), B, T, window, timed in FLASH_CASES:
        q = torch.randn(B, T, h, d, generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn(B, T, kh, d, generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn(B, T, kh, d, generator=gen, device="cuda").to(torch.bfloat16)
        out = flash_attention(q, k, v, causal=True, window=window)
        ref = flash_attention_reference(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        ok = bool(torch.isfinite(out).all()) and torch.allclose(
            out.float(), ref.float(), atol=TOL, rtol=TOL)
        what = f"H={h} KH={kh} D={d} B={B} T={T} window={window}"
        expect(ok, f"flash_attention {what}: max err {err}")
        if T in FLASH_REPEATED or (h, kh) in ((Q_H, Q_KH), (A_H, A_KH)):
            expect(torch.equal(flash_attention(q, k, v, causal=True, window=window), out),
                   f"flash_attention {what}: a second launch gave other bits")
            what += ", repeat bit-identical"
        worst = max(worst, err)
        del ref
        if not timed:
            log(f"[kernel] flash_attention {what}: ok={ok} max_abs_err={err:.3e} (checked only)")
            continue
        ms = time_ms(lambda: flash_attention(q, k, v, causal=True, window=window))
        plain = time_ms(lambda: flash_attention_reference(q, k, v, causal=True, window=window))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        asked, calls = _sdpa_calls(qt, kt, vt, window)
        lib, backend = min((time_ms(call), name) for name, call in calls)
        lib_what = f"SDPA {asked}, fastest of {len(calls)} backends: {backend}"
        rows = torch.arange(T, device="cuda")[:, None]
        cols = torch.arange(T, device="cuda")[None, :]
        mask = (cols <= rows) & ((cols > rows - window) if window else True)
        pairs = float(mask.sum().item())
        nbytes = B * (2 * T * h * d + 2 * T * kh * d) * 2
        bnd = bound_ms(nbytes, 4.0 * B * pairs * h * d)
        _report("flash_attention", f"{what}, library {lib_what}", ms, plain, lib, bnd, err, ok)
        if T == 512 and window is None and d == D:
            headline = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd[0],
                            bound_by=bnd[1], measured_at="one launch, T=S=512, TinyLlama heads")
    headline["max_abs_err"] = worst
    return headline


def _paged_tables(lengths, MB, window, seed):
    """Page tables [B, MB] over shuffled physical pages, as the allocator
    leaves them: page 0 is the sacrificial page, which an inactive slot
    (length 0) and every page wholly below a slot's window map. Returns the
    tables and the pool's page count."""
    need = [-(-(n + 1) // P) for n in lengths]
    N = 1 + sum(need) + 3
    perm = (torch.randperm(N - 1, generator=torch.Generator().manual_seed(seed)) + 1).tolist()
    tables = torch.zeros(len(lengths), MB, dtype=torch.int32)
    for b, n in enumerate(need):
        first = max(lengths[b] + 1 - window, 0) // P if window else 0
        for i in range(n):
            page = perm.pop()
            if lengths[b] and i >= first:
                tables[b, i] = page
    return tables.cuda(), N


def _live_rows(lens, C, window, win_starts, sink):
    """[B, C] mask of the rows each slot attends."""
    cols = torch.arange(C, device="cuda")[None, :]
    lcol = lens.long()[:, None]
    live = cols <= lcol
    if window is not None:
        live &= cols > lcol - window
    if win_starts is not None:
        live &= (cols < sink) | (cols >= win_starts.long()[:, None])
    return live


# K3 and K4 split each (slot, kv head)'s visible rows into equal shares of
# whole 32-row chunks (split_plan: 8 shares at TinyLlama's shapes, 4 at
# Mistral's), at D = 128 of at least 256 rows. Lengths whose rows fill their
# shares exactly and one row past (TinyLlama: 256 rows in shares of 32, 257
# in shares of 64 with the fifth holding one row; Mistral: 256 rows in one
# share, 257 in two with the second holding one row, 4096 rows in four of
# 1024, windowed ones starting anywhere in a page), and lengths 0 and 1.
# Checked, not timed.
K3_SPLIT_CASES = (
    ("split edges", [255, 256, 257, 511, 512, 513, 0, 1], {}),
    ("split edges, window=256", [255, 256, 257, 1000, 2047, 300, 0, 1], {"window": 256}),
)
K4_SPLIT_CASES = (
    ("split edges", [255, 256, 4095, 4096, 8191, 2047, 0, 1], {}),
    (f"split edges, window={M_WINDOW}", [255, 256, 4095, 4096, 8191, 5000, 0, 1],
     {"window": M_WINDOW}),
)


def check_paged_decode_attention(gen) -> dict:
    import torch.nn.functional as F

    from aios_tpu_torch.ops import (
        gather_pages, paged_decode_attention, paged_decode_attention_reference,
    )

    MB, sink = 16, 128
    lengths = [0, 1, 127, 128, 129, 700, 1500, 2047]
    ws = torch.tensor([0, 0, 0, 0, 256, 384, 1024, 1536], dtype=torch.int32, device="cuda")
    cases = [("no window", lengths, {}), ("window=512", lengths, {"window": 512}),
             ("sink=128 win_starts", lengths, {"win_starts": ws, "sink": sink}),
             *K3_SPLIT_CASES,
             ("Qwen3 heads H=40 KH=8 D=128, C=8192", [0, 1, 127, 300, 1000, 2047, 4096, 8191],
              {}, (Q_H, Q_KH, Q_D), 64),
             ("Qwen3-30B-A3B heads H=32 KH=4 D=128, C=32768",
              [0, 1, 127, 300, 1000, 4096, 16000, 32767], {}, (A_H, A_KH, A_D), 256)]
    worst = 0.0
    headline = None
    for label, lens_, kw, *geom in cases:
        (h, kh, d), MB_ = geom or ((H, KH, D), MB)
        tables, N = _paged_tables(lens_, MB_, kw.get("window"), 7)
        q = torch.randn(len(lens_), h, d, generator=gen, device="cuda").to(torch.bfloat16)
        k_pool, v_pool = (torch.randn(N, P, kh, d, generator=gen, device="cuda")
                          .to(torch.bfloat16) for _ in range(2))
        lens = torch.tensor(lens_, dtype=torch.int32, device="cuda")
        args = (q, k_pool, v_pool, tables, lens)
        out = paged_decode_attention(*args, **kw)
        ref = paged_decode_attention_reference(*args, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        ok = (bool(torch.isfinite(out).all())
              and torch.allclose(out.float(), ref.float(), atol=TOL, rtol=TOL)
              and torch.equal(paged_decode_attention(*args, **kw), out))
        expect(ok, f"paged_decode_attention {label}: max err {err}")
        worst = max(worst, err)
        what = f"B=8 lengths={lens_} {label}, repeat bit-identical"
        if label.startswith("split"):
            log(f"[kernel] paged_decode_attention {what}: ok={ok} max_abs_err={err:.3e} "
                "(checked only)")
            continue
        ms = time_ms(lambda: paged_decode_attention(*args, **kw))
        plain = time_ms(lambda: paged_decode_attention_reference(*args, **kw))
        live = _live_rows(lens, MB_ * P, kw.get("window"), kw.get("win_starts"), sink)
        kg = gather_pages(k_pool, tables).transpose(1, 2).contiguous()  # [B, KH, C, D]
        vg = gather_pages(v_pool, tables).transpose(1, 2).contiguous()
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None, :], kg, vg, attn_mask=live[:, None, None, :], enable_gqa=True))
        rows = float(live.sum().item())
        nbytes = (rows * kh * d * 2 * 2 + 2 * len(lens_) * h * d * 2 + tables.numel() * 4
                  + len(lens_) * 4)
        bnd = bound_ms(nbytes, 4.0 * rows * h * d)
        _report("paged_decode_attention", what, ms, plain, lib, bnd, err, ok)
        if not kw and not geom:
            headline = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd[0],
                            bound_by=bnd[1], measured_at="one launch, 8 ragged slots")
    headline["max_abs_err"] = worst
    return headline


def _int4_maker(gen):
    from aios_tpu_torch.ops import dequantize_int4

    def make(K, N):
        packed = torch.randint(0, 256, (K // 2, N), generator=gen, device="cuda").to(torch.uint8)
        s = torch.rand(K // 128, 1, N, generator=gen, device="cuda") * (0.04 / 7) + 1e-5
        return packed, s, dequantize_int4(packed, s), K * N // 2 + (K // 128) * N * 4

    return make


def check_int4_matmul(gen) -> dict:
    return _check_weight_matmul(gen, "int4_matmul", MISTRAL_KN, 4096, _int4_maker(gen))


# the int4 TinyLlama draft beside Mistral-7B: a draft step over 8 slots (M =
# 8), the fused round's catch-up (8 slots x 8 rows) and the widest bulk
# ingest (8 slots x 512 rows, timed only)
DRAFT_FORWARDS = {8: "one draft step", 64: "one draft catch-up forward"}


def check_int4_matmul_draft(gen) -> None:
    _check_weight_matmul(gen, "int4_matmul", TINYLLAMA_KN, 4096, _int4_maker(gen),
                         checked=(8, 64), forwards=DRAFT_FORWARDS,
                         tag="TinyLlama draft ")


def check_paged_decode_attention_int8(gen) -> dict:
    import torch.nn.functional as F

    from aios_tpu_torch.engine.model import gather_dequant
    from aios_tpu_torch.ops import (
        paged_decode_attention_int8, paged_decode_attention_int8_reference,
    )

    MB, sink = 8192 // P, 128
    lengths = [0, 1, 127, 128, 1000, 4095, 4096, 8191]  # slot 0 is inactive
    ws = torch.tensor([0, 0, 0, 0, 256, 1024, 2048, 4096], dtype=torch.int32, device="cuda")
    cases = [("no window", lengths, {}), (f"window={M_WINDOW}", lengths, {"window": M_WINDOW}),
             ("sink=128 win_starts", lengths, {"win_starts": ws, "sink": sink}),
             *K4_SPLIT_CASES]
    worst = 0.0
    headline = None
    for label, lens_, kw in cases:
        tables, N = _paged_tables(lens_, MB, kw.get("window"), 11)
        q = torch.randn(len(lens_), M_H, M_D, generator=gen, device="cuda").to(torch.bfloat16)
        pools = [torch.randint(-127, 128, (N, P, M_KH, M_D), generator=gen,
                               device="cuda").to(torch.int8) for _ in range(2)]
        scales = [torch.rand(N, P, M_KH, generator=gen, device="cuda") * 0.015 + 0.005
                  for _ in range(2)]
        lens = torch.tensor(lens_, dtype=torch.int32, device="cuda")
        args = (q, *pools, *scales, tables, lens)
        out = paged_decode_attention_int8(*args, **kw)
        ref = paged_decode_attention_int8_reference(*args, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        ok = (bool(torch.isfinite(out).all()) and err <= TOL
              and torch.equal(paged_decode_attention_int8(*args, **kw), out))
        expect(ok, f"paged_decode_attention_int8 {label}: max err {err}")
        worst = max(worst, err)
        what = f"B=8 lengths={lens_} {label}, repeat bit-identical"
        if label.startswith("split"):
            log(f"[kernel] paged_decode_attention_int8 {what}: ok={ok} max_abs_err={err:.3e} "
                "(checked only)")
            continue
        ms = time_ms(lambda: paged_decode_attention_int8(*args, **kw))
        plain = time_ms(lambda: paged_decode_attention_int8_reference(*args, **kw))
        live = _live_rows(lens, MB * P, kw.get("window"), kw.get("win_starts"), sink)
        kg, vg = (gather_dequant(pool, sc, tables, torch.bfloat16).transpose(1, 2).contiguous()
                  for pool, sc in zip(pools, scales))
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None, :], kg, vg, attn_mask=live[:, None, None, :], enable_gqa=True))
        del kg, vg
        rows = float(live.sum().item())
        nbytes = (rows * M_KH * (M_D + 4) * 2 + 2 * len(lens_) * M_H * M_D * 2
                  + tables.numel() * 4 + len(lens_) * 4)
        bnd = bound_ms(nbytes, 4.0 * rows * M_H * M_D)
        _report("paged_decode_attention_int8", what, ms, plain, lib, bnd, err, ok)
        if "window" in kw:
            headline = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd[0],
                            bound_by=bnd[1],
                            measured_at=f"one launch, 8 ragged slots, window {M_WINDOW}")
        torch.cuda.empty_cache()
    headline["max_abs_err"] = worst
    return headline


def _dense_check(gen, geom, C, window, quant, T, lengths, strides, saturated=(),
                 timed=True, rows=None, sink=None):
    """One dense-cache attention kernel (T queries per slot; T = None the
    single-query decode kernel) against its plain version on ``geom`` =
    (H, KH, D) with a cache of C rows, bf16 or int8 + scales; a second launch
    on the same inputs must give the same bits. Slots listed in
    ``saturated`` run past the cache end: their outputs are unconsumed by
    contract and only have to be finite; with ``rows`` only the queries
    t < rows are compared (a chunk whose last queries run past the cache
    end). ``sink`` = (win_starts, sink rows) takes the multi-query
    kernels' ``_sink`` entry: each slot sees only its rows below the sink
    or from its live-window start on (window+sink compression). Untimed
    cases return no times."""
    import torch.nn.functional as F

    from aios_tpu_torch import ops
    from aios_tpu_torch.ops.decode_attention import dequantize_cache

    h, kh, d = geom
    B = len(lengths)
    multi = T is not None
    Tq = T if multi else 1
    q = torch.randn(B, Tq, h, d, generator=gen, device="cuda").to(torch.bfloat16)
    if quant:
        caches = [torch.randint(-127, 128, (B, C, kh, d), generator=gen,
                                device="cuda").to(torch.int8) for _ in range(2)]
        caches += [torch.rand(B, C, kh, generator=gen, device="cuda") * 0.015 + 0.005
                   for _ in range(2)]
        kd, vd = (dequantize_cache(c, sc).to(torch.bfloat16)
                  for c, sc in zip(caches[:2], caches[2:]))
    else:
        caches = [torch.randn(B, C, kh, d, generator=gen, device="cuda").to(torch.bfloat16)
                  for _ in range(2)]
        kd, vd = caches
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    strd = torch.tensor(strides, dtype=torch.int32, device="cuda")
    kw = {"window": window}
    if sink is not None:
        kw.update(win_starts=torch.tensor(sink[0], dtype=torch.int32, device="cuda"),
                  sink=sink[1])
    if multi:
        fn, ref = ((ops.multiquery_decode_attention_int8,
                    ops.multiquery_decode_attention_int8_reference) if quant else
                   (ops.multiquery_decode_attention,
                    ops.multiquery_decode_attention_reference))
        args = (q, *caches, lens, strd)
    else:
        fn, ref = ((ops.decode_attention_int8, ops.decode_attention_int8_reference)
                   if quant else (ops.decode_attention, ops.decode_attention_reference))
        args = (q[:, 0].contiguous(), *caches, lens)
    out = fn(*args, **kw)
    want = ref(*args, **kw)
    torch.cuda.synchronize()
    keep = [b for b in range(B) if b not in saturated]
    err = (out[keep, :rows].float() - want[keep, :rows].float()).abs().max().item()
    ok = bool(torch.isfinite(out).all()) and err <= TOL and torch.equal(fn(*args, **kw), out)
    if not timed:
        return dict(ok=ok, max_abs_err=err)
    ms = time_ms(lambda: fn(*args, **kw))
    plain = time_ms(lambda: ref(*args, **kw))
    # one library call on the same cache: SDPA under the explicit mask
    steps = torch.arange(Tq, device="cuda")[None, :]
    qpos = lens.long()[:, None] + steps * (strd.long()[:, None] if multi else 0)
    cols = torch.arange(C, device="cuda")[None, None, :]
    mask = cols <= qpos[..., None]
    if window is not None:
        mask &= cols > qpos[..., None] - window
    if sink is not None:
        mask &= (cols < sink[1]) | (cols >= kw["win_starts"].long()[:, None, None])
    kt, vt = (t.transpose(1, 2).contiguous() for t in (kd, vd))  # [B, KH, C, D]
    qt = q.transpose(1, 2).contiguous()  # [B, H, T, D]
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask[:, None], enable_gqa=True))
    rows = float(mask.any(dim=1).sum().item())  # cache rows some query sees
    pairs = float(mask.sum().item())
    row_bytes = kh * (d * (1 if quant else 2) + (4 if quant else 0)) * 2
    nbytes = rows * row_bytes + 2 * B * Tq * h * d * 2 + B * 4 * (2 if multi else 1)
    bnd = bound_ms(nbytes, 4.0 * pairs * h * d)
    return dict(ok=ok, max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=bnd[0], bound_by=bnd[1])


TINY_GEOM, MISTRAL_GEOM, QWEN3_GEOM = (H, KH, D), (M_H, M_KH, M_D), (Q_H, Q_KH, Q_D)
MOE_GEOM = (A_H, A_KH, A_D)
# slot 0 is inactive (length 0, stride 0); the last staircase ends on the last
# cache row; in the saturated cases the last slot runs past the cache end
TINY_LENS = [0, 1, 127, 128, 700, 1500, 2000, 2046]
MISTRAL_LENS = [0, 1, 127, 1000, 4095, 4096, 6000, 8190]
STRIDES = [0, 1, 1, 1, 1, 1, 1, 1]
SPEC_T = 8  # draft_len 7 + 1
# K8 cuts each (slot, kv head)'s visible rows into equal shares of whole
# 32-row chunks, one block each (ops/split.py, split_plan and split_share:
# 8 shares at TinyLlama's shapes, 4 at Mistral's). Lengths whose
# rows fill every share exactly and one row to each side (256 rows: shares of
# 32; 257: shares of 64, the fifth holding one row); windows whose rows fit
# one share (window 200, slots of 21 to 34 rows) or start deep in the cache;
# every slot at length 0 but one.
K8_SPLIT_CASES = [
    ("split edges, TinyLlama C=2048", TINY_GEOM, 2048, None, False, None,
     [255, 256, 257, 511, 512, 513, 1023, 1024], ()),
    ("split-local rows, TinyLlama C=2048 window=200", TINY_GEOM, 2048, 200, False, None,
     [20, 31, 32, 33, 1000, 2046, 0, 300], ()),
    ("split: one slot live, TinyLlama C=2048", TINY_GEOM, 2048, None, False, None,
     [0, 0, 0, 1700, 0, 0, 0, 0], ()),
    (f"split edges and windows deep in the cache, Mistral C=8192 window={M_WINDOW}", MISTRAL_GEOM,
     8192, M_WINDOW, False, None, [5000, 7000, 8191, 1023, 1024, 1025, 4096, 0], ()),
]


# K9 takes the split with a least share of 256 rows at D = 128 (4 shares at
# Mistral-7B's shapes): lengths whose rows fill one, two or four shares
# exactly and one row to each side (256 rows: one share; 257: 256 and one;
# 1024: four of 256; 1025: four of 288); a window whose slots fit one share
# (window 200, slots of 21 to 34 rows); every slot at length 0 but one;
# windows that start deep in the cache.
K9_SPLIT_CASES = [
    ("split edges, Mistral C=8192", MISTRAL_GEOM, 8192, None, True, None,
     [255, 256, 257, 511, 512, 513, 1023, 1024], ()),
    ("split-local rows, Mistral C=8192 window=200", MISTRAL_GEOM, 8192, 200, True, None,
     [20, 31, 32, 33, 1000, 8190, 0, 300], ()),
    ("split: one slot live, Mistral C=8192", MISTRAL_GEOM, 8192, None, True, None,
     [0, 0, 0, 6700, 0, 0, 0, 0], ()),
    (f"split edges and windows deep in the cache, Mistral C=8192 window={M_WINDOW}",
     MISTRAL_GEOM, 8192, M_WINDOW, True, None, [5000, 7000, 8191, 1023, 1024, 1025, 4096, 0],
     ()),
]
# the lengths of a served window: 8 slots of ~300 rows
SERVED_LENS = [290, 295, 300, 305, 310, 315, 320, 325]
# K7 takes K6's tiles and split over the int8 cache, a D = 128 share of at
# least 256 rows (4 splits at Mistral-7B's shapes). A slot's T = 8 queries
# see its length + 8 rows (slot 0, inactive, length + 1): rows that fill
# one, two or four shares exactly and one row to each side (256: one share;
# 257: 256 and one; 1024: four of 256; 1025: four of 288); a window whose
# slots fit one share (window 200: 207 rows); every slot at length 0 but
# one; windows that start deep in the cache.
K7_SPLIT_CASES = [
    (f"split edges, Mistral C=8192 T={SPEC_T}", MISTRAL_GEOM, 8192, None, True, SPEC_T,
     [255, 248, 249, 503, 504, 505, 1016, 1017], ()),
    (f"split-local rows, Mistral C=8192 window=200 T={SPEC_T}", MISTRAL_GEOM, 8192, 200, True,
     SPEC_T, [20, 24, 25, 26, 1000, 8184, 0, 300], ()),
    (f"split: one slot live, Mistral C=8192 T={SPEC_T}", MISTRAL_GEOM, 8192, None, True, SPEC_T,
     [0, 0, 0, 6700, 0, 0, 0, 0], ()),
    (f"split edges and windows deep in the cache, Mistral C=8192 window={M_WINDOW} "
     f"T={SPEC_T}", MISTRAL_GEOM, 8192, M_WINDOW, True, SPEC_T,
     [5000, 7000, 8184, 1015, 1016, 1017, 4088, 0], ()),
]


# K6 and K7 in a jump of grammar-forced tokens: B = 8 slots, T = kb + 1 = 5
# or 17 (JUMP_BUCKETS 4 and 16) over each slot's gathered page view (C =
# MB * P) or its dense cache, slot 0 inactive (length 0, stride 0) as an
# idle slot is; at the served lengths, and for Mistral-7B deep in the cache
# past its window
JUMP_LENS = [0] + SERVED_LENS[1:]
JUMP_CASES = {
    "multiquery_decode_attention": [
        (f"jump: TinyLlama C=2048 T={T}, served lengths", TINY_GEOM, 2048, None, False, T,
         JUMP_LENS, ()) for T in (5, 17)
    ],
    "multiquery_decode_attention_int8": [
        case for T in (5, 17) for case in (
            (f"jump: Mistral C=8192 window={M_WINDOW} T={T}, served lengths", MISTRAL_GEOM,
             8192, M_WINDOW, True, T, JUMP_LENS, ()),
            (f"jump: Mistral C=8192 window={M_WINDOW} T={T}, past the window", MISTRAL_GEOM,
             8192, M_WINDOW, True, T, MISTRAL_LENS[:-1] + [8192 - T], ()))
    ],
}


# The draft rung (TinyLlama-1.1B proposing for Mistral-7B): K8 over the
# draft's dense bf16 cache at Mistral's context (C = 8192) at TinyLlama's
# heads, 8 slots at the served lengths; K6 for its bulk ingest, B = 8 at the
# narrowest and widest buckets (T = 32, 512) from the served lengths; and
# the serving verify of a paged round, K6 (TinyLlama) and K7 (Mistral) at T
# = 8 over each slot's gathered pages (the [B, MB x P, KH, D] view
# ``verify_step_paged`` gathers), slot 0 idle.
DRAFT_CASES = {
    "decode_attention": [
        ("draft step: TinyLlama heads C=8192, served lengths", TINY_GEOM, 8192, None, False,
         None, SERVED_LENS, ()),
    ],
    "multiquery_decode_attention": [
        (f"draft ingest: TinyLlama heads C=8192 T={T}, served lengths", TINY_GEOM, 8192,
         None, False, T, SERVED_LENS, ()) for T in (32, 512)
    ] + [
        (f"paged round over gathered pages: TinyLlama C=2048 T={SPEC_T}", TINY_GEOM, 2048,
         None, False, SPEC_T, JUMP_LENS, ()),
    ],
    "multiquery_decode_attention_int8": [
        (f"paged round over gathered pages: Mistral C=8192 window={M_WINDOW} T={SPEC_T}",
         MISTRAL_GEOM, 8192, M_WINDOW, True, SPEC_T, JUMP_LENS, ()),
    ],
}


# K6 and K7 at a chunk of an admission: B = 1, T = 512 queries from row
# ``start`` (the third chunk of TinyLlama's 1800-token prompt, the last of
# Mistral-7B's 4090 and of its 7000, deep in the window); and a chunk from row
# 1664 (a 13-block prefix hit of a 2047-token prompt) whose last 128 queries
# run past the cache end, compared on its first 384
CHUNK_CASES = {
    "multiquery_decode_attention": [
        ("chunk: TinyLlama C=2048 T=512", TINY_GEOM, 2048, None, False, 512, [1024], ()),
        ("saturated chunk: TinyLlama C=2048 T=512 from row 1664, rows < 384", TINY_GEOM,
         2048, None, False, 512, [1664], (), 384),
    ],
    "multiquery_decode_attention_int8": [
        (f"chunk: Mistral C=8192 window={M_WINDOW} T=512", MISTRAL_GEOM, 8192, M_WINDOW,
         True, 512, [3584], ()),
        (f"chunk: Mistral C=8192 window={M_WINDOW} T=512 past the window", MISTRAL_GEOM,
         8192, M_WINDOW, True, 512, [6656], ()),
    ],
}


# K6 and K7 with window+sink compression's predicate (the ``_sink`` entries):
# the verify forward of 8 slots (T = 8) over their gathered pages, slot 0
# idle, the others at ~1200-2000 rows with live-window starts of 0 (not yet
# pruned) to 1024 rows behind a sink of 128 rows, at TinyLlama's heads over
# the bf16 and the int8 pool and at Mistral-7B's over the int8 pool; and the
# chunk of an admission that crossed the threshold (B = 1, T = 512 from row
# 1536, start 512: the 1900-token prompt's last chunk at sink 1 + window 8).
SINK_LENS = [0, 1200, 1300, 1500, 1700, 1900, 1950, 2000]
SINK_STARTS = [0, 0, 256, 512, 640, 896, 896, 1024]
SINK_CASES = {
    "multiquery_decode_attention": [
        (f"sink=128 win_starts={SINK_STARTS}: TinyLlama C=2048 T={SPEC_T}", TINY_GEOM, 2048,
         None, False, SPEC_T, SINK_LENS, (), None, (SINK_STARTS, P)),
        ("sink=128 win_start=512, chunk: TinyLlama C=2048 T=512", TINY_GEOM, 2048, None,
         False, 512, [1536], (), None, ([512], P)),
    ],
    "multiquery_decode_attention_int8": [
        (f"sink=128 win_starts={SINK_STARTS}: TinyLlama int8 C=2048 T={SPEC_T}", TINY_GEOM,
         2048, None, True, SPEC_T, SINK_LENS, (), None, (SINK_STARTS, P)),
        ("sink=128 win_start=512, chunk: TinyLlama int8 C=2048 T=512", TINY_GEOM, 2048,
         None, True, 512, [1536], (), None, ([512], P)),
        (f"sink=128 win_starts={SINK_STARTS}: Mistral C=8192 T={SPEC_T}", MISTRAL_GEOM, 8192,
         None, True, SPEC_T, SINK_LENS, (), None, (SINK_STARTS, P)),
    ],
}


def check_dense_attention(gen) -> dict:
    """K8, K9, K6 and K7 at the shapes the dense servers give them."""
    def mq_lens(lens, C, T=SPEC_T):
        return lens[:-1] + [C - T]

    cases = {
        "decode_attention": [
            ("TinyLlama C=2048", TINY_GEOM, 2048, None, False, None, TINY_LENS, ()),
            (f"Mistral C=8192 window={M_WINDOW}", MISTRAL_GEOM, 8192, M_WINDOW, False,
             None, MISTRAL_LENS, ()),
            *K8_SPLIT_CASES,
            *DRAFT_CASES["decode_attention"],
        ],
        "decode_attention_int8": [
            (f"Mistral C=8192 window={M_WINDOW}", MISTRAL_GEOM, 8192, M_WINDOW, True,
             None, MISTRAL_LENS, ()),
            ("Mistral C=8192 no window", MISTRAL_GEOM, 8192, None, True, None,
             MISTRAL_LENS, ()),
            (f"Mistral C=8192 window={M_WINDOW}, served lengths", MISTRAL_GEOM, 8192,
             M_WINDOW, True, None, SERVED_LENS, ()),
            *K9_SPLIT_CASES,
        ],
        "multiquery_decode_attention": [
            (f"TinyLlama C=2048 T={SPEC_T}", TINY_GEOM, 2048, None, False, SPEC_T,
             mq_lens(TINY_LENS, 2048), ()),
            (f"Mistral C=8192 window={M_WINDOW} T={SPEC_T}", MISTRAL_GEOM, 8192, M_WINDOW,
             False, SPEC_T, mq_lens(MISTRAL_LENS, 8192), ()),
            (f"TinyLlama C=2048 T={SPEC_T}, slot 7 saturated", TINY_GEOM, 2048, None,
             False, SPEC_T, TINY_LENS, (7,)),
            ("TinyLlama C=2048 T=31", TINY_GEOM, 2048, None, False, 31,
             mq_lens(TINY_LENS, 2048, 31), ()),
            ("TinyLlama C=2048 T=3", TINY_GEOM, 2048, None, False, 3,
             mq_lens(TINY_LENS, 2048, 3), ()),
            (f"TinyLlama C=2048 T={SPEC_T}, served lengths", TINY_GEOM, 2048, None, False,
             SPEC_T, SERVED_LENS, ()),
            *CHUNK_CASES["multiquery_decode_attention"],
            (f"Qwen3 heads C=8192 T={SPEC_T}", QWEN3_GEOM, 8192, None, False, SPEC_T,
             mq_lens(MISTRAL_LENS, 8192), ()),
            ("chunk: Qwen3 heads C=8192 T=512", QWEN3_GEOM, 8192, None, False, 512, [3584],
             ()),
            (f"Qwen3-30B-A3B heads C=32768 T={SPEC_T}", MOE_GEOM, 32768, None, False, SPEC_T,
             [0, 1, 127, 300, 1000, 4096, 16000, 32760], ()),
            ("chunk: Qwen3-30B-A3B heads C=32768 T=512", MOE_GEOM, 32768, None, False, 512,
             [1024], ()),
            ("chunk: Qwen3-30B-A3B heads C=32768 T=512 deep in the cache", MOE_GEOM, 32768,
             None, False, 512, [30720], ()),
            *JUMP_CASES["multiquery_decode_attention"],
            *DRAFT_CASES["multiquery_decode_attention"],
            *SINK_CASES["multiquery_decode_attention"],
        ],
        "multiquery_decode_attention_int8": [
            (f"Mistral C=8192 window={M_WINDOW} T={SPEC_T}", MISTRAL_GEOM, 8192, M_WINDOW,
             True, SPEC_T, mq_lens(MISTRAL_LENS, 8192), ()),
            (f"Mistral C=8192 window={M_WINDOW} T={SPEC_T}, slot 7 saturated", MISTRAL_GEOM,
             8192, M_WINDOW, True, SPEC_T, MISTRAL_LENS, (7,)),
            (f"Mistral C=8192 window={M_WINDOW} T={SPEC_T}, served lengths", MISTRAL_GEOM,
             8192, M_WINDOW, True, SPEC_T, SERVED_LENS, ()),
            (f"Mistral C=8192 window={M_WINDOW} T=31", MISTRAL_GEOM, 8192, M_WINDOW, True, 31,
             mq_lens(MISTRAL_LENS, 8192, 31), ()),
            *K7_SPLIT_CASES,
            *CHUNK_CASES["multiquery_decode_attention_int8"],
            *JUMP_CASES["multiquery_decode_attention_int8"],
            *DRAFT_CASES["multiquery_decode_attention_int8"],
            *SINK_CASES["multiquery_decode_attention_int8"],
        ],
    }
    measured = {}
    for name, rows in cases.items():
        worst = 0.0
        for i, (label, geom, C, window, quant, T, lens, sat, *valid) in enumerate(rows):
            timed = not label.startswith(("split", "saturated"))
            strides = STRIDES if len(lens) == len(STRIDES) else [1] * len(lens)
            r = _dense_check(gen, geom, C, window, quant, T, lens, strides, sat, timed,
                             *valid)
            what = f"B={len(lens)} lengths={lens} {label}, repeat bit-identical"
            if timed:
                _report(name, what, r["ms"], r["plain_ms"], r["library_ms"],
                        (r["bound_ms"], r["bound_by"]), r["max_abs_err"], r["ok"])
            else:
                log(f"[kernel] {name} {what}: ok={r['ok']} "
                    f"max_abs_err={r['max_abs_err']:.3e} (checked only)")
            expect(r["ok"], f"{name} {label}: max err {r['max_abs_err']}")
            worst = max(worst, r["max_abs_err"])
            if i == 0:  # the headline: the shape its dense server launches
                measured[name] = dict(r, measured_at=f"one launch, 8 ragged slots, {label}")
            torch.cuda.empty_cache()
        measured[name]["max_abs_err"] = worst
    return measured


# -- K1's expert entry: the stacked int8 experts of a mixture-of-experts layer --

# (X, K, N) of each expert stack: Qwen3-30B-A3B's fused gate|up and down (48
# layers) and Mixtral-8x7B's
QWEN3_MOE_EXPERTS = {"we_gateup": (128, 2048, 1536), "we_down": (128, 768, 2048)}
MIXTRAL_EXPERTS = {"we_gateup": (8, 4096, 28672), "we_down": (8, 14336, 4096)}
MOE_K = 8  # Qwen3-30B-A3B's experts a token


def _expert_stack(gen, X, K, N):
    """A random int8 stack [X, K, N] with [X, 1, N] scales, made in place
    (an int64 draw of Mixtral's 940 MB stack would take 7.5 GB)."""
    q = torch.empty((X, K, N), dtype=torch.int8, device="cuda").random_(-127, 128, generator=gen)
    s = torch.rand(X, 1, N, generator=gen, device="cuda") * (0.04 / 127) + 1e-5
    return q, s


def _pick_rows(gen, tokens: int, X: int, k: int) -> torch.Tensor:
    """[tokens * k] int32 picks, k distinct experts a token, as top-k routes."""
    return torch.stack([torch.randperm(X, generator=gen, device="cuda")[:k]
                        for _ in range(tokens)]).reshape(-1).to(torch.int32)


def _expert_case(gen, label, X, K, N, layout, rows, picks=None) -> dict:
    """One expert-entry launch against its plain twin within TOL of max|ref|
    and bit-identical on repeat; its time, the plain twin's, one library
    call's (``torch.matmul``/``torch.bmm`` on the bf16 dequantized stack,
    the picks gathered first) and the bound: x, every expert the launch
    reads (the distinct picks of a per-pick launch), the scales and y."""
    from aios_tpu_torch import ops

    q, s = _expert_stack(gen, X, K, N)
    if layout == "shared":
        x = torch.randn(rows, K, generator=gen, device="cuda").to(torch.bfloat16)
        n_rows = X * rows
    elif layout == "per expert":
        x = torch.randn(X, rows, K, generator=gen, device="cuda").to(torch.bfloat16)
        n_rows = X * rows
    else:
        x = torch.randn(picks.numel(), K, generator=gen, device="cuda").to(torch.bfloat16)
        n_rows = picks.numel()
    y = ops.quantized_matmul_experts(x, q, s, picks)
    ref = ops.quantized_matmul_experts_reference(x, q, s, picks)
    torch.cuda.synchronize()
    err = (y.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    ok = (bool(torch.isfinite(y).all()) and err <= TOL * scale
          and torch.equal(ops.quantized_matmul_experts(x, q, s, picks), y))
    expect(ok, f"quantized_matmul_experts {label}: err {err} vs max|ref| {scale}")
    del ref
    ms = time_ms(lambda: ops.quantized_matmul_experts(x, q, s, picks))
    plain = time_ms(lambda: ops.quantized_matmul_experts_reference(x, q, s, picks), iters=5,
                    warmup=1)
    w = (q.float() * s).to(torch.bfloat16)
    if picks is None:
        lib = time_ms(lambda: torch.matmul(x, w) if layout == "shared" else torch.bmm(x, w))
        touched = X
    else:
        pl = picks.long()
        lib = time_ms(lambda: torch.bmm(x[:, None, :], w[pl]))
        touched = int(torch.unique(picks).numel())
    del w
    nbytes = x.numel() * 2 + touched * (K * N + N * 4) + y.numel() * 2
    bnd = bound_ms(nbytes, 2.0 * n_rows * K * N)
    _report("quantized_matmul_experts", f"{label} {layout} x {tuple(x.shape)} over "
            f"[{X}, {K}, {N}] ({touched} experts read), repeat bit-identical", ms, plain, lib,
            bnd, err, ok)
    del q, s, x, y
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bytes=nbytes, bound_ms=bnd[0],
                bound_by=bnd[1], max_abs_err=err)


def check_quantized_matmul_experts(gen) -> dict:
    """The expert entry in its three row layouts at the shapes the MoE path
    gives it: Qwen3-30B-A3B's dense decode step (8 slots over all 128
    experts: gate|up over shared rows, down over each expert's own rows),
    its gather at 8 slots (P = 64 picks) and at one (P = 8), its 512-row
    chunk, and Mixtral-8x7B's stacks at M = 8 and 512; then the sums of a
    Qwen3-30B-A3B decode step, gather step and chunk (48 layers, two
    launches each)."""
    gu, dn = QWEN3_MOE_EXPERTS["we_gateup"], QWEN3_MOE_EXPERTS["we_down"]
    cases = {
        "decode": [("Qwen3-30B-A3B decode gate|up", *gu, "shared", 8, None),
                   ("Qwen3-30B-A3B decode down", *dn, "per expert", 8, None)],
        "gather8": [("Qwen3-30B-A3B gather 8 slots gate|up", *gu, "per pick", 0,
                     _pick_rows(gen, 8, gu[0], MOE_K)),
                    ("Qwen3-30B-A3B gather 8 slots down", *dn, "per pick", 0,
                     _pick_rows(gen, 8, gu[0], MOE_K))],
        "gather1": [("Qwen3-30B-A3B gather 1 slot gate|up", *gu, "per pick", 0,
                     _pick_rows(gen, 1, gu[0], MOE_K)),
                    ("Qwen3-30B-A3B gather 1 slot down", *dn, "per pick", 0,
                     _pick_rows(gen, 1, gu[0], MOE_K))],
        "chunk": [("Qwen3-30B-A3B 512-row chunk gate|up", *gu, "shared", 512, None),
                  ("Qwen3-30B-A3B 512-row chunk down", *dn, "per expert", 512, None)],
        "mixtral": [(f"Mixtral-8x7B {name} M={M}", *xkn,
                     "shared" if name == "we_gateup" else "per expert", M, None)
                    for M in (8, 512) for name, xkn in MIXTRAL_EXPERTS.items()],
    }
    out, worst = {}, 0.0
    for key, rows in cases.items():
        acc = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, by=set())
        for label, X, K, N, layout, M, picks in rows:
            r = _expert_case(gen, label, X, K, N, layout, M, picks)
            worst = max(worst, r["max_abs_err"])
            for f in ("ms", "plain_ms", "library_ms", "bound_ms"):
                acc[f] += r[f]
            acc["by"].add(r["bound_by"])
        out[key] = acc
    per_layer = out["decode"]["bound_ms"]
    log(f"[kernel] quantized_matmul_experts Qwen3-30B-A3B dense decode: bound "
        f"{per_layer:.4f} ms a layer by bytes (every expert's int8 rows and scales at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
    for key, what in (("decode", "one dense decode step, 8 slots"),
                      ("gather8", "one gather decode step, 8 slots (P = 64)"),
                      ("gather1", "one gather decode step, 1 slot (P = 8)"),
                      ("chunk", "one 512-row chunk")):
        a = out[key]
        log(f"[kernel] quantized_matmul_experts Qwen3-30B-A3B {what} ({2 * A_L} launches): "
            f"kernel_ms={A_L * a['ms']:.4f} plain_ms={A_L * a['plain_ms']:.4f} "
            f"library_ms={A_L * a['library_ms']:.4f} bound_ms={A_L * a['bound_ms']:.4f} "
            f"x{a['ms'] / a['bound_ms']:.2f} of bound, x{a['ms'] / a['library_ms']:.2f} of "
            f"torch.matmul/bmm on the dequantized stack")
    d = out["decode"]
    return dict(max_abs_err=worst, ms=A_L * d["ms"], plain_ms=A_L * d["plain_ms"],
                library_ms=A_L * d["library_ms"], bound_ms=A_L * d["bound_ms"],
                bound_by="/".join(sorted(d["by"])),
                measured_at=f"one Qwen3-30B-A3B dense decode step: {2 * A_L} launches, 8 slots "
                            "over 128 experts")


def check_mega_gate(gen) -> dict:
    """The megagraph's gate (``ops.mega_gate``, launched without a
    conditional handle) against its plain version over 8 slots: random live
    flags at every tick of an 8-tick window, each slot alone live, no slot
    live and ticks past the cap. Times one launch beside the plain
    version's ops."""
    from aios_tpu_torch import ops

    S, K, ctx = 8, 8, 2047
    go = torch.zeros(K, dtype=torch.int32, device="cuda")
    worst, n = 0, 0
    for trial in range(48):
        cap = torch.tensor([trial % (K + 1)], dtype=torch.int32, device="cuda")
        active = torch.rand(S, generator=gen, device="cuda") < 0.6
        done = torch.rand(S, generator=gen, device="cuda") < 0.3
        rem = torch.randint(-1, 3, (S,), generator=gen, device="cuda").to(torch.int32)
        lengths = torch.randint(ctx - 3, ctx + 1, (S,), generator=gen,
                                device="cuda").to(torch.int32)
        if trial < S:  # one slot live alone
            active.zero_(), done.zero_(), rem.zero_()
            active[trial], rem[trial], lengths[trial] = True, 5, 10
        for tick in range(K):
            ops.mega_gate(tick, cap, active, done, rem, lengths, ctx, go)
            want = ops.mega_gate_reference(tick, cap, active, done, rem, lengths, ctx)
            worst = max(worst, abs(int(go[tick]) - int(want[0])))
            n += 1
    expect(worst == 0, "mega_gate disagrees with its plain version")
    cap = torch.tensor([K], dtype=torch.int32, device="cuda")
    args = (3, cap, active, done, rem, lengths, ctx)
    ms = time_ms(lambda: ops.mega_gate(*args, go))
    plain = time_ms(lambda: ops.mega_gate_reference(*args))
    bnd = bound_ms(S * (1 + 1 + 4 + 4) + 4 + 4, 4.0 * S)
    _report("mega_gate", f"{n} gates of 8 slots (random flags, one live slot, none, past "
            "the cap)", ms, plain, None, bnd, float(worst), True)
    return dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=bnd[0], bound_by=bnd[1],
                max_abs_err=float(worst), measured_at="one launch, 8 slots")


def phase_kernels() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    # what time_ms reads for a kernel that does nothing: the floor under
    # every per-launch time below, and so under every per-step sum
    log(f"[kernel] timing floor: an empty kernel under time_ms takes "
        f"{time_ms(lambda: torch.cuda._sleep(1)):.4f} ms")
    measured = {
        "mega_gate": check_mega_gate(gen),
        "quantized_matmul": check_quantized_matmul(gen),
        "flash_attention": check_flash_attention(gen),
        "paged_decode_attention": check_paged_decode_attention(gen),
        "paged_decode_attention_int8": check_paged_decode_attention_int8(gen),
        "int4_matmul": check_int4_matmul(gen),
        **check_dense_attention(gen),
        "quantized_matmul_experts": check_quantized_matmul_experts(gen),
    }
    check_int4_matmul_draft(gen)
    return measured


# -- phase 4: serve TinyLlama-1.1B over gRPC through the kernels ---------------

PROMPTS = (  # chat-templated byte prompts land in buckets 256, 512, 1024, 2048
    "Summarize the state of the cluster. " * 6,
    "List the failing services and why. " * 12,
    "Draft a remediation plan, step by step. " * 24,
    "Explain every alert from the last hour. " * 45,
)
MAX_TOKENS = 64


def _load(manager, stub, name: str, path: str, ctx: int = 0):
    from aios_tpu_torch.proto_gen import runtime_pb2

    t0 = time.perf_counter()
    st = stub.LoadModel(runtime_pb2.LoadModelRequest(
        model_name=name, model_path=path, context_length=ctx), timeout=1200)
    load_s = time.perf_counter() - t0
    expect(st.status == "ready", f"LoadModel {path} returned {st.status!r}")
    return manager.get(name), load_s


def _served_window(manager, stub, m, card: str, tag: str = "", prompts=PROMPTS) -> dict:
    """Three Infer and one StreamInfer of ``prompts`` at once over gRPC, with
    every kernel count set to 0 just before and read just after."""
    from aios_tpu_torch import ops
    from aios_tpu_torch.engine.tokenizer import render_chat
    from aios_tpu_torch.proto_gen import common_pb2, runtime_pb2

    eng, cfg = m.engine, m.config
    # LoadModel captured the step graph, with speculation the round graph of
    # the batcher's sizes, and the admission graphs: nothing is captured
    # while serving
    captured = eng.stats()["graph_captures"]
    expect(captured == _planned_graphs(m), f"{captured} graphs captured at LoadModel, "
           f"planned {_planned_graphs(m)}")
    # one short request first, so the counted window excludes one-time setup
    stub.Infer(runtime_pb2.InferRequest(prompt="warm up", max_tokens=4), timeout=300)

    for k in ops.KERNELS:
        k.launches = 0
    tokens0, steps0, prefills0 = m.batcher.tokens_emitted, eng.decode_steps, eng.prefills
    admission_chunks0, ingest0 = eng.prefill_chunks, eng.draft_ingest_dispatches
    replays0 = eng.stats()["graph_replays"]
    results, errors = {}, []

    def infer(i):
        r = stub.Infer(runtime_pb2.InferRequest(
            prompt=prompts[i], max_tokens=MAX_TOKENS, temperature=0.5), timeout=600)
        results[i] = r

    def stream(i):
        results[i] = list(stub.StreamInfer(runtime_pb2.InferRequest(
            prompt=prompts[i], max_tokens=MAX_TOKENS, temperature=0.5), timeout=600))

    def run(fn, i):
        try:
            fn(i)
        except Exception as exc:  # noqa: BLE001 - re-raised on the main thread
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(infer, i)) for i in range(3)]
    threads.append(threading.Thread(target=run, args=(stream, 3)))
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    expect(not errors, f"requests failed: {errors!r}")
    expect(all(not t.is_alive() for t in threads), "a request did not finish")
    launches = {k.__name__: k.launches for k in ops.KERNELS}
    tokens = m.batcher.tokens_emitted - tokens0
    prefills, steps = eng.prefills - prefills0, eng.decode_steps - steps0
    admission_chunks = eng.prefill_chunks - admission_chunks0
    ingest = eng.draft_ingest_dispatches - ingest0
    stats = eng.stats()
    replays = stats["graph_replays"] - replays0
    expect(stats["graph_captures"] == captured,
           f"{stats['graph_captures'] - captured} graphs captured while serving")
    expect(replays == steps + prefills + admission_chunks + ingest,
           f"{replays} graph replays for {steps} dispatched steps or rounds, {prefills} "
           f"prefills, {admission_chunks} chunks and {ingest} draft ingests")
    for i in range(3):
        n_prompt = len(m.tokenizer.encode(render_chat(cfg.name, prompts[i])))
        expect(results[i].tokens_used > n_prompt, f"Infer {i} returned no tokens")
    chunks = results[3]
    expect(chunks and chunks[-1].done and all(not c.done for c in chunks[:-1]),
           "StreamInfer did not end with one done chunk")
    expect(tokens >= 4, f"only {tokens} tokens emitted")
    models = stub.ListModels(common_pb2.Empty())
    health = stub.HealthCheck(common_pb2.Empty())
    expect([x.model_name for x in models.models] == [m.name], "ListModels")
    expect(health.details.get("backend") == "torch-cuda", f"HealthCheck {dict(health.details)}")
    log(
        f"[serve] {cfg.name}{tag}: 3 Infer + 1 StreamInfer (prompts {[len(p) for p in prompts]} "
        f"chars, max_tokens {MAX_TOKENS}) in {wall:.3f} s: {tokens} tokens, "
        f"{tokens / wall:.1f} tok/s end to end on {card}; "
        f"{prefills} whole-prompt prefills, {admission_chunks} admission chunks, {steps} "
        f"decode steps, "
        f"{replays} graph replays, graph captures flat at {captured} since LoadModel "
        f"({stats['graph_capture_seconds']} s); launches {launches}"
    )
    log(f"[serve] health: {health.details.get(m.name + '.serving')}")
    return dict(launches=launches, prefills=prefills, steps=steps, chunks=admission_chunks)


def _planned_graphs(m) -> int:
    """The graphs ``LoadModel`` captures for ``m``: the decode step, with
    speculation the round (over either cache), with a draft its fused round
    and one ingest graph per width, and the admission plan at the batcher's
    chunk."""
    eng = m.engine
    buckets, chunks = eng.admission_plan(eng.prefill_chunk_default)
    draft = 1 + len(eng._draft_ingest_buckets()) if eng.draft is not None else 0
    return 1 + m.batcher.speculative + draft + len(buckets) + len(chunks)


def _graphs_line(m, load_s: float) -> str:
    eng = m.engine
    return (f"LoadModel {load_s:.2f} s, {eng.graphs.captures} graphs captured in it "
            f"({eng.graphs.capture_seconds:.2f} s of captures; {eng.admission_graphs()} of "
            f"admission in a shared pool of {eng.admission_pool_bytes} B, reserved bytes "
            f"before and after their captures)")


def _refused_load(stub) -> None:
    """A geometry no kernel takes is refused at LoadModel on the card:
    ``synthetic://tiny-test`` (head_dim 16) answers status error naming
    head_dim, lists as error and never as ready, and is unloaded again."""
    import grpc

    from aios_tpu_torch.proto_gen import common_pb2, runtime_pb2

    try:
        st = stub.LoadModel(runtime_pb2.LoadModelRequest(
            model_name="tiny", model_path="synthetic://tiny-test"), timeout=300)
        code, details = st.status, ""
    except grpc.RpcError as exc:
        code, details = exc.code().name, exc.details() or ""
    listed = {x.model_name: x.status for x in stub.ListModels(common_pb2.Empty()).models}
    expect(code == "INTERNAL" and "head_dim 16" in details and listed.get("tiny") == "error",
           f"LoadModel synthetic://tiny-test: {code} {details!r}, listed {listed}")
    log(f"[serve] LoadModel synthetic://tiny-test refused: {code}, listed as "
        f"{listed['tiny']!r}: {details}")
    expect(stub.UnloadModel(runtime_pb2.UnloadModelRequest(model_name="tiny")).success,
           "UnloadModel tiny")


def phase_serve(manager, stub, card: str) -> dict:
    _refused_load(stub)
    m, load_s = _load(manager, stub, "tinyllama", "synthetic://tinyllama-1.1b")
    eng, cfg = m.engine, m.config
    expect(
        (cfg.num_layers, cfg.hidden_size, cfg.vocab_size, eng.max_context)
        == (22, 2048, 32000, 2048),
        f"not the full TinyLlama geometry: {cfg}",
    )
    expect(eng.quantized and eng.k_pool.dtype == torch.bfloat16, "expected int8 weights, bf16 pool")
    log(
        f"[serve] LoadModel synthetic://tinyllama-1.1b ready in {load_s:.2f} s: "
        f"{cfg.num_layers} layers, E={cfg.hidden_size}, V={cfg.vocab_size}, ctx={eng.max_context}, "
        f"int8 weights, bf16 pool of {eng.allocator.num_pages} pages x {eng.allocator.page_size} rows"
    )
    log(f"[serve] {cfg.name}: {_graphs_line(m, load_s)}")
    log(f"[serve] chunked admission at {m.batcher.prefill_chunk} rows, prefix index "
        f"{type(eng.prefix_index).__name__}, split workspace {eng.workspace_bytes()} B a "
        f"stream (a 512-row chunk over {eng.max_context} rows)")
    w = _served_window(manager, stub, m, card)
    launches, pre, steps, chunks = w["launches"], w["prefills"], w["steps"], w["chunks"]
    for name in TINYLLAMA_KERNELS:
        expect(launches[name] > 0, f"kernel {name} never launched while serving")
    want = dict.fromkeys(launches, 0)
    want.update({"quantized_matmul": 89 * (pre + chunks + steps), "flash_attention": 22 * pre,
                 "paged_decode_attention": 22 * steps,
                 "multiquery_decode_attention": 22 * chunks})
    expect(launches == want, f"launch counts {launches} != {want} for {pre} prefills, "
           f"{chunks} chunks, {steps} steps")
    log(f"[serve] launch counts exact for {pre} whole-prompt prefills, {chunks} admission "
        f"chunks (the 960- and 1800-byte prompts) and {steps} decode steps (each step one "
        f"graph replay): {launches}")
    _prefix_over_grpc(m, stub, card)
    _overrun_hit(m)
    return launches


# -- phase 5: model numerics, determinism and where the time goes --------------


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def _admission(m, n: int) -> str:
    """How the batcher admits an n-token prompt."""
    chunk = m.batcher.prefill_chunk
    if chunk and n > chunk:
        return f"{-(-n // chunk)} chunks of {chunk}"
    return f"whole-prompt, bucket {m.engine.bucket_for(n)}"


def _logits_gate(m, tag: str, vocab: int, tol: float = E2E_TOL) -> None:
    """Prefill (T = 512) and decode-step logits through the kernels against
    the plain path on the served params, within ``tol`` of max|logit|: the
    prompt's tokens drawn below ``vocab``, the step for 8 ragged slots over
    pools holding that prompt's K/V."""
    from aios_tpu_torch.engine import model

    eng, cfg, params = m.engine, m.config, m.engine.params
    gen = torch.Generator(device="cuda").manual_seed(1)
    T = 512
    tokens = torch.randint(0, vocab, (1, T), generator=gen, device="cuda")
    lk, _, _ = model.prefill(params, cfg, tokens, kernels=True)
    lp, ksp, vsp = model.prefill(params, cfg, tokens, kernels=False)
    rel_prefill = _rel(lk, lp)
    B, L, kh, d = 8, cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    nb = T // P
    k_pool = torch.zeros((L, 1 + B * nb, P, kh, d), dtype=torch.bfloat16, device="cuda")
    v_pool = torch.zeros_like(k_pool)
    order = torch.randperm(B * nb, generator=torch.Generator().manual_seed(3)) + 1
    tables = order.reshape(B, nb).to(torch.int32)
    tables = torch.cat([tables, torch.zeros(B, 16 - nb, dtype=torch.int32)], 1).cuda()
    for b in range(B):
        pages = tables[b, :nb].long()
        k_pool[:, pages] = ksp[:, 0].reshape(L, nb, P, kh, d).to(torch.bfloat16)
        v_pool[:, pages] = vsp[:, 0].reshape(L, nb, P, kh, d).to(torch.bfloat16)
    lengths = torch.tensor([0, 5, 127, 128, 200, 300, 400, 510], dtype=torch.int32, device="cuda")
    step_tokens = torch.randint(0, vocab, (B,), generator=gen, device="cuda")
    dk = model.decode_step_paged(params, cfg, step_tokens, lengths, k_pool.clone(),
                                 v_pool.clone(), tables, kernels=True)
    dp = model.decode_step_paged(params, cfg, step_tokens, lengths, k_pool.clone(),
                                 v_pool.clone(), tables, kernels=False)
    rel_decode = _rel(dk, dp)
    ok = (rel_prefill <= tol and rel_decode <= tol
          and bool(torch.isfinite(lk).all()) and bool(torch.isfinite(dk).all())
          and lk.shape[-1] == dk.shape[-1] == cfg.vocab_size)
    log(
        f"{tag} kernel path vs plain path, full model: prefill T={T} "
        f"max|dlogit|/max|logit|={rel_prefill:.3e}, decode step B=8 "
        f"max|dlogit|/max|logit|={rel_decode:.3e} (limit {tol}); "
        f"prefill argmax agreement {(lk.argmax(-1) == lp.argmax(-1)).float().mean().item():.3f}, "
        f"decode {(dk.argmax(-1) == dp.argmax(-1)).float().mean().item():.3f}; "
        f"logits [..., {lk.shape[-1]}]"
    )
    expect(ok, f"{tag} kernel and plain logits disagree")


def phase_numerics(manager, card: str) -> None:
    from aios_tpu_torch.engine.batching import Request

    m = manager.get("tinyllama")
    eng, cfg = m.engine, m.config
    _logits_gate(m, "[numerics]", 256)

    # two cold admissions (an index hit would admit the second through the
    # chunk path, whose sums are taken in another order)
    ids = [256] + list(range(200))
    eng.prefix_index.clear()
    a = m.batcher.generate(ids, max_tokens=32, temperature=0.0)
    eng.prefix_index.clear()
    b = m.batcher.generate(ids, max_tokens=32, temperature=0.0)
    expect(len(a) == 32 and a == b, f"greedy streams differ: {a} vs {b}")
    log(f"[numerics] two greedy batcher streams of 32 tokens identical: {a[:8]}...")

    # time to first token and decode rate on the idle server, cold index
    for n in (250, 1000):
        eng.prefix_index.clear()
        h = m.batcher.submit(Request(prompt_ids=[256] + [65] * n, max_tokens=2,
                                     temperature=0.0))
        h.tokens()
        log(f"[serve] ttft_ms={h.ttft_ms:.2f} for a {n + 1}-token prompt "
            f"({_admission(m, n + 1)}) on an idle server, {card}")
    hs = [m.batcher.submit(Request(prompt_ids=[256] + list(range(100)), max_tokens=129,
                                   temperature=0.7)) for _ in range(eng.num_slots)]
    steps0 = eng.decode_steps
    t0 = time.perf_counter()
    n_tok = sum(len(h.tokens()) for h in hs)
    wall = time.perf_counter() - t0
    steps = eng.decode_steps - steps0
    log(f"[serve] 8 slots x 129 tokens: {n_tok} tokens in {wall:.3f} s = {n_tok / wall:.1f} tok/s, "
        f"{steps} decode steps, {wall / max(steps, 1) * 1e3:.2f} ms per step (host clock, "
        f"prefills included), {card}")

    _graph_vs_eager("[numerics]", eng, {"quantized_matmul": 89, "paged_decode_attention": 22},
                    rounds=False)
    _fresh_noise("[numerics]", eng, rounds=False)
    _profile_decode(eng, "tinyllama", 16, card)
    _admission_graphs("[admission tinyllama]", m, card)
    _chunk_numerics(m, 1800, card)
    _interleaved(m, 1800, card)


# -- chunked admission and the prefix cache --------------------------------------


def _reset_counts() -> None:
    from aios_tpu_torch import ops

    for k in ops.KERNELS:
        k.launches = 0


def _read_counts() -> dict:
    from aios_tpu_torch import ops

    torch.cuda.synchronize()
    return {k.__name__: k.launches for k in ops.KERNELS if k.launches}


def _counted(fn):
    """``fn()`` with every kernel count set to 0 just before; returns its
    result and the launches it made, {kernel: launches}."""
    _reset_counts()
    out = fn()
    return out, _read_counts()


def _busy_and_wall(fn):
    """(device busy ms, host wall ms) of one eager ``fn()``: the busy time is
    the sum of its device events under torch.profiler, the wall the median
    of three unprofiled calls, synchronized."""
    from torch.profiler import ProfilerActivity, profile

    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy = sum(us for _, us in _device_kernels(prof).values()) / 1e3
    return busy, statistics.median(walls) * 1e3


def _chunk_plan(eng, n: int, chunk: int = 512, start: int = 0):
    """(start, rows, bucket) of each chunk of an n-token admission from
    ``start``, as ``ChunkedPrefill`` runs them."""
    plan, pos = [], start
    while pos < n:
        rows = min(chunk, n - pos)
        plan.append((pos, rows, eng.bucket_for(rows) if n - pos <= chunk else chunk))
        pos += rows
    return plan


def _chunk_kernels(eng) -> dict:
    """The launches one chunk of ``eng`` makes: every projection and the
    lm_head, and a K6 (bf16 cache) or K7 (int8 cache) per layer."""
    L = eng.cfg.num_layers
    mm = "int4_matmul" if "q4" in eng.params["lm_head"] else "quantized_matmul"
    attn = ("multiquery_decode_attention_int8" if eng.quant_cache
            else "multiquery_decode_attention")
    return {mm: 4 * L + 1, attn: L}


def _layerwise_chunk(eng, toks, start: int, pools, table, rows: int):
    """Each sublayer of one chunk over a one-slot pool run through the
    kernels and through the plain versions on the SAME input (the plain
    path's), each writing its K/V rows into its own copy of that layer's
    pool, so that rounding does not compound over depth: the largest
    max|difference| / max|output| over the attention and MLP sublayers of
    every layer on the chunk's first ``rows`` rows, and the logits of both
    paths from the plain path's final hidden state relative to
    max|logit|."""
    from aios_tpu_torch import ops
    from aios_tpu_torch.engine import model

    cfg, params = eng.cfg, eng.params
    Tc, P, kh, d = toks.shape[1], pools[0].shape[2], pools[0].shape[3], pools[0].shape[4]
    C = table.shape[0] * P
    st = torch.tensor([start], dtype=torch.int32, device="cuda")
    strides = torch.ones(1, dtype=torch.int32, device="cuda")
    positions = st.long()[:, None] + torch.arange(Tc, device="cuda")[None, :]
    cos, sin = model.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    pages, offs = model.chunk_write_rows(table, st, Tc, P)
    t = table.long()
    x = params["embed"][toks]
    worst = 0.0
    for i, lp in enumerate(model.layer_params(params)):
        attn = {}
        for kernels in (True, False):
            q, k, v = model._project_qkv(x, lp, cfg, cos, sin, kernels)
            kl, vl, ks, vs = (p[i].clone() for p in pools)
            model.scatter_quant(kl, ks, pages, offs, k[0])
            model.scatter_quant(vl, vs, pages, offs, v[0])
            caches = (kl[t].reshape(1, C, kh, d), vl[t].reshape(1, C, kh, d),
                      ks[t].reshape(1, C, kh), vs[t].reshape(1, C, kh))
            fn = (ops.multiquery_decode_attention_int8 if kernels
                  else ops.multiquery_decode_attention_int8_reference)
            a = fn(q.contiguous(), *caches, st, strides, window=cfg.sliding_window)
            attn[kernels] = model.matmul(a.reshape(1, Tc, -1), lp["wo"], kernels)
        x = x + attn[False]
        mlp = {kernels: model._mlp(x, lp, cfg, kernels) for kernels in (True, False)}
        worst = max(worst, _rel(attn[True][0, :rows], attn[False][0, :rows]),
                    _rel(mlp[True][0, :rows], mlp[False][0, :rows]))
        x = x + mlp[False]
    head = [model._final_logits(x, params, cfg, kernels)[0, :rows] for kernels in (True, False)]
    return worst, _rel(*head)


def _chunk_numerics(m, n: int, card: str) -> None:
    """An n-token prompt admitted chunk by chunk over a private one-slot pool
    shaped like the engine's, through the kernels and through the plain
    path. TinyLlama: each kernel chunk against the plain chunk on the same
    pool state (E2E_TOL), the chunked first-token logits against a
    whole-prompt prefill (E2E_TOL). Mistral-7B (int8 pool): each path on its
    own pool, free-running, the logits of every chunk within DRIFT_TOL (32
    layers compound, as in its whole-prompt prefill), and the first chunk's
    sublayers, each fed the plain path's input, within E2E_TOL. Every kernel
    chunk makes exactly ``_chunk_kernels`` launches; one chunk is timed both
    ways."""
    from aios_tpu_torch.engine import model

    eng, cfg = m.engine, m.config
    tag = f"[chunks {cfg.name}]"
    mistral = eng.quant_cache
    gen = torch.Generator(device="cuda").manual_seed(6)
    ids = torch.randint(0, 256, (n,), generator=gen, device="cuda")
    L, _, Pg, kh, d = eng.k_pool.shape
    pages = eng.max_context // Pg
    shape = (L, 1 + pages, Pg, kh, d)
    pools = [torch.zeros(shape, dtype=eng.k_pool.dtype, device="cuda") for _ in range(2)]
    if eng.quant_cache:
        pools += [torch.ones(shape[:4], dtype=torch.float32, device="cuda") for _ in range(2)]
    plain_pools = [t.clone() for t in pools]
    table = (torch.randperm(pages, generator=torch.Generator().manual_seed(5)) + 1)
    table = table.to(torch.int32).cuda()

    def chunk(toks, start, st, kernels):
        return model.prefill_chunk_paged(
            eng.params, cfg, toks, start, st[0], st[1], table, kernels=kernels,
            cache_scales=(st[2], st[3]) if len(st) == 4 else None)

    want = _chunk_kernels(eng)
    rels, rows_k, timed, layers = [], [], None, None
    plan = _chunk_plan(eng, n)
    for i, (start, rows, bucket) in enumerate(plan):
        toks = torch.zeros((1, bucket), dtype=torch.int64, device="cuda")
        toks[0, :rows] = ids[start:start + rows]
        if mistral and i == 0:
            layers = _layerwise_chunk(eng, toks, start, pools, table, rows)
        before = None if mistral else [t.clone() for t in pools]
        lk, launches = _counted(lambda: chunk(toks, start, pools, True))
        expect(launches == want, f"{tag} chunk {i}: launches {launches}, want {want}")
        lp = chunk(toks, start, plain_pools if mistral else before, False)
        rels.append(_rel(lk[0, :rows], lp[0, :rows]))
        expect(bool(torch.isfinite(lk[0, :rows]).all()), f"{tag} chunk {i}: non-finite logits")
        if not mistral:
            rows_k.append(lk[0, :rows])
        if i == len(plan) // 2:  # a full chunk deep in the prompt, rewritten in place
            st = before if before is not None else [t.clone() for t in pools]
            timed = (start, _busy_and_wall(lambda: chunk(toks, start, pools, True)),
                     _busy_and_wall(lambda: chunk(toks, start, st, False)))
        del lp, before
    limit = DRIFT_TOL if mistral else E2E_TOL
    sublayers = ""
    if mistral:
        sublayers = (f"; first chunk, each sublayer fed the plain path's input: within "
                     f"{layers[0]:.3e} of max|output|, logits from the same final hidden "
                     f"state within {layers[1]:.3e} (limit {E2E_TOL})")
    log(f"{tag} {n}-token prompt in {len(plan)} chunks {[(s, r, b) for s, r, b in plan]}: "
        f"{'free-running ' if mistral else 'same pool state, '}kernel vs plain "
        f"max|dlogit|/max|logit| per chunk {', '.join(f'{r:.3e}' for r in rels)} (limit "
        f"{limit}){sublayers}; launches exact per chunk {want}; chunk at row {timed[0]}: "
        f"kernel path device busy {timed[1][0]:.3f} ms, host wall {timed[1][1]:.3f} ms; "
        f"plain path {timed[2][0]:.3f} / {timed[2][1]:.3f} ms; {card}")
    expect(max(rels) <= limit and (layers is None or max(layers) <= E2E_TOL),
           f"{tag} chunk logits disagree")
    del pools, plain_pools
    torch.cuda.empty_cache()
    if mistral:
        return
    # the chunked admission against one whole-prompt prefill of the prompt
    bucket = eng.bucket_for(n)
    padded = torch.zeros((1, bucket), dtype=torch.int64, device="cuda")
    padded[0, :n] = ids
    whole = model.prefill(eng.params, cfg, padded)[0][0, :n]
    chunked = torch.cat(rows_k)
    rel = _rel(chunked[-1], whole[-1])
    agree = (chunked.argmax(-1) == whole.argmax(-1)).float().mean().item()
    same = bool(chunked[-1].argmax() == whole[-1].argmax())
    log(f"{tag} first-token logits, chunked (K6) vs whole-prompt prefill (K2, bucket "
        f"{bucket}): max|dlogit|/max|logit|={rel:.3e} (limit {E2E_TOL}); first greedy token "
        f"{'the same' if same else 'differs'}; argmax agreement over all {n} rows {agree:.3f}")
    expect(rel <= E2E_TOL, f"{tag} chunked and whole-prompt first-token logits disagree")


def _interleaved(m, n: int, card: str, streams: int = 7) -> None:
    """``streams`` sampled streams decode while an n-token prompt is
    admitted, chunked and then whole-prompt (``prefill_chunk`` off): the
    decode dispatches between its chunks (at least chunks - 1), the longest
    gap between two tokens of one stream during the admission, and its
    TTFT; the per-tick timeline of the admission (each chunk's or
    prefill's dispatch and each decode dispatch, from its call to its
    return, which for a decode dispatch or a prefill is its readback, the
    dispatch in flight at the submit included). The first gap spans the
    submit, so the decode dispatch in flight then (16 steps on an idle
    queue) bounds it from below; the longest gap from a token that arrives
    between the submit and the admission's first token (to the stream's
    next token, which may come after it) is what the admission itself
    costs the streams. No graph is captured since LoadModel and no
    workspace error raised."""
    from aios_tpu_torch.engine.batching import Request

    eng = m.engine
    trace = []
    chunk_fwd, step, prefill = eng._chunk_forward, eng.step, eng.prefill

    def chunk_traced(*a):
        t0 = time.perf_counter()
        out = chunk_fwd(*a)
        trace.append(("C", t0, time.perf_counter()))
        return out

    def step_traced(k):
        t0 = time.perf_counter()
        out = step(k)
        trace.append(("S", t0, time.perf_counter()))
        return out

    def prefill_traced(*a, **kw):
        t0 = time.perf_counter()
        out = prefill(*a, **kw)
        trace.append(("P", t0, time.perf_counter()))
        return out

    captures0 = eng.stats()["graph_captures"]
    prompt = [256] + [(i * 13 + 5) % 256 for i in range(n - 1)]
    found = {}
    eng._chunk_forward, eng.step, eng.prefill = chunk_traced, step_traced, prefill_traced
    try:
        for chunk in (eng.prefill_chunk_default, None):
            m.batcher.prefill_chunk = chunk
            eng.prefix_index.clear()
            stamps = [[] for _ in range(streams)]
            hs = [m.batcher.submit(Request(prompt_ids=[256] + list(range(40 + s)),
                                           max_tokens=1500, temperature=0.7))
                  for s in range(streams)]
            threads = [threading.Thread(target=lambda h=h, st=st: st.extend(
                time.perf_counter() for _ in h)) for h, st in zip(hs, stamps)]
            for t in threads:
                t.start()
            deadline = time.monotonic() + 120
            while min(len(st) for st in stamps) < 8 and time.monotonic() < deadline:
                time.sleep(0.01)
            del trace[:]
            t0 = time.perf_counter()
            big = m.batcher.submit(Request(prompt_ids=prompt, max_tokens=1, temperature=0.0))
            big.tokens()
            t1 = time.perf_counter()
            # each stream's next token after the admission, so that a gap
            # that starts inside it is seen to its end
            seen = [len(st) for st in stamps]
            deadline = time.monotonic() + 30
            while (any(len(st) <= n for st, n in zip(stamps, seen))
                   and time.monotonic() < deadline):
                time.sleep(0.005)
            events = list(trace)
            for h in hs:
                h.cancel()
            for t in threads:
                t.join(timeout=120)
            chunks = [t for k, t, _ in events if k == "C"]
            between = sum(1 for k, t, _ in events
                          if k == "S" and chunks and chunks[0] < t < chunks[-1])
            pairs = [(a, b) for st in stamps for a, b in zip(st, st[1:])]
            gap = max((b - a for a, b in pairs if b >= t0 and a <= t1), default=0.0)
            inside = max((b - a for a, b in pairs if t0 <= a <= t1), default=0.0)
            ticks = " ".join(f"{k}{(a - t0) * 1e3:.1f}-{(b - t0) * 1e3:.1f}"
                             for k, a, b in events if b >= t0 and a <= t1)
            found[chunk] = (len(chunks), between, gap * 1e3, big.ttft_ms, ticks, inside * 1e3)
    finally:
        eng._chunk_forward, eng.step, eng.prefill = chunk_fwd, step, prefill
        m.batcher.prefill_chunk = eng.prefill_chunk_default
    (nc, between, gap_c, ttft_c, ticks_c, in_c), (_, _, gap_w, ttft_w, ticks_w, in_w) = (
        found[eng.prefill_chunk_default], found[None])
    expect(nc == -(-n // eng.prefill_chunk_default) and between >= nc - 1,
           f"{nc} chunks with {between} decode dispatches between them")
    expect(eng.stats()["graph_captures"] == captures0 == _planned_graphs(m),
           f"graphs captured: {eng.stats()['graph_captures']}, {captures0} before the "
           f"admissions, {_planned_graphs(m)} planned at LoadModel")
    log(f"[chunks {m.config.name}] timeline of the chunked admission, ms from its submit "
        f"(C a chunk's dispatch, P a whole-prompt prefill to its readback, S a decode "
        f"dispatch to its readback): {ticks_c}")
    log(f"[chunks {m.config.name}] timeline of the whole-prompt admission: {ticks_w}")
    log(f"[chunks {m.config.name}] {n}-token admission with {streams} sampled streams "
        f"decoding: {nc} chunks with {between} decode dispatches between them; longest gap "
        f"between two tokens of a stream during the admission {gap_c:.2f} ms chunked, "
        f"{gap_w:.2f} ms whole-prompt (prefill_chunk off), from a token that arrives "
        f"inside it {in_c:.2f} / {in_w:.2f} ms; TTFT {ttft_c:.2f} / {ttft_w:.2f} "
        f"ms; graph captures flat at the {captures0} of LoadModel; {card}")


def _batcher_admission(m, n: int, card: str) -> None:
    """An n-token greedy prompt through the idle batcher, chunked and then
    whole-prompt, each from a cold index: exact launches (a chunk:
    ``_chunk_kernels``; the whole prompt: one prefill of K2 and the
    projections) and TTFT."""
    from aios_tpu_torch.engine.batching import Request

    eng = m.engine
    prompt = [256] + [(i * 7 + 3) % 256 for i in range(n - 1)]
    per_chunk, L = _chunk_kernels(eng), eng.cfg.num_layers
    mm = next(iter(per_chunk))
    ttft = {}
    try:
        for chunk in (eng.prefill_chunk_default, None):
            m.batcher.prefill_chunk = chunk
            eng.prefix_index.clear()
            chunks0, pre0 = eng.prefill_chunks, eng.prefills
            _reset_counts()
            h = m.batcher.submit(Request(prompt_ids=prompt, max_tokens=1, temperature=0.0))
            toks = h.tokens()
            launches = _read_counts()
            chunks, pre = eng.prefill_chunks - chunks0, eng.prefills - pre0
            want = ({k: v * chunks for k, v in per_chunk.items()} if chunk
                    else {mm: 4 * L + 1, "flash_attention": L})
            expect(len(toks) == 1 and launches == want and (chunks, pre) == (
                (-(-n // chunk), 0) if chunk else (0, 1)),
                f"{n}-token admission: {chunks} chunks, {pre} prefills, launches {launches}")
            ttft[chunk] = (h.ttft_ms, chunks, launches)
    finally:
        m.batcher.prefill_chunk = eng.prefill_chunk_default
    (tc, nc, lc), (tw, _, lw) = ttft[eng.prefill_chunk_default], ttft[None]
    log(f"[chunks {m.config.name}] {n}-token prompt through the batcher: {nc} chunks, "
        f"launches exact {lc}, ttft_ms={tc:.2f}; whole-prompt (bucket {eng.bucket_for(n)}) "
        f"launches {lw}, ttft_ms={tw:.2f}; {card}")


def _trimmed_admission(m, n: int) -> None:
    """An n-token prompt longer than the window admits in chunks that return
    the blocks no later chunk can see: pages trimmed during the admission,
    the slot's resident pages at most window + chunk + a page, and nothing
    registered in the index (its chain no longer starts at block 0)."""
    eng = m.engine
    window, P = eng.cfg.sliding_window, eng.allocator.page_size
    bound = -(-(window + eng.prefill_chunk_default + P) // P)
    eng.prefix_index.clear()
    trimmed0 = eng.kv_pages_trimmed
    prompt = [256] + [(i * 11 + 1) % 256 for i in range(n - 1)]
    pc = eng.start_chunked_prefill(0, prompt, temperature=0.0,
                                   chunk=eng.prefill_chunk_default)
    peak, steps = 0, 0
    while True:
        first = pc.step()
        steps += 1
        peak = max(peak, eng.allocator.slot_pages_resident(0))
        if first is not None:
            break
    trimmed = eng.kv_pages_trimmed - trimmed0
    registered = len(eng.prefix_index.snapshot())
    eng.release(0)
    expect(trimmed > 0 and peak <= bound and not registered and bool(
        torch.isfinite(pc.first_logits).all()),
        f"{n}-token windowed admission: {trimmed} pages trimmed, peak {peak} pages "
        f"(bound {bound}), {registered} blocks registered")
    log(f"[chunks {m.config.name}] {n}-token prompt past the {window}-row window in {steps} "
        f"chunks: {trimmed} pages trimmed during the admission, the slot's peak {peak} "
        f"resident pages (bound ceil((window + chunk + page) / page) = {bound}), nothing "
        f"registered in the prefix index; first token {first}")


def _dense_chunks(tag: str, m, case: dict, card: str) -> None:
    """The chunked admission over the dense cache: one 512-row chunk at row
    512 through the kernels against the plain path on the same cache state,
    then a long greedy prompt through the speculative batcher, admitted in
    chunks, then decoded in rounds, with exact launches."""
    from aios_tpu_torch.engine import model
    from aios_tpu_torch.engine.batching import Request

    eng, cfg = m.engine, m.config
    quant = eng.quant_cache
    gen = torch.Generator(device="cuda").manual_seed(7)
    state = _dense_state(eng.params, cfg, quant, gen, 2, 512, eng.max_context)
    toks = torch.randint(0, 256, (1, 512), generator=gen, device="cuda")
    outs = []
    for kernels in (True, False):
        st = [t.clone() for t in state]
        outs.append(_counted(lambda: model.prefill_chunk(
            eng.params, cfg, toks, 1, 512, st[0], st[1], kernels=kernels,
            cache_scales=(st[2], st[3]) if quant else None)))
    (lk, launches), (lp, _) = outs
    rel = _rel(lk, lp)
    expect(launches == _chunk_kernels(eng) and rel <= case["drift_tol"]
           and bool(torch.isfinite(lk).all()),
           f"{tag} dense chunk: rel {rel}, launches {launches}")
    del state, outs, lk, lp
    torch.cuda.empty_cache()
    n = 1800 if not case["ctx"] else 4090
    prompt = [256] + [(i * 3 + 7) % 256 for i in range(n - 1)]
    chunks0, steps0, pre0 = eng.prefill_chunks, eng.decode_steps, eng.prefills
    out, counts = _counted(lambda: m.batcher.generate(prompt, max_tokens=24, temperature=0.0))
    chunks, rounds = eng.prefill_chunks - chunks0, eng.decode_steps - steps0
    L, per = case["layers"], case["per_forward"]
    want = {case["matmul"]: per * (chunks + rounds), case["verify"]: L * (chunks + rounds)}
    expect(len(out) == 24 and eng.prefills == pre0 and chunks == -(-n // 512)
           and counts == want, f"{tag} {n}-token chunked admission then rounds: "
           f"{chunks} chunks, {rounds} rounds, launches {counts}")
    log(f"{tag} dense chunk at row 512 through the kernels vs the plain path: "
        f"max|dlogit|/max|logit|={rel:.3e} (limit {case['drift_tol']}), launches {launches}; "
        f"a {n}-token greedy prompt through the speculative batcher: {chunks} chunks, then "
        f"{rounds} rounds, launches exact {counts}; {card}")


def _prefix_over_grpc(m, stub, card: str) -> None:
    """A 1536-token preamble (the chat template's head included) with tail A,
    then with tail B, over gRPC from a cold index: B reuses the 1536 rows
    (HealthCheck's prefix_rows_reused) and its TTFT is printed beside A's
    and beside B's own cold one. Then on the engine: 1536 is three whole
    chunks, so the hit runs the tail's chunk on the same bytes as a cold
    chunked admission of B, and its first-token logits equal the cold
    ones bit for bit."""
    from aios_tpu_torch.engine.tokenizer import render_chat
    from aios_tpu_torch.proto_gen import common_pb2, runtime_pb2

    eng, tok, name = m.engine, m.tokenizer, m.config.name
    head = tok.encode(render_chat(name, "\x00")).index(0)  # tokens before the prompt
    shared = 1536
    preamble = ("Shared agent preamble: follow the plan, report status, never guess. "
                * 40)[:shared - head]
    tails = ("Tail A: list the failing services.", "Tail B: restart them in order.")
    handles = []
    submit = m.batcher.submit

    def recorded(req):
        handles.append(submit(req))
        return handles[-1]

    def reused() -> int:
        details = stub.HealthCheck(common_pb2.Empty()).details[f"{m.name}.serving"]
        return int(dict(kv.split("=") for kv in details.split(","))["prefix_rows_reused"])

    m.batcher.submit = recorded
    try:
        runs = []
        for tail, clear in ((tails[0], True), (tails[1], False), (tails[1], True)):
            if clear:
                eng.prefix_index.clear()
            r0 = reused()
            stub.Infer(runtime_pb2.InferRequest(prompt=preamble + tail, max_tokens=4),
                       timeout=300)
            runs.append((reused() - r0, handles[-1].ttft_ms))
    finally:
        m.batcher.submit = submit
    (_, ttft_a), (hit_rows, ttft_hit), (cold_rows, ttft_cold) = runs
    expect(hit_rows == shared and cold_rows == 0,
           f"prefix rows reused {hit_rows} (hit), {cold_rows} (cold)")
    ids = [tok.encode(render_chat(name, preamble + t)) for t in tails]

    def admit(prompt):
        pc = eng.start_chunked_prefill(0, prompt, temperature=0.0,
                                       chunk=eng.prefill_chunk_default)
        start = pc.pos
        while pc.step() is None:
            pass
        eng.release(0)
        return start, pc.first_logits

    eng.prefix_index.clear()
    admit(ids[0])
    s_hit, hit = admit(ids[1])
    eng.prefix_index.clear()
    s_cold, cold = admit(ids[1])
    expect(s_hit == shared and s_cold == 0 and torch.equal(hit, cold),
           f"hit from row {s_hit}, cold from {s_cold}: first-token logits differ by "
           f"{(hit - cold).abs().max().item():.3e}")
    log(f"[prefix] over gRPC, {len(ids[1])}-token prompts sharing a {shared}-token preamble: "
        f"the second reuses {hit_rows} rows (HealthCheck prefix_rows_reused), ttft_ms="
        f"{ttft_hit:.2f} against {ttft_a:.2f} for the first and {ttft_cold:.2f} for the "
        f"same prompt from a cold index; on the engine the hit's first-token logits equal the "
        f"cold chunked admission's bit for bit; {card}")


def _overrun_hit(m) -> None:
    """A prefix hit whose final bucket runs past the cache end: a 2047-token
    prompt whose first 13 blocks (1664 rows) are cached leaves a 383-row
    tail, admitted as one 512-row bucket from row 1664 (rows past 2048 land
    on the sacrificial page, its queries past the end are saturated). The
    kernel chunk matches the plain chunk on rows < 383 within E2E_TOL, on
    the same pool state; the engine's own hit admission of it runs."""
    from aios_tpu_torch.engine import model

    eng, cfg = m.engine, m.config
    C, P = eng.max_context, eng.allocator.page_size
    gen = torch.Generator().manual_seed(8)
    x = [256] + torch.randint(0, 256, (C - 2,), generator=gen).tolist()
    matched = 13 * P
    y = x[:matched] + [(i * 5 + 1) % 256 for i in range(100)]
    eng.prefix_index.clear()
    eng.prefill(0, y, temperature=0.0)  # registers 13 blocks
    eng.release(0)
    with eng._lock:
        got, _ = eng._match_prefix(0, x)
        eng.allocator.ensure(0, len(x))
        table = torch.from_numpy(eng.allocator.tables[0]).cuda()
        n = len(x) - got
        toks = torch.zeros((1, 512), dtype=torch.int64, device="cuda")
        toks[0, :n] = torch.tensor(x[got:], device="cuda")
        outs = []
        for kernels in (True, False):
            st = [t.clone() for t in (eng.k_pool, eng.v_pool)]
            outs.append(model.prefill_chunk_paged(eng.params, cfg, toks, got, st[0], st[1],
                                                  table, kernels=kernels))
            del st
    eng.release(0)
    rel = _rel(outs[0][0, :n], outs[1][0, :n])
    reused0 = eng.prefix_rows_reused
    first = eng.prefill(0, x, temperature=0.0)  # the engine's hit path, same overrun
    eng.release(0)
    expect(got == matched and rel <= E2E_TOL and eng.prefix_rows_reused - reused0 == matched
           and bool(torch.isfinite(outs[0][0, :n]).all()),
           f"overrun hit: matched {got}, rel {rel}")
    log(f"[prefix] a hit of {got} rows of a {len(x)}-token prompt: the {n}-row tail as one "
        f"512-row bucket from row {got} runs to row {got + 512} > {C} (saturated queries, "
        f"overflow rows on the sacrificial page); kernel vs plain chunk on rows < {n}: "
        f"max|dlogit|/max|logit|={rel:.3e} (limit {E2E_TOL}); the engine's hit admission "
        f"of it gives first token {first}")
    del outs
    torch.cuda.empty_cache()


# -- the admission graphs against their eager twins ------------------------------


def _slot_rows(eng, slot: int, n: int):
    """Rows [0, n) of ``slot`` in every cache tensor (values and, int8,
    scales) through its page table, copied."""
    out = []
    for p in (eng.k_pool, eng.v_pool, eng.k_scales, eng.v_scales):
        if p is None:
            continue
        if eng.paged:
            P = eng.allocator.page_size
            t = torch.from_numpy(eng.allocator.tables[slot, : -(-n // P)]).cuda().long()
            p = p[:, t].flatten(1, 2)
        else:
            p = p[:, slot]
        out.append(p[:, :n].clone())
    return out


def _admission_graphs(tag: str, m, card: str) -> None:
    """Every admission graph kind against its eager twin from the same
    state (a cold index, slot 0): a 400-token prompt's bucket of 512; a
    1200-token prompt's two 512-row mid chunks and its final bucket of 256;
    over the pool a prefix hit's 700-row tail (a mid chunk from row 768 and
    a final bucket of 256). The same greedy first token, its logits row and
    every cache byte the admission wrote (rows [0, n) of the slot)
    bit-identical, and exact launches per replay (a bucket: the forward's
    matmuls and one K2 a layer; a chunk: ``_chunk_kernels``), both ways;
    no graph captured. Sampled first tokens of one prompt at temperature
    1e4 differ across replays. Then device busy and host wall
    (``_busy_and_wall``) per bucket (512 and 2048) and per 512-row mid chunk
    at row 1024, graph against eager, and the host's issue time of a mid
    chunk (from the call to its return, no readback)."""
    eng = m.engine
    L = eng.cfg.num_layers
    per_chunk = _chunk_kernels(eng)
    per_bucket = {next(iter(per_chunk)): 4 * L + 1, "flash_attention": L}
    captures0 = eng.graphs.captures
    gen = torch.Generator().manual_seed(9)

    def prompt(n):
        return [256] + torch.randint(0, 256, (n - 1,), generator=gen).tolist()

    def clear():
        if eng.prefix_index is not None:
            eng.prefix_index.clear()

    def whole(ids, eager):
        clear()
        fn = eng.prefill_eager if eager else eng.prefill
        first, n = _counted(lambda: fn(0, ids, temperature=0.0))
        out = (first, eng._adm_logits.clone(), _slot_rows(eng, 0, len(ids)), [n])
        eng.release(0)
        return out

    def chunked(ids, eager):
        clear()
        pc = eng.start_chunked_prefill(0, ids, temperature=0.0,
                                       chunk=eng.prefill_chunk_default, eager=eager)
        per, first = [], None
        while first is None:
            first, n = _counted(pc.step)
            per.append(n)
        out = (first, pc.first_logits, _slot_rows(eng, 0, len(ids)), per)
        eng.release(0)
        return out

    def hit(x, y, eager):
        clear()
        fn = eng.prefill_eager if eager else eng.prefill
        fn(0, y, temperature=0.0)  # registers y's blocks
        eng.release(0)
        reused0 = eng.prefix_rows_reused
        first, n = _counted(lambda: fn(0, x, temperature=0.0))
        expect(eng.prefix_rows_reused - reused0 == 768, f"{tag} the hit reused "
               f"{eng.prefix_rows_reused - reused0} rows, not 768")
        out = (first, eng._adm_logits.clone(), _slot_rows(eng, 0, len(x)), [n])
        eng.release(0)
        return out

    x = prompt(1468)
    kinds = {
        "bucket 512 (400 tokens)": (functools.partial(whole, prompt(400)), [per_bucket]),
        "2 mid chunks + a final bucket of 256 (1200 tokens)":
            (functools.partial(chunked, prompt(1200)), [per_chunk] * 3),
    }
    if eng.prefix_index is not None:
        y = x[:768] + prompt(101)[1:]
        kinds["a prefix hit's tail of 700 rows from row 768 (a mid chunk, a final bucket of "
              "256)"] = (functools.partial(hit, x, y),
                         [{k: 2 * v for k, v in per_chunk.items()}])
    for what, (run, want) in kinds.items():
        g, e = run(False), run(True)
        same_rows = all(torch.equal(a, b) for a, b in zip(g[2], e[2]))
        expect(g[0] == e[0] and torch.equal(g[1], e[1]) and same_rows,
               f"{tag} {what}: graph and eager differ: first token {g[0]} / {e[0]}, logits "
               f"max |d| {(g[1] - e[1]).abs().max().item():.3e}, rows equal {same_rows}")
        expect(g[3] == want and e[3] == want, f"{tag} {what}: launches graph {g[3]}, "
               f"eager {e[3]}, want {want}")
        expect(bool(torch.isfinite(g[1]).all()), f"{tag} {what}: non-finite logits")
        log(f"{tag} {what}: replay vs eager twin from the same state: first token {g[0]} "
            f"both ways, its logits row and the {len(g[2])} cache tensors' rows written "
            f"bit-identical, launches exact per replay {want}")
    expect(eng.graphs.captures == captures0, f"{tag} a graph was captured")

    # sampled first tokens draw fresh noise on every replay
    ids = prompt(300)
    firsts = []
    for _ in range(12):
        clear()
        firsts.append(eng.prefill(0, ids, temperature=1e4, top_p=1.0))
        eng.release(0)
    expect(len(set(firsts)) >= 4, f"{tag} sampled first tokens repeat: {firsts}")
    log(f"{tag} 12 sampled admissions of one prompt (temperature 1e4) through the bucket's "
        f"graph: {len(set(firsts))} distinct first tokens")

    # device busy and host wall, graph against eager
    timed = []
    for n in (400, 2000):
        ids = prompt(n)
        for name, fn in (("graph", eng.prefill), ("eager", eng.prefill_eager)):
            def admit(fn=fn, ids=ids):
                clear()
                fn(0, ids, temperature=0.0)
                eng.release(0)
            busy, wall = _busy_and_wall(admit)
            timed.append(f"bucket {eng.bucket_for(n)} {name} {busy:.3f} / {wall:.3f}")
    ids = prompt(2000)
    for eager in (False, True):
        clear()
        pc = eng.start_chunked_prefill(0, ids, temperature=0.0,
                                       chunk=eng.prefill_chunk_default, eager=eager)
        pc.step()
        pc.step()

        def mid(pc=pc):
            pc.pos = 1024
            pc.step()

        busy, wall = _busy_and_wall(mid)
        issue = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mid()
            issue.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
        eng.release(0)
        timed.append(f"mid chunk {'eager' if eager else 'graph'} {busy:.3f} / {wall:.3f}, "
                     f"issue {statistics.median(issue) * 1e3:.3f}")
    log(f"{tag} device busy / host wall ms per admission dispatch (torch.profiler / host "
        f"clock, median of 3 synchronized), and the host's issue time of a 512-row mid "
        f"chunk at row 1024 (median of 5, to its return): {'; '.join(timed)}; {card}")
    expect(eng.graphs.captures == captures0, f"{tag} a graph was captured")


# -- the graphs: replay against the eager body, fresh noise, where the time goes


def _snapshot(eng):
    """What a dispatch moves besides the cache rows it writes before it
    reads them again: lengths, last tokens, the history, with a draft its
    lengths, and the host's mirrors of the lengths. Restoring it replays a
    dispatch from the same state."""
    moved = [eng.lengths, eng.last_tokens] + ([eng.history] if eng.track_history else [])
    if eng.draft is not None:
        moved.append(eng.draft_state["lengths"])
    return (moved, [t.clone() for t in moved],
            (eng._host_lengths.copy(), eng._draft_host_lengths.copy()))


def _restore(eng, snap) -> None:
    moved, saved, (host, draft_host) = snap
    for t, was in zip(moved, saved):
        t.copy_(was)
    eng._host_lengths[:] = host
    eng._draft_host_lengths[:] = draft_host


def _dispatchers(eng, rounds: bool):
    """The served dispatch (a graph replay per step or round) and its eager
    twin."""
    if rounds:
        return {"graph": eng.spec_step, "eager": eng.spec_step_eager}
    return {"graph": eng.step, "eager": eng.step_eager}


def _graph_vs_eager(tag: str, eng, per_dispatch: dict, rounds: bool) -> None:
    """A greedy dispatch of 16 steps (8 rounds) through the graph and again
    through the eager body from the same state: identical tokens,
    bit-identical logits of the last step or round, and the exact launches
    ``per_dispatch`` x n both ways (counted through replays for the
    graph)."""
    from aios_tpu_torch import ops

    n = 8 if rounds else 16
    prompt = REPEATING if rounds else [256] + list(range(300))
    for s in range(eng.num_slots):
        eng.prefill(s, prompt[: len(prompt) - 5 * s], temperature=0.0)
    snap = _snapshot(eng)
    runs = {}
    for mode, fn in _dispatchers(eng, rounds).items():
        _restore(eng, snap)
        for k in ops.KERNELS:
            k.launches = 0
        out = fn(n)
        launches = {k.__name__: k.launches for k in ops.KERNELS if k.launches}
        runs[mode] = (out if rounds else (out,), eng.last_logits.clone(), launches)
    for s in range(eng.num_slots):
        eng.release(s)
    (g_out, g_logits, g_n), (e_out, e_logits, e_n) = runs["graph"], runs["eager"]
    want = {k: v * n for k, v in per_dispatch.items()}
    what = f"{n} {'rounds' if rounds else 'steps'}"
    expect(all((a == b).all() for a, b in zip(g_out, e_out)),
           f"{tag} graph and eager tokens differ over {what}")
    expect(torch.equal(g_logits, e_logits), f"{tag} graph and eager logits differ: "
           f"max |d| {(g_logits - e_logits).abs().max().item():.3e}")
    expect(g_n == want and e_n == want, f"{tag} launches: graph {g_n}, eager {e_n}, "
           f"want {want}")
    log(f"{tag} graph replay vs eager body, 8 greedy slots, {what}: tokens identical, "
        f"logits of the last {'round' if rounds else 'step'} bit-identical, launches exact "
        f"both ways ({per_dispatch} each)")


def _fresh_noise(tag: str, eng, rounds: bool) -> None:
    """Sampled slots over a flat distribution (temperature 1e4 over the
    top-k pool): the same step replayed twice from the same state draws
    other tokens, and 16 replays do not repeat one token."""
    fn = _dispatchers(eng, rounds)["graph"]
    for s in range(eng.num_slots):
        eng.prefill(s, [256] + list(range(100 + s)), temperature=1e4, top_p=1.0)
    snap = _snapshot(eng)

    def one():
        out = fn(1)
        return out[0][0, :, 0] if rounds else out[0]

    first = one()
    _restore(eng, snap)
    again = one()
    more = [one() for _ in range(15)]
    for s in range(eng.num_slots):
        eng.release(s)
    differ = int((first != again).sum())
    distinct = [len({int(t[s]) for t in [again] + more}) for s in range(eng.num_slots)]
    expect(differ >= eng.num_slots // 2 and min(distinct) >= 4,
           f"{tag} sampled replays repeat their noise: {differ} of {eng.num_slots} slots "
           f"differ on a replayed step, distinct tokens per slot over 16: {distinct}")
    log(f"{tag} sampled graph replays draw fresh noise: the same "
        f"{'round' if rounds else 'step'} replayed from the same state differs in {differ} "
        f"of {eng.num_slots} slots; distinct tokens per slot over 16 replays {distinct}")


# what the eager body's profile is broken down by: (range, module, function)
RANGES = (
    ("forward", "model", "decode_step_paged"), ("forward", "model", "decode_step"),
    ("forward", "model", "verify_step"), ("qkv", "model", "_project_qkv"),
    ("scatter_quant", "model", "scatter_quant"), ("mlp", "model", "_mlp"),
    ("head", "model", "_final_logits"), ("propose", "spec", "propose_ngram"),
    ("accept", "spec", "accept_counts"), ("sample", "sampling", "sample"),
)


def _annotated():
    """Wrap the functions of RANGES in profiler ranges for the lifetime of
    the context (the engine and the model look them up at each call)."""
    from torch.profiler import record_function

    from aios_tpu_torch.engine import model, sampling, spec

    modules = {"model": model, "spec": spec, "sampling": sampling}

    def wrap(name, fn):
        def inner(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)
        return inner

    stack = contextlib.ExitStack()
    for name, mod, attr in RANGES:
        orig = getattr(modules[mod], attr)
        setattr(modules[mod], attr, wrap(name, orig))
        stack.callback(setattr, modules[mod], attr, orig)
    return stack


def _device_kernels(prof) -> dict:
    """{name: (launches, device us)} of the device events of a profile
    (kernels, copies and fills), without the ranges ``_annotated`` marks
    on the device's timeline."""
    ranges = {r[0] for r in RANGES}
    return {e.key: (e.count, e.self_device_time_total) for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and e.self_device_time_total > 0 and e.key not in ranges}


def _op_table(tag: str, prof, n: int, launches: dict) -> None:
    """Kernels and device ms per step or round in each range of RANGES
    (outer ranges counted without their inner ones) and in the engine's own
    ops ("engine"), by the aten op that launched them; ``launches`` are the
    wrappers' kernels, which the profiler links to no op."""
    from collections import Counter

    names = {r[0] for r in RANGES}
    per = {}  # range -> [kernels, device us, Counter of kernels by op]

    def walk(ev, owner):
        if ev.name in names:
            owner = ev.name
        row = per.setdefault(owner, [0, 0.0, Counter()])
        kernels = [k for k in ev.kernels if k.name not in names]
        if kernels:
            row[0] += len(kernels)
            row[1] += sum(k.duration for k in kernels)
            row[2][ev.name] += len(kernels)
        for child in ev.cpu_children:
            walk(child, owner)

    for ev in prof.events():
        if ev.cpu_parent is None and not str(ev.device_type).endswith("CUDA"):
            walk(ev, "engine")
    total = sum(c for c, _ in _device_kernels(prof).values())
    linked = sum(row[0] for row in per.values())
    wrappers = sum(launches.values())
    log(f"[ops] {tag}: {total / n:g} device events per step, {linked / n:g} of them linked to "
        f"an aten op, {wrappers / n:g} launched by the kernel wrappers "
        f"({ {k: v / n for k, v in launches.items()} })")
    for name, (k, us, ops) in sorted(per.items(), key=lambda kv: -kv[1][0]):
        top = ", ".join(f"{op} {c / n:g}" for op, c in ops.most_common(12))
        log(f"[ops]   {name}: {k / n:g} kernels, {us / 1e3 / n:.4f} ms per step: {top}")


def _profile_decode(eng, tag: str, n_steps: int, card: str, prompt=None) -> None:
    """A decode dispatch of ``n_steps`` with all slots active at ~300 rows
    through the graph and through the eager body, from the same state each
    time: host wall per step (median of three unprofiled dispatches), the
    device span of one (CUDA events), three under torch.profiler (device
    busy share, the device events per step of each, the top kernels), and
    for the eager body one more with its functions marked (``_op_table``).
    With ``prompt`` the slots are greedy on that prompt and the dispatch is
    ``n_steps`` speculative rounds."""
    from torch.profiler import ProfilerActivity, profile

    from aios_tpu_torch import ops

    rounds = prompt is not None
    for s in range(eng.num_slots):
        if rounds:
            eng.prefill(s, prompt, temperature=0.0)
        else:
            eng.prefill(s, [256] + list(range(300)), temperature=0.7, top_p=0.95)
    snap = _snapshot(eng)
    what = "speculative rounds" if rounds else "decode steps"
    per = "round" if rounds else "step"
    rows = len(prompt) if rounds else 300

    def fresh():
        _restore(eng, snap)
        torch.cuda.synchronize()

    for mode, fn in _dispatchers(eng, rounds).items():
        walls = []
        for _ in range(3):
            fresh()
            t0 = time.perf_counter()
            fn(n_steps)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        fresh()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn(n_steps)
        b.record()
        torch.cuda.synchronize()
        span = a.elapsed_time(b)
        windows = []
        for _ in range(3):
            fresh()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                out = fn(n_steps)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            windows.append((wall, _device_kernels(prof)))
        wall, dev = windows[0]
        busy = sum(us for _, us in dev.values()) / 1e3
        counts = [sum(c for c, _ in d.values()) / n_steps for _, d in windows]
        extra = ""
        if rounds:
            extra = f" ({out[1].sum() / out[1].size:.2f} tokens per slot and round)"
        wall_ms = statistics.median(walls) * 1e3
        log(f"[profile] {tag} {mode}: {n_steps} {what}{extra}, 8 slots at ~{rows} rows: host "
            f"wall {wall_ms / n_steps:.3f} ms per {per} (median of 3, unprofiled), device span "
            f"{span / n_steps:.3f} ms per {per} (CUDA events); profiled: wall {wall * 1e3:.2f} "
            f"ms, device busy {busy:.2f} ms ({busy / (wall * 1e3):.1%} of the profiled wall, "
            f"{busy / (wall_ms):.1%} of the unprofiled), device events per {per} in three "
            f"windows {counts}, {card}")
        for key, (_, us) in sorted(dev.items(), key=lambda kv: -kv[1][1])[:8]:
            log(f"[profile]   {us / 1e3:9.3f} ms  {key[:110]}")
        if mode == "eager":
            fresh()
            for k in ops.KERNELS:
                k.launches = 0
            with _annotated(), profile(activities=[ProfilerActivity.CPU,
                                                   ProfilerActivity.CUDA]) as prof:
                fn(n_steps)
                torch.cuda.synchronize()
            launches = {k.__name__: k.launches for k in ops.KERNELS if k.launches}
            _op_table(f"{tag} eager {per}", prof, n_steps, launches)
    for s in range(eng.num_slots):
        eng.release(s)


# -- phase 6: serve Mistral-7B, int4 weights over an int8 pool ------------------


def phase_mistral_serve(manager, stub, card: str) -> dict:
    m, load_s = _load(manager, stub, "mistral", "synthetic://mistral-7b", 8192)
    eng, cfg = m.engine, m.config
    expect(
        (cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
         cfg.vocab_size, cfg.sliding_window, eng.max_context)
        == (M_L, 4096, M_H, M_KH, M_D, 32000, M_WINDOW, 8192),
        f"not the full Mistral-7B geometry: {cfg}",
    )
    leaves = [eng.params["layers"][k] for k in MISTRAL_KN if k != "lm_head"]
    leaves.append(eng.params["lm_head"])
    expect(all("q4" in w for w in leaves), "expected every matmul leaf in int4")
    expect(eng.quant_cache and eng.k_pool.dtype == torch.int8, "expected an int8 pool")
    pool_bytes = sum(t.numel() * t.element_size()
                     for t in (eng.k_pool, eng.v_pool, eng.k_scales, eng.v_scales))
    weight_bytes = sum(t.numel() * t.element_size() for w in leaves for t in w.values())
    log(
        f"[mistral] LoadModel synthetic://mistral-7b ready in {load_s:.2f} s: "
        f"{cfg.num_layers} layers, E={cfg.hidden_size}, H={cfg.num_heads}/{cfg.num_kv_heads}, "
        f"D={cfg.head_dim}, window {cfg.sliding_window}, ctx={eng.max_context}; int4 weights "
        f"{weight_bytes} B (matmul leaves and scales); int8 pool of "
        f"{eng.allocator.num_pages} pages x {eng.allocator.page_size} rows = {pool_bytes} B "
        f"(values and scales); peak device memory {torch.cuda.max_memory_allocated()} B"
    )
    log(f"[mistral] {_graphs_line(m, load_s)}")
    w = _served_window(manager, stub, m, card)
    n, pre, steps, chunks = w["launches"], w["prefills"], w["steps"], w["chunks"]
    want = dict.fromkeys(n, 0)
    want.update({"int4_matmul": 129 * (pre + chunks + steps), "flash_attention": 32 * pre,
                 "paged_decode_attention_int8": 32 * steps,
                 "multiquery_decode_attention_int8": 32 * chunks})
    expect(n == want, f"launch counts {n} != {want} for {pre} prefills, {chunks} chunks, "
           f"{steps} steps")
    log(f"[mistral] launch counts exact for {pre} whole-prompt prefills, {chunks} admission "
        f"chunks and {steps} decode steps: {n}")
    return n


# -- phase 7: Mistral numerics, the sliding window and where the time goes -------


def _layerwise_prefill(params, cfg, tokens):
    """Each sublayer of a prefill run through the kernels and through the
    plain versions on the SAME input (the plain path's), so that rounding
    does not compound over depth: per layer the larger of the attention
    sublayer's and the MLP's max|difference| / max|output|; then the logits
    of both paths from the plain path's final hidden state, relative to
    max|logit|."""
    from aios_tpu_torch import ops
    from aios_tpu_torch.engine import model

    B, T = tokens.shape
    x = params["embed"][tokens]
    positions = torch.arange(T, device=tokens.device).expand(B, T)
    cos, sin = model.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    per_layer = []
    for lp in model.layer_params(params):
        attn = {}
        for kernels in (True, False):
            fn = ops.flash_attention if kernels else ops.flash_attention_reference
            q, k, v = model._project_qkv(x, lp, cfg, cos, sin, kernels)
            a = fn(q, k, v, causal=True, window=cfg.sliding_window)
            attn[kernels] = model.matmul(a.reshape(B, T, -1), lp["wo"], kernels)
        x = x + attn[False]
        mlp = {kernels: model._mlp(x, lp, cfg, kernels) for kernels in (True, False)}
        per_layer.append(max(_rel(attn[True], attn[False]), _rel(mlp[True], mlp[False])))
        x = x + mlp[False]
    h = model.rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    head = [model.matmul(h, params["lm_head"], kernels).float() for kernels in (True, False)]
    return per_layer, _rel(*head)


def _windowed_greedy(eng, prompt, new_tokens: int):
    """One greedy slot on the engine, driven past the window; returns its
    tokens and (host length, pages the slot holds, pages the length alone
    needs). Pages the slot trimmed may live on under the prefix index."""
    toks = [eng.prefill(0, prompt, temperature=0.0)]
    while len(toks) < new_tokens:
        toks += eng.step(min(16, new_tokens - len(toks)))[:, 0].tolist()
    n = eng.slot_length(0)
    pages = (n, eng.allocator.slot_pages_resident(0), eng.allocator.blocks_for(n + 1))
    eng.release(0)
    return toks, pages


def phase_mistral_numerics(manager, card: str) -> None:
    from aios_tpu_torch.engine import model
    from aios_tpu_torch.engine.batching import Request

    m = manager.get("mistral")
    eng, cfg, params = m.engine, m.config, m.engine.params
    gen = torch.Generator(device="cuda").manual_seed(2)
    T = 512
    tokens = torch.randint(0, 256, (1, T), generator=gen, device="cuda")
    lk, _, _ = model.prefill(params, cfg, tokens, kernels=True)
    lp, ksp, vsp = model.prefill(params, cfg, tokens, kernels=False)
    rel_prefill = _rel(lk, lp)
    per_layer, rel_head = _layerwise_prefill(params, cfg, tokens)
    log(
        f"[mistral] prefill T={T}, each sublayer fed the plain path's input: the kernel "
        f"path's output within {max(per_layer):.3e} of max|output| (limit {E2E_TOL}; "
        f"layers 0, 8, 16, 24, 31: "
        f"{', '.join(f'{per_layer[i]:.2e}' for i in (0, 8, 16, 24, 31))}), logits from the "
        f"same final hidden state within {rel_head:.3e} of max|logit|"
    )
    expect(max(per_layer) <= E2E_TOL and rel_head <= E2E_TOL,
           "a Mistral layer's kernel path disagrees with its plain path")
    # one decode step for 8 ragged slots over an int8 pool holding that
    # prompt's K/V
    B, L, nb, MB = 8, cfg.num_layers, T // P, 8192 // P
    shape = (L, 1 + B * nb, P, M_KH, M_D)
    k_pool = torch.zeros(shape, dtype=torch.int8, device="cuda")
    v_pool = torch.zeros_like(k_pool)
    k_s = torch.ones(shape[:4], dtype=torch.float32, device="cuda")
    v_s = torch.ones_like(k_s)
    kq, kqs = model.quantize_kv(ksp[:, 0])
    vq, vqs = model.quantize_kv(vsp[:, 0])
    order = torch.randperm(B * nb, generator=torch.Generator().manual_seed(3)) + 1
    tables = order.reshape(B, nb).to(torch.int32)
    tables = torch.cat([tables, torch.zeros(B, MB - nb, dtype=torch.int32)], 1).cuda()
    for b in range(B):
        pages = tables[b, :nb].long()
        k_pool[:, pages] = kq.reshape(L, nb, P, M_KH, M_D)
        v_pool[:, pages] = vq.reshape(L, nb, P, M_KH, M_D)
        k_s[:, pages] = kqs.reshape(L, nb, P, M_KH)
        v_s[:, pages] = vqs.reshape(L, nb, P, M_KH)
    lengths = torch.tensor([0, 5, 127, 128, 200, 300, 400, 510], dtype=torch.int32, device="cuda")
    step_tokens = torch.randint(0, 256, (B,), generator=gen, device="cuda")
    outs = []
    for kernels in (True, False):
        pools = [t.clone() for t in (k_pool, v_pool, k_s, v_s)]
        outs.append(model.decode_step_paged(
            params, cfg, step_tokens, lengths, pools[0], pools[1], tables,
            kernels=kernels, cache_scales=(pools[2], pools[3])))
    dk, dp = outs
    rel_decode = _rel(dk, dp)
    ok = (rel_prefill <= DRIFT_TOL and rel_decode <= E2E_TOL
          and bool(torch.isfinite(lk).all()) and bool(torch.isfinite(dk).all()))
    log(
        f"[mistral] kernel path vs plain path, full model: prefill T={T} "
        f"max|dlogit|/max|logit|={rel_prefill:.3e} (limit {DRIFT_TOL}, 32 layers "
        f"compounding), decode step B=8 over the int8 pool "
        f"max|dlogit|/max|logit|={rel_decode:.3e} (limit {E2E_TOL}); "
        f"prefill argmax agreement {(lk.argmax(-1) == lp.argmax(-1)).float().mean().item():.3f}, "
        f"decode {(dk.argmax(-1) == dp.argmax(-1)).float().mean().item():.3f}"
    )
    expect(ok, "Mistral kernel and plain logits disagree")
    del lk, lp, ksp, vsp, k_pool, v_pool, k_s, v_s, kq, vq, outs, dk, dp

    # a greedy request whose prompt (bucket 4096) plus 160 new tokens runs
    # past the 4096-row window: twice on the engine, once through the batcher
    # all three whole-prompt (the index cleared before each, the batcher's
    # chunking off for its run): phase 7b admits the prompt in chunks
    prompt = [256] + [(i * 7 + 3) % 256 for i in range(4089)]
    trimmed0 = eng.kv_pages_trimmed
    runs = []
    for _ in range(2):
        eng.prefix_index.clear()
        runs.append(_windowed_greedy(eng, prompt, 160))
    eng.prefix_index.clear()
    m.batcher.prefill_chunk = None
    t0 = time.perf_counter()
    h = m.batcher.submit(Request(prompt_ids=prompt, max_tokens=160, temperature=0.0))
    served = h.tokens()
    wall = time.perf_counter() - t0
    m.batcher.prefill_chunk = eng.prefill_chunk_default
    (a, (n, in_use, need)), (b, _) = runs
    log(
        f"[mistral] windowed greedy: prompt {len(prompt)} tokens (whole-prompt, bucket "
        f"{eng.bucket_for(len(prompt))}) + 160 new: slot length {n} > window {M_WINDOW}, "
        f"the slot holds {in_use} pages where the length alone needs {need}, "
        f"{eng.kv_pages_trimmed - trimmed0} pages trimmed over three runs; batcher run "
        f"ttft_ms={h.ttft_ms:.2f}, {len(served)} tokens in {wall:.3f} s, {card}"
    )
    expect(n > M_WINDOW and in_use < need, "decode did not run past the window with "
           "trimmed pages returned")
    expect(len(a) == 160 and a == b == served,
           f"greedy streams differ: {a[:8]}... / {b[:8]}... / {served[:8]}...")
    log(f"[mistral] three greedy streams of 160 tokens identical: {a[:8]}...")

    # time to first token and decode rate on the idle server, cold index
    for n_prompt in (250, 500, 1000, 2000):
        eng.prefix_index.clear()
        h = m.batcher.submit(Request(prompt_ids=[256] + [65] * n_prompt, max_tokens=2,
                                     temperature=0.0))
        h.tokens()
        log(f"[mistral] ttft_ms={h.ttft_ms:.2f} for a {n_prompt + 1}-token prompt "
            f"({_admission(m, n_prompt + 1)}) on an idle server, {card}")
    hs = [m.batcher.submit(Request(prompt_ids=[256] + list(range(100)), max_tokens=129,
                                   temperature=0.7)) for _ in range(eng.num_slots)]
    steps0 = eng.decode_steps
    t0 = time.perf_counter()
    n_tok = sum(len(h.tokens()) for h in hs)
    wall = time.perf_counter() - t0
    steps = eng.decode_steps - steps0
    log(f"[mistral] 8 slots x 129 tokens: {n_tok} tokens in {wall:.3f} s = "
        f"{n_tok / wall:.1f} tok/s, {steps} decode steps, "
        f"{wall / max(steps, 1) * 1e3:.2f} ms per step (host clock, prefills included), {card}")
    _graph_vs_eager("[mistral]", eng, {"int4_matmul": 129, "paged_decode_attention_int8": 32},
                    rounds=False)
    _fresh_noise("[mistral]", eng, rounds=False)
    _profile_decode(eng, "mistral", 8, card)
    _admission_graphs("[admission mistral]", m, card)
    _chunk_numerics(m, 4090, card)
    _batcher_admission(m, 4090, card)
    _trimmed_admission(m, 7000)


# -- phases 8-10: the dense slot cache with n-gram speculation -------------------

DENSE = {
    "tinyllama": dict(
        path="synthetic://tinyllama-1.1b", ctx=0, layers=22, per_forward=89,
        matmul="quantized_matmul", verify="multiquery_decode_attention",
        decode="decode_attention", geometry=(22, 2048, 32000, 2048), cache=torch.bfloat16,
        drift_tol=E2E_TOL,
    ),
    "mistral": dict(
        path="synthetic://mistral-7b", ctx=8192, layers=M_L, per_forward=129,
        matmul="int4_matmul", verify="multiquery_decode_attention_int8",
        decode="decode_attention_int8", geometry=(M_L, 4096, 32000, 8192), cache=torch.int8,
        drift_tol=DRIFT_TOL,  # 32 layers compound, as in the Mistral prefill
    ),
}
# a period of 40 tokens six times over (bucket 256): the n-gram proposer finds
# matches in it from the first round on
REPEATING = [256] + [(i % 40) * 5 + 33 for i in range(240)]


def phase_dense_serve(name: str):
    """The served window over the dense cache, once with speculation and once
    with ``degrade_spec`` set, both with exact launch counts."""
    case = DENSE[name]

    def run(manager, stub, card: str) -> dict:
        m, load_s = _load(manager, stub, name, case["path"], case["ctx"])
        eng, cfg = m.engine, m.config
        expect((cfg.num_layers, cfg.hidden_size, cfg.vocab_size, eng.max_context)
               == case["geometry"], f"not the full {name} geometry: {cfg}")
        expect(not eng.paged and eng.allocator is None and eng.track_history
               and m.batcher.speculative, "expected the dense cache with speculation")
        expect(eng.k_pool.dtype == case["cache"] and eng.k_pool.shape[1:3]
               == (eng.num_slots, eng.max_context), f"cache {eng.k_pool.shape}")
        cache_bytes = sum(t.numel() * t.element_size() for t in
                          (eng.k_pool, eng.v_pool, eng.k_scales, eng.v_scales)
                          if t is not None)
        log(f"[dense {name}] LoadModel {case['path']} ready in {load_s:.2f} s: dense "
            f"{eng.k_pool.dtype} cache {tuple(eng.k_pool.shape)} = {cache_bytes} B (values "
            f"and scales), speculation on (draft_len {m.batcher.spec_draft_len}, ngram "
            f"{m.batcher.spec_ngram})")
        log(f"[dense {name}] {_graphs_line(m, load_s)}")
        total = {}
        L, per = case["layers"], case["per_forward"]
        for spec_on in (True, False):
            m.batcher.degrade_spec = not spec_on
            w = _served_window(manager, stub, m, card,
                               " dense, speculative" if spec_on else " dense, degrade_spec")
            n, pre, steps, chunks = w["launches"], w["prefills"], w["steps"], w["chunks"]
            want = dict.fromkeys(n, 0)
            # a chunk of an admission attends through the verify kernel
            want.update({case["matmul"]: per * (pre + chunks + steps),
                         "flash_attention": L * pre, case["verify"]: L * chunks})
            want[case["verify" if spec_on else "decode"]] += L * steps
            expect(n == want, f"launch counts {n} != {want} for {pre} prefills, {chunks} "
                   f"chunks, {steps} {'rounds' if spec_on else 'steps'}")
            log(f"[dense {name}] launch counts exact for {pre} whole-prompt prefills, {chunks} "
                f"admission chunks and {steps} "
                f"{'speculative rounds' if spec_on else 'plain steps'}: "
                f"{ {k: v for k, v in n.items() if v} }")
            for k, v in n.items():
                total[k] = total.get(k, 0) + v
        m.batcher.degrade_spec = False
        return total

    return run


def _dense_state(params, cfg, quant: bool, gen, B: int, T0: int, C: int):
    """A dense cache [L, B, C, KH, D] whose rows [0, T0) of every slot hold
    the plain path's K/V of one random prompt."""
    from aios_tpu_torch.engine import model

    tokens = torch.randint(0, 256, (1, T0), generator=gen, device="cuda")
    _, ks, vs = model.prefill(params, cfg, tokens, kernels=False)
    shape = (cfg.num_layers, B, C, cfg.num_kv_heads, cfg.head_dim)
    state = []
    if quant:
        quantized = [model.quantize_kv(t[:, 0]) for t in (ks, vs)]
        for q, _ in quantized:
            cache = torch.zeros(shape, dtype=torch.int8, device="cuda")
            cache[:, :, :T0] = q[:, None]
            state.append(cache)
        for _, sc in quantized:
            scales = torch.ones(shape[:4], dtype=torch.float32, device="cuda")
            scales[:, :, :T0] = sc[:, None]
            state.append(scales)
    else:
        for t in (ks, vs):
            cache = torch.zeros(shape, dtype=torch.bfloat16, device="cuda")
            cache[:, :, :T0] = t[:, 0][:, None].to(torch.bfloat16)
            state.append(cache)
    return state


def _layerwise_dense(params, cfg, state, feed, lengths, active, multi: bool):
    """Each sublayer of a dense-cache forward (``verify_step`` when ``multi``,
    else ``decode_step`` on the first token) run through the kernels and
    through the plain versions on the SAME input (the plain path's), each on
    its own copy of that layer's cache, so that rounding does not compound
    over depth: the largest max|difference| / max|output| over the attention
    and MLP sublayers of every layer, then the logits of both paths from the
    plain path's final hidden state relative to max|logit| (the lm_head at
    M = slots x T); the inactive slot 0 left out of both."""
    from aios_tpu_torch.engine import model

    toks = feed if multi else feed[:, :1]
    T, C = toks.shape[1], state[0].shape[2]
    plans = {kernels: model._dense_plan(cfg, lengths, active, T, C, kernels, multi)
             for kernels in (True, False)}
    cos, sin = model.rope_tables(plans[True][0], cfg.head_dim, cfg.rope_theta)
    x = params["embed"][toks]
    worst = 0.0
    for i, lp in enumerate(model.layer_params(params)):
        attn = {kernels: model._dense_attention_sublayer(
            x, lp, cfg, cos, sin, tuple(t[i].clone() for t in state), plans[kernels][1],
            kernels) for kernels in (True, False)}
        x = x + attn[False]
        mlp = {kernels: model._mlp(x, lp, cfg, kernels) for kernels in (True, False)}
        worst = max(worst, _rel(attn[True][1:], attn[False][1:]),
                    _rel(mlp[True][1:], mlp[False][1:]))
        x = x + mlp[False]
    head = [model._final_logits(x, params, cfg, kernels) for kernels in (True, False)]
    return worst, _rel(head[0][1:], head[1][1:])


def _dense_logits_gates(tag: str, params, cfg, quant: bool, drift_tol: float) -> None:
    """decode_step and verify_step through the kernels against the plain
    path: every sublayer on the same input within E2E_TOL of max|output|,
    the logits from the same final hidden state within E2E_TOL of max|logit|,
    the free-running logits within ``drift_tol`` of max|logit|; and row t of
    the verify forward against the t-th of T decode steps, both through the
    kernels, within E2E_TOL of max|logit|."""
    from aios_tpu_torch.engine import model

    gen = torch.Generator(device="cuda").manual_seed(4)
    B, T = 8, SPEC_T
    state = _dense_state(params, cfg, quant, gen, B, 512, 1024)
    lengths = torch.tensor([0, 5, 127, 128, 200, 300, 400, 500], dtype=torch.int32,
                           device="cuda")
    active = torch.tensor([False] + [True] * 7, device="cuda")
    feed = torch.randint(0, 256, (B, T), generator=gen, device="cuda")

    def forward(fn, toks, lens, kernels, st=None):
        st = [t.clone() for t in state] if st is None else st
        return fn(params, cfg, toks, lens, st[0], st[1], active=active, kernels=kernels,
                  cache_scales=(st[2], st[3]) if quant else None)

    vk = forward(model.verify_step, feed, lengths, True)
    vp = forward(model.verify_step, feed, lengths, False)
    dk = forward(model.decode_step, feed[:, 0], lengths, True)
    dp = forward(model.decode_step, feed[:, 0], lengths, False)
    rel_verify, rel_decode = _rel(vk[1:], vp[1:]), _rel(dk[1:], dp[1:])
    (layer_verify, head_verify), (layer_decode, head_decode) = (
        _layerwise_dense(params, cfg, state, feed, lengths, active, multi)
        for multi in (True, False))
    st = [t.clone() for t in state]
    rel_rows = [_rel(forward(model.decode_step, feed[:, t], lengths + t, True, st)[1:],
                     vk[1:, t]) for t in range(T)]
    ok = (max(rel_verify, rel_decode) <= drift_tol
          and max(layer_verify, layer_decode, head_verify, head_decode,
                  *rel_rows) <= E2E_TOL
          and bool(torch.isfinite(vk).all()) and bool(torch.isfinite(dk).all()))
    log(f"{tag} kernel path vs plain path, full model over a dense cache of 1024 rows: "
        f"verify_step B=8 T={T} max|dlogit|/max|logit|={rel_verify:.3e}, decode_step "
        f"{rel_decode:.3e} (limit {drift_tol}, {cfg.num_layers} layers compounding); each "
        f"sublayer fed the plain path's input within {layer_verify:.3e} (verify_step) and "
        f"{layer_decode:.3e} (decode_step) of max|output|, logits from the same final "
        f"hidden state within {head_verify:.3e} (M={B * T}) and {head_decode:.3e} (M={B}) "
        f"of max|logit| (limit {E2E_TOL}); verify row t "
        f"vs the t-th of {T} decode steps, kernel path: "
        f"{', '.join(f'{r:.2e}' for r in rel_rows)} (limit {E2E_TOL}); argmax agreement "
        f"verify {(vk[1:].argmax(-1) == vp[1:].argmax(-1)).float().mean().item():.3f}, "
        f"decode {(dk[1:].argmax(-1) == dp[1:].argmax(-1)).float().mean().item():.3f}")
    expect(ok, f"{tag} dense-cache logits disagree")


def _round_invariants(tag: str, eng) -> None:
    """One speculative round recomputed by hand from the engine's state, then
    run by the engine: counts in [1, K+1], the emitted tokens are the argmax
    rows of the verify logits, the accepted drafts equal those argmaxes."""
    from aios_tpu_torch.engine import model, spec

    K = 7
    for s in range(eng.num_slots):
        n = len(REPEATING) - s
        eng.prefill(s, REPEATING[:n], temperature=0.0)
        # a random-weight model does not continue its prompt, so its first
        # token ends no earlier trigram; plant it one period back in the
        # history (the proposer's evidence only), so the round verifies real
        # drafts: the prompt's continuation there
        eng.history[s, n - 40] = eng.last_tokens[s]
    drafts, _ = spec.propose_ngram(eng.history, eng.lengths, K, 3, eng.max_context)
    feed = torch.cat([eng.last_tokens[:, None], drafts], dim=1)
    # writes the rows the engine's own round then writes again, with the same values
    logits = model.verify_step(
        eng.params, eng.cfg, feed, eng.lengths, eng.k_pool, eng.v_pool,
        active=eng.active_dev,
        cache_scales=(eng.k_scales, eng.v_scales) if eng.quant_cache else None)
    g, drafts = logits.argmax(dim=-1).cpu().numpy(), drafts.cpu().numpy()
    toks, counts = eng.spec_step(1, draft_len=K, ngram=3)
    for s in range(eng.num_slots):
        n = int(counts[0, s])
        expect(1 <= n <= K + 1, f"{tag} slot {s}: count {n} outside [1, {K + 1}]")
        expect((toks[0, s, :n] == g[s, :n]).all(),
               f"{tag} slot {s}: emitted {toks[0, s, :n]} are not the argmax rows {g[s, :n]}")
        expect((drafts[s, : n - 1] == g[s, : n - 1]).all(),
               f"{tag} slot {s}: accepted drafts {drafts[s, :n - 1]} != argmax {g[s, :n - 1]}")
    toks, more = eng.spec_step(8, draft_len=K, ngram=3)
    expect(((more >= 1) & (more <= K + 1)).all(), f"{tag} counts outside [1, {K + 1}]")
    log(f"{tag} one round by hand and by the engine agree for 8 greedy slots: counts "
        f"{counts[0].tolist()}, drafts proposed {(drafts >= 0).sum(1).tolist()}; 8 more "
        f"rounds emit {more.sum(0).tolist()} tokens per slot")
    # teacher-forced: feed the verify forward the tokens it predicts itself
    for s in range(1, eng.num_slots):
        eng.release(s)
    forced = torch.full((eng.num_slots, K), -1, dtype=torch.int64, device="cuda")
    for j in range(K + 1):
        feed = torch.cat([eng.last_tokens[:, None], forced], dim=1)
        logits = model.verify_step(
            eng.params, eng.cfg, feed, eng.lengths, eng.k_pool, eng.v_pool,
            active=eng.active_dev,
            cache_scales=(eng.k_scales, eng.v_scales) if eng.quant_cache else None)
        pred = logits.argmax(dim=-1)
        accepted = int(spec.accept_counts(forced, pred)[0])
        if j < K:
            forced[0, j] = pred[0, j]
    eng.release(0)
    log(f"{tag} teacher-forced verify: {accepted} of {K} self-predicted drafts accepted")
    expect(accepted >= 1, f"{tag} no self-predicted draft was accepted")


def phase_dense_numerics(name: str):
    case = DENSE[name]
    quant = case["cache"] == torch.int8

    def run(manager, card: str) -> None:
        from aios_tpu_torch.engine.batching import Request

        m = manager.get(name)
        eng, cfg = m.engine, m.config
        tag = f"[dense {name}]"
        _dense_logits_gates(tag, eng.params, cfg, quant, case["drift_tol"])
        _round_invariants(tag, eng)

        # greedy speculation through the batcher (temperature 0 on the wire
        # means unset), twice, and once without speculation
        tokens0, rounds0 = eng.spec_tokens, eng.spec_slot_rounds
        a = m.batcher.generate(REPEATING, max_tokens=96, temperature=0.0)
        b = m.batcher.generate(REPEATING, max_tokens=96, temperature=0.0)
        emitted, rounds = eng.spec_tokens - tokens0, eng.spec_slot_rounds - rounds0
        m.batcher.degrade_spec = True
        plain = m.batcher.generate(REPEATING, max_tokens=96, temperature=0.0)
        m.batcher.degrade_spec = False
        expect(len(a) == 96 and a == b, f"{tag} greedy speculative streams differ")
        agree = sum(x == y for x, y in zip(a, plain)) / len(a)
        log(f"{tag} two greedy speculative batcher streams of 96 tokens identical: "
            f"{a[:8]}...; {emitted} tokens in {rounds} rounds = {emitted / rounds:.2f} "
            f"tokens per round, draft acceptance {(emitted - rounds) / (rounds * 7):.3f} "
            f"(random weights); agrees with the plain greedy stream at {agree:.3f} of "
            f"positions (not gated: verify and decode forwards sum in another order)")

        if case["ctx"]:  # Mistral: decode past the window over the dense cache
            prompt = [256] + [(i * 7 + 3) % 256 for i in range(4089)]
            runs = []
            for _ in range(2):
                t0 = time.perf_counter()
                h = m.batcher.submit(Request(prompt_ids=prompt, max_tokens=160,
                                             temperature=0.0))
                runs.append((h.tokens(), h.ttft_ms, time.perf_counter() - t0))
            (x, ttft, wall), (y, _, _) = runs
            expect(len(x) == 160 and x == y, f"{tag} windowed greedy streams differ")
            log(f"{tag} windowed greedy, speculative: prompt {len(prompt)} tokens + 160 "
                f"new past the {M_WINDOW}-row window over the dense cache, twice "
                f"identical: {x[:8]}...; ttft_ms={ttft:.2f}, {wall:.3f} s, {card}")

        for spec_on in (True, False):
            m.batcher.degrade_spec = not spec_on
            steps0 = eng.decode_steps
            hs = [m.batcher.submit(Request(prompt_ids=REPEATING, max_tokens=129,
                                           temperature=0.0)) for _ in range(eng.num_slots)]
            t0 = time.perf_counter()
            n_tok = sum(len(h.tokens()) for h in hs)
            wall = time.perf_counter() - t0
            steps = eng.decode_steps - steps0
            log(f"{tag} 8 greedy slots x 129 tokens, "
                f"{'speculative rounds' if spec_on else 'plain steps'}: {n_tok} tokens in "
                f"{wall:.3f} s = {n_tok / wall:.1f} tok/s, {steps} dispatched "
                f"{'rounds' if spec_on else 'steps'}, {wall / max(steps, 1) * 1e3:.2f} ms "
                f"each (host clock, prefills included), {card}")
        m.batcher.degrade_spec = False
        per, L = case["per_forward"], case["layers"]
        _graph_vs_eager(tag, eng, {case["matmul"]: per, case["verify"]: L}, rounds=True)
        _graph_vs_eager(tag, eng, {case["matmul"]: per, case["decode"]: L}, rounds=False)
        _fresh_noise(tag, eng, rounds=True)
        _fresh_noise(tag, eng, rounds=False)
        _profile_decode(eng, f"dense {name}", 8, card, prompt=REPEATING)
        _profile_decode(eng, f"dense {name}", 8, card)
        # the masked step and the jumps over the dense cache (captured now)
        _constrained_dispatches(f"[constrained dense {name}]", eng,
                                {case["matmul"]: per, case["decode"]: L},
                                {case["matmul"]: per, case["verify"]: L}, card, timed=False,
                                drift_tol=case["drift_tol"])
        _dense_chunks(tag, m, case, card)
        if not quant:
            _admission_graphs(f"[admission dense {name}]", m, card)

    return run


# -- phase 11: serve GGUF files ------------------------------------------------------

GGUF_SEED = 0
# the files the phase writes: (a) TinyLlama-1.1B in llama.cpp's layout at full
# width and depth (layer 0's attn_q/attn_k in F32, layer 1's FFN in Q4_0, the
# rest Q8_0), (b) DeepSeek-R1-Distill-Llama-8B and (c) Qwen3-14B at full
# width with 2 of their 32 and 40 layers; context 8192 as the presets
GGUF_FILES = {
    "tinyllama": dict(stem="tinyllama-1.1b-chat-v1.0.Q8_0", arch="llama",
                      name="TinyLlama 1.1B Chat v1.0", layers=22, hidden=2048, ffn=5632,
                      heads=32, kv_heads=4, head_dim=64, vocab=32000, ctx=2048,
                      theta=10000.0, eps=1e-5, tokenizer="llama"),
    "deepseek": dict(stem="DeepSeek-R1-Distill-Llama-8B.Q8_0", arch="llama",
                     name="DeepSeek R1 Distill Llama 8B", layers=2, hidden=4096, ffn=14336,
                     heads=32, kv_heads=8, head_dim=128, vocab=128256, ctx=8192,
                     theta=500000.0, eps=1e-5, tokenizer="gpt2", pre="llama-bpe",
                     specials=("<|begin_of_text|>", "<|end_of_text|>"), special_pad=256),
    "qwen3": dict(stem="Qwen3-14B.Q8_0", arch="qwen3", name="Qwen3 14B", layers=2,
                  hidden=5120, ffn=17408, heads=40, kv_heads=8, head_dim=128, vocab=151936,
                  ctx=8192, theta=1000000.0, eps=1e-6, tokenizer="gpt2", pre="qwen2",
                  specials=("<|endoftext|>", "<|im_start|>", "<|im_end|>"), special_pad=293),
}
WEIGHT_STD = 0.02
GGUF_PROMPTS = (
    "Summarize the state of the cluster and name the three services that restarted most.",
    "List the failing services and why: disk 93% full on node-7, OOM kills in api-gateway.",
    "Draft a remediation plan, step by step, for the storage tier. " * 6,
)
BPE_PROMPTS = (  # bytes of every width: the byte-level round trip must be exact
    "Summarize the state of the cluster: 42 nodes, 3 degraded.",
    "Résumé des incidents — 中文日志 🙂, naïve café; tabs\tand\r\nnewlines.",
    "Draft a remediation plan, step by step, for the storage tier. " * 6,
    "Explain every alert from the last hour (p99 latency 1834 ms, error rate 0.7%). " * 8,
)


def _sp_vocab(rng, n_pieces: int, added=()):
    """A SentencePiece vocab: <unk>, <s>, </s>, the 256 byte tokens, the
    characters of English text and then pieces, each two earlier pieces
    joined (the short ones drawn more often), scores falling with rank in
    tied groups of 4; ``added`` user-defined tokens last."""
    import string

    from aios_tpu_torch.engine.tokenizer import SPIECE_SPACE

    chars = [SPIECE_SPACE] + list(string.ascii_letters + string.digits + ".,;:!?'\"()%-/")
    pieces, seen = list(chars), set(chars)
    while len(pieces) < n_pieces:
        for a, b in rng.random((n_pieces, 2)) ** 3:
            piece = pieces[int(a * len(pieces))] + pieces[int(b * len(pieces))]
            if len(piece) <= 12 and piece not in seen:
                seen.add(piece)
                pieces.append(piece)
                if len(pieces) == n_pieces:
                    break
    tokens = (["<unk>", "<s>", "</s>"] + [f"<0x{i:02X}>" for i in range(256)] + pieces
              + list(added))
    scores = [0.0] * 259 + [-float(i // 4) for i in range(n_pieces)] + [0.0] * len(added)
    types = [2, 3, 3] + [6] * 256 + [1] * n_pieces + [4] * len(added)
    return tokens, scores, types


def _bpe_vocab(rng, vocab: int, specials, pad: int):
    """A byte-level BPE vocab of ``vocab`` tokens: the 256 byte symbols, then
    one token per merge of two earlier tokens (first pairs of letters and the
    space symbol, then any two, the short ones drawn more often), and ``pad``
    control tokens: ``specials`` and reserved ones."""
    from aios_tpu_torch.engine.tokenizer import _bytes_to_unicode

    b2u = _bytes_to_unicode()
    tokens = [b2u[b] for b in range(256)]
    letters = [b2u[b] for b in b"etaoinshrdlucmfwypvbgkqjxzETAOINSHRDLUC "]
    seen, merges = set(tokens), []
    n = vocab - pad
    while len(tokens) < n:
        for a, b in rng.random((n, 2)):
            if len(tokens) < 256 + 1024:
                left, right = letters[int(a * len(letters))], letters[int(b * len(letters))]
            else:
                left, right = tokens[int(a ** 3 * len(tokens))], tokens[int(b ** 3 * len(tokens))]
            tok = left + right
            if len(tok) <= 16 and tok not in seen:
                seen.add(tok)
                tokens.append(tok)
                merges.append(f"{left} {right}")
                if len(tokens) == n:
                    break
    control = list(specials) + [f"<|reserved_special_token_{i}|>"
                                for i in range(pad - len(specials))]
    return tokens + control, merges, [1] * n + [3] * pad


def _q8_0(rng, rows: int, cols: int, std: float = WEIGHT_STD):
    """Q8_0 blocks drawn directly: uniform int8 quants (std 73.9) under f16
    scales of std/73.9 x U(0.75, 1.25)."""
    nb = rows * cols // 32
    blocks = rng.integers(0, 256, size=(nb, 34), dtype=np.uint8)
    d = (std / 73.9 * rng.uniform(0.75, 1.25, nb)).astype(np.float16)
    blocks[:, :2] = d.view(np.uint8).reshape(nb, 2)
    return blocks


def _q4_0(rng, rows: int, cols: int, std: float = WEIGHT_STD):
    """Q4_0 blocks: uniform nibbles (q - 8 of std 4.61) under f16 scales."""
    nb = rows * cols // 32
    blocks = rng.integers(0, 256, size=(nb, 18), dtype=np.uint8)
    d = (std / 4.61 * rng.uniform(0.75, 1.25, nb)).astype(np.float16)
    blocks[:, :2] = d.view(np.uint8).reshape(nb, 2)
    return blocks


def _permute_hf_to_gguf(w, n_heads: int):
    """convert_hf_to_gguf's q/k row permutation (HF half rotation ->
    llama.cpp's interleaved rows)."""
    out_dim = w.shape[0]
    return (w.reshape(n_heads, 2, out_dim // n_heads // 2, w.shape[1])
            .swapaxes(1, 2).reshape(w.shape))


def _write_gguf_file(path, spec: dict, seed: int, vocab=None) -> dict:
    """Write the model of ``spec`` with the port's streaming writer, one
    tensor at a time, each drawn from its own generator (seed, tensor
    index); the 2-D tensors are Q8_0 unless ``spec`` says otherwise
    (``f32``: tensor names stored in F32, HF layout given and permuted as
    llama.cpp writes them; ``q4_0``: names stored in Q4_0). Returns the F32
    tensors in HF layout and the tokenizer vocab."""
    from aios_tpu_torch.engine.gguf import F32, Q4_0, Q8_0, write_gguf_stream

    arch, L, E, F_ = spec["arch"], spec["layers"], spec["hidden"], spec["ffn"]
    H, KH, D, V = spec["heads"], spec["kv_heads"], spec["head_dim"], spec["vocab"]
    rng = np.random.default_rng([seed, 0])
    md = {
        "general.architecture": arch, "general.name": spec["name"],
        f"{arch}.block_count": L, f"{arch}.context_length": spec["ctx"],
        f"{arch}.embedding_length": E, f"{arch}.feed_forward_length": F_,
        f"{arch}.attention.head_count": H, f"{arch}.attention.head_count_kv": KH,
        f"{arch}.attention.key_length": D, f"{arch}.attention.value_length": D,
        f"{arch}.attention.layer_norm_rms_epsilon": spec["eps"],
        f"{arch}.rope.freq_base": spec["theta"],
    }
    if vocab is None:
        if spec["tokenizer"] == "llama":
            added = spec.get("added", ())
            vocab = _sp_vocab(rng, V - 259 - len(added), added)
        else:
            vocab = _bpe_vocab(rng, V, spec["specials"], spec["special_pad"])
    if spec["tokenizer"] == "llama":
        tokens, scores, types = vocab
        md.update({"tokenizer.ggml.model": "llama", "tokenizer.ggml.tokens": tokens,
                   "tokenizer.ggml.scores": scores, "tokenizer.ggml.token_type": types,
                   "tokenizer.ggml.bos_token_id": 1, "tokenizer.ggml.eos_token_id": 2})
    else:
        tokens, merges, types = vocab
        specials = spec["specials"]
        md.update({"tokenizer.ggml.model": "gpt2", "tokenizer.ggml.pre": spec["pre"],
                   "tokenizer.ggml.tokens": tokens, "tokenizer.ggml.merges": merges,
                   "tokenizer.ggml.token_type": types,
                   "tokenizer.ggml.bos_token_id": tokens.index(specials[0]),
                   "tokenizer.ggml.eos_token_id": tokens.index(specials[-1])})
    expect(len(tokens) == V, f"vocab of {len(tokens)} tokens, expected {V}")

    shapes = {"token_embd.weight": (V, E)}
    heads = {}
    for i in range(L):
        p = f"blk.{i}."
        shapes.update({p + "attn_norm.weight": (E,), p + "ffn_norm.weight": (E,)})
        if spec.get("qk_norm", arch == "qwen3"):
            shapes.update({p + "attn_q_norm.weight": (D,), p + "attn_k_norm.weight": (D,)})
        shapes.update({p + "attn_q.weight": (H * D, E), p + "attn_k.weight": (KH * D, E),
                       p + "attn_v.weight": (KH * D, E), p + "attn_output.weight": (E, H * D),
                       p + "ffn_gate.weight": (F_, E), p + "ffn_up.weight": (F_, E),
                       p + "ffn_down.weight": (E, F_)})
        heads[p + "attn_q.weight"], heads[p + "attn_k.weight"] = H, KH
    shapes["output_norm.weight"] = (E,)
    shapes["output.weight"] = (V, E)
    index = {name: i + 1 for i, name in enumerate(shapes)}
    f32_hf = {}

    def kind(name):
        if len(shapes[name]) == 1 or name in spec.get("f32", ()):
            return F32
        return Q4_0 if name in spec.get("q4_0", ()) else Q8_0

    def draw(name):
        r = np.random.default_rng([seed, index[name]])
        shape = shapes[name]
        if len(shape) == 1:
            return r.uniform(0.8, 1.2, shape).astype(np.float32)
        if kind(name) == F32:
            w = r.standard_normal(shape, dtype=np.float32) * WEIGHT_STD
            f32_hf[name] = w
            if arch in ("llama", "mistral") and name in heads:
                w = _permute_hf_to_gguf(w, heads[name])
            return np.ascontiguousarray(w)
        return (_q4_0 if kind(name) == Q4_0 else _q8_0)(r, *shape)

    write_gguf_stream(path, md, {name: (shapes[name], kind(name)) for name in shapes}, draw)
    return dict(f32_hf=f32_hf, vocab=vocab)


def _rss_mb() -> int:
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024


def _loaded_leaves(params, prefix=""):
    for k, v in params.items():
        if isinstance(v, dict):
            yield from _loaded_leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _gguf_params_check(path, tag: str, spec: dict, f32_hf: dict) -> None:
    """``params_from_gguf`` on the card against the same file on the CPU,
    every leaf bit for bit; the F32 tensors (HF layout as drawn) read back
    bit for bit after the unpermute, and their bf16 leaves equal them
    rounded."""
    from aios_tpu_torch.engine.gguf import GGUFFile
    from aios_tpu_torch.engine.weights import _unpermute_llamacpp, params_from_gguf

    t0 = time.perf_counter()
    timings = {}
    on_card, cfg = params_from_gguf(path, "cuda", timings=timings)
    card_s = time.perf_counter() - t0
    on_cpu, _ = params_from_gguf(path, "cpu")
    cpu_s = time.perf_counter() - t0 - card_s
    cpu_leaves = dict(_loaded_leaves(on_cpu))
    n = 0
    for name, leaf in _loaded_leaves(on_card):
        expect(leaf.dtype == torch.bfloat16 and torch.equal(leaf.cpu(), cpu_leaves.pop(name)),
               f"{tag} {name}: the card's load differs from the CPU's")
        n += leaf.numel()
    expect(not cpu_leaves, f"{tag}: leaves only on the CPU: {sorted(cpu_leaves)}")
    f = GGUFFile(path)
    leaf_of = {"attn_q": ("wq", spec["heads"]), "attn_k": ("wk", spec["kv_heads"])}
    for name, w in f32_hf.items():
        layer, kind = int(name.split(".")[1]), name.split(".")[2]
        key, heads = leaf_of[kind]
        back = _unpermute_llamacpp(f.load_tensor(name), heads)
        expect(np.array_equal(back.view(np.uint32), w.view(np.uint32)),
               f"{tag} {name}: F32 values differ after the unpermute")
        want = torch.from_numpy(np.ascontiguousarray(w.T)).to(torch.bfloat16)
        expect(torch.equal(on_cpu["layers"][key][layer], want),
               f"{tag} {name}: the bf16 leaf is not the F32 tensor rounded")
    log(f"{tag} params_from_gguf: {n} parameters in bf16 on the card equal the CPU's load "
        f"bit for bit ({card_s:.2f} s to the card: parse and dequantize "
        f"{timings['dequantize_s']:.2f} s, upload {timings['upload_s']:.2f} s; {cpu_s:.2f} s "
        f"to the CPU); F32 tensors {sorted(f32_hf)} bit for bit after the unpermute; "
        f"process peak RSS {_rss_mb()} MB")
    del on_card, on_cpu
    torch.cuda.empty_cache()


def _gguf_load(manager, stub, tag: str, name: str, path, spec: dict):
    """LoadModel by path at the file's own context, and its log line."""
    m, load_s = _load(manager, stub, name, str(path))
    eng, cfg = m.engine, m.config
    want = (spec["layers"], spec["hidden"], spec["ffn"], spec["heads"], spec["kv_heads"],
            spec["head_dim"], spec["vocab"], spec["ctx"], spec["arch"] == "qwen3")
    got = (cfg.num_layers, cfg.hidden_size, cfg.intermediate_size, cfg.num_heads,
           cfg.num_kv_heads, cfg.head_dim, cfg.vocab_size, eng.max_context, cfg.qk_norm)
    expect(got == want, f"{tag}: config {got} from the file, expected {want}")
    expect(eng.quantized and eng.k_pool.dtype == torch.bfloat16 and eng.paged,
           f"{tag}: expected int8 weights over a bf16 pool")
    head = eng.params["lm_head"]["q"].shape[-1]
    expect(head == -(-cfg.vocab_size // 16) * 16, f"{tag}: lm_head of {head} columns")
    t = m.load_timings
    pool_bytes = sum(x.numel() * x.element_size() for x in (eng.k_pool, eng.v_pool))
    log(f"{tag} LoadModel {path.name} ready in {load_s:.2f} s: {cfg.name!r}, "
        f"{cfg.num_layers} layers, E={cfg.hidden_size}, H/KH={cfg.num_heads}/"
        f"{cfg.num_kv_heads}, D={cfg.head_dim}, V={cfg.vocab_size} (lm_head {head} columns), "
        f"ctx={eng.max_context}, {type(m.tokenizer).__name__}; parse and dequantize "
        f"{t['dequantize_s']:.2f} s, upload {t['upload_s']:.2f} s, quantize "
        f"{t['quantize_s']:.2f} s, capture {t['capture_s']:.2f} s; bf16 pool of "
        f"{eng.allocator.num_pages} pages x {eng.allocator.page_size} rows = {pool_bytes} B; "
        f"process peak RSS {_rss_mb()} MB")
    log(f"{tag} {_graphs_line(m, load_s)}")
    return m


def _gguf_window(manager, stub, m, card: str, tag: str, prompts) -> dict:
    """The served window over ``prompts``, its launches exact: per
    whole-prompt prefill 4L+1 K1 and L K2, per admission chunk 4L+1 K1 and
    L K6, per decode step 4L+1 K1 and L K3."""
    w = _served_window(manager, stub, m, card, f" ({tag})", prompts)
    L = m.config.num_layers
    n, pre, steps, chunks = w["launches"], w["prefills"], w["steps"], w["chunks"]
    want = dict.fromkeys(n, 0)
    want.update({"quantized_matmul": (4 * L + 1) * (pre + chunks + steps),
                 "flash_attention": L * pre, "paged_decode_attention": L * steps,
                 "multiquery_decode_attention": L * chunks})
    expect(n == want, f"{tag} launch counts {n} != {want} for {pre} prefills, {chunks} "
           f"chunks, {steps} steps")
    log(f"{tag} launch counts exact for {pre} whole-prompt prefills, {chunks} admission "
        f"chunks and {steps} decode steps ({4 * L + 1} K1 and {L} K2, K6 or K3 each): {n}")
    return w


def _gguf_greedy(m, tag: str, prompt: str) -> None:
    """Two greedy requests of one templated prompt, each admitted cold, give
    one stream."""
    from aios_tpu_torch.engine.tokenizer import render_chat

    eng = m.engine
    ids = m.tokenizer.encode(render_chat(m.config.name, prompt))
    eng.prefix_index.clear()
    a = m.batcher.generate(ids, max_tokens=24, temperature=0.0)
    eng.prefix_index.clear()
    b = m.batcher.generate(ids, max_tokens=24, temperature=0.0)
    expect(a and a == b, f"{tag} greedy streams differ: {a} vs {b}")
    log(f"{tag} two greedy streams of {len(a)} tokens for a {len(ids)}-token prompt "
        f"identical: {a[:8]}... -> {m.tokenizer.decode(a)[:60]!r}")


def _long_sp_prompt(tok, name: str, vocab, at_least: int) -> str:
    """Text of the vocab's own pieces that templates to ``at_least`` tokens."""
    from aios_tpu_torch.engine.tokenizer import SPIECE_SPACE, render_chat

    pieces = [t for t, typ in zip(vocab[0], vocab[2]) if typ == 1]
    rng = np.random.default_rng([GGUF_SEED, 99])
    words = []
    while True:
        words += [pieces[i].replace(SPIECE_SPACE, " ")
                  for i in rng.integers(0, len(pieces), 64)]
        text = "".join(words)
        if len(tok.encode(render_chat(name, text))) >= at_least:
            return text


def _bad_files(manager, stub, tmp) -> None:
    """Files that cannot be served leave the model in ``error`` with the
    reason in LoadModel's reply: a corrupt header, a mixture-of-experts
    header without its router and expert tensors and a tensor in a ggml
    type with no dequantizer (Q2_K)."""
    import grpc

    from aios_tpu_torch.engine.gguf import F32, Q2_K, Q8_0, quantize_q8_0, write_gguf
    from aios_tpu_torch.proto_gen import common_pb2, runtime_pb2

    E, H, D, F_, V = 128, 2, 64, 256, 512
    md = {"general.architecture": "llama", "general.name": "bad",
          "llama.block_count": 1, "llama.context_length": 256,
          "llama.embedding_length": E, "llama.feed_forward_length": F_,
          "llama.attention.head_count": H, "llama.attention.head_count_kv": H}
    rng = np.random.default_rng([GGUF_SEED, 7])

    def tensors(q2k: bool):
        def mat(rows, cols, name):
            if q2k and name == "blk.0.ffn_down.weight":
                return ((rows, cols), Q2_K, rng.integers(0, 256, rows * cols // 256 * 84,
                                                          dtype=np.uint8).tobytes())
            w = rng.standard_normal(rows * cols).astype(np.float32) * WEIGHT_STD
            return ((rows, cols), Q8_0, quantize_q8_0(w).tobytes())

        out = {"token_embd.weight": mat(V, E, "token_embd.weight")}
        for name, shape in (("attn_norm", E), ("ffn_norm", E)):
            out[f"blk.0.{name}.weight"] = ((shape,), F32, np.ones(shape, np.float32).tobytes())
        for name, (r, c) in (("attn_q", (H * D, E)), ("attn_k", (H * D, E)),
                             ("attn_v", (H * D, E)), ("attn_output", (E, H * D)),
                             ("ffn_gate", (F_, E)), ("ffn_up", (F_, E)),
                             ("ffn_down", (E, F_))):
            out[f"blk.0.{name}.weight"] = mat(r, c, f"blk.0.{name}.weight")
        out["output_norm.weight"] = ((E,), F32, np.ones(E, np.float32).tobytes())
        return out

    bad = tmp / "bad"
    bad.mkdir()
    write_gguf(bad / "q2k.gguf", md, tensors(True))
    write_gguf(bad / "moe.gguf", {**md, "llama.expert_count": 8}, tensors(False))
    (bad / "corrupt.gguf").write_bytes((bad / "moe.gguf").read_bytes()[:40])
    for name, why in (("corrupt", "unpack"), ("moe", "no tensor blk.0.ffn_gate_inp.weight"),
                      ("q2k", "Q2_K")):
        try:
            st = stub.LoadModel(runtime_pb2.LoadModelRequest(
                model_name=name, model_path=str(bad / f"{name}.gguf")), timeout=300)
            code, details = st.status, ""
        except grpc.RpcError as exc:
            code, details = exc.code().name, exc.details() or ""
        listed = {x.model_name: x.status for x in stub.ListModels(common_pb2.Empty()).models}
        expect(code == "INTERNAL" and why in details and listed.get(name) == "error",
               f"LoadModel {name}.gguf: {code} {details!r}, listed {listed}")
        log(f"[gguf] LoadModel {name}.gguf refused: {code}, listed as {listed[name]!r}: "
            f"{details}")
        expect(stub.UnloadModel(runtime_pb2.UnloadModelRequest(model_name=name)).success,
               f"UnloadModel {name}")


def phase_gguf(card: str) -> dict:
    """Write the three GGUF files one at a time, hold each loader against
    the CPU, serve each over gRPC through the kernels; TinyLlama also by
    ``autoload`` and with a 32002-token vocab. Returns the launches of the
    served windows."""
    import tempfile
    from pathlib import Path

    from aios_tpu_torch import rpc, services
    from aios_tpu_torch.engine.tokenizer import render_chat
    from aios_tpu_torch.proto_gen import runtime_pb2
    from aios_tpu_torch.runtime.model_manager import ModelManager
    from aios_tpu_torch.runtime.service import serve

    totals: dict = {}

    def count(w):
        for k, v in w["launches"].items():
            totals[k] = totals.get(k, 0) + v

    def unload(name):
        expect(stub.UnloadModel(runtime_pb2.UnloadModelRequest(model_name=name)).success,
               f"UnloadModel {name}")
        torch.cuda.empty_cache()

    manager = ModelManager(num_slots=8, quantize="int8", kv_cache="bf16")
    server, _, port = serve("127.0.0.1:0", manager, block=False)
    channel = rpc.insecure_channel(f"127.0.0.1:{port}")
    stub = services.AIRuntimeStub(channel)
    try:
        with tempfile.TemporaryDirectory(prefix="aios-gguf-") as tmp:
            tmp = Path(tmp)
            _bad_files(manager, stub, tmp)
            # (a) TinyLlama, full width and depth
            spec = dict(GGUF_FILES["tinyllama"], f32=("blk.0.attn_q.weight",
                                                      "blk.0.attn_k.weight"),
                        q4_0=("blk.1.ffn_gate.weight", "blk.1.ffn_up.weight",
                              "blk.1.ffn_down.weight"))
            models = tmp / "models"
            models.mkdir()
            path = models / f"{spec['stem']}.gguf"
            t0 = time.perf_counter()
            made = _write_gguf_file(path, spec, GGUF_SEED)
            log(f"[gguf tinyllama] wrote {path.name}: {path.stat().st_size} B in "
                f"{time.perf_counter() - t0:.2f} s (one tensor at a time; process peak RSS "
                f"{_rss_mb()} MB)")
            _gguf_params_check(path, "[gguf tinyllama]", spec, made["f32_hf"])
            m = _gguf_load(manager, stub, "[gguf tinyllama]", "tinyllama-gguf", path, spec)
            long_prompt = _long_sp_prompt(m.tokenizer, m.config.name, made["vocab"], 1800)
            t0 = time.perf_counter()
            n_long = len(m.tokenizer.encode(render_chat(m.config.name, long_prompt)))
            encode_ms = (time.perf_counter() - t0) * 1e3
            log(f"[gguf tinyllama] SentencePieceBPE.encode of the long prompt ({len(long_prompt)}"
                f" chars, {n_long} tokens templated) took {encode_ms:.2f} ms on the host")
            w = _gguf_window(manager, stub, m, card, "[gguf tinyllama]",
                             GGUF_PROMPTS + (long_prompt,))
            expect(w["chunks"] >= 4, f"the {n_long}-token prompt was not admitted in chunks")
            count(w)
            _logits_gate(m, "[gguf tinyllama]", m.config.vocab_size)
            _gguf_greedy(m, "[gguf tinyllama]", GGUF_PROMPTS[0])
            unload("tinyllama-gguf")
            t0 = time.perf_counter()
            names = manager.autoload(str(models))
            stem = spec["stem"].lower()
            m = manager.get(stem)
            expect(names == [stem] and m is not None and m.engine.max_context == 2048
                   and m.context_length == 2048,
                   f"autoload loaded {names}, context {m and m.engine.max_context}")
            r = stub.Infer(runtime_pb2.InferRequest(prompt=GGUF_PROMPTS[1], max_tokens=16,
                                                    intelligence_level="operational"),
                           timeout=300)
            expect(r.model_used == stem and r.tokens_used > 0, f"autoload model: {r}")
            log(f"[gguf tinyllama] autoload({models.name}/) in {time.perf_counter() - t0:.2f} s "
                f"loaded {names} at context {m.engine.max_context} ({path.stat().st_size} B "
                f"file); an operational Infer went to {r.model_used!r}")
            unload(stem)
            path.unlink()

            # a TinyLlama-width file whose vocab (32002) the head pads to 32016
            spec = dict(GGUF_FILES["tinyllama"], layers=2, vocab=32002,
                        added=("<|im_start|>", "<|im_end|>"))
            path = tmp / "tinyllama-32002.gguf"
            _write_gguf_file(path, spec, GGUF_SEED + 1)
            m = _gguf_load(manager, stub, "[gguf 32002]", "tinyllama-32002", path, spec)
            _logits_gate(m, "[gguf 32002]", m.config.vocab_size)
            r = stub.Infer(runtime_pb2.InferRequest(prompt=GGUF_PROMPTS[0], max_tokens=16),
                           timeout=300)
            expect(r.tokens_used > 0, f"Infer on the 32002-token vocab: {r}")
            log(f"[gguf 32002] one Infer: {r.tokens_used} tokens, {r.text[:40]!r}")
            unload("tinyllama-32002")
            path.unlink()

            # (b) DeepSeek-R1-8B and (c) Qwen3-14B, full width, 2 layers
            for key, seed in (("deepseek", GGUF_SEED + 2), ("qwen3", GGUF_SEED + 3)):
                tag, spec = f"[gguf {key}]", GGUF_FILES[key]
                path = tmp / f"{spec['stem']}.gguf"
                t0 = time.perf_counter()
                _write_gguf_file(path, spec, seed)
                log(f"{tag} wrote {path.name}: {path.stat().st_size} B in "
                    f"{time.perf_counter() - t0:.2f} s")
                _gguf_params_check(path, tag, spec, {})
                m = _gguf_load(manager, stub, tag, key, path, spec)
                for p in BPE_PROMPTS:
                    ids = m.tokenizer.encode(p)
                    expect(m.tokenizer.decode(ids) == p, f"{tag} round trip of {p!r}")
                log(f"{tag} decode(encode(s)) == s for the {len(BPE_PROMPTS)} served prompts "
                    f"({[len(m.tokenizer.encode(p)) for p in BPE_PROMPTS]} tokens)")
                count(_gguf_window(manager, stub, m, card, tag, BPE_PROMPTS))
                _logits_gate(m, tag, m.config.vocab_size)
                _gguf_greedy(m, tag, BPE_PROMPTS[0])
                ids = m.tokenizer.encode(render_chat(m.config.name, BPE_PROMPTS[1]))
                m.engine.prefix_index.clear()
                first = m.engine.prefill(0, ids, temperature=0.0)
                row = m.engine._adm_logits
                top = torch.topk(row, 3)
                m.engine.release(0)
                expect(first == int(top.indices[0]) and bool(torch.isfinite(row).all()),
                       f"{tag} first token {first}, logits argmax {int(top.indices[0])}")
                log(f"{tag} first-token logits of a {len(ids)}-token request: argmax {first} "
                    f"({m.tokenizer.decode([first])!r}), top 3 {top.values.tolist()} at "
                    f"{top.indices.tolist()}, max|logit| {row.abs().max().item():.4f}")
                unload(key)
                path.unlink()
    finally:
        manager.close()
        channel.close()
        server.stop(grace=None)
    torch.cuda.empty_cache()
    return totals



# -- phase 12: grammar-constrained decoding ------------------------------------------

# a catalog of a dozen tool names for the orchestrator's reasoning-reply schema
TOOL_CATALOG = ("read_file", "write_file", "list_dir", "search_logs", "restart_service",
                "scale_deployment", "query_metrics", "open_ticket", "page_oncall",
                "run_playbook", "check_health", "rollback_release")


def toolcalls_schema(catalog) -> dict:
    """The orchestrator's reasoning-reply schema (``toolcalls_schema`` of
    aios_tpu/orchestrator/autonomy.py): a free thought, tool calls whose
    names are the catalog's enum with free-form args, and done."""
    return {
        "type": "object",
        "properties": {
            "thought": {"type": "string"},
            "tool_calls": {"type": "array", "items": {
                "type": "object",
                "properties": {"tool": {"type": "string", "enum": list(catalog)},
                               "args": {"type": "object"}},
                "required": ["tool"]}},
            "done": {"type": "boolean"},
        },
        "required": ["done"],
    }


# enums, integers, booleans and a nested object
MIXED_SCHEMA = {
    "type": "object",
    "properties": {
        "severity": {"type": "string", "enum": ["low", "medium", "high", "critical"]},
        "count": {"type": "integer"},
        "paged": {"type": "boolean"},
        "owner": {"type": "object", "properties": {
            "team": {"type": "string", "enum": ["storage", "network", "compute"]},
            "shift": {"type": "integer"}}, "required": ["team", "shift"]},
    },
    "required": ["severity", "count", "paged", "owner"],
}
# the enum-heavy tool-call shape of tests/test_structured_fastpath.py, over
# the catalog: every position is forced once an enum's first bytes decide it
FORCED_SCHEMA = {
    "type": "object",
    "properties": {"tool": {"type": "string", "enum": list(TOOL_CATALOG)},
                   "path": {"type": "string", "enum": ["slash_tmp", "slash_var_log"]},
                   "recursive": {"type": "boolean"}},
    "required": ["tool", "path", "recursive"],
}
CONSTRAINED_PROMPTS = (
    "Decide the next tool call for the incident: disk 93% full on node-7.",
    "Pick a tool and report whether the rollout is done.",
    "Classify the alert storm from the last hour and name the owning team.",
    "Summarize the cluster state as one JSON object.",
)
GREEDY = 1e-5  # below the sampler's GREEDY_EPS: 0 on the wire means unset


def _conforms(schema: dict, text: str) -> bool:
    """Whether ``text`` is a complete value of ``schema`` (the port's
    SchemaMachine, lenient whitespace)."""
    from aios_tpu_torch.engine import jsonschema

    machine = jsonschema.SchemaMachine(*jsonschema.compile_schema(schema))
    st = machine.start()
    for b in text.encode("utf-8"):
        st = machine.step(st, b)
        if st is None:
            return False
    return machine.terminal(st)


def _tool_names(parsed: dict):
    return [c.get("tool") for c in parsed.get("tool_calls", [])]


def _constrained_window(m, stub, tag: str, temperature: float, card: str) -> dict:
    """Four Infer at once (two with the tool-call schema, one with
    MIXED_SCHEMA, one plain under forced JSON mode) and one StreamInfer
    beside them, every kernel count set to 0 just before and read just
    after: every reply parses to an object, the schema replies end in a
    terminal state of their schema's machine with tool names from the
    catalog, the stream was not constrained, the launches are exact (per
    prefill, admission chunk, masked or plain step and jump) and every
    dispatch was a graph replay."""
    from aios_tpu_torch.proto_gen import runtime_pb2

    eng, L = m.engine, m.config.num_layers
    per = 4 * L + 1
    tools = json.dumps(toolcalls_schema(TOOL_CATALOG))
    reqs = [(CONSTRAINED_PROMPTS[0], tools), (CONSTRAINED_PROMPTS[1], tools),
            (CONSTRAINED_PROMPTS[2], json.dumps(MIXED_SCHEMA)), (CONSTRAINED_PROMPTS[3], "")]
    seen, orig = [], m.submit
    m.submit = lambda req, **kw: seen.append(req) or orig(req, **kw)
    captured = eng.stats()["graph_captures"]
    _reset_counts()
    before = (eng.decode_steps, eng.jump_dispatches, eng.jump_tokens, eng.prefills,
              eng.prefill_chunks, eng.graphs.replays)
    results, errors = {}, []

    def infer(i):
        prompt, schema = reqs[i]
        results[i] = stub.Infer(runtime_pb2.InferRequest(
            prompt=prompt, max_tokens=256, temperature=temperature, json_schema=schema),
            timeout=600)

    def stream():
        results["stream"] = list(stub.StreamInfer(runtime_pb2.InferRequest(
            prompt=CONSTRAINED_PROMPTS[3], max_tokens=48, temperature=temperature),
            timeout=600))

    def run(fn, *a):
        try:
            fn(*a)
        except Exception as exc:  # noqa: BLE001 - re-raised on the main thread
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(infer, i)) for i in range(4)]
    threads.append(threading.Thread(target=run, args=(stream,)))
    t0 = time.perf_counter()
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
    finally:
        m.submit = orig
    wall = time.perf_counter() - t0
    launches = _read_counts()
    expect(not errors and all(not t.is_alive() for t in threads),
           f"{tag} requests failed: {errors!r}")
    steps, jumps, jump_tokens, pre, chunks, replays = (
        now - was for now, was in zip((eng.decode_steps, eng.jump_dispatches,
                                       eng.jump_tokens, eng.prefills, eng.prefill_chunks,
                                       eng.graphs.replays), before))
    replies = []
    for i, (_, schema) in enumerate(reqs):
        text = results[i].text
        try:
            parsed = json.loads(text)
        except ValueError:
            parsed = None
        expect(isinstance(parsed, dict), f"{tag} Infer {i} is not a JSON object: {text!r}")
        if schema:
            expect(_conforms(json.loads(schema), text),
                   f"{tag} Infer {i} does not end in a terminal state of its schema: {text!r}")
        expect(all(t in TOOL_CATALOG for t in _tool_names(parsed)),
               f"{tag} tool names outside the catalog: {text!r}")
        replies.append(text)
    flags = sorted((r.json_mode, r.json_schema is not None) for r in seen)
    expect(flags == [(False, False), (False, True), (False, True), (False, True),
                     (True, False)],
           f"{tag} constrained flags of the five requests: {flags} (the stream must be "
           "unconstrained, the plain Infer in forced JSON mode)")
    chunks_ = results["stream"]
    expect(chunks_ and chunks_[-1].done, f"{tag} StreamInfer did not end with done")
    want = {"quantized_matmul": per * (pre + chunks + steps), "flash_attention": L * pre,
            "paged_decode_attention": L * (steps - jumps),
            "multiquery_decode_attention": L * (chunks + jumps)}
    want = {k: v for k, v in want.items() if v}
    expect(launches == want, f"{tag} launches {launches} != {want} for {pre} prefills, "
           f"{chunks} chunks, {steps - jumps} steps, {jumps} jumps")
    expect(eng.stats()["graph_captures"] == captured and replays == steps + pre + chunks,
           f"{tag} {eng.stats()['graph_captures'] - captured} graphs captured while "
           f"serving, {replays} replays for {steps + pre + chunks} dispatches")
    log(f"{tag} 4 constrained Infer (2 tool-call schema, 1 mixed schema, 1 forced JSON "
        f"mode) + 1 unconstrained StreamInfer at temperature {temperature}: {wall:.3f} s, "
        f"{steps} decode dispatches ({jumps} jumps carrying {jump_tokens} tokens, "
        f"{jump_tokens / max(jumps, 1):.2f} a jump), {pre} prefills, {chunks} chunks, every "
        f"one a graph replay, captures flat at {captured}; launches exact {launches}; "
        f"{card}")
    for i, text in enumerate(replies):
        log(f"{tag}   reply {i}: {text[:150]!r}")
    return launches


def _jump_arms(m, tag: str, requests, card: str, schema_name: str) -> dict:
    """The same greedy requests through the batcher with jump-ahead on and
    then off: the streams, the dispatches and wall of each arm; where the
    two streams part, the token is a free choice of the grammar (never a
    forced one), and the fraction of positions where they agree."""
    from aios_tpu_torch.engine.batching import Request

    eng, b = m.engine, m.batcher
    for h in [b.submit(Request(**r)) for r in requests]:
        h.tokens()  # the automaton's mask rows are built on first use: not timed
    arms = {}
    for jump in (True, False):
        b.jump_ahead = jump
        if eng.prefix_index is not None:
            eng.prefix_index.clear()
        steps0, t0 = eng.decode_steps, time.perf_counter()
        jumps0, carried0 = eng.jump_dispatches, eng.jump_tokens
        hs = [b.submit(Request(**r)) for r in requests]
        outs = [h.tokens() for h in hs]
        arms[jump] = (outs, eng.decode_steps - steps0, time.perf_counter() - t0)
        if jump:
            jumps, carried = eng.jump_dispatches - jumps0, eng.jump_tokens - carried0
    b.jump_ahead = True
    (on, on_steps, on_wall), (off, off_steps, off_wall) = arms[True], arms[False]
    agree = total = 0
    for r, x, y in zip(requests, on, off):
        cache = (b._schema_mask_cache(r["json_schema"]) if r.get("json_schema")
                 else b._json_mask_cache())
        from aios_tpu_torch.engine.jsonmode import JsonConstraint

        con = JsonConstraint(cache)
        con.advance(cache.start_token_id)
        for i, (p, q) in enumerate(zip(x[1:], y[1:])):
            if p != q:
                expect(cache.singleton_token(con.state) is None,
                       f"{tag} jump and masked streams part at a forced token")
                break
            con.advance(p)
        total += max(len(x), len(y))
        agree += sum(p == q for p, q in zip(x, y))
    log(f"{tag} {len(requests)} greedy {schema_name} requests, jump-ahead on vs off: "
        f"{on_steps} vs {off_steps} decode dispatches (x{off_steps / max(on_steps, 1):.2f}; "
        f"{jumps} jumps carrying {carried} tokens, {carried / max(jumps, 1):.2f} a jump), "
        f"{on_wall:.3f} vs {off_wall:.3f} s; the streams agree at {agree / total:.3f} of "
        f"positions and part only at free choices of the grammar; {card}")
    return dict(on_steps=on_steps, off_steps=off_steps, agree=agree / total)


def _forcing_rows(eng, tokens_):
    """Mask rows that admit only ``tokens_[s]`` for every slot."""
    from aios_tpu_torch.engine.jsonmode import NEG_INF

    rows = {}
    for s, t in enumerate(tokens_):
        row = torch.full((eng.cfg.vocab_size,), NEG_INF, dtype=torch.float32,
                         device=eng.device)
        row[int(t)] = 0.0
        rows[s] = row
    return rows


def _written_rows(eng, lengths, n: int):
    """Rows [lengths[s], lengths[s] + n) of every slot in every cache tensor,
    copied (int8 values dequantized with their scales)."""
    out = []
    for s, start in enumerate(lengths):
        rows = _slot_rows(eng, s, start + n)
        if eng.quant_cache:
            rows = [rows[0].float() * rows[2][..., None], rows[1].float() * rows[3][..., None]]
        out.append([r[:, start:start + n].float() for r in rows])
    return out


def _busy(fn, snap, eng) -> float:
    """Median device busy ms of ``fn()`` over three profiled windows, each
    from ``snap``."""
    from torch.profiler import ProfilerActivity, profile

    busy = []
    for _ in range(3):
        _restore(eng, snap)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        busy.append(sum(us for _, us in _device_kernels(prof).values()) / 1e3)
    return statistics.median(busy)


def _wall(fn, snap, eng) -> float:
    """Median host wall ms of ``fn()`` over five synchronized runs, each
    from ``snap``."""
    walls = []
    for _ in range(5):
        _restore(eng, snap)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls) * 1e3


def _constrained_dispatches(tag: str, eng, per_masked: dict, per_jump: dict, card: str,
                            timed: bool = True, drift_tol: float = E2E_TOL) -> None:
    """On 8 greedy slots at ~300 rows, from one state each time: the masked
    step's replay against its eager body and each jump bucket's replay
    against its eager body (tokens or lengths and last tokens, the logits
    and every cache row written, bit for bit), their launches exact through
    the replays (``per_masked``, ``per_jump``); over the pool, the jump's
    forward (``verify_step_paged``) through the kernels against the plain
    path at each bucket (``_paged_verify_gate``); the K/V rows one jump of
    16 writes against those 16 masked steps forcing the same tokens write
    (layer 0 within TOL of max |row|, every layer within ``drift_tol``);
    with ``timed``, host wall and device busy of
    a plain step, a masked step, and a jump of 4 and 16 against 4 and 16
    masked steps, and over the pool the device time of a jump's page
    gather alone. A check on a test state, not the served path: the
    launches it makes are gated here and counted nowhere else."""
    from aios_tpu_torch.engine.engine import JUMP_BUCKETS
    from aios_tpu_torch.engine.jsonmode import NEG_INF

    S, V = eng.num_slots, eng.cfg.vocab_size
    if eng.prefix_index is not None:
        eng.prefix_index.clear()
    for s in range(S):
        eng.prefill(s, [1] + list(range(3, 300 - 5 * s)), temperature=0.0)
    eng.capture_masked()
    for kb in JUMP_BUCKETS:
        eng.capture_jump(kb)
    snap = _snapshot(eng)
    lengths = [eng.slot_length(s) for s in range(S)]
    gen = np.random.default_rng(0)
    rows = {}
    for s in range(0, S, 2):  # half the slots constrained, the rest zero rows
        row = torch.full((V,), NEG_INF, dtype=torch.float32, device=eng.device)
        row[torch.from_numpy(gen.choice(V, 64, replace=False)).to(eng.device)] = 0.0
        rows[s] = row

    def both(name, graph_fn, eager_fn, per, n_rows):
        runs = {}
        for mode, fn in (("graph", graph_fn), ("eager", eager_fn)):
            _restore(eng, snap)
            out, launches = _counted(fn)
            runs[mode] = (out, eng.last_logits.clone(), eng.lengths.clone(),
                          eng.last_tokens.clone(), _written_rows(eng, lengths, n_rows),
                          launches)
        g, e = runs["graph"], runs["eager"]
        same = ((g[0] is None or (g[0] == e[0]).all()) and torch.equal(g[1], e[1])
                and torch.equal(g[2], e[2]) and torch.equal(g[3], e[3])
                and all(torch.equal(a, b) for x, y in zip(g[4], e[4]) for a, b in zip(x, y)))
        expect(same, f"{tag} {name}: graph replay and eager body differ")
        expect(g[5] == per and e[5] == per, f"{tag} {name} launches: graph {g[5]}, eager "
               f"{e[5]}, planned {per}")
        log(f"{tag} {name}: graph replay vs eager body bit-identical (tokens, logits, "
            f"lengths, last tokens, the {n_rows} rows written a slot), launches exact both "
            f"ways {per}")

    both("masked step", lambda: eng.step_masked(rows), lambda: eng.step_masked_eager(rows),
         per_masked, 1)
    for kb in JUMP_BUCKETS:
        forced = gen.integers(3, min(V, 30000), (S, kb))
        counts = np.array([kb, kb - 1, 0, kb, 1, kb, kb // 2, kb])
        both(f"jump at bucket {kb}", lambda: eng.jump_step(forced, counts),
             lambda: eng.jump_step_eager(forced, counts), per_jump, kb + 1)
        _restore(eng, snap)
        if eng.paged:
            _paged_verify_gate(tag, eng, snap, lengths, forced, drift_tol)

    # one jump of 16 against 16 masked steps forcing the same tokens
    kb = JUMP_BUCKETS[-1]
    forced = gen.integers(3, min(V, 30000), (S, kb))
    _restore(eng, snap)
    eng.jump_step(forced, np.full(S, kb))
    jumped = _written_rows(eng, lengths, kb)
    _restore(eng, snap)
    stepped = []
    for i in range(kb):
        stepped.append(eng.step_masked(_forcing_rows(eng, forced[:, i]))[0])
    expect((np.stack(stepped, 1) == forced).all(), f"{tag} forcing masked steps sampled "
           "other tokens")
    masked_rows = _written_rows(eng, lengths, kb)
    # per layer, max |d| / max |row| over the slots, K and V: layer 0 sees
    # the same input both ways (only the matmul tiles differ); deeper layers
    # see hidden states that drifted through the layers before, as the
    # logits do (E2E_TOL, Mistral's free-running DRIFT_TOL)
    per_layer = torch.stack([(a - b).abs().amax(dim=(1, 2, 3)) / b.abs().amax(dim=(1, 2, 3))
                             for x, y in zip(jumped, masked_rows)
                             for a, b in zip(x, y)]).amax(0).tolist()
    bits = all(torch.equal(a, b) for x, y in zip(jumped, masked_rows) for a, b in zip(x, y))
    expect(per_layer[0] <= TOL and max(per_layer) <= drift_tol,
           f"{tag} K/V rows of a jump vs masked steps: layer 0 {per_layer[0]:.3e} (limit "
           f"{TOL}), deepest {max(per_layer):.3e} (limit {drift_tol})")
    log(f"{tag} K/V rows one jump of {kb} writes vs {kb} masked steps forcing the same "
        f"tokens, max |d| / max |row| per layer: layer 0 {per_layer[0]:.3e} (limit {TOL}), "
        f"layer {len(per_layer) // 2} {per_layer[len(per_layer) // 2]:.3e}, last "
        f"{per_layer[-1]:.3e}, largest {max(per_layer):.3e} (limit {drift_tol}); bit-equal: "
        f"{bits}")

    if timed:
        plain_w, plain_b = _wall(lambda: eng.step(1), snap, eng), _busy(
            lambda: eng.step(1), snap, eng)
        mask_w, mask_b = (_wall(lambda: eng.step_masked(rows), snap, eng),
                          _busy(lambda: eng.step_masked(rows), snap, eng))
        log(f"[constrained time] {tag} one plain step: host wall {plain_w:.3f} ms, device "
            f"busy {plain_b:.3f} ms; one masked step (4 of 8 slots constrained): host wall "
            f"{mask_w:.3f} ms, device busy {mask_b:.3f} ms; {card}")
        for kb in JUMP_BUCKETS:
            forced = gen.integers(3, min(V, 30000), (S, kb))
            counts = np.full(S, kb)
            forcing = [_forcing_rows(eng, forced[:, i]) for i in range(kb)]

            def masked_run(forcing=forcing):
                for r in forcing:
                    eng.step_masked(r)

            jw = _wall(lambda: eng.jump_step(forced, counts), snap, eng)
            jb = _busy(lambda: eng.jump_step(forced, counts), snap, eng)
            mw, mb = _wall(masked_run, snap, eng), _busy(masked_run, snap, eng)
            log(f"[constrained time] {tag} a jump of {kb} tokens a slot: host wall "
                f"{jw:.3f} ms, device busy {jb:.3f} ms; {kb} masked steps: host wall "
                f"{mw:.3f} ms, device busy {mb:.3f} ms (x{mw / jw:.2f} wall, x{mb / jb:.2f} "
                f"busy); {card}")
        if eng.paged:
            t = eng.tables_dev.long()
            pools = [p for p in (eng.k_pool, eng.v_pool, eng.k_scales, eng.v_scales)
                     if p is not None]

            def gather():
                for i in range(eng.cfg.num_layers):
                    for p in pools:
                        p[i][t]

            # the views written; the entries past a slot's blocks all read
            # the sacrificial page, so most reads hit the L2
            nbytes = sum(p[0][t].numel() * p.element_size() for p in pools) \
                * eng.cfg.num_layers
            log(f"[constrained time] {tag} the page gather of one paged jump (every "
                f"layer's [S, C] views, {nbytes} B written) timed alone: "
                f"{time_ms(gather):.3f} ms device (CUDA events); {card}")
    _restore(eng, snap)
    for s in range(S):
        eng.release(s)


def _paged_verify_gate(tag: str, eng, snap, lengths, forced, drift_tol: float) -> None:
    """The jump's forward, ``model.verify_step_paged``, fed [last token,
    ``forced``] (T = kb + 1) from the state ``snap``, through the kernels
    (K1/K5, K6/K7 with B = 8 over the gathered page views) and through the
    plain path, on the engine's own pool, slot 2 inactive: the logits of
    the active slots within ``drift_tol`` of max |logit| (the free-running
    logits gate), the K/V rows each writes within TOL of max |row| at layer
    0 (the projections alone) and within ``drift_tol`` at every layer."""
    from aios_tpu_torch.engine import model

    S, kb = eng.num_slots, forced.shape[1]
    keep = [s for s in range(S) if s != 2]
    active = torch.ones(S, dtype=torch.bool, device=eng.device)
    active[2] = False
    feed = torch.cat([eng.last_tokens.view(S, 1).long(),
                      torch.from_numpy(forced).to(eng.device).long()], 1)
    with eng._lock:  # the rows the jump backs (backed already by the jumps above)
        eng._back_active_slots(kb + 1)
        eng._stage_tables()
    runs = {}
    for kernels in (True, False):
        _restore(eng, snap)
        logits = model.verify_step_paged(
            eng.params, eng.cfg, feed, eng.lengths, eng.k_pool, eng.v_pool, eng.tables_dev,
            active=active, kernels=kernels, cache_scales=eng._cache_scales())
        runs[kernels] = (logits[keep], [_written_rows(eng, lengths, kb + 1)[s] for s in keep])
    _restore(eng, snap)
    (lk, rk), (lp, rp) = runs[True], runs[False]
    rel_logits = _rel(lk, lp)
    per_layer = torch.stack([(a - b).abs().amax(dim=(1, 2, 3)) / b.abs().amax(dim=(1, 2, 3))
                             for x, y in zip(rk, rp) for a, b in zip(x, y)]).amax(0).tolist()
    ok = (bool(torch.isfinite(lk).all()) and rel_logits <= drift_tol
          and per_layer[0] <= TOL and max(per_layer) <= drift_tol)
    log(f"{tag} the jump's forward at bucket {kb} (verify_step_paged, B={S}, T={kb + 1}, "
        f"slot 2 inactive), kernels vs plain path on the same pool: max|dlogit|/max|logit| "
        f"{rel_logits:.3e} (limit {drift_tol}), argmax agreement "
        f"{(lk.argmax(-1) == lp.argmax(-1)).float().mean().item():.3f}; rows written, "
        f"max |d| / max |row|: layer 0 {per_layer[0]:.3e} (limit {TOL}), largest "
        f"{max(per_layer):.3e} (limit {drift_tol})")
    expect(ok, f"{tag} verify_step_paged at T={kb + 1}: kernel and plain paths disagree")


def _window_jump(tag: str, m, card: str) -> None:
    """A slot past Mistral's window jumps: before it backs its rows the jump
    returns the block its window left behind, every row it writes lands on
    a live block of the slot's table, the sacrificial page keeps its rows
    but the inactive slots' row P-1, and the pages in use move by exactly
    the slot's resident blocks."""
    eng, alloc = m.engine, m.engine.allocator
    P, W = alloc.page_size, eng.cfg.sliding_window
    eng.prefix_index.clear()
    n = W + P + 10  # block 0 falls out of the window at the jump
    eng.prefill(0, [1] + [(i * 7 + 3) % 256 for i in range(n - 1)], temperature=0.0)
    eng.prefix_index.clear()  # the slot alone holds its pages
    before, res_before = alloc.pages_in_use(), alloc.slot_pages_resident(0)
    page0 = [p[:, 0, : P - 1].clone() for p in (eng.k_pool, eng.v_pool)]
    kb = 16
    eng.jump_step(np.full((eng.num_slots, kb), 65), np.array([kb] + [0] * (eng.num_slots - 1)))
    after, res_after = alloc.pages_in_use(), alloc.slot_pages_resident(0)
    dead = (n - W) // P
    live = range(alloc.trimmed_blocks(0), alloc.blocks_for(n + kb + 1))
    written = range(n // P, (n + kb) // P + 1)
    expect(alloc.trimmed_blocks(0) == dead
           and all(b in live and alloc.tables[0, b] > 0 for b in written),
           f"{tag} a jump row on a block not backed: trimmed {alloc.trimmed_blocks(0)}, "
           f"written blocks {list(written)}, live {live}")
    expect(all(torch.equal(a, p[:, 0, : P - 1]) for a, p in zip(page0, (eng.k_pool, eng.v_pool))),
           f"{tag} the jump wrote the sacrificial page")
    expect(res_after == len(live) and after - before == res_after - res_before,
           f"{tag} pages in use {before} -> {after}, resident blocks {res_before} -> "
           f"{res_after}, planned {len(live)}")
    log(f"{tag} a jump of {kb} past the {W}-row window from row {n}: pages in use "
        f"{before} -> {after} (the slot's resident blocks {res_before} -> {res_after}: "
        f"{dead} left the window), every written row on a live block, the sacrificial "
        f"page's rows 0..{P - 2} untouched; {card}")
    eng.release(0)


def _mask_build_times(vocabs) -> None:
    """Host seconds of a JsonMaskCache (token byte table and byte matrix)
    and a fresh state's mask row for each of ``vocabs`` {name: tokenizer}."""
    from aios_tpu_torch.engine import jsonmode

    for name, tok in vocabs.items():
        V = tok.vocab_size
        t0 = time.perf_counter()
        table = jsonmode.token_bytes_table(tok, V)
        t1 = time.perf_counter()
        cache = jsonmode.JsonMaskCache(table, tok.eos_id, compact=True, device="cuda")
        t2 = time.perf_counter()
        st = cache.run(cache.start(), b'{"')
        cache.mask_row(st)
        t3 = time.perf_counter()
        log(f"[constrained time] host: vocab {V} ({name}): token byte table "
            f"{(t1 - t0) * 1e3:.1f} ms, JsonMaskCache (byte matrix "
            f"{cache._byte_mat.shape}) {(t2 - t1) * 1e3:.1f} ms, a fresh state's mask row "
            f"{(t3 - t2) * 1e3:.1f} ms")


def phase_constrained(card: str) -> dict:
    """Grammar-constrained decoding over gRPC and on the engines, with
    LoadModel under AIOS_TPU_JSON_MODE=force: (1) the TinyLlama-1.1B GGUF
    file (SentencePiece, 32000) loaded without and with forced JSON mode
    (capture seconds both ways; the masked graph and both jump graphs
    captured at load), two constrained windows (greedy and temperature
    0.7), malformed and unsupported schemas refused, the dispatch checks of
    ``_constrained_dispatches``, and jump-ahead on against off on the
    enum-heavy tool-call shape and the tool-call schema; (2) the 2-layer
    DeepSeek-R1-8B file (byte-level, 128256): one tool-call request parses;
    (3) Mistral-7B paged (int4 weights, int8 pool, window 4096): one
    tool-call request per slot, one with a 4100-token prompt, jump on
    against off, a jump past the window, the dispatch checks. Returns the
    launches counted."""
    import os
    import tempfile
    from pathlib import Path

    import grpc

    from aios_tpu_torch import rpc, services
    from aios_tpu_torch.engine.batching import Request
    from aios_tpu_torch.engine.engine import JUMP_BUCKETS
    from aios_tpu_torch.engine.tokenizer import ByteLevelBPE
    from aios_tpu_torch.proto_gen import runtime_pb2
    from aios_tpu_torch.runtime.model_manager import ModelManager
    from aios_tpu_torch.runtime.service import serve

    totals: dict = {}

    def count(launches):
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v

    def unload(stub, name):
        expect(stub.UnloadModel(runtime_pb2.UnloadModelRequest(model_name=name)).success,
               f"UnloadModel {name}")
        torch.cuda.empty_cache()

    old_mode = os.environ.get("AIOS_TPU_JSON_MODE")
    manager = ModelManager(num_slots=8, quantize="int8", kv_cache="bf16")
    server, _, port = serve("127.0.0.1:0", manager, block=False)
    channel = rpc.insecure_channel(f"127.0.0.1:{port}")
    stub = services.AIRuntimeStub(channel)
    try:
        with tempfile.TemporaryDirectory(prefix="aios-constrained-") as tmp:
            tmp = Path(tmp)
            spec = GGUF_FILES["tinyllama"]
            path = tmp / f"{spec['stem']}.gguf"
            made = _write_gguf_file(path, spec, GGUF_SEED)
            os.environ.pop("AIOS_TPU_JSON_MODE", None)
            m, plain_s = _load(manager, stub, "tinyllama-json", str(path))
            plain = (m.engine.graphs.captures, m.engine.graphs.capture_seconds)
            unload(stub, "tinyllama-json")
            os.environ["AIOS_TPU_JSON_MODE"] = "force"
            m, load_s = _load(manager, stub, "tinyllama-json", str(path))
            eng = m.engine
            # forced JSON mode adds the masked step and a jump graph a bucket
            expect(eng.graphs.captures == plain[0] + 1 + len(JUMP_BUCKETS)
                   and "masked" in eng.graphs
                   and all(("jump", k) in eng.graphs for k in JUMP_BUCKETS),
                   f"[constrained] LoadModel under forced JSON mode captured "
                   f"{eng.graphs.captures} graphs, {plain[0]} without")
            log(f"[constrained] TinyLlama GGUF ({type(m.tokenizer).__name__}, vocab "
                f"{m.config.vocab_size}): LoadModel {plain_s:.2f} s with {plain[0]} graphs "
                f"({plain[1]:.2f} s of captures) without forced JSON mode, {load_s:.2f} s with "
                f"{eng.graphs.captures} ({eng.graphs.capture_seconds:.2f} s of captures: the "
                f"masked step and the jumps at {JUMP_BUCKETS} added) under "
                f"AIOS_TPU_JSON_MODE=force; {card}")
            for temperature in (GREEDY, 0.7):
                count(_constrained_window(m, stub, f"[constrained tinyllama t={temperature}]",
                                          temperature, card))
            for schema, why in (("{not json", "invalid json_schema"),
                                ('["a"]', "invalid json_schema"),
                                (json.dumps({"type": "tuple"}), "unsupported json_schema"),
                                (json.dumps({"type": "string"}), "unsupported json_schema")):
                try:
                    stub.Infer(runtime_pb2.InferRequest(prompt="x", max_tokens=8,
                                                        json_schema=schema), timeout=60)
                    code, details = "OK", ""
                except grpc.RpcError as exc:
                    code, details = exc.code(), exc.details() or ""
                expect(code == grpc.StatusCode.INVALID_ARGUMENT and details.startswith(why),
                       f"[constrained] schema {schema!r}: {code} {details!r}")
            log("[constrained] malformed JSON, a non-object root, an unsupported type and a "
                "scalar root: INVALID_ARGUMENT, invalid/unsupported json_schema")
            # one tool-call Infer alone, jump-ahead on and off
            for jump in (True, False):
                m.batcher.jump_ahead = jump
                eng.prefix_index.clear()
                steps0, t0 = eng.decode_steps, time.perf_counter()
                r = stub.Infer(runtime_pb2.InferRequest(
                    prompt=CONSTRAINED_PROMPTS[0], max_tokens=256, temperature=GREEDY,
                    json_schema=json.dumps(toolcalls_schema(TOOL_CATALOG))), timeout=300)
                expect(_conforms(toolcalls_schema(TOOL_CATALOG), r.text),
                       f"[constrained] {r.text!r}")
                log(f"[constrained time] a greedy tool-call Infer (max_tokens 256) alone, "
                    f"jump-ahead {'on' if jump else 'off'}: {time.perf_counter() - t0:.3f} s "
                    f"wall, {eng.decode_steps - steps0} decode dispatches, {r.tokens_used} "
                    f"tokens used; {card}")
            m.batcher.jump_ahead = True
            tok = m.tokenizer
            ids = [tok.encode(render) for render in CONSTRAINED_PROMPTS]
            forced_reqs = [dict(prompt_ids=p, max_tokens=96, temperature=0.0,
                                stop_ids=(tok.eos_id,), json_schema=FORCED_SCHEMA)
                           for p in ids * 2]
            # not gated: a SentencePiece vocab spells most forced bytes several
            # ways ("t", "to", "tool" ...), so its grammar has few singleton
            # states for jump-ahead to chain (the byte vocab of Mistral's
            # synthetic model below has them at every forced byte)
            _jump_arms(m, "[constrained tinyllama]", forced_reqs, card, "enum-heavy tool-call")
            _jump_arms(m, "[constrained tinyllama]",
                       [dict(r, json_schema=toolcalls_schema(TOOL_CATALOG), max_tokens=256)
                        for r in forced_reqs], card, "tool-call schema")
            _constrained_dispatches(
                "[constrained tinyllama paged]", eng,
                {"quantized_matmul": 89, "paged_decode_attention": 22},
                {"quantized_matmul": 89, "multiquery_decode_attention": 22}, card)
            vocabs = {"TinyLlama SentencePiece": m.tokenizer}
            unload(stub, "tinyllama-json")
            path.unlink()
            del made

            spec = GGUF_FILES["deepseek"]
            path = tmp / f"{spec['stem']}.gguf"
            made = _write_gguf_file(path, spec, GGUF_SEED + 2)
            m, load_s = _load(manager, stub, "deepseek-json", str(path))
            _reset_counts()
            r = stub.Infer(runtime_pb2.InferRequest(
                prompt=CONSTRAINED_PROMPTS[0], max_tokens=256, temperature=0.7,
                json_schema=json.dumps(toolcalls_schema(TOOL_CATALOG))), timeout=300)
            count(_read_counts())
            expect(_conforms(toolcalls_schema(TOOL_CATALOG), r.text)
                   and all(t in TOOL_CATALOG for t in _tool_names(json.loads(r.text))),
                   f"[constrained deepseek] {r.text!r}")
            log(f"[constrained deepseek] ({type(m.tokenizer).__name__}, vocab "
                f"{m.config.vocab_size}, 2 layers): LoadModel {load_s:.2f} s under forced JSON "
                f"mode ({m.engine.graphs.captures} graphs); a tool-call Infer at t=0.7 parses "
                f"and conforms: {r.text[:150]!r}; jumps {m.engine.jump_dispatches} carrying "
                f"{m.engine.jump_tokens} tokens")
            vocabs["DeepSeek-R1 byte-level"] = m.tokenizer
            unload(stub, "deepseek-json")
            path.unlink()
            qspec = GGUF_FILES["qwen3"]
            tokens, merges, types = _bpe_vocab(np.random.default_rng([GGUF_SEED + 3, 0]),
                                               qspec["vocab"], qspec["specials"],
                                               qspec["special_pad"])
            vocabs["Qwen3 byte-level"] = ByteLevelBPE(
                tokens=tokens, merges=merges, token_types=types,
                eos_id=tokens.index(qspec["specials"][-1]), pre=qspec["pre"])
            _mask_build_times(vocabs)
    finally:
        manager.close()
        channel.close()
        server.stop(grace=None)
        if old_mode is None:
            os.environ.pop("AIOS_TPU_JSON_MODE", None)
        else:
            os.environ["AIOS_TPU_JSON_MODE"] = old_mode
    torch.cuda.empty_cache()

    # (3) Mistral-7B paged: int4 weights, int8 pool, window 4096
    os.environ["AIOS_TPU_JSON_MODE"] = "force"
    manager = ModelManager(num_slots=8, quantize="int4", kv_cache="int8")
    server, _, port = serve("127.0.0.1:0", manager, block=False)
    channel = rpc.insecure_channel(f"127.0.0.1:{port}")
    stub = services.AIRuntimeStub(channel)
    try:
        m, load_s = _load(manager, stub, "mistral-json", "synthetic://mistral-7b", 8192)
        eng = m.engine
        expect(eng.paged and eng.quant_cache and eng.cfg.sliding_window == M_WINDOW
               and "masked" in eng.graphs, "[constrained mistral] not the paged int8 engine "
               "with the masked graph")
        tok = m.tokenizer
        prompts = [tok.encode(p) for p in CONSTRAINED_PROMPTS] * 2
        prompts[3] = tok.encode("Explain every alert from the last hour. " * 103)[:4100]
        reqs = [dict(prompt_ids=p, max_tokens=160, temperature=0.0, stop_ids=(tok.eos_id,),
                     json_schema=toolcalls_schema(TOOL_CATALOG)) for p in prompts]
        _reset_counts()
        hs = [m.batcher.submit(Request(**r)) for r in reqs]
        outs = [h.tokens() for h in hs]
        count(_read_counts())
        for o in outs:
            text = tok.decode([t for t in o if t != tok.eos_id])
            expect(_conforms(toolcalls_schema(TOOL_CATALOG), text),
                   f"[constrained mistral] {text!r}")
        log(f"[constrained mistral] 8 greedy tool-call requests, one a slot, one with a "
            f"{len(prompts[3])}-token prompt past the {M_WINDOW}-row window: every reply "
            f"parses and conforms; {eng.kv_pages_trimmed} pages trimmed, {card}")
        # a regression gate of the jump tick on a shape where every forced
        # byte is a singleton state; the orchestrator's tool-call schema
        # (the next arms) is reported, not gated: on random weights its free
        # strings are sampled a token at a time and a jump tick stalls the
        # slots that do not jump, so it saves no dispatches there
        forced_reqs = [dict(r, json_schema=FORCED_SCHEMA, max_tokens=96) for r in reqs]
        arms = _jump_arms(m, "[constrained mistral]", forced_reqs, card, "enum-heavy tool-call")
        expect(arms["off_steps"] >= 2 * arms["on_steps"],
               f"[constrained mistral] jump-ahead saved less than 2x on the enum-heavy "
               f"tool call: {arms}")
        _jump_arms(m, "[constrained mistral]", reqs, card, "tool-call schema")
        _window_jump("[constrained mistral]", m, card)
        _constrained_dispatches(
            "[constrained mistral paged]", eng,
            {"int4_matmul": 129, "paged_decode_attention_int8": 32},
            {"int4_matmul": 129, "multiquery_decode_attention_int8": 32}, card,
            drift_tol=DRIFT_TOL)
    finally:
        manager.close()
        channel.close()
        server.stop(grace=None)
        if old_mode is None:
            os.environ.pop("AIOS_TPU_JSON_MODE", None)
        else:
            os.environ["AIOS_TPU_JSON_MODE"] = old_mode
    torch.cuda.empty_cache()
    return totals


# -- main ----------------------------------------------------------------------


# -- phase 13: the serving front door over two replicas ----------------------------

SERVING_MODEL = "tinyllama-serve"
SERVING_KNOBS = ("AIOS_TPU_REPLICAS", "AIOS_TPU_TENANT_TOKENS_PER_SEC",
                 "AIOS_TPU_TENANT_BURST_TOKENS", "AIOS_TPU_TENANT_BY", "AIOS_TPU_MAX_QUEUE",
                 "AIOS_TPU_ASSUMED_TPS", "AIOS_TPU_ROUTE_OVERLAP_MIN",
                 "AIOS_TPU_FAILOVER_RETRIES", "AIOS_TPU_FAILOVER_BACKOFF_MS")
FAILOVER_PROMPT = "Failover drill: summarize the incident timeline, step by step. " * 6


def _knobs(**env) -> None:
    """Set the serving knobs that the next LoadModel reads (``ServingConfig``
    is read once per load), every other one unset."""
    for k in SERVING_KNOBS:
        os.environ.pop(k, None)
    for k, v in env.items():
        os.environ[k] = str(v)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _pool_counters(m) -> dict:
    keys = ("prefills", "prefill_chunks", "decode_steps", "graph_replays", "graph_captures")
    out = dict.fromkeys(keys, 0)
    for r in m.pool.replicas:
        st = r.engine.stats()
        for k in keys:
            out[k] += st[k]
    return out


def _pool_window(m, fn, what: str):
    """``fn()`` with every kernel count set to 0 just before and read just
    after, the replicas' dispatches summed: the launches must be exactly
    89 K1 per prefill, chunk and step, 22 K2 per prefill, 22 K6 per chunk and
    22 K3 per step, one graph replay per dispatch and no capture. Returns
    (fn's result, launches, dispatches)."""
    c0 = _pool_counters(m)
    _reset_counts()
    out = fn()
    launches = _read_counts()
    d = {k: v - c0[k] for k, v in _pool_counters(m).items()}
    pre, chunks, steps = d["prefills"], d["prefill_chunks"], d["decode_steps"]
    want = {"quantized_matmul": 89 * (pre + chunks + steps), "flash_attention": 22 * pre,
            "paged_decode_attention": 22 * steps, "multiquery_decode_attention": 22 * chunks}
    want = {k: v for k, v in want.items() if v}
    expect(launches == want, f"[serving] {what}: launches {launches} != {want} for {pre} "
           f"prefills, {chunks} chunks, {steps} steps over {len(m.pool.replicas)} replicas")
    expect(d["graph_captures"] == 0 and d["graph_replays"] == pre + chunks + steps,
           f"[serving] {what}: {d['graph_replays']} replays, {d['graph_captures']} captures "
           f"for {pre + chunks + steps} dispatches")
    return out, launches, d


class _Recorded:
    """A served handle whose tokens and their arrival times are kept."""

    def __init__(self, handle) -> None:
        self.handle, self.tokens, self.times = handle, [], []

    def __iter__(self):
        for t in self.handle:
            self.times.append(time.perf_counter())
            self.tokens.append(t)
            yield t

    def __getattr__(self, name):
        return getattr(self.handle, name)


@contextlib.contextmanager
def _recording(m):
    """Keep every handle ``m.submit`` hands the service while inside."""
    got = []
    submit = m.submit

    def recorded(req, **kw):
        got.append(_Recorded(submit(req, **kw)))
        return got[-1]

    m.submit = recorded
    try:
        yield got
    finally:
        del m.submit


def _wave(m, n: int, tag: str) -> tuple:
    """``n`` requests of 129 tokens through the pool at once (8 slots a
    replica): (tokens, wall s, decode steps summed over replicas)."""
    from aios_tpu_torch.engine.batching import Request

    steps0 = _pool_counters(m)["decode_steps"]
    t0 = time.perf_counter()
    hs = [m.submit(Request(prompt_ids=[256] + list(range(100 + i % 8)), max_tokens=129,
                           temperature=0.7, request_id=f"{tag}-{i}"), tenant=f"wave-{i}")
          for i in range(n)]
    tokens = sum(len(h.tokens()) for h in hs)
    wall = time.perf_counter() - t0
    expect(not any(h.aborted for h in hs) and tokens == 129 * n,
           f"[serving] {tag}: {tokens} tokens, aborted {[h.abort_reason for h in hs if h.aborted]}")
    return tokens, wall, _pool_counters(m)["decode_steps"] - steps0


def _stream(stub, prompt: str, max_tokens: int, temperature: float, **fields):
    from aios_tpu_torch.proto_gen import runtime_pb2

    return list(stub.StreamInfer(runtime_pb2.InferRequest(
        prompt=prompt, max_tokens=max_tokens, temperature=temperature, **fields), timeout=600))


def _routes(pool, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in pool._routed.items() if v - before.get(k, 0)}


def _serving_memory_and_swap(manager, stub, card: str) -> dict:
    """One replica, then a hot swap to two while a stream is live: the wave
    on one replica; the stream ends whole on the old pool; the new pool's
    replicas share one copy of the weights (equal data_ptrs) and its second
    replica adds its page pool and graph pool, not the weights; the old
    engines' bytes are released within 30 s, up to their admission graph
    pool's bytes."""
    from aios_tpu_torch import faults
    from aios_tpu_torch.engine import model as model_mod
    from aios_tpu_torch.proto_gen import runtime_pb2

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    _knobs(AIOS_TPU_REPLICAS=1)
    m1, load1 = _load(manager, stub, SERVING_MODEL, "synthetic://tinyllama-1.1b")
    one = torch.cuda.memory_allocated() - base
    tok1, wall1, steps1 = _wave(m1, 16, "wave1")
    log(f"[serving] 1 replica: LoadModel {load1:.2f} s, {one} B allocated; 16 x 129-token "
        f"wave {tok1} tokens in {wall1:.3f} s = {tok1 / wall1:.1f} tok/s, {steps1} decode "
        f"steps, {card}")

    # a stream live across the swap: a delay before each of its decode
    # dispatches (only batcher ticks sleep) keeps it decoding past the load
    old_pool, old_adm = m1.pool, m1.engine.admission_pool_bytes
    errors = []

    def live_stream():
        try:
            chunks.extend(_stream(stub, "Stream across the swap.", 1500, 0.5))
        except Exception as exc:  # noqa: BLE001 - re-raised on the main thread
            errors.append(exc)

    chunks = []
    faults.activate("dispatch.delay=prob:1.0,delay_ms=60")
    try:
        with _recording(m1) as got:
            t = threading.Thread(target=live_stream)
            t.start()
            t0 = time.perf_counter()
            while not (got and got[0].tokens) and time.perf_counter() - t0 < 60:
                time.sleep(0.01)
            expect(bool(got and got[0].tokens), "[serving] the live stream never started")
            h = got[0]
            at_start = len(h.tokens)
            _knobs(AIOS_TPU_REPLICAS=2)
            torch.cuda.synchronize()
            before_swap = torch.cuda.memory_allocated()
            m2, load2 = _load(manager, stub, SERVING_MODEL, "synthetic://tinyllama-1.1b")
            two = torch.cuda.memory_allocated() - before_swap
            at_end, live_after = len(h.tokens), t.is_alive()
    finally:
        faults.deactivate()
    t.join(timeout=600)
    expect(not errors and not t.is_alive(), f"[serving] the live stream failed: {errors!r}")
    eos = m1.tokenizer.eos_id
    whole = (chunks and chunks[-1].done and not h.aborted
             and (len(h.tokens) == 1500 or h.tokens[-1] == eos))
    expect(m2 is not m1 and len(m2.pool.replicas) == 2 and whole and 0 < at_start < at_end
           and live_after,
           f"[serving] hot swap: stream whole {whole} ({len(h.tokens)} tokens, aborted "
           f"{h.aborted}), {at_start} tokens when LoadModel began, {at_end} when it returned, "
           f"live after it {live_after}")
    r0 = dict(m2.pool._routed)
    r = stub.Infer(runtime_pb2.InferRequest(prompt="after the swap", max_tokens=8), timeout=300)
    expect(r.tokens_used > 0 and sum(_routes(m2.pool, r0).values()) == 1,
           "[serving] the new pool did not serve the next request")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 30 and not old_pool._closed:
        time.sleep(0.05)
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    released = before_swap + two - after
    # what is left of the old model beside the new one: within its graph pool
    left = after - (base + two)
    expect(old_pool._closed and left <= old_adm,
           f"[serving] old pool closed {old_pool._closed}; {left} B of the old model left "
           f"after {time.perf_counter() - t0:.1f} s (its admission graph pool {old_adm} B)")
    log(f"[serving] hot swap to 2 replicas while a 1500-token stream was live (tokens "
        f"{at_start} at the LoadModel, {at_end} at its return, 60 ms before each dispatch): "
        f"LoadModel {load2:.2f} s, the stream ended whole ({len(h.tokens)} tokens), the new "
        f"pool served the next request, the old pool drained and released {released} B in "
        f"{time.perf_counter() - t0:.2f} s ({left} B left beside the new model, admission "
        f"graph pool {old_adm} B); {card}")

    # the two replicas: one copy of the weights, a pool and graph pool each
    e0, e1 = (r.engine for r in m2.pool.replicas)
    l0, l1 = dict(_leaves(e0.params)), dict(_leaves(e1.params))
    shared = l0.keys() == l1.keys() and all(l0[k].data_ptr() == l1[k].data_ptr() for k in l0)
    weights = sum(t.numel() * t.element_size() for t in l0.values())
    pool_b = sum(t.numel() * t.element_size() for t in (e1.k_pool, e1.v_pool))
    second = two - one
    # the second replica adds its page pool, its graphs' memory and a few
    # static buffers, never a copy of the weights
    room = pool_b + e1.admission_pool_bytes + e1.workspace_bytes() + (256 << 20)
    expect(shared and e0.k_pool.data_ptr() != e1.k_pool.data_ptr() and second < weights
           and second <= room,
           f"[serving] replicas share weights {shared}; the second replica added {second} B "
           f"against {weights} B of weights and {room} B of pool, graph pool and slack")
    log(f"[serving] 2 replicas share every one of {len(l0)} weight tensors (equal data_ptr, "
        f"{weights} B, {model_mod.serving_weight_bytes(e0.params)} B streamed a step): "
        f"1 replica {one} B, 2 replicas {two} B allocated, so the second replica adds {second} B "
        f"(its page pool {pool_b} B, admission graph pool {e1.admission_pool_bytes} B, split "
        f"workspace {e1.workspace_bytes()} B a stream); graph streams "
        f"{e0.graphs.stream.cuda_stream:#x} / {e1.graphs.stream.cuda_stream:#x}; budgeted "
        f"{int(m2.hbm_chip_bytes)} B; {card}")
    return dict(load1=load1, load2=load2, wave1=(tok1, wall1, steps1))


def _serving_routes(m, stub, card: str) -> dict:
    """A 1536-token preamble, then a second request sharing it: routed
    ``prefix`` to the replica that holds it and a prefix hit there; a new
    task id ``least_loaded``, the same again ``sticky``."""
    from aios_tpu_torch.engine.tokenizer import render_chat
    from aios_tpu_torch.proto_gen import runtime_pb2

    pool, tok, name = m.pool, m.tokenizer, m.config.name
    for r in pool.replicas:
        r.engine.prefix_index.clear()
    head = tok.encode(render_chat(name, "\x00")).index(0)
    preamble = ("Shared agent preamble: follow the plan, report status, never guess. "
                * 40)[:1536 - head]
    hits0 = [r.engine.prefix_index.hits for r in pool.replicas]
    r0 = dict(pool._routed)

    def prefix_pair():
        for tail in ("Tail A: list the failing services.", "Tail B: restart them in order."):
            stub.Infer(runtime_pb2.InferRequest(prompt=preamble + tail, max_tokens=4),
                       timeout=300)

    _, launches, _ = _pool_window(m, prefix_pair, "prefix routing")
    ids = tok.encode(render_chat(name, preamble + "Tail C"))
    holders = [r.idx for r in pool.replicas if r.overlap_rows(ids) >= 1536]
    hits = [r.engine.prefix_index.hits - h for r, h in zip(pool.replicas, hits0)]
    routed = _routes(pool, r0)
    expect(routed == {"least_loaded": 1, "prefix": 1} and len(holders) == 1
           and hits[holders[0]] == 1 and sum(hits) == 1,
           f"[serving] prefix routing: routed {routed}, holders {holders}, hits {hits}")
    r1 = dict(pool._routed)
    for _ in range(2):
        stub.Infer(runtime_pb2.InferRequest(prompt="status of task 7", max_tokens=4,
                                            task_id="serving-task-7"), timeout=300)
    sticky = _routes(pool, r1)
    expect(sticky == {"least_loaded": 1, "sticky": 1}, f"[serving] task routing: {sticky}")
    log(f"[serving] routing over gRPC, 2 replicas: a 1536-token preamble went least_loaded, "
        f"the request sharing it prefix to replica {holders[0]} (prefix hits by replica "
        f"{hits}); a new task id least_loaded, its repeat sticky; exact launches {launches}")
    return launches


def _serving_failover(m, stub, card: str) -> dict:
    """A greedy 64-token StreamInfer crossing an injected scheduler crash
    ends whole, with one respawn and one resumed failover; its agreement
    with the fault-free stream and the longest gap between tokens are
    printed."""
    from aios_tpu_torch import faults
    from aios_tpu_torch.obs import instruments as obs

    pool = m.pool
    resumed = obs.SERVING_FAILOVERS.labels(model=m.name, outcome="resumed")
    runs = {}
    for arm in ("fault-free", "crash"):
        for r in pool.replicas:  # both arms admit cold
            r.engine.prefix_index.clear()
        restarts0, resumed0 = pool.restarts, resumed.value

        def go():
            with _recording(m) as got:
                chunks = _stream(stub, FAILOVER_PROMPT, 64, GREEDY)
            return chunks, got[0]

        if arm == "crash":
            faults.activate("pool.scheduler_crash=nth:3")
        try:
            (chunks, h), launches, d = _pool_window(m, go, f"failover {arm}")
        finally:
            faults.deactivate()
        gaps = np.diff(h.times) * 1e3
        runs[arm] = dict(tokens=h.tokens, gap=float(gaps.max()), launches=launches, d=d,
                         restarts=pool.restarts - restarts0, resumed=resumed.value - resumed0,
                         whole=bool(chunks and chunks[-1].done and not h.aborted))
    free, crash = runs["fault-free"], runs["crash"]
    agree = float(np.mean([a == b for a, b in zip(free["tokens"], crash["tokens"])]))
    expect(crash["whole"] and len(crash["tokens"]) == 64 and crash["restarts"] == 1
           and crash["resumed"] == 1 and free["restarts"] == 0,
           f"[serving] failover: whole {crash['whole']}, {len(crash['tokens'])} tokens, "
           f"restarts {crash['restarts']}, resumed {crash['resumed']}")
    expect(crash["launches"].get("multiquery_decode_attention", 0) > 0,
           "[serving] the resumed prompt did not admit through the chunk path (K6)")
    log(f"[serving] failover: a greedy 64-token StreamInfer across an injected scheduler "
        f"crash ended whole (64 tokens, no abort, replica_restarts 1, failover resumed 1); "
        f"agreement with the fault-free stream {agree:.3f}; longest inter-token gap "
        f"{crash['gap']:.2f} ms against {free['gap']:.2f} ms fault-free; the resume re-admitted "
        f"through {crash['d']['prefill_chunks']} chunk(s), launches {crash['launches']}; {card}")
    return crash["launches"]


def _serving_sheds(manager, stub, card: str) -> None:
    """With AIOS_TPU_FAILOVER_RETRIES=0, a tenant quota, a queue bound of 1
    and an assumed rate: the crash surfaces UNAVAILABLE with retry-after-ms;
    an agent's second request RESOURCE_EXHAUSTED (quota) with a positive
    retry-after-ms; a burst sheds queue_full; a request under a 100 ms
    deadline behind a busy replica sheds deadline without taking a slot."""
    import grpc

    from aios_tpu_torch import faults
    from aios_tpu_torch.proto_gen import runtime_pb2

    stub.UnloadModel(runtime_pb2.UnloadModelRequest(model_name=SERVING_MODEL))
    _knobs(AIOS_TPU_REPLICAS=2, AIOS_TPU_FAILOVER_RETRIES=0, AIOS_TPU_TENANT_TOKENS_PER_SEC=1,
           AIOS_TPU_TENANT_BURST_TOKENS=2000, AIOS_TPU_MAX_QUEUE=1, AIOS_TPU_ASSUMED_TPS=1000)
    m, load_s = _load(manager, stub, SERVING_MODEL, "synthetic://tinyllama-1.1b")
    pool = m.pool
    expect((pool.cfg.failover_retries, pool.cfg.max_queue) == (0, 1), f"{pool.cfg}")

    def rpc_error(fn):
        try:
            fn()
        except grpc.RpcError as e:
            return e
        return None

    faults.activate("pool.scheduler_crash=nth:3")
    try:
        err = rpc_error(lambda: _stream(stub, FAILOVER_PROMPT, 64, GREEDY,
                                        requesting_agent="crash-agent"))
    finally:
        faults.deactivate()
    retry = int(dict(err.trailing_metadata() or ()).get("retry-after-ms", 0)) if err else 0
    expect(err is not None and err.code() == grpc.StatusCode.UNAVAILABLE and retry > 0,
           f"[serving] retries 0: {err and err.code()} retry-after-ms {retry}")
    log(f"[serving] AIOS_TPU_FAILOVER_RETRIES=0: the crash surfaced as UNAVAILABLE with "
        f"retry-after-ms {retry} ({err.details()!r})")

    quota = [rpc_error(lambda: stub.Infer(runtime_pb2.InferRequest(
        prompt="Q" * 1400, max_tokens=8, requesting_agent="quota-agent"), timeout=300))
        for _ in range(2)]
    qretry = int(dict(quota[1].trailing_metadata() or ()).get("retry-after-ms", 0)) \
        if quota[1] else 0
    expect(quota[0] is None and quota[1] is not None
           and quota[1].code() == grpc.StatusCode.RESOURCE_EXHAUSTED and qretry > 0
           and "quota" in quota[1].details(),
           f"[serving] quota: {[q and (q.code(), q.details()) for q in quota]}")

    shed0 = dict(pool._shed)
    codes = []

    def burst(i):
        e = rpc_error(lambda: stub.Infer(runtime_pb2.InferRequest(
            prompt=f"burst request {i}", max_tokens=32, requesting_agent=f"burst-{i}"),
            timeout=300))
        codes.append("OK" if e is None else f"{e.code().name}:{e.details().split(':')[0]}")

    threads = [threading.Thread(target=burst, args=(i,)) for i in range(48)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    full = codes.count("RESOURCE_EXHAUSTED:request shed (queue_full)")
    expect(len(codes) == 48 and full >= 1 and codes.count("OK") + full == 48
           and pool._shed["queue_full"] - shed0["queue_full"] == full,
           f"[serving] burst of 48 with AIOS_TPU_MAX_QUEUE=1: {sorted(set(codes))}")

    time.sleep(1.2)  # a rate window closes on every replica
    busy = threading.Thread(target=lambda: _stream(stub, "Busy stream.", 600, 0.7,
                                                   requesting_agent="busy-agent"))
    busy.start()
    time.sleep(0.3)
    held = sum(r.batcher.active_count + r.queue_depth() for r in pool.replicas)
    deadline0 = pool._shed["deadline"]
    t0 = time.perf_counter()
    err = rpc_error(lambda: stub.Infer(runtime_pb2.InferRequest(
        prompt="late request", max_tokens=1024, requesting_agent="deadline-agent"), timeout=0.1))
    shed_ms = (time.perf_counter() - t0) * 1e3
    held_after = sum(r.batcher.active_count + r.queue_depth() for r in pool.replicas)
    rates = [round(r.tokens_per_second(), 1) for r in pool.replicas]
    busy.join(timeout=300)
    # the shed is the server's verdict; the client's own 100 ms timer may
    # read it as DEADLINE_EXCEEDED first
    codes_ok = err is not None and (
        (err.code() == grpc.StatusCode.RESOURCE_EXHAUSTED and "deadline" in err.details())
        or err.code() == grpc.StatusCode.DEADLINE_EXCEEDED)
    expect(codes_ok and pool._shed["deadline"] == deadline0 + 1 and held_after == held == 1,
           f"[serving] deadline: {err and (err.code(), err.details())}, slots+queue {held} -> "
           f"{held_after}")
    log(f"[serving] LoadModel {load_s:.2f} s with quota 1 tok/s (burst 2000), queue bound 1; "
        f"an agent's second 1400-byte request: RESOURCE_EXHAUSTED (quota), retry-after-ms "
        f"{qretry}; a burst of 48: {codes.count('OK')} served, {full} shed queue_full; a "
        f"100 ms deadline behind a busy replica shed deadline ({err.code().name}) in "
        f"{shed_ms:.1f} ms without a slot (observed rates {rates} tok/s); {card}")


def phase_serving(card: str) -> dict:
    """The serving front door on TinyLlama-1.1B at full width (int8 weights,
    bf16 pool ``auto``, 8 slots a replica) with two replicas, through gRPC:
    the replicas' shared weights and memory, a hot swap, each replica's
    replays against its eager body, prefix / least-loaded / sticky routing,
    exact launches with both replicas busy, the recorder's cost, failover,
    and the three sheds. Returns the served windows' launches."""
    from aios_tpu_torch import rpc, services
    from aios_tpu_torch.obs import flightrec
    from aios_tpu_torch.runtime.model_manager import ModelManager
    from aios_tpu_torch.runtime.service import serve

    manager = ModelManager(num_slots=8, quantize="int8", kv_cache="bf16")
    server, _, port = serve("127.0.0.1:0", manager, block=False)
    channel = rpc.insecure_channel(f"127.0.0.1:{port}")
    stub = services.AIRuntimeStub(channel)
    served = {}

    def add(launches):
        for k, v in launches.items():
            served[k] = served.get(k, 0) + v

    try:
        first = _serving_memory_and_swap(manager, stub, card)
        m = manager.get(SERVING_MODEL)
        expect(len(m.pool.replicas) == 2, "two replicas expected")
        streams = set()
        probe = threading.Thread(
            target=lambda: streams.add(torch.cuda.current_stream().cuda_stream))
        probe.start()
        probe.join()
        log(f"[serving] every batcher thread replays on its current stream, the legacy "
            f"default stream ({sorted(streams)}): the replicas' work is ordered one after "
            f"another on the device, each graph with its own split workspace")
        for r in m.pool.replicas:
            _graph_vs_eager(f"[serving replica {r.idx}]", r.engine,
                            {"quantized_matmul": 89, "paged_decode_attention": 22},
                            rounds=False)
        add(_serving_routes(m, stub, card))
        (tok2, wall2, steps2), launches, d = _pool_window(m, lambda: _wave(m, 16, "wave2"),
                                                          "16 x 129 wave on 2 replicas")
        add(launches)
        tok1, wall1, steps1 = first["wave1"]
        log(f"[serving] 16 x 129-token wave: 1 replica {tok1 / wall1:.1f} tok/s ({wall1:.3f} s, "
            f"{steps1} steps), 2 replicas {tok2 / wall2:.1f} tok/s ({wall2:.3f} s, {steps2} "
            f"steps summed, {d['prefills']} prefills); launches exact with both replicas busy: "
            f"{launches}; LoadModel 1 replica {first['load1']:.2f} s, 2 replicas "
            f"{first['load2']:.2f} s; {card}")
        cost = {}
        for enabled in (True, False, True, False):
            flightrec.RECORDER.enabled = enabled
            tok, wall, steps = _wave(m, 16, f"rec-{enabled}")
            cost.setdefault(enabled, []).append(wall / (steps / 2) * 1e3)
        flightrec.RECORDER.enabled = True
        log(f"[serving] host wall per replayed step (a 16 x 129 wave on 2 replicas, wall over "
            f"each replica's steps): recorder on {[round(x, 3) for x in cost[True]]} ms, off "
            f"{[round(x, 3) for x in cost[False]]} ms; {card}")
        add(_serving_failover(m, stub, card))
        _serving_sheds(manager, stub, card)
        for name in ("quantized_matmul", "flash_attention", "paged_decode_attention",
                     "multiquery_decode_attention"):
            expect(served.get(name, 0) > 0, f"[serving] kernel {name} never launched")
    finally:
        _knobs()
        manager.close()
        channel.close()
        server.stop(grace=None)
    torch.cuda.empty_cache()
    return served


# -- phase 14: speculation over the page pool and the draft-model rung ----------

SPEC_TINY, SPEC_MISTRAL = "tinyllama-spec", "mistral-draft"
# a draft-model round over 8 slots: the fused round's catch-up (the draft's
# verify_step without its lm_head: 4 weight matmuls a layer, K6 at T = 8),
# 7 draft steps (every layer's 4 and the lm_head, K8), the serving verify
DRAFT_STEPS = 7


class _Warnings(logging.Handler):
    """The WARNING records of the port's loggers while it is attached."""

    def __init__(self) -> None:
        super().__init__(logging.WARNING)
        self.lines = []

    def emit(self, record) -> None:
        self.lines.append(record.getMessage())


def _draft_round_launches(eng) -> dict:
    """The launches of one fused draft round on ``eng``: its wrappers and
    counts for the serving verify over the pool (K1 or K5 on its 4 weight
    matmuls a layer and the lm_head, K6 or K7 a layer) and the draft's
    catch-up and steps (K1 or K5, K6 and K8 a draft layer)."""
    cfg, dcfg = eng.cfg, eng.draft.cfg
    serve_mm = "int4_matmul" if eng.params["lm_head"].get("q4") is not None else "quantized_matmul"
    draft_mm = "int4_matmul" if eng.draft.quant_mode == "int4" else "quantized_matmul"
    verify = ("multiquery_decode_attention_int8" if eng.quant_cache
              else "multiquery_decode_attention")
    want = {}
    for name, n in ((serve_mm, 4 * cfg.num_layers + 1),
                    (draft_mm, 4 * dcfg.num_layers + DRAFT_STEPS * (4 * dcfg.num_layers + 1)),
                    (verify, cfg.num_layers),
                    ("multiquery_decode_attention", dcfg.num_layers),
                    ("decode_attention", DRAFT_STEPS * dcfg.num_layers)):
        want[name] = want.get(name, 0) + n
    return want


def _spec_prompts(n: int = 8, base: int = 300):
    return [[256] + [(i * 13 + 7 * s) % 250 + 1 for i in range(base + 7 * s)]
            for s in range(n)]


def _round_cost(tag: str, eng, card: str, draft: bool = False) -> dict:
    """Host wall and device busy of one paged round (``spec_step``, draft
    length 7, n-gram 3, or with ``draft`` the fused draft round) against one
    plain step, 8 greedy slots at ~300 rows, each timed from one state."""
    for s, p in enumerate(_spec_prompts()):
        eng.prefill(s, p, temperature=0.0)
    if draft:
        eng._draft_catchup(DRAFT_STEPS + 1, eager=False)
    snap = _snapshot(eng)
    fns = {"step": lambda: eng.step(1),
           "round": (lambda: eng.spec_step_draft(1)) if draft else (lambda: eng.spec_step(1))}
    out = {k: (_wall(fn, snap, eng), _busy(fn, snap, eng)) for k, fn in fns.items()}
    for s in range(eng.num_slots):
        eng.release(s)
    (ws, bs), (wr, br) = out["step"], out["round"]
    log(f"{tag} 8 greedy slots at ~300 rows, from one state each time: a plain step "
        f"{ws:.3f} ms host wall, {bs:.3f} ms device busy; a {'draft' if draft else 'n-gram'} "
        f"round {wr:.3f} ms wall, {br:.3f} ms busy ({wr / ws:.2f}x / {br / bs:.2f}x the step); "
        f"{card}")
    return out


def _ingest_vs_eager(tag: str, eng) -> None:
    """Each ingest width's replay against its eager body from one state (8
    greedy slots whose draft cache is empty): the draft lengths and every
    draft cache byte identical, the launches exact both ways (the draft's
    verify_step without its lm_head)."""
    dcfg = eng.draft.cfg
    mm = "int4_matmul" if eng.draft.quant_mode == "int4" else "quantized_matmul"
    want = {mm: 4 * dcfg.num_layers, "multiquery_decode_attention": dcfg.num_layers}
    d = eng.draft_state
    for w in eng._draft_ingest_buckets():
        saved = d["lengths"].clone()
        runs = {}
        for mode in ("graph", "eager"):
            d["lengths"].copy_(saved)
            _reset_counts()
            with eng._lock:
                eng._dispatcher(("draft_ingest", w),
                                functools.partial(eng._draft_ingest_body, w),
                                eager=mode == "eager", pool=eng._draft_pool)()
            runs[mode] = (d["lengths"].clone(), d["k"].clone(), d["v"].clone(), _read_counts())
        (gl, gk, gv, gn), (el, ek, ev, en) = runs["graph"], runs["eager"]
        expect(torch.equal(gl, el) and torch.equal(gk, ek) and torch.equal(gv, ev),
               f"{tag} ingest {w}: replay and eager body differ")
        expect(gn == want and en == want, f"{tag} ingest {w} launches: graph {gn}, eager "
               f"{en}, want {want}")
        expect(int(gl.min()) == min(w, int(eng.lengths.min())), f"{tag} ingest {w}: draft "
               f"lengths {gl.tolist()}")
        d["lengths"].copy_(saved)
        del runs
    log(f"{tag} each ingest width {eng._draft_ingest_buckets()} (B = {eng.num_slots}): "
        f"replay vs eager body, draft lengths and every draft cache byte identical, "
        f"launches exact both ways ({want} each)")


def _draft_round_vs_eager(tag: str, eng, rounds: int = 4) -> None:
    """The fused draft round's replay against its eager body from one
    caught-up state: tokens, counts, proposed and the draft lengths equal,
    the last round's logits bit-identical, the launches exact both ways."""
    eng._draft_catchup(DRAFT_STEPS + 1, eager=False)
    snap = _snapshot(eng)
    per = _draft_round_launches(eng)
    runs = {}
    for mode, fn in (("graph", eng.spec_step_draft), ("eager", eng.spec_step_draft_eager)):
        _restore(eng, snap)
        _reset_counts()
        out = fn(rounds)
        runs[mode] = (out, eng.last_logits.clone(), eng.draft_state["lengths"].clone(),
                      _read_counts())
    (g_out, g_logits, g_dl, g_n), (e_out, e_logits, e_dl, e_n) = runs["graph"], runs["eager"]
    want = {k: v * rounds for k, v in per.items()}
    expect(all((a == b).all() for a, b in zip(g_out, e_out)) and torch.equal(g_dl, e_dl),
           f"{tag} draft round: replay and eager tokens, counts or draft lengths differ")
    expect(torch.equal(g_logits, e_logits), f"{tag} draft round logits differ: max |d| "
           f"{(g_logits - e_logits).abs().max().item():.3e}")
    expect(g_n == want and e_n == want, f"{tag} draft round launches: graph {g_n}, eager "
           f"{e_n}, want {want}")
    log(f"{tag} fused draft round, replay vs eager body, 8 greedy slots, {rounds} rounds: "
        f"tokens, counts, proposed and draft lengths identical, logits of the last round "
        f"bit-identical, launches exact both ways ({per} a round); tokens a round "
        f"{g_out[1][:, :].mean():.2f}")


def _self_draft(tag: str, m, card: str) -> dict:
    """(b) TinyLlama paged with ``DraftModel(cfg, the same params, "int8")``:
    each ingest width and the fused round against their eager twins, then 8
    greedy 129-token requests through a speculative batcher (the draft
    rung) and a plain one on the same engine: acceptance >= 0.5, tokens a
    round, the streams' agreement, dispatches both ways."""
    from aios_tpu_torch.engine.batching import ContinuousBatcher, Request
    from aios_tpu_torch.engine.engine import TorchEngine
    from aios_tpu_torch.engine.spec import DraftModel

    cfg, params = m.config, m.engine.params
    draft = DraftModel(cfg, params, quantize="int8")
    expect(draft.params is params and draft.quant_mode == "int8",
           f"{tag} the draft must hold the serving int8 leaves")
    t0 = time.perf_counter()
    eng = TorchEngine(cfg, params, paged_pool_rows=9 * cfg.max_context, page_size=128,
                      num_slots=8, max_context=cfg.max_context, cache_dtype=torch.bfloat16,
                      prefix_cache=False, draft=draft)
    try:
        eng.warmup(prefill_chunk=0)
        log(f"{tag} engine over the serving leaves with the int8 self-draft: "
            f"{eng.graphs.captures} graphs in {time.perf_counter() - t0:.2f} s "
            f"({eng.draft_graphs()} of the draft, ingest pool {eng.draft_pool_bytes} B); "
            f"draft cache {sum(eng.draft_state[k].numel() * 2 for k in ('k', 'v'))} B")
        for s, p in enumerate(_spec_prompts()):
            eng.prefill(s, p, temperature=0.0)
        _ingest_vs_eager(tag, eng)
        _draft_round_vs_eager(tag, eng)
        for s in range(eng.num_slots):
            eng.release(s)
        cost = _round_cost(tag, eng, card, draft=True)
        prompts = _spec_prompts(base=100)

        def wave(speculative: bool):
            b = ContinuousBatcher(eng, speculative=speculative, prefill_chunk=0)
            st0 = eng.stats()
            t = time.perf_counter()
            try:
                hs = [b.submit(Request(prompt_ids=p, max_tokens=129, temperature=0.0))
                      for p in prompts]
                outs = [h.tokens() for h in hs]
            finally:
                b.shutdown()
            wall = time.perf_counter() - t
            st = eng.stats()
            expect(b.last_error is None and all(len(o) == 129 for o in outs),
                   f"{tag} wave: {[len(o) for o in outs]} tokens, {b.last_error!r}")
            return outs, wall, {k: st.get(k, 0) - st0.get(k, 0) for k in st}, b

        plain, wall_p, d_p, _ = wave(False)
        drafted, wall_d, d_d, b = wave(True)
        expect(b.spec_proposers == ("draft", "ngram"), f"{tag} ladder {b.spec_proposers}")
        proposed, accepted = d_d["draft_proposed_tokens"], d_d["spec_draft_accepted"]
        acceptance = accepted / max(proposed, 1)
        expect(proposed > 0 and acceptance >= 0.5,
               f"{tag} the self-draft accepted {accepted} of {proposed} proposed tokens")
        agree = [next((i for i, (a, c) in enumerate(zip(x, y)) if a != c), len(x)) / len(x)
                 for x, y in zip(plain, drafted)]
        slot_rounds = eng.spec_slot_rounds  # cumulative; the wave's own below
        log(f"{tag} 8 x 129 greedy tokens: plain {d_p['decode_steps']} step replays in "
            f"{wall_p:.3f} s ({8 * 129 / wall_p:.1f} tok/s); with the draft "
            f"{d_d['decode_steps']} round replays + {d_d['draft_ingest_dispatches']} ingest "
            f"replays in {wall_d:.3f} s ({8 * 129 / wall_d:.1f} tok/s); draft acceptance "
            f"{acceptance:.3f} ({accepted} of {proposed}); engine tokens a round "
            f"{eng.stats()['spec_tokens_per_round']} over {slot_rounds} slot-rounds; greedy "
            f"streams agree with the plain path over {[round(a, 3) for a in agree]} of "
            f"their length (first divergence / 129); {card}")
        return dict(cost=cost, acceptance=acceptance)
    finally:
        eng.close()


def _backing_and_trim(tag: str, eng) -> None:
    """A 4340-token greedy prompt on Mistral-7B (34 blocks), then 4 rounds
    of draft length 7: before the dispatch every active slot's next 32 rows
    are backed (a 35th block, whatever the rounds accept), and the blocks
    wholly below the 4096-row window go back to the pool first."""
    P, W = eng.allocator.page_size, eng.cfg.sliding_window
    ids = [256] + [(i * 7) % 250 + 1 for i in range(4339)]
    eng.prefill(0, ids, temperature=0.0)
    n0, trimmed0, free0 = eng.slot_length(0), eng.kv_pages_trimmed, eng.allocator.free_pages
    tokens, counts = eng.spec_step(4)
    blocks = eng.allocator.blocks_for(min(n0 + 4 * (DRAFT_STEPS + 1), eng.max_context))
    dead = (n0 - W) // P
    expect(eng.allocator._blocks_used[0] == blocks,
           f"{tag} {eng.allocator._blocks_used[0]} blocks backed, want {blocks}")
    expect(eng.allocator._trimmed[0] == dead and eng.kv_pages_trimmed - trimmed0 == dead > 0,
           f"{tag} trimmed {eng.allocator._trimmed[0]} blocks, want {dead}")
    expect(eng.slot_length(0) == n0 + int(counts[:, 0].sum()), f"{tag} lengths")
    eng.release(0)
    log(f"{tag} a {n0}-row slot, 4 rounds: {blocks} blocks backed before the dispatch "
        f"(its rows + 4 x 8), {dead} blocks below the {W}-row window returned first "
        f"({free0} free pages before, {eng.allocator.free_pages} after the release)")


def _spec_tiny(card: str) -> None:
    """(a), (b) and (d) on TinyLlama-1.1B paged (int8 weights, bf16 pool,
    8 slots, speculative): the vocabulary mismatch of a 128,256-vocab
    draft, the paged round against its eager body and its cost, and the
    self-draft."""
    from aios_tpu_torch.engine.batching import Request
    from aios_tpu_torch.runtime.model_manager import ModelManager

    manager = ModelManager(num_slots=8, quantize="int8", kv_cache="bf16", speculative=True)
    warned = _Warnings()
    logging.getLogger("aios.torch").addHandler(warned)
    os.environ["AIOS_TPU_DRAFT_MODEL"] = "deepseek"
    try:
        t0 = time.perf_counter()
        m = manager.load_model(SPEC_TINY, "synthetic://tinyllama-1.1b")
        load_s = time.perf_counter() - t0
    finally:
        os.environ.pop("AIOS_TPU_DRAFT_MODEL")
        logging.getLogger("aios.torch").removeHandler(warned)
    try:
        eng = m.engine
        mismatch = [x for x in warned.lines if "does not match the serving vocab" in x]
        expect(mismatch and eng.draft is None and m.batcher.spec_proposers == ("ngram",)
               and m.batcher.speculative and eng.paged,
               f"[spec tinyllama] a 128,256-vocab draft: warnings {warned.lines}, "
               f"proposers {m.batcher.spec_proposers}")
        expect(eng.graphs.captures == _planned_graphs(m), f"[spec tinyllama] "
               f"{eng.graphs.captures} graphs, planned {_planned_graphs(m)}")
        h = m.submit(Request(prompt_ids=_spec_prompts(1)[0], max_tokens=32, temperature=0.0))
        expect(len(h.tokens()) == 32 and eng.stats().get("spec_ngram_rounds", 0) > 0,
               "[spec tinyllama] the n-gram rung did not serve")
        log(f"[spec tinyllama] AIOS_TPU_DRAFT_MODEL=deepseek: \"{mismatch[0]}\"; served "
            f"with the n-gram rung over the pool ({eng.stats()['spec_ngram_rounds']} rounds); "
            f"LoadModel {load_s:.2f} s, {eng.graphs.captures} graphs (the paged round among "
            f"them)")
        _graph_vs_eager("[spec tinyllama]", eng,
                        {"quantized_matmul": 89, "multiquery_decode_attention": 22},
                        rounds=True)
        _round_cost("[spec tinyllama]", eng, card)
        _self_draft("[spec self-draft]", m, card)
    finally:
        manager.close()
    torch.cuda.empty_cache()


def _spec_mistral(card: str) -> dict:
    """(c) Mistral-7B paged (int4 weights, int8 pool, window 4096) with
    ``AIOS_TPU_DRAFT_MODEL=tinyllama`` through LoadModel and gRPC, then (a)
    on the same engine: the n-gram round against its eager body, its cost,
    the backing and trim; and the draft round's cost. Returns the served
    launches (3 Infer + 1 StreamInfer, and an 8-request greedy wave)."""
    from aios_tpu_torch import rpc, services
    from aios_tpu_torch.engine.batching import Request
    from aios_tpu_torch.proto_gen import common_pb2
    from aios_tpu_torch.runtime import model_manager as mm
    from aios_tpu_torch.runtime.service import serve

    manager = mm.ModelManager(num_slots=8, quantize="int4", kv_cache="int8")
    server, _, port = serve("127.0.0.1:0", manager, block=False)
    channel = rpc.insecure_channel(f"127.0.0.1:{port}")
    stub = services.AIRuntimeStub(channel)
    os.environ["AIOS_TPU_DRAFT_MODEL"] = "tinyllama"
    try:
        try:
            m, load_s = _load(manager, stub, SPEC_MISTRAL, "synthetic://mistral-7b", 8192)
        finally:
            os.environ.pop("AIOS_TPU_DRAFT_MODEL")
        eng = m.engine
        draft = eng.draft
        expect(draft is not None and draft.cfg.name == "tinyllama-1.1b"
               and draft.quant_mode == "int4" and m.batcher.speculative
               and m.batcher.spec_proposers == ("draft", "ngram"),
               f"[spec mistral] the tinyllama draft did not pair: {draft}")
        cache = sum(eng.draft_state[k].numel() * eng.draft_state[k].element_size()
                    for k in ("k", "v"))
        expect(cache == 1_476_395_008, f"[spec mistral] draft cache {cache} B")
        expect(m.draft_chip_bytes == draft.weight_bytes() + cache
               and m.hbm_chip_bytes >= m.draft_chip_bytes + eng.draft_pool_bytes
               + eng.admission_pool_bytes,
               f"[spec mistral] budget {m.hbm_chip_bytes} B, draft {m.draft_chip_bytes} B")
        log(f"[spec mistral] LoadModel with AIOS_TPU_DRAFT_MODEL=tinyllama ready in "
            f"{load_s:.2f} s: {eng.graphs.captures} graphs ({eng.draft_graphs()} of the draft, "
            f"ingest pool {eng.draft_pool_bytes} B); budgeted {int(m.hbm_chip_bytes)} B, of "
            f"which the draft {int(m.draft_chip_bytes)} B = int4 weights "
            f"{draft.weight_bytes()} B + cache {cache} B (22 layers x K and V x 8 slots x "
            f"8192 rows x 4 heads x 64 x 2 B); {card}")
        served = {}

        def add(launches):
            for k, v in launches.items():
                served[k] = served.get(k, 0) + v

        add(_served_window(manager, stub, m, card, " with the tinyllama draft")["launches"])
        health = stub.HealthCheck(common_pb2.Empty()).details.get(m.name + ".serving", "")
        fields = dict(kv.split("=", 1) for kv in health.split(","))
        expect("draft_proposed_tokens" in fields and "draft_ingest_dispatches" in fields
               and int(fields["graph_captures"]) == _planned_graphs(m),
               f"[spec mistral] HealthCheck: {health}")
        st0 = eng.stats()
        _reset_counts()
        t0 = time.perf_counter()
        hs = [m.submit(Request(prompt_ids=p, max_tokens=129, temperature=1e-5))
              for p in _spec_prompts(base=100)]
        outs = [h.tokens() for h in hs]
        wall = time.perf_counter() - t0
        launches = _read_counts()
        add(launches)
        st = eng.stats()
        d = {k: st.get(k, 0) - st0.get(k, 0) for k in st}
        expect(all(len(o) == 129 for o in outs) and d["spec_draft_rounds"] > 0
               and d["draft_ingest_dispatches"] > 0,
               f"[spec mistral] greedy wave: {[len(o) for o in outs]}, {d}")
        for k in ("int4_matmul", "multiquery_decode_attention",
                  "multiquery_decode_attention_int8", "decode_attention"):
            expect(launches.get(k, 0) > 0, f"[spec mistral] {k} never launched in the wave")
        log(f"[spec mistral] 8 greedy requests x 129 tokens through the draft rung in "
            f"{wall:.3f} s ({8 * 129 / wall:.1f} tok/s): {d['spec_draft_rounds']} draft "
            f"rounds, {d['draft_ingest_dispatches']} ingests, acceptance "
            f"{d['spec_draft_accepted']} of {d['draft_proposed_tokens']} proposed; launches "
            f"{launches}; {card}")
        _graph_vs_eager("[spec mistral]", eng,
                        {"int4_matmul": 129, "multiquery_decode_attention_int8": 32},
                        rounds=True)
        _round_cost("[spec mistral]", eng, card)
        _round_cost("[spec mistral]", eng, card, draft=True)
        _backing_and_trim("[spec mistral]", eng)
    finally:
        manager.close()
        channel.close()
        server.stop(grace=None)
    torch.cuda.empty_cache()
    return served


def phase_spec_paged(card: str) -> dict:
    """Speculation over the page pool and the draft-model rung (phase 14).
    Returns the served launches of Mistral-7B with its draft."""
    t0 = time.perf_counter()
    _spec_tiny(card)
    served = _spec_mistral(card)
    log(f"[spec] phase done in {time.perf_counter() - t0:.1f} s")
    return served


# -- phase 15: the prefix cache's host tier ---------------------------------------

HOST_TIER_BYTES = 2 << 30  # AIOS_TPU_PREFIX_HOST_BYTES for the phase
HOST_POOL_ROWS = 16384  # AIOS_TPU_PAGED_KV: 128 pages, so that a spill takes few admissions
HOST_PRESSURE = 4000  # rows of a distinct prompt (under Mistral's window and the context)


def _kernel_plan(eng, d: dict) -> dict:
    """The launches ``d`` (deltas of prefills, prefill_chunks, decode_steps)
    make on ``eng``: every projection and the lm_head per forward; K2 per
    layer a prefill, K6/K7 a chunk, K3/K4 a step."""
    L = eng.cfg.num_layers
    mm = "int4_matmul" if "q4" in eng.params["lm_head"] else "quantized_matmul"
    q = eng.quant_cache
    out = {mm: (4 * L + 1) * (d["prefills"] + d["prefill_chunks"] + d["decode_steps"]),
           "flash_attention": L * d["prefills"],
           "multiquery_decode_attention_int8" if q else "multiquery_decode_attention":
           L * d["prefill_chunks"],
           "paged_decode_attention_int8" if q else "paged_decode_attention":
           L * d["decode_steps"]}
    return {k: v for k, v in out.items() if v}


def _link_gbps(nbytes: int):
    """(host-to-device, device-to-host) GB/s of one pinned copy of ``nbytes``
    (CUDA events, the median of 5)."""
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    out = []
    for src, dst in ((host, dev), (dev, host)):
        ms = []
        for _ in range(6):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            dst.copy_(src, non_blocking=True)
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
        out.append(nbytes / (statistics.median(ms[1:]) * 1e-3) / 1e9)
    return tuple(out)


def _host_tier_model(tag: str, m, card: str) -> dict:
    """The host tier on one model: a 1536-row preamble's prompt cold, as a
    pool hit, then restored from the host after distinct prompts pushed
    its 12 pages out (TTFT of each through the batcher; on the engine the
    restored pages against the spilled bytes and the first-token logits and
    greedy stream against the hit's, bit for bit); each fault point ending
    in a counted recompute with the cold stream; the chain exported,
    through KVX1 and restored on a second engine. Returns the launches of
    the batcher's runs."""
    from aios_tpu_torch import faults
    from aios_tpu_torch.engine import paged
    from aios_tpu_torch.engine.batching import Request
    from aios_tpu_torch.engine.engine import HOST_ENTRY_KEYS, TorchEngine
    from aios_tpu_torch.engine.tokenizer import render_chat

    eng, tok, cfg = m.engine, m.tokenizer, m.config
    st, P = eng.host_store, eng.allocator.page_size
    expect(st is not None and st.max_bytes == HOST_TIER_BYTES,
           f"{tag} no host store of {HOST_TIER_BYTES} B")
    head = tok.encode(render_chat(cfg.name, "\x00")).index(0)
    shared = 12 * P
    preamble = ("Shared agent preamble: follow the plan, report status, never guess. "
                * 40)[:shared - head]
    ids = tok.encode(render_chat(cfg.name, preamble + "Tail B: restart them in order."))
    chain = eng.prefix_hashes(ids)
    expect(len(chain) == 12, f"{tag} {len(ids)}-token prompt: {len(chain)} full blocks")
    gen = torch.Generator().manual_seed(15)
    pressure_len = min(HOST_PRESSURE, eng.max_context - 48)

    def drain():
        t0 = time.perf_counter()
        while eng.spill_backlog() and time.perf_counter() - t0 < 60:
            time.sleep(0.005)
        expect(eng.spill_backlog() == 0, f"{tag} the spill worker did not drain")

    def spill():
        """Distinct prompts until the preamble's chain has left the pool,
        the worker drained after each (so that no spill meets a full
        backlog)."""
        n, t0 = 0, time.perf_counter()
        while eng.prefix_index.peek(chain) and n < 40:
            p = [256] + torch.randint(0, 256, (pressure_len - 1,), generator=gen).tolist()
            eng.prefill(0, p, temperature=0.0)
            eng.release(0)
            drain()
            n += 1
        expect(eng.prefix_index.peek(chain) == 0 and st.peek_chain(chain) == 12,
               f"{tag} after {n} prompts: {eng.prefix_index.peek(chain)} blocks in the pool, "
               f"{st.peek_chain(chain)} on the host")
        return n, time.perf_counter() - t0

    def admit(other=None, eager=False):
        """Admit ``ids`` on slot 0 at the batcher's chunk, then 8 greedy
        steps: (start row, first-token logits, stream, the slot's first 12
        pages as host arrays)."""
        e = other or eng
        pc = e.start_chunked_prefill(0, ids, temperature=0.0, chunk=e.prefill_chunk_default,
                                     eager=eager)
        start = pc.pos
        while pc.step() is None:
            pass
        stream = [pc.first_token] + (e.step_eager(8) if eager else e.step(8))[:, 0].tolist()
        pages = [int(p) for p in e.allocator.tables[0, :12]]
        with e._lock:
            copy = e._copy_pages(pages)
        host = copy.wait()
        e.release(0)
        return start, pc.first_logits, stream, host

    def ttft() -> float:
        h = m.batcher.submit(Request(prompt_ids=ids, max_tokens=2, temperature=0.0))
        h.tokens()
        return h.ttft_ms

    served = {}

    def counted_ttft() -> float:
        keys = ("prefills", "prefill_chunks", "decode_steps")
        s0 = eng.stats()
        out, launches = _counted(ttft)
        s1 = eng.stats()
        want = _kernel_plan(eng, {k: s1[k] - s0[k] for k in keys})
        expect(launches == want, f"{tag} launches {launches} != {want}")
        for k, v in launches.items():
            served[k] = served.get(k, 0) + v
        return out

    eng.prefix_index.clear()
    st.clear()
    _, cold_logits, cold_stream, _ = admit()
    t_cold = []
    for _ in range(3):
        eng.prefix_index.clear()
        t_cold.append(counted_ttft())
    t_hit = [counted_ttft() for _ in range(3)]
    reused0 = eng.prefix_rows_reused
    s_hit, hit_logits, hit_stream, _ = admit()
    expect(s_hit == shared and eng.prefix_rows_reused - reused0 == shared,
           f"{tag} the hit started at row {s_hit}")

    # spill: the preamble's pages leave the pool for the host
    spills0, timing0 = st.spills, dict(eng.spill_timing)
    n_press, t_press = spill()
    spilled = {h: {k: a.copy() for k, a in st._entries[h].items()} for h in chain}
    d = {k: eng.spill_timing[k] - timing0[k] for k in timing0}
    expect(st.spills - spills0 >= 12 and eng.spill_drops == 0,
           f"{tag} {st.spills - spills0} pages spilled, {eng.spill_drops} dropped")
    reused1, restored1 = eng.prefix_rows_reused, eng.prefix_rows_restored
    hs = (eng.host_probe_seconds, eng.host_staging_seconds, eng.host_restore_seconds)
    s_r, r_logits, r_stream, r_pages = admit()
    probe_ms, staging_ms, restore_wall = (
        (b - a) * 1e3 for a, b in zip(hs, (eng.host_probe_seconds, eng.host_staging_seconds,
                                           eng.host_restore_seconds)))
    e0, e1, e2 = eng.last_restore_events
    h2d_ms, scatter_ms = e0.elapsed_time(e1), e1.elapsed_time(e2)
    same_bytes = all(np.array_equal(r_pages[j][:, i], spilled[h][k])
                     for i, h in enumerate(chain) for j, k in enumerate(HOST_ENTRY_KEYS)
                     if k in spilled[h])
    expect(s_r == shared and eng.prefix_rows_restored - restored1 == shared
           and eng.prefix_rows_reused == reused1,
           f"{tag} restored from row {s_r}: {eng.prefix_rows_restored - restored1} rows "
           f"restored, {eng.prefix_rows_reused - reused1} reused")
    expect(same_bytes, f"{tag} the restored pages differ from the spilled bytes")
    expect(torch.equal(r_logits, hit_logits) and r_stream == hit_stream,
           f"{tag} restored vs hit: logits differ by "
           f"{(r_logits - hit_logits).abs().max().item():.3e}, streams {r_stream} / {hit_stream}")
    nbytes = 12 * eng.page_bytes()
    log(f"{tag} a {len(ids)}-token prompt's 1536-row preamble (12 pages, {nbytes} B) spilled "
        f"after {n_press} distinct {pressure_len}-token prompts ({t_press:.2f} s, the worker "
        f"drained after each) and restored: {shared} rows from the host tier, 0 from the pool; "
        f"the 12 pages equal the spilled bytes and the first-token logits and 9-token greedy "
        f"stream equal the pool hit's bit for bit; {card}")
    log(f"{tag} spill: gather {d['gather_ms'] / max(d['pages'], 1):.4f} ms a page, "
        f"device-to-host {d['d2h_ms'] / max(d['pages'], 1):.4f} ms a page "
        f"({d['bytes'] / max(d['d2h_ms'], 1e-9) / 1e6:.2f} GB/s), the worker's host copy "
        f"{d['copy_s'] * 1e3 / max(d['pages'], 1):.4f} ms a page over {d['pages']} pages; "
        f"peak spill staging {eng.spill_staging_peak} B (cap {eng.spill_cap_bytes} B); "
        f"restore of 12 pages: the probe (crc32 of each page) {probe_ms:.3f} ms, host wall "
        f"{restore_wall:.3f} ms (staging into pinned memory {staging_ms:.3f} ms, then the "
        f"issue), device {h2d_ms:.3f} ms host-to-device ({nbytes / (h2d_ms * 1e-3) / 1e9:.2f} "
        f"GB/s) + {scatter_ms:.3f} ms scatter; {card}")
    entries = list(spilled.values())
    crc_ms = []
    for threads in (1, paged.HOST_COPY_THREADS):
        was, paged.HOST_COPY_THREADS = paged.HOST_COPY_THREADS, threads
        t0 = time.perf_counter()
        paged.host_map(paged.HostPageStore._entry_crc, entries, nbytes)
        crc_ms.append((threads, (time.perf_counter() - t0) * 1e3))
        paged.HOST_COPY_THREADS = was
    log(f"{tag} crc32 of the 12 spilled pages on the host: " + ", ".join(
        f"{t} thread(s) {ms:.3f} ms" for t, ms in crc_ms))
    t_restored, parts = [], []
    for _ in range(3):
        spill()
        restored2 = eng.prefix_rows_restored
        hs = (eng.host_probe_seconds, eng.host_staging_seconds, eng.host_restore_seconds)
        t_restored.append(counted_ttft())
        parts.append(tuple(round((b - a) * 1e3, 3) for a, b in zip(
            hs, (eng.host_probe_seconds, eng.host_staging_seconds, eng.host_restore_seconds))))
        expect(eng.prefix_rows_restored - restored2 == shared, f"{tag} the batcher's run "
               f"restored {eng.prefix_rows_restored - restored2} rows")
    up, down = _link_gbps(nbytes)
    med = statistics.median
    log(f"{tag} TTFT through the batcher, a {len(ids)}-token prompt, the median of 3 (each "
        f"run): cold {med(t_cold):.2f} ms ({', '.join(f'{t:.2f}' for t in t_cold)}), pool hit "
        f"{med(t_hit):.2f} ms ({', '.join(f'{t:.2f}' for t in t_hit)}), restored from the "
        f"host {med(t_restored):.2f} ms ({', '.join(f'{t:.2f}' for t in t_restored)}; of "
        f"each the probe, the staging, the staging and issue: {parts} ms); a pinned "
        f"copy of the 12 pages' bytes: host-to-device {up:.2f} GB/s, device-to-host "
        f"{down:.2f} GB/s; host_tier_bytes {eng.stats()['host_tier_bytes']}; {card}")

    # the fault points: each a counted recompute with the cold stream
    for point in ("host_store.corrupt", "host_store.restore_fail"):
        spill()
        s0 = eng.stats()
        around = []
        restore = eng._restore_from_host

        def watched(*a, **kw):
            def obtainable():
                return eng.allocator.free_pages + eng.prefix_index.reclaimable()

            before = (eng.allocator.free_pages, obtainable())
            got = restore(*a, **kw)
            around.append((before, (eng.allocator.free_pages, obtainable()), len(got)))
            return got

        eng._restore_from_host = watched
        faults.activate(f"{point}=nth:1")
        try:
            s_f, f_logits, f_stream, _ = admit()
        finally:
            faults.deactivate()
            del eng._restore_from_host
        s1 = eng.stats()
        expect(s_f == 0 and f_stream == cold_stream,
               f"{tag} {point}: started at row {s_f}, stream {f_stream} vs cold {cold_stream}")
        if point == "host_store.corrupt":
            expect(s1["host_tier_corrupt"] - s0["host_tier_corrupt"] == 1 and not around,
                   f"{tag} corrupt: {s1['host_tier_corrupt'] - s0['host_tier_corrupt']} counted")
            what = "the chain truncated at its first page, 1 corruption counted"
        else:
            expect(len(around) == 1 and around[0][2] == 0 and around[0][0][1] == around[0][1][1]
                   and s1["host_tier_misses"] - s0["host_tier_misses"] == 1,
                   f"{tag} restore_fail: {around}")
            what = (f"the 12 pages given back (free pages {around[0][0][0]} -> "
                    f"{around[0][1][0]}, free or reclaimable {around[0][0][1]} -> "
                    f"{around[0][1][1]}), 1 miss counted")
        log(f"{tag} {point}: {what}; the recompute from row 0 gives the cold stream "
            f"(logits vs cold: max diff {(f_logits - cold_logits).abs().max().item():.3e})")

    # KVX1 across engines: export, pack, unpack, put, restore on a second engine
    exported = eng.export_prefix(ids)
    wire = [(h, paged.pack_entry(e)) for h, e in exported]
    other = TorchEngine(cfg, eng.params, paged_pool_rows=HOST_POOL_ROWS, page_size=P,
                        num_slots=eng.num_slots, max_context=eng.max_context,
                        cache_dtype=eng.k_pool.dtype, quantize=None, track_history=False,
                        prefix_host_bytes=HOST_TIER_BYTES)
    try:
        for h, payload in wire:
            other.host_store.put(h, paged.unpack_entry(payload))
        s_o, o_logits, o_stream, _ = admit(other, eager=True)
        expect(len(exported) == 12 and s_o == shared and other.prefix_rows_restored == shared
               and torch.equal(o_logits, hit_logits),
               f"{tag} KVX1: {len(exported)} entries, the second engine from row {s_o}, logits "
               f"vs the hit {(o_logits - hit_logits).abs().max().item():.3e}")
        log(f"{tag} KVX1: 12 pages exported ({sum(len(p) for _, p in wire)} B on the wire), "
            f"unpacked into a second engine's store and restored there ({shared} rows), its "
            f"first-token logits equal the first engine's pool hit bit for bit; prefix_digest "
            f"sizes: first engine {len(eng.prefix_digest())}, second "
            f"{len(other.prefix_digest())} (cap 256); {card}")
    finally:
        other.close()
    return {"served": served}


def phase_host_tier(card: str) -> dict:
    """TinyLlama-1.1B paged (int8 weights, bf16 pool) and Mistral-7B paged
    (int4 weights, int8 pool, window 4096) at full width, each loaded
    through LoadModel with ``AIOS_TPU_PREFIX_HOST_BYTES`` = 2 GiB and a pool
    of 128 pages, through ``_host_tier_model``. Returns the launches of the
    batcher's runs."""
    from aios_tpu_torch import rpc, services
    from aios_tpu_torch.runtime.model_manager import ModelManager
    from aios_tpu_torch.runtime.service import serve

    t0 = time.perf_counter()
    served = {}
    os.environ["AIOS_TPU_PREFIX_HOST_BYTES"] = str(HOST_TIER_BYTES)
    try:
        for name, path, kw in (("tinyllama-host", "synthetic://tinyllama-1.1b",
                                dict(quantize="int8", kv_cache="bf16")),
                               ("mistral-host", "synthetic://mistral-7b",
                                dict(quantize="int4", kv_cache="int8"))):
            manager = ModelManager(num_slots=8, paged_kv=HOST_POOL_ROWS, **kw)
            server, _, port = serve("127.0.0.1:0", manager, block=False)
            channel = rpc.insecure_channel(f"127.0.0.1:{port}")
            try:
                m, load_s = _load(manager, services.AIRuntimeStub(channel), name, path)
                log(f"[host {name}] LoadModel {load_s:.2f} s: {m.engine.allocator.num_pages} "
                    f"pages of {m.engine.page_bytes()} B, host tier {HOST_TIER_BYTES} B, "
                    f"device staging up to {m.engine.host_staging_bytes()} B")
                out = _host_tier_model(f"[host {name}]", m, card)
                for k, v in out["served"].items():
                    served[k] = served.get(k, 0) + v
            finally:
                manager.close()
                channel.close()
                server.stop(grace=None)
            torch.cuda.empty_cache()
    finally:
        os.environ.pop("AIOS_TPU_PREFIX_HOST_BYTES", None)
    for k in ("quantized_matmul", "paged_decode_attention", "multiquery_decode_attention",
              "int4_matmul", "paged_decode_attention_int8",
              "multiquery_decode_attention_int8"):
        expect(served.get(k, 0) > 0, f"[host] kernel {k} never launched")
    log(f"[host] phase done in {time.perf_counter() - t0:.1f} s; launches {served}")
    return served


# -- phase 16: mixture-of-experts, Qwen3-30B-A3B at full depth on one card --------

MOE_MODEL = "qwen3-moe"
# 8 prompts of 301-350 tokens, no two sharing a first block (no prefix hits)
MOE_WAVE_PROMPTS = [[256] + [(7 * i + j) % 256 for j in range(300 + 7 * i)] for i in range(8)]
MOE_WAVE_TOKENS = 128
MOE_GATHER_CTX = 4096  # the gather engine's context: its pool beside the served weights
# per dispatch of Qwen3-30B-A3B: w_qkv and wo a layer and the lm_head (K1), gate|up
# and down a layer (the expert entry), one attention a layer
MOE_K1, MOE_EXPERT_LAUNCHES = 2 * A_L + 1, 2 * A_L


def _moe_want(launches: dict, pre: int, chunks: int, steps: int) -> dict:
    want = dict.fromkeys(launches, 0)
    want.update({"quantized_matmul": MOE_K1 * (pre + chunks + steps),
                 "quantized_matmul_experts": MOE_EXPERT_LAUNCHES * (pre + chunks + steps),
                 "flash_attention": A_L * pre, "paged_decode_attention": A_L * steps,
                 "multiquery_decode_attention": A_L * chunks})
    return want


def _moe_wave(eng, submit, tag: str, card: str) -> dict:
    """The 8 greedy MOE_WAVE_PROMPTS at once through ``submit`` (a batcher's
    or a pool's), MOE_WAVE_TOKENS each, every kernel count set to 0 just
    before: tokens, tok/s, steps and exact launches, each dispatch a graph
    replay and none captured."""
    from aios_tpu_torch.engine.batching import Request

    eng.prefix_index.clear()
    captured = eng.stats()["graph_captures"]
    replays0, steps0 = eng.stats()["graph_replays"], eng.decode_steps
    pre0, chunks0 = eng.prefills, eng.prefill_chunks
    _reset_counts()
    t0 = time.perf_counter()
    hs = [submit(Request(prompt_ids=p, max_tokens=MOE_WAVE_TOKENS, temperature=0.0))
          for p in MOE_WAVE_PROMPTS]
    outs = [h.tokens() for h in hs]
    wall = time.perf_counter() - t0
    launches = _read_counts()
    tokens = sum(len(o) for o in outs)
    steps, pre = eng.decode_steps - steps0, eng.prefills - pre0
    chunks = eng.prefill_chunks - chunks0
    stats = eng.stats()
    expect(tokens == MOE_WAVE_TOKENS * len(hs), f"{tag}: {tokens} tokens")
    expect(stats["graph_captures"] == captured, f"{tag}: graphs captured while serving")
    expect(stats["graph_replays"] - replays0 == steps + pre + chunks,
           f"{tag}: {stats['graph_replays'] - replays0} replays for {steps} steps, {pre} "
           f"prefills and {chunks} chunks")
    want = {k: v for k, v in _moe_want(launches, pre, chunks, steps).items() if v}
    expect(launches == want, f"{tag}: launches {launches} != {want}")
    log(f"[moe] {tag}: 8 greedy requests x {MOE_WAVE_TOKENS} tokens at once (prompts of "
        f"{len(MOE_WAVE_PROMPTS[0])}-{len(MOE_WAVE_PROMPTS[-1])} tokens): {tokens} tokens in "
        f"{wall:.3f} s = {tokens / wall:.1f} tok/s end to end, {steps} decode steps "
        f"({wall / max(steps, 1) * 1e3:.2f} ms a step on the host clock, admissions "
        f"included), {pre} whole-prompt prefills, every dispatch a graph replay; launches "
        f"exact: {launches}; {card}")
    return dict(launches=launches, outs=outs, tok_s=tokens / wall)


def _moe_layer_gate(params, cfg, tokens) -> None:
    """Layer 0 of a T = 512 prefill, sublayer by sublayer through the kernels
    and the plain path on the same input: the attention sublayer (K1, K2),
    the router on the hidden states each attention left (the same code:
    picks and probabilities), and the FFN (the expert entry over 128
    experts) within E2E_TOL of max|output|."""
    from aios_tpu_torch import ops
    from aios_tpu_torch.engine import model, moe

    B, T = tokens.shape
    lp = model.layer_params(params)[0]
    x = params["embed"][tokens]
    cos, sin = model.rope_tables(torch.arange(T, device="cuda").expand(B, T), cfg.head_dim,
                                 cfg.rope_theta)
    attn = {}
    for kernels in (True, False):
        fn = ops.flash_attention if kernels else ops.flash_attention_reference
        q, k, v = model._project_qkv(x, lp, cfg, cos, sin, kernels)
        a = fn(q, k, v, causal=True, window=cfg.sliding_window)
        attn[kernels] = model.matmul(a.reshape(B, T, -1), lp["wo"], kernels)
    routes = {}
    for kernels in (True, False):
        h = model.rms_norm(x + attn[kernels], lp["ffn_norm"], cfg.rms_norm_eps)
        routes[kernels] = moe.route(h.reshape(B * T, -1), lp["w_router"], cfg)
    same = (routes[True][2] == routes[False][2]).float().mean().item()
    dprob = (routes[True][0] - routes[False][0]).abs().max().item()
    x = x + attn[False]
    ffn = {kernels: model._mlp(x, lp, cfg, kernels) for kernels in (True, False)}
    r_attn, r_ffn = _rel(attn[True], attn[False]), _rel(ffn[True], ffn[False])
    log(f"[moe] layer 0, T={T}, kernels vs plain on the same input: attention sublayer "
        f"max|d|/max={r_attn:.3e}, FFN (128 experts, top-8) max|d|/max={r_ffn:.3e} (limit "
        f"{E2E_TOL}); router on each path's attention output: {same:.4f} of the picks equal, "
        f"max|dprob|={dprob:.3e}")
    expect(r_attn <= E2E_TOL and r_ffn <= E2E_TOL, "[moe] layer 0 sublayers disagree")


def phase_moe_serve(manager, stub, card: str, state: dict) -> dict:
    from aios_tpu_torch.engine import model

    torch.cuda.reset_peak_memory_stats()
    m, load_s = _load(manager, stub, MOE_MODEL, "synthetic://qwen3-30b-a3b")
    eng, cfg = m.engine, m.config
    expect((cfg.num_layers, cfg.hidden_size, cfg.num_experts, cfg.num_experts_per_tok,
            cfg.expert_dim, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.vocab_size,
            eng.max_context) == (A_L, 2048, 128, MOE_K, 768, A_H, A_KH, A_D, 151936, 32768),
           f"not the full Qwen3-30B-A3B geometry: {cfg}")
    layers = eng.params["layers"]
    expect(layers["we_gateup"]["q"].dtype == torch.int8
           and tuple(layers["we_gateup"]["q"].shape) == (A_L, 128, 2048, 1536)
           and tuple(layers["we_down"]["q"].shape) == (A_L, 128, 768, 2048)
           and layers["w_qkv"]["q"].dtype == torch.int8 and eng.k_pool.dtype == torch.bfloat16,
           "expected int8 expert stacks and attention leaves over a bf16 pool")
    experts = sum(t.numel() * t.element_size() for k in ("we_gateup", "we_down")
                  for t in layers[k].values())
    weights = model.serving_weight_bytes(eng.params)
    pool = eng.k_pool.numel() * 2 * 2
    rows = (eng.allocator.num_pages - 1) * eng.allocator.page_size
    log(f"[moe] LoadModel synthetic://qwen3-30b-a3b ready in {load_s:.2f} s (made a layer at "
        f"a time in its serving leaves: {m.load_timings.get('init_s', 0.0):.2f} s, captures "
        f"{m.load_timings['capture_s']:.2f} s): {cfg.num_layers} layers, E={cfg.hidden_size}, "
        f"{cfg.num_experts} experts of {cfg.expert_dim}, top-{cfg.num_experts_per_tok}, "
        f"H={cfg.num_heads}/{cfg.num_kv_heads}, D={cfg.head_dim}, V={cfg.vocab_size}, "
        f"ctx={eng.max_context}; serving weights {weights} B (expert stacks {experts} B, int8 "
        f"with scales), {model.serving_weight_bytes(eng.params, picks=8 * MOE_K)} B a gather "
        f"step of 8 slots; bf16 pool of {rows} rows = {pool} B (auto: 9 x 32768 rows, less "
        f"what the admission transient needs); budgeted {int(m.hbm_chip_bytes)} B; peak "
        f"device memory {torch.cuda.max_memory_allocated()} B, allocated now "
        f"{torch.cuda.memory_allocated()} B of {torch.cuda.get_device_properties(0).total_memory}"
        f" B; {card}")
    log(f"[moe] {_graphs_line(m, load_s)}")
    w = _served_window(manager, stub, m, card)
    n, pre, steps, chunks = w["launches"], w["prefills"], w["steps"], w["chunks"]
    want = _moe_want(n, pre, chunks, steps)
    expect(n == want, f"[moe] launch counts {n} != {want} for {pre} prefills, {chunks} chunks, "
           f"{steps} steps")
    log(f"[moe] launch counts exact for {pre} whole-prompt prefills, {chunks} admission chunks "
        f"and {steps} decode steps: {n}")
    wave = _moe_wave(eng, m.submit, "dense wave through the pool", card)
    for k, v in wave["launches"].items():
        n[k] = n.get(k, 0) + v
    state["dense_wave"] = wave
    return n


def _greedy_state(eng, prompts, steps: int):
    """Admit ``prompts`` greedily into slots 0.. and decode ``steps``: the
    first tokens, the logits of the first decode step, and the tokens
    [steps, slots]; the slots are released after."""
    eng.prefix_index.clear()
    first = [eng.prefill(s, p, temperature=0.0) for s, p in enumerate(prompts)]
    toks = [eng.step(1)]
    logits = eng.last_logits.clone()
    toks.append(eng.step(steps - 1))
    for s in range(len(prompts)):
        eng.release(s)
    return first, logits, np.concatenate(toks, axis=0)


def _agreement(a: np.ndarray, b: np.ndarray) -> float:
    """Mean over slots of the share of tokens before the first difference."""
    same = []
    for s in range(a.shape[1]):
        diff = np.nonzero(a[:, s] != b[:, s])[0]
        same.append((diff[0] if len(diff) else a.shape[0]) / a.shape[0])
    return float(np.mean(same))


def phase_moe_numerics(manager, card: str, state: dict) -> dict:
    """The MoE numerics, the decode profile, and the gather path: layer 0's
    sublayers, every layer's sublayers (E2E_TOL) and the free-running
    logits (DRIFT_TOL) through the kernels against the plain path; TTFT of
    a ~1000-token prompt (two chunks); the step's replay against its eager
    body and its profile; then, the served model unloaded and its weights
    kept, an engine of MOE_GATHER_CTX built with AIOS_TPU_MOE_GATHER=1 over
    the same leaves, its greedy streams and first decode logits against the
    served dense engine's, and the wave through its batcher."""
    from aios_tpu_torch.engine.batching import ContinuousBatcher, Request
    from aios_tpu_torch.engine.engine import TorchEngine

    m = manager.get(MOE_MODEL)
    eng, cfg, params = m.engine, m.config, m.engine.params
    gen = torch.Generator(device="cuda").manual_seed(4)
    tokens = torch.randint(0, 256, (1, 512), generator=gen, device="cuda")
    _moe_layer_gate(params, cfg, tokens)
    per_layer, rel_head = _layerwise_prefill(params, cfg, tokens)
    worst = max(range(len(per_layer)), key=lambda i: per_layer[i])
    log(f"[moe] prefill T=512, each sublayer fed the plain path's input: worst layer {worst} "
        f"max|d|/max={per_layer[worst]:.3e} (limit {E2E_TOL}), lm_head {rel_head:.3e}")
    expect(max(per_layer) <= E2E_TOL and rel_head <= E2E_TOL, "[moe] a sublayer disagrees")
    _logits_gate(m, "[moe]", 256, tol=DRIFT_TOL)

    eng.prefix_index.clear()
    h = m.batcher.submit(Request(prompt_ids=[256] + [65] * 1000, max_tokens=2, temperature=0.0))
    h.tokens()
    log(f"[moe] ttft_ms={h.ttft_ms:.2f} for a 1001-token prompt ({_admission(m, 1001)}) on an "
        f"idle server, {card}")
    _graph_vs_eager("[moe]", eng, {"quantized_matmul": MOE_K1,
                                   "quantized_matmul_experts": MOE_EXPERT_LAUNCHES,
                                   "paged_decode_attention": A_L}, rounds=False)
    _profile_decode(eng, "qwen3-30b-a3b", 8, card)

    dense_first, dense_logits, dense_toks = _greedy_state(eng, MOE_WAVE_PROMPTS, 32)
    dense_wave = state["dense_wave"]
    manager.unload_model(MOE_MODEL)  # its pool and graphs go; the leaves stay with `params`
    torch.cuda.empty_cache()
    os.environ["AIOS_TPU_MOE_GATHER"] = "1"
    try:
        g = TorchEngine(cfg, params, num_slots=8, max_context=MOE_GATHER_CTX,
                        paged_pool_rows=9 * MOE_GATHER_CTX, page_size=128, device="cuda",
                        track_history=False)
    finally:
        del os.environ["AIOS_TPU_MOE_GATHER"]
    launches = {}
    try:
        expect(g._moe_impl == "gather" and g._verify_moe_impl(8) is None,
               f"[moe] the gather engine chose {g._moe_impl!r}")
        t0 = time.perf_counter()
        g.warmup(prefill_chunk=512)
        log(f"[moe] gather engine (AIOS_TPU_MOE_GATHER=1, 8 slots x 8 picks < 128 experts, "
            f"ctx {MOE_GATHER_CTX}) over the served leaves: warmup {time.perf_counter() - t0:.2f}"
            f" s, {g.graphs.captures} graphs")
        first, logits, toks = _greedy_state(g, MOE_WAVE_PROMPTS, 32)
        gap = _rel(logits, dense_logits)
        log(f"[moe] gather vs dense, 8 greedy slots: first tokens "
            f"{'equal' if first == dense_first else 'differ'} (both from the dense prefill), "
            f"first decode step's logits max|d|/max|logit|={gap:.3e} (argmax agreement "
            f"{(logits.argmax(-1) == dense_logits.argmax(-1)).float().mean().item():.3f}), "
            f"greedy agreement over 32 steps {_agreement(toks, dense_toks):.3f} (bf16 near-ties "
            f"flip argmax, so the streams may part)")
        expect(first == dense_first and gap <= E2E_TOL and bool(torch.isfinite(logits).all()),
               "[moe] the gather step's logits disagree with the dense step's")
        b = ContinuousBatcher(g, prefill_chunk=512)
        try:
            wave = _moe_wave(g, b.submit, "gather wave through the batcher", card)
        finally:
            b.shutdown()
        launches = wave["launches"]
        agree = np.mean([_agreement(np.array(a)[:, None], np.array(d)[:, None])
                         for a, d in zip(wave["outs"], dense_wave["outs"])])
        log(f"[moe] gather wave {wave['tok_s']:.1f} tok/s against the dense wave's "
            f"{dense_wave['tok_s']:.1f} tok/s (same prompts, greedy; stream agreement "
            f"{agree:.3f}), {card}")
    finally:
        g.close()
        del params
        torch.cuda.empty_cache()
    return launches


def phase_moe(card: str) -> dict:
    """Qwen3-30B-A3B served through LoadModel at full depth (int8, bf16 pool
    sized auto), its numerics and the gather engine; the served windows'
    launches."""
    served, state = {}, {}

    def serve_(manager, stub, card_):
        served.update(phase_moe_serve(manager, stub, card_, state))
        return served

    def numerics(manager, card_):
        for k, v in phase_moe_numerics(manager, card_, state).items():
            served[k] = served.get(k, 0) + v

    _serve_phases(card, (serve_, numerics), quantize="int8", kv_cache="bf16")
    return served


# -- phase 17: the decode loop's modes and window+sink compression --------------

LOOP_KNOBS = ("AIOS_TPU_DECODE_PIPELINE", "AIOS_TPU_UNIFIED_STEP", "AIOS_TPU_MEGA_TICKS",
              "AIOS_TPU_KV_COMPRESS_AFTER", "AIOS_TPU_KV_SINK_PAGES", "AIOS_TPU_KV_WINDOW_PAGES")
LOOP_MODES = (
    ("sync", {}),
    ("pipeline", {"AIOS_TPU_DECODE_PIPELINE": 1}),
    ("unified", {"AIOS_TPU_UNIFIED_STEP": 1}),
    ("mega", {"AIOS_TPU_MEGA_TICKS": 8}),
    ("mega+pipeline", {"AIOS_TPU_MEGA_TICKS": 8, "AIOS_TPU_DECODE_PIPELINE": 1}),
)
# 8 distinct prompts of 181 to 321 tokens (whole-prompt admissions, no shared
# 128-row block: no prefix hit inside a wave)
LOOP_PROMPTS = tuple([256] + [(31 * i + 7 * j + 3) % 256 for j in range(180 + 20 * i)]
                     for i in range(8))
LOOP_TOKENS = 96
MISTRAL_LOOP_TOKENS = 48
LOOP_TICKS = 16  # ticks of a timed dispatch: the batcher's chunk
COMPRESS_KNOBS = {"AIOS_TPU_KV_COMPRESS_AFTER": 1152, "AIOS_TPU_KV_SINK_PAGES": 1,
                  "AIOS_TPU_KV_WINDOW_PAGES": 8}
COMPRESS_PROMPT = [256] + [(17 * j + 5) % 256 for j in range(1000)]  # 1001 tokens
COMPRESS_TOKENS = 950  # decoded to 1951 rows
MIDFLIGHT_PROMPT = [256] + [(11 * j + 3) % 256 for j in range(1899)]  # 1900 tokens


def _loop_knobs(**env) -> None:
    """Set the decode loop's knobs that the next LoadModel reads, every
    other one unset."""
    for k in LOOP_KNOBS:
        os.environ.pop(k, None)
    for k, v in env.items():
        os.environ[k] = str(v)


def _record_ticks(eng) -> list:
    """A list that each megagraph dispatch of ``eng`` appends its real
    tick count k to."""
    ticks = []
    real = eng._mega_dispatch

    def spy(*a, **kw):
        out = real(*a, **kw)
        ticks.append(int(out[2]))
        return out

    eng._mega_dispatch = spy
    return ticks


def _loop_wave(m, reqs):
    """(prompt, max_tokens, stop ids) requests, greedy, through the model's
    pool at once, every kernel count set to 0 just before and read just
    after: (streams, wall seconds, launches)."""
    from aios_tpu_torch.engine.batching import Request

    def run():
        t0 = time.perf_counter()
        hs = [m.submit(Request(prompt_ids=list(p), max_tokens=n, temperature=0.0,
                               stop_ids=tuple(st))) for p, n, st in reqs]
        out = [h.tokens() for h in hs]
        return out, time.perf_counter() - t0

    (streams, wall), launches = _counted(run)
    return streams, wall, launches


def _tick_cost(fn, ticks: int):
    """(host wall ms, device ms) a tick of ``fn``, a dispatch of ``ticks``
    ticks that reads its tokens back: medians of three runs after one
    warm-up, the wall on the host's clock, the device's between CUDA events
    recorded around the dispatch."""
    fn()
    walls, devs = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        devs.append(a.elapsed_time(b))
    return statistics.median(walls) * 1e3 / ticks, statistics.median(devs) / ticks


def _loop_dispatch(eng, mode: str, ticks: int, budget: int = 10 ** 6):
    """One dispatch of ``ticks`` decode ticks over the live slots as
    ``mode`` issues it: ``step`` (the one-tick graph replayed, with the
    unified step or without), ``step_async`` waited for, or megagraph
    dispatches of K ticks each with ``budget`` tokens a slot."""
    S = eng.num_slots
    stops = np.full((S, 4), -1, np.int32)
    budgets = np.full(S, budget, np.int32)
    if mode.startswith("mega"):
        K = min(eng.mega_ticks, ticks)

        def fn():
            for _ in range(max(ticks // K, 1)):
                eng.mega_step(K, stops, budgets)
        return fn
    if mode == "pipeline":
        return lambda: eng.step_async(ticks).wait()
    return lambda: eng.step(ticks)


def _tick_profile(eng, tag: str, card: str) -> None:
    """Where a megagraph tick's extra device time goes: one window of
    LOOP_TICKS ticks over the live slots as megagraph dispatches of 8 and
    as LOOP_TICKS replays of the one-tick step graph, from the same state,
    each under torch.profiler after one unprofiled run: device events and
    device ms a tick of each, and the kernels whose device time a tick
    differs most between the two (the body's kernels, or the gate and what
    the conditional nodes add)."""
    from torch.profiler import ProfilerActivity, profile

    S = eng.num_slots
    stops = np.full((S, 4), -1, np.int32)
    budgets = np.full(S, 10 ** 6, np.int32)
    runs = {"megagraph": lambda: [eng.mega_step(8, stops, budgets)
                                  for _ in range(LOOP_TICKS // 8)],
            "step graph": lambda: eng.step(LOOP_TICKS)}
    snap = _snapshot(eng)
    per = {}
    for name, fn in runs.items():
        fn()
        _restore(eng, snap)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        _restore(eng, snap)
        per[name] = {k: (c / LOOP_TICKS, us / LOOP_TICKS)
                     for k, (c, us) in _device_kernels(prof).items()}
    mega, step = per["megagraph"], per["step graph"]
    expect(mega and step, f"[loop {tag}] the profiler saw no device time")
    diff = sorted(set(mega) | set(step),
                  key=lambda k: -abs(mega.get(k, (0, 0))[1] - step.get(k, (0, 0))[1]))
    top = "; ".join(f"{k[:60]} {mega.get(k, (0, 0))[1] - step.get(k, (0, 0))[1]:+.1f} us "
                    f"({mega.get(k, (0, 0))[0]:.2f} vs {step.get(k, (0, 0))[0]:.2f} a tick)"
                    for k in diff[:8])
    log(f"[loop {tag}] profile of {LOOP_TICKS} ticks over {S} slots, a tick: megagraph "
        f"{sum(c for c, _ in mega.values()):.2f} device events, "
        f"{sum(us for _, us in mega.values()) / 1e3:.4f} ms; step graph "
        f"{sum(c for c, _ in step.values()):.2f} events, "
        f"{sum(us for _, us in step.values()) / 1e3:.4f} ms; the kernels that differ most "
        f"(megagraph less step graph, launches a tick): {top}, {card}")


def _loop_mode(manager, stub, card: str, tag: str, path: str, mode: str, env: dict, reqs,
               base, timing: bool = True):
    """LoadModel ``path`` with the mode's knobs, a wave of ``reqs`` through
    the pool (streams token for token ``base``'s when given), the per-tick
    cost of a dispatch over 8 live slots; the model stays loaded. Returns
    (managed model, streams, launches, tick counts)."""
    name = f"loop-{tag}"
    _loop_knobs(**env)
    m, load_s = _load(manager, stub, name, path)
    eng, b = m.engine, m.batcher
    mega = int(env.get("AIOS_TPU_MEGA_TICKS", 0))
    expect(b.pipeline == ("AIOS_TPU_DECODE_PIPELINE" in env)
           and eng.unified_step == ("AIOS_TPU_UNIFIED_STEP" in env) and eng.mega_ticks == mega,
           f"[loop {tag}] {mode}: the knobs did not reach the engine and batcher")
    expect(eng.mega_graphs() == (4 if mega else 0), f"[loop {tag}] {mode}: LoadModel "
           f"captured {eng.mega_graphs()} megagraph buckets, not {4 if mega else 0}")
    captured = eng.stats()["graph_captures"]
    ticks = _record_ticks(eng)
    gap0, disp0 = b.host_gap_seconds, b.decode_dispatches
    streams, wall, launches = _loop_wave(m, reqs)
    expect(eng.stats()["graph_captures"] == captured,
           f"[loop {tag}] {mode}: a graph was captured while serving")
    n_tok = sum(len(t) for t in streams)
    expect(all(len(t) == n for t, (_, n, _) in zip(streams, reqs)),
           f"[loop {tag}] {mode}: a stream ended short")
    if base is not None:
        bad = [i for i, (x, y) in enumerate(zip(streams, base)) if x != y]
        expect(not bad, f"[loop {tag}] {mode}: streams {bad} differ from the sync loop's")
    gap = (b.host_gap_seconds - gap0) / max(b.decode_dispatches - disp0, 1) * 1e3
    line = (f"[loop {tag}] {mode}: LoadModel {load_s:.2f} s ({eng.stats()['graph_captures']} "
            f"graphs, {eng.mega_graphs()} megagraph buckets); {len(reqs)} greedy requests: "
            f"{n_tok} tokens in {wall:.3f} s = {n_tok / wall:.1f} tok/s, host gap "
            f"{gap:.3f} ms a dispatch, {eng.mega_dispatches} mega dispatches of "
            f"{eng.mega_tick_total} ticks (k {ticks}); streams "
            f"{'identical to the sync loop' if base is not None else 'the reference'}")
    if timing:
        eng.prefix_index.clear()
        for s_, p in enumerate(reqs[:eng.num_slots]):
            eng.prefill(s_, list(p[0]), temperature=0.0)
        wall_t, dev_t = _tick_cost(_loop_dispatch(eng, mode, LOOP_TICKS), LOOP_TICKS)
        line += (f"; a {LOOP_TICKS}-tick dispatch over 8 slots: {wall_t:.3f} ms host wall and "
                 f"{dev_t:.3f} ms device a tick")
        if mega:
            # what the skipped ticks of an early exit cost: a bucket-8
            # dispatch that runs 1 tick against the 1-tick bucket
            one = _tick_cost(_loop_dispatch(eng, mode, 1, budget=1), 1)
            eight = _tick_cost(lambda: eng.mega_step(8, np.full((8, 4), -1, np.int32),
                                                     np.ones(8, np.int32)), 1)
            line += (f"; 7 dead ticks cost {eight[0] - one[0]:.3f} ms host wall and "
                     f"{eight[1] - one[1]:.3f} ms device (bucket 8 at k=1 {eight[0]:.3f} / "
                     f"{eight[1]:.3f} ms, bucket 1 {one[0]:.3f} / {one[1]:.3f} ms)")
        if mode == "mega":
            _tick_profile(eng, tag, card)
        for s_ in range(eng.num_slots):
            eng.release(s_)
    log(line + f", {card}")
    return m, streams, launches, ticks


def _early_exits(m, card: str, base) -> dict:
    """On the megagraph engine: a wave whose budgets and a stop id end its
    windows early (k per dispatch printed; the streams are the sync loop's
    truncated), then a wave under ``pool.megatick_abort`` (the first
    dispatch ends after 3 of 8 ticks; the streams are the sync loop's).
    Returns the launches."""
    from aios_tpu_torch import faults

    eng = m.engine
    stop = base[0][9]
    reqs = [(p, 3 + 5 * i, ()) for i, p in enumerate(LOOP_PROMPTS)]
    reqs[0] = (LOOP_PROMPTS[0], 40, (stop,))
    want = [t[:n] for t, (_, n, _) in zip(base, reqs)]
    want[0] = base[0][:base[0].index(stop) + 1]
    eng.prefix_index.clear()
    ticks = _record_ticks(eng)
    streams, _, launches = _loop_wave(m, reqs)
    expect(streams == want, "[loop] the early-exit wave's streams are not the sync loop's")
    expect(any(k < 8 for k in ticks), f"[loop] no dispatch exited early: k {ticks}")
    log(f"[loop] early exits (budgets 3..38, request 0 stopping on token {stop} after "
        f"{len(want[0])} tokens): k per dispatch {ticks}, streams the sync loop's, {card}")
    eng.prefix_index.clear()
    ticks = _record_ticks(eng)
    faults.activate("seed=1;pool.megatick_abort=nth:1,ticks=3")
    try:
        streams, _, more = _loop_wave(m, [(p, 24, ()) for p in LOOP_PROMPTS])
    finally:
        faults.deactivate()
    expect(ticks and ticks[0] == 3, f"[loop] pool.megatick_abort: first dispatch ran {ticks}")
    expect(streams == [t[:24] for t in base],
           "[loop] the streams under pool.megatick_abort are not the sync loop's")
    log(f"[loop] pool.megatick_abort (ticks=3) on the first dispatch: k per dispatch {ticks}, "
        f"streams the sync loop's, {card}")
    for k_, v in more.items():
        launches[k_] = launches.get(k_, 0) + v
    return launches


def _add(acc: dict, launches: dict) -> None:
    for k, v in launches.items():
        acc[k] = acc.get(k, 0) + v


def phase_loop_tinyllama(manager, stub, card: str) -> dict:
    """TinyLlama-1.1B (int8 weights, bf16 pool) in each decode-loop mode,
    its streams the sync loop's, and the megagraph's early exits."""
    acc, base = {}, None
    reqs = [(p, LOOP_TOKENS, ()) for p in LOOP_PROMPTS]
    for mode, env in LOOP_MODES:
        m, streams, launches, _ = _loop_mode(manager, stub, card, "tinyllama",
                                              "synthetic://tinyllama-1.1b", mode, env, reqs,
                                              base)
        _add(acc, launches)
        if base is None:
            base = streams
        if mode == "mega":
            _add(acc, _early_exits(m, card, base))
        manager.unload_model(m.name)
    _loop_knobs()
    return acc


def phase_loop_mistral(manager, stub, card: str) -> dict:
    """Mistral-7B (int4 weights, int8 pool) in the sync loop and with the
    megagraph pipelined: the same streams."""
    acc, base = {}, None
    reqs = [(p, MISTRAL_LOOP_TOKENS, ()) for p in LOOP_PROMPTS]
    for mode, env in (LOOP_MODES[0], LOOP_MODES[-1]):
        m, streams, launches, _ = _loop_mode(manager, stub, card, "mistral",
                                              "synthetic://mistral-7b", mode, env, reqs, base)
        _add(acc, launches)
        base = base or streams
        manager.unload_model(m.name)
    _loop_knobs()
    return acc


def _compression_logits(eng, tag: str) -> None:
    """The first logits after a slot's first prune, through the kernels
    (K3 or K4 with the sink mask; K6 or K7 with the new predicate for a
    verify forward of 8 tokens) against the plain path under the same
    mask, on the same state: within E2E_TOL of max|logit|."""
    from aios_tpu_torch.engine import model

    eng.prefix_index.clear()
    eng.prefill(0, COMPRESS_PROMPT, temperature=0.0)
    while int(eng.win_starts()[0]) == 0:
        eng.step(LOOP_TICKS)
    with eng._lock:
        eng._back_active_slots(8)
        eng._stage_tables()
    snap = _snapshot(eng)
    kw = dict(active=eng.active_dev, cache_scales=eng._cache_scales(),
              win_starts=eng.win_starts_dev, sink_rows=eng._sink_rows)
    gen = torch.Generator(device="cuda").manual_seed(5)
    feed = torch.cat([eng.last_tokens[:, None],
                      torch.randint(0, 256, (eng.num_slots, 7), generator=gen, device="cuda")],
                     1)
    out = {}
    for kernels in (True, False):
        out[("step", kernels)] = model.decode_step_paged(
            eng.params, eng.cfg, eng.last_tokens, eng.lengths, eng.k_pool, eng.v_pool,
            eng.tables_dev, kernels=kernels, **kw)[0]
        _restore(eng, snap)
        out[("verify", kernels)] = model.verify_step_paged(
            eng.params, eng.cfg, feed, eng.lengths, eng.k_pool, eng.v_pool, eng.tables_dev,
            kernels=kernels, **kw)[0]
        _restore(eng, snap)
    rel_step = _rel(out[("step", True)], out[("step", False)])
    rel_verify = _rel(out[("verify", True)], out[("verify", False)])
    ws, L = int(eng.win_starts()[0]), eng.slot_length(0)
    eng.release(0)
    log(f"{tag} first logits after the first prune (length {L}, live window from row {ws}, "
        f"sink {eng._sink_rows} rows): decode step max|dlogit|/max|logit|={rel_step:.3e}, "
        f"verify T=8 {rel_verify:.3e} (limit {E2E_TOL})")
    expect(rel_step <= E2E_TOL and rel_verify <= E2E_TOL
           and bool(torch.isfinite(out[("step", True)]).all()),
           f"{tag} kernel and plain logits under the sink mask disagree")


def phase_loop_compression(manager, stub, card: str, kv: str) -> dict:
    """TinyLlama-1.1B with window+sink compression armed (1 sink + 8
    window pages, threshold 1152 rows, the floor) over the ``kv`` pool:
    a 1001-token prompt decoded to 1951 rows through the batcher, each
    dispatch's residency, the pages back in the pool afterwards; the first
    logits after a prune through the kernels against the plain path; a
    1900-token prompt pruned mid-admission (K6/K7 with the sink predicate),
    registering only its sink block. Returns the served runs' launches."""
    tag = f"[compress {kv}]"
    _loop_knobs(**COMPRESS_KNOBS)
    m, load_s = _load(manager, stub, f"compress-{kv}", "synthetic://tinyllama-1.1b")
    eng = m.engine
    alloc = eng.allocator
    sink, window, P_ = eng.kv_sink_pages, eng.kv_window_pages, alloc.page_size
    expect(eng.kv_compress_armed and eng.kv_compress_after == 1152
           and eng._sink_rows == sink * P_, f"{tag} compression not armed as asked")
    eng.prefix_index.clear()
    free0 = alloc.free_pages
    samples = []
    real = eng._back_active_slots

    def spy(grow_rows):
        real(grow_rows)
        for s_ in range(eng.num_slots):
            if eng.active[s_] and eng._win_starts[s_] > 0:
                L = int(eng._host_lengths[s_])
                resident = alloc.slot_pages_resident(s_)
                ahead = int(alloc._blocks_used[s_]) - alloc.blocks_for(L + 1)
                samples.append((resident, resident - ahead))

    eng._back_active_slots = spy
    streams, wall, launches = _loop_wave(m, [(COMPRESS_PROMPT, COMPRESS_TOKENS, ())])
    eng._back_active_slots = real
    pruned = eng.kv_pages_pruned
    expect(len(streams[0]) == COMPRESS_TOKENS and pruned > 0 and samples,
           f"{tag} the long slot did not prune ({pruned} pages)")
    most = max(r for r, _ in samples)
    most_rows = max(r for _, r in samples)
    expect(most_rows <= sink + window + 1 and most <= sink + window + 2,
           f"{tag} residency {most} pages ({most_rows} holding rows) past sink {sink} + "
           f"window {window} + 1")
    eng.prefix_index.clear()
    expect(alloc.free_pages == free0, f"{tag} {free0 - alloc.free_pages} pages not returned")
    log(f"{tag} LoadModel {load_s:.2f} s, threshold {eng.kv_compress_after} rows; a "
        f"{len(COMPRESS_PROMPT)}-token prompt decoded to {len(COMPRESS_PROMPT) + COMPRESS_TOKENS} "
        f"rows in {wall:.3f} s: {pruned} pages pruned, resident pages at most {most_rows} "
        f"holding rows (sink {sink} + window {window} + 1) and {most} with the dispatch's "
        f"backing, over {len(samples)} dispatches; every page back in the pool after, "
        f"{card}")
    _compression_logits(eng, tag)
    # a prompt past the threshold, pruned between its chunks
    eng.prefix_index.clear()
    calls = []
    real_c = eng._maybe_compress

    def spy_c(slot, length=None):
        before = int(eng._win_starts[slot])
        real_c(slot, length)
        if length is not None and int(eng._win_starts[slot]) != before:
            calls.append((length, int(eng._win_starts[slot])))

    eng._maybe_compress = spy_c
    pruned0 = eng.kv_pages_pruned
    streams, _, more = _loop_wave(m, [(MIDFLIGHT_PROMPT, 4, ())])
    eng._maybe_compress = real_c
    attn = "multiquery_decode_attention_int8" if kv == "int8" else "multiquery_decode_attention"
    expect(calls and len(streams[0]) == 4 and more.get(attn, 0) > 0,
           f"{tag} the 1900-token admission did not prune mid-flight ({calls})")
    overlap = eng.prefix_overlap_rows(MIDFLIGHT_PROMPT)
    expect(overlap == sink * P_, f"{tag} the pruned admission registered {overlap} rows, "
           f"not its {sink * P_} sink rows")
    log(f"{tag} a {len(MIDFLIGHT_PROMPT)}-token prompt admitted in chunks of "
        f"{m.batcher.prefill_chunk}: pruned mid-admission at {calls} (admitted rows, live "
        f"window start), {eng.kv_pages_pruned - pruned0} pages, {more.get(attn, 0)} {attn} "
        f"launches with the sink predicate; only its sink block registered ({overlap} rows)")
    _add(launches, more)
    manager.unload_model(m.name)
    _loop_knobs()
    return launches


def phase_decode_loop(card: str) -> dict:
    """Phase 17: the decode loop's modes on TinyLlama-1.1B and Mistral-7B
    and window+sink compression on TinyLlama over both pools, all through
    LoadModel and the batcher; the served runs' launches."""
    t0 = time.perf_counter()
    acc = {}

    def tiny(manager, stub, card_):
        _add(acc, phase_loop_tinyllama(manager, stub, card_))
        _add(acc, phase_loop_compression(manager, stub, card_, "bf16"))
        return acc

    def int8_pool(manager, stub, card_):
        _add(acc, phase_loop_compression(manager, stub, card_, "int8"))
        return acc

    def mistral(manager, stub, card_):
        _add(acc, phase_loop_mistral(manager, stub, card_))
        return acc

    def nothing(manager, card_):
        pass

    _serve_phases(card, (tiny, nothing), quantize="int8", kv_cache="bf16")
    _serve_phases(card, (int8_pool, nothing), quantize="int8", kv_cache="int8")
    _serve_phases(card, (mistral, nothing), quantize="int4", kv_cache="int8")
    log(f"[loop] phase done in {time.perf_counter() - t0:.1f} s; launches {acc}")
    return acc


def _serve_phases(card: str, phases, **manager_kw) -> dict:
    """A ModelManager and its gRPC server on 127.0.0.1 for ``phases``; both
    stop, and the models unload, before this returns."""
    from aios_tpu_torch import rpc, services
    from aios_tpu_torch.runtime.model_manager import ModelManager
    from aios_tpu_torch.runtime.service import serve

    manager = ModelManager(num_slots=8, **manager_kw)
    server, _, port = serve("127.0.0.1:0", manager, block=False)
    channel = rpc.insecure_channel(f"127.0.0.1:{port}")
    try:
        served, numerics = phases
        launches = served(manager, services.AIRuntimeStub(channel), card)
        numerics(manager, card)
    finally:
        manager.close()
        channel.close()
        server.stop(grace=None)
    torch.cuda.empty_cache()
    return launches


def _phase_clock():
    """A runner that logs each phase's seconds on the host's clock."""
    def run(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        log(f"[chip_smoke] phase {name}: {time.perf_counter() - t0:.1f} s")
        return out
    return run


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing ran",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = phase_device()
    timed = _phase_clock()
    timed("build", phase_build)
    measured = timed("kernels", phase_kernels)

    tiny = timed("tinyllama", _serve_phases, card, (phase_serve, phase_numerics),
                 quantize="int8", kv_cache="bf16")
    torch.cuda.reset_peak_memory_stats()
    mistral = timed("mistral", _serve_phases, card,
                    (phase_mistral_serve, phase_mistral_numerics),
                    quantize="int4", kv_cache="int8")
    dense = {"paged_kv": "off", "speculative": True}
    tiny_dense = timed(
        "tinyllama dense", _serve_phases, card,
        (phase_dense_serve("tinyllama"), phase_dense_numerics("tinyllama")),
        quantize="int8", kv_cache="bf16", **dense)
    mistral_dense = timed(
        "mistral dense", _serve_phases, card,
        (phase_dense_serve("mistral"), phase_dense_numerics("mistral")),
        quantize="int4", kv_cache="int8", **dense)
    gguf = timed("gguf", phase_gguf, card)
    constrained = timed("constrained", phase_constrained, card)
    serving = timed("serving", phase_serving, card)
    spec_paged = timed("spec paged", phase_spec_paged, card)
    host = timed("host tier", phase_host_tier, card)
    loop = timed("decode loop", phase_decode_loop, card)
    moe = timed("moe", phase_moe, card)

    kernels = []
    for name, meta in KERNEL_META.items():
        r = measured[name]
        tiny[name] = tiny.get(name, 0) + tiny_dense.get(name, 0)
        mistral[name] = mistral.get(name, 0) + mistral_dense.get(name, 0)
        n = (tiny.get(name, 0) + mistral.get(name, 0) + gguf.get(name, 0)
             + constrained.get(name, 0) + serving.get(name, 0) + spec_paged.get(name, 0)
             + host.get(name, 0) + loop.get(name, 0) + moe.get(name, 0))
        expect(n > 0, f"kernel {name} launched no time while serving")
        kernels.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": n,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
        log(f"[kernels] {name}: ok, {n} launches while serving ({tiny[name]} TinyLlama, "
            f"{mistral[name]} Mistral-7B, {gguf.get(name, 0)} GGUF files, "
            f"{constrained.get(name, 0)} constrained, {serving.get(name, 0)} two replicas, "
            f"{spec_paged.get(name, 0)} Mistral-7B with its draft, {host.get(name, 0)} over "
            f"the host tier, {loop.get(name, 0)} in the decode loop's modes, "
            f"{moe.get(name, 0)} Qwen3-30B-A3B), "
            f"{r['measured_at']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {'none' if r['library_ms'] is None else format(r['library_ms'], '.4f')}"
            f"{'' if r['library_ms'] is None else ' ms'}, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    log(f"[chip_smoke] every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
