#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``aios_tpu_torch``) on one NVIDIA GPU.

Phases, each printing its lines:
  1. device — the card's name and power limit; TF32 off for every reference;
  2. build  — compile every kernel from ``aios_tpu_torch/csrc`` with nvcc;
  3. kernels — each kernel against its plain PyTorch version on the same
     bf16 inputs at the shapes the TinyLlama-1.1B main path gives it, with
     its time (CUDA events, median of 20 runs, the L2 flushed and the
     stream held before each so that host overhead is not counted), the
     plain version's time, one PyTorch library call's time and the bound;
  4. serve  — ``ModelManager`` + ``serve()`` on 127.0.0.1, LoadModel
     ``synthetic://tinyllama-1.1b`` at full width, three Infer and one
     StreamInfer over gRPC, and proof that every kernel launched meanwhile;
  5. numerics — prefill and decode-step logits of the loaded model through
     the kernels against the plain path, and two identical greedy streams.

Then one ``{"kernels": [...]}`` line and, last, the result line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed phase exits non-zero without the result line; so does a machine
without CUDA.

Run from the repository root:  python3 chip_smoke.py
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time

import torch

# NVIDIA H100 SXM data sheet: HBM3 rate and dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
TOL = 2e-2  # bf16 outputs and p, fp32 sums taken in another order
E2E_TOL = 5e-2  # 22 layers of such differences, relative to max |logit|

TINYLLAMA_KN = {  # (K, N) of each int8 matmul; launches per decode step
    "w_qkv": ((2048, 2560), 22),
    "wo": ((2048, 2048), 22),
    "w_gateup": ((2048, 11264), 22),
    "w_down": ((5632, 2048), 22),
    "lm_head": ((2048, 32000), 1),
}
H, KH, D, P = 32, 4, 64, 128

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
}


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
            if "registers" in line or "spill" in line:
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


def check_quantized_matmul(gen) -> dict:
    from aios_tpu_torch.ops import quantized_matmul, quantized_matmul_reference

    worst = 0.0
    step = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0, "flops": 0.0}
    for M in (8, 512):
        for key, ((K, N), per_step) in TINYLLAMA_KN.items():
            x = torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16)
            w_q = torch.randint(-127, 128, (K, N), generator=gen, device="cuda").to(torch.int8)
            s = torch.rand(1, N, generator=gen, device="cuda") * (0.04 / 127) + 1e-5
            y = quantized_matmul(x, w_q, s)
            ref = quantized_matmul_reference(x, w_q, s)
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            ok = bool(torch.isfinite(y).all()) and err <= TOL * scale
            w_bf16 = (w_q.float() * s).to(torch.bfloat16)
            ms = time_ms(lambda: quantized_matmul(x, w_q, s))
            plain = time_ms(lambda: quantized_matmul_reference(x, w_q, s))
            lib = time_ms(lambda: torch.matmul(x, w_bf16))
            nbytes = M * K * 2 + K * N + N * 4 + M * N * 2
            flops = 2.0 * M * N * K
            bnd = bound_ms(nbytes, flops)
            _report("quantized_matmul", f"{key} M={M} K={K} N={N}", ms, plain, lib,
                    bnd, err, ok)
            expect(ok, f"quantized_matmul {key} M={M}: err {err} vs max|ref| {scale}")
            worst = max(worst, err)
            if M == 8:
                step["ms"] += per_step * ms
                step["plain_ms"] += per_step * plain
                step["library_ms"] += per_step * lib
                step["bytes"] += per_step * nbytes
                step["flops"] += per_step * flops
    bnd = bound_ms(step["bytes"], step["flops"])
    log(
        f"[kernel] quantized_matmul one decode step (89 launches, M=8): "
        f"kernel_ms={step['ms']:.4f} plain_ms={step['plain_ms']:.4f} "
        f"library_ms={step['library_ms']:.4f} bound_ms={bnd[0]:.4f} ({bnd[1]}) "
        f"weight_bytes={step['bytes']:.4e}"
    )
    return dict(max_abs_err=worst, ms=step["ms"], plain_ms=step["plain_ms"],
                library_ms=step["library_ms"], bound_ms=bnd[0], bound_by=bnd[1],
                measured_at="one decode step: 89 launches at M=8")


def check_flash_attention(gen) -> dict:
    import torch.nn.functional as F

    from aios_tpu_torch.ops import flash_attention, flash_attention_reference

    worst = 0.0
    headline = None
    for T, window in ((128, None), (512, None), (2048, None), (512, 128)):
        q = torch.randn(1, T, H, D, generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn(1, T, KH, D, generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn(1, T, KH, D, generator=gen, device="cuda").to(torch.bfloat16)
        out = flash_attention(q, k, v, causal=True, window=window)
        ref = flash_attention_reference(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        ok = bool(torch.isfinite(out).all()) and torch.allclose(
            out.float(), ref.float(), atol=TOL, rtol=TOL)
        ms = time_ms(lambda: flash_attention(q, k, v, causal=True, window=window))
        plain = time_ms(lambda: flash_attention_reference(q, k, v, causal=True, window=window))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        rows = torch.arange(T, device="cuda")[:, None]
        cols = torch.arange(T, device="cuda")[None, :]
        mask = (cols <= rows) & ((cols > rows - window) if window else True)
        if window is None:
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))
        else:
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True))
        pairs = float(mask.sum().item())
        nbytes = (2 * T * H * D + 2 * T * KH * D) * 2
        bnd = bound_ms(nbytes, 4.0 * pairs * H * D)
        _report("flash_attention", f"T={T} window={window}", ms, plain, lib, bnd, err, ok)
        expect(ok, f"flash_attention T={T} window={window}: max err {err}")
        worst = max(worst, err)
        if T == 512 and window is None:
            headline = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd[0],
                            bound_by=bnd[1], measured_at="one launch, T=S=512")
    headline["max_abs_err"] = worst
    return headline


def _paged_case(gen, lengths, MB=16):
    B = len(lengths)
    need = [-(-(n + 1) // P) for n in lengths]
    N = 1 + sum(need) + 3  # page 0 is the sacrificial page
    perm = (torch.randperm(N - 1, generator=torch.Generator().manual_seed(7)) + 1).tolist()
    tables = torch.zeros(B, MB, dtype=torch.int32)
    for b, n in enumerate(need):
        for i in range(n):
            tables[b, i] = perm.pop()
    q = torch.randn(B, H, D, generator=gen, device="cuda").to(torch.bfloat16)
    k_pool = torch.randn(N, P, KH, D, generator=gen, device="cuda").to(torch.bfloat16)
    v_pool = torch.randn(N, P, KH, D, generator=gen, device="cuda").to(torch.bfloat16)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, k_pool, v_pool, tables.cuda(), lens


def check_paged_decode_attention(gen) -> dict:
    import torch.nn.functional as F

    from aios_tpu_torch.ops import (
        gather_pages, paged_decode_attention, paged_decode_attention_reference,
    )

    lengths = [0, 1, 127, 128, 129, 700, 1500, 2047]
    q, k_pool, v_pool, tables, lens = _paged_case(gen, lengths)
    B = len(lengths)
    sink = 128
    ws = torch.tensor([0, 0, 0, 0, 256, 384, 1024, 1536], dtype=torch.int32, device="cuda")
    worst = 0.0
    headline = None
    for label, kw in (
        ("no window", {}),
        ("window=512", {"window": 512}),
        ("sink=128 win_starts", {"win_starts": ws, "sink": sink}),
    ):
        out = paged_decode_attention(q, k_pool, v_pool, tables, lens, **kw)
        ref = paged_decode_attention_reference(q, k_pool, v_pool, tables, lens, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        ok = bool(torch.isfinite(out).all()) and torch.allclose(
            out.float(), ref.float(), atol=TOL, rtol=TOL)
        ms = time_ms(lambda: paged_decode_attention(q, k_pool, v_pool, tables, lens, **kw))
        plain = time_ms(lambda: paged_decode_attention_reference(
            q, k_pool, v_pool, tables, lens, **kw))
        C = tables.shape[1] * P
        cols = torch.arange(C, device="cuda")[None, :]
        lcol = lens.long()[:, None]
        live = cols <= lcol
        if "window" in kw:
            live &= cols > lcol - kw["window"]
        if "win_starts" in kw:
            live &= (cols < sink) | (cols >= ws.long()[:, None])
        kg = gather_pages(k_pool, tables).transpose(1, 2).contiguous()  # [B, KH, C, D]
        vg = gather_pages(v_pool, tables).transpose(1, 2).contiguous()
        q4 = q[:, :, None, :]
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q4, kg, vg, attn_mask=live[:, None, None, :], enable_gqa=True))
        rows = float(live.sum().item())
        nbytes = rows * KH * D * 2 * 2 + 2 * B * H * D * 2 + tables.numel() * 4 + B * 4
        bnd = bound_ms(nbytes, 4.0 * rows * H * D)
        _report("paged_decode_attention", f"B=8 lengths={lengths} {label}", ms, plain,
                lib, bnd, err, ok)
        expect(ok, f"paged_decode_attention {label}: max err {err}")
        worst = max(worst, err)
        if not kw:
            headline = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd[0],
                            bound_by=bnd[1], measured_at="one launch, 8 ragged slots")
    headline["max_abs_err"] = worst
    return headline


def phase_kernels() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    return {
        "quantized_matmul": check_quantized_matmul(gen),
        "flash_attention": check_flash_attention(gen),
        "paged_decode_attention": check_paged_decode_attention(gen),
    }


# -- phase 4: serve TinyLlama-1.1B over gRPC through the kernels ---------------

PROMPTS = (  # chat-templated byte prompts land in buckets 256, 512, 1024, 2048
    "Summarize the state of the cluster. " * 6,
    "List the failing services and why. " * 12,
    "Draft a remediation plan, step by step. " * 24,
    "Explain every alert from the last hour. " * 45,
)
MAX_TOKENS = 64


def phase_serve(manager, stub, card: str) -> dict:
    from aios_tpu_torch import ops
    from aios_tpu_torch.engine.tokenizer import render_chat
    from aios_tpu_torch.proto_gen import common_pb2, runtime_pb2

    t0 = time.perf_counter()
    st = stub.LoadModel(runtime_pb2.LoadModelRequest(
        model_name="tinyllama", model_path="synthetic://tinyllama-1.1b"), timeout=900)
    load_s = time.perf_counter() - t0
    expect(st.status == "ready", f"LoadModel returned {st.status!r}")
    m = manager.get("tinyllama")
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
    # one short request first, so the counted window excludes one-time setup
    stub.Infer(runtime_pb2.InferRequest(prompt="warm up", max_tokens=4), timeout=300)

    for k in ops.KERNELS:
        k.launches = 0
    tokens0, steps0, prefills0 = m.batcher.tokens_emitted, eng.decode_steps, eng.prefills
    results, errors = {}, []
    stream_first = []

    def infer(i):
        r = stub.Infer(runtime_pb2.InferRequest(
            prompt=PROMPTS[i], max_tokens=MAX_TOKENS, temperature=0.5), timeout=600)
        results[i] = r

    def stream(i):
        t = time.perf_counter()
        chunks = []
        for c in stub.StreamInfer(runtime_pb2.InferRequest(
                prompt=PROMPTS[i], max_tokens=MAX_TOKENS, temperature=0.5), timeout=600):
            if not chunks:
                stream_first.append(time.perf_counter() - t)
            chunks.append(c)
        results[i] = chunks

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
    for i in range(3):
        n_prompt = len(m.tokenizer.encode(render_chat(cfg.name, PROMPTS[i])))
        expect(results[i].tokens_used > n_prompt, f"Infer {i} returned no tokens")
    chunks = results[3]
    expect(chunks and chunks[-1].done and all(not c.done for c in chunks[:-1]),
           "StreamInfer did not end with one done chunk")
    expect(tokens >= 4, f"only {tokens} tokens emitted")
    models = stub.ListModels(common_pb2.Empty())
    health = stub.HealthCheck(common_pb2.Empty())
    expect([x.model_name for x in models.models] == ["tinyllama"], "ListModels")
    expect(health.details.get("backend") == "torch-cuda", f"HealthCheck {dict(health.details)}")
    for name, n in launches.items():
        expect(n > 0, f"kernel {name} never launched while serving")
    log(
        f"[serve] 3 Infer + 1 StreamInfer (prompts {[len(p) for p in PROMPTS]} chars, "
        f"max_tokens {MAX_TOKENS}) in {wall:.3f} s: {tokens} tokens, "
        f"{tokens / wall:.1f} tok/s end to end on {card}; "
        f"{eng.prefills - prefills0} prefills, {eng.decode_steps - steps0} decode steps; "
        f"launches {launches}"
    )
    log(f"[serve] health: {health.details.get('tinyllama.serving')}")
    return launches


# -- phase 5: model numerics, determinism and where the time goes --------------


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def phase_numerics(manager, card: str) -> None:
    from aios_tpu_torch.engine import model
    from aios_tpu_torch.engine.batching import Request

    m = manager.get("tinyllama")
    eng, cfg, params = m.engine, m.config, m.engine.params
    gen = torch.Generator(device="cuda").manual_seed(1)
    T = 512
    tokens = torch.randint(0, 256, (1, T), generator=gen, device="cuda")
    lk, _, _ = model.prefill(params, cfg, tokens, kernels=True)
    lp, ksp, vsp = model.prefill(params, cfg, tokens, kernels=False)
    rel_prefill = _rel(lk, lp)
    # one decode step for 8 ragged slots over pools holding that prompt's K/V
    B, L = 8, cfg.num_layers
    nb = T // P
    k_pool = torch.zeros((L, 1 + B * nb, P, KH, D), dtype=torch.bfloat16, device="cuda")
    v_pool = torch.zeros_like(k_pool)
    order = torch.randperm(B * nb, generator=torch.Generator().manual_seed(3)) + 1
    tables = order.reshape(B, nb).to(torch.int32)
    tables = torch.cat([tables, torch.zeros(B, 16 - nb, dtype=torch.int32)], 1).cuda()
    for b in range(B):
        pages = tables[b, :nb].long()
        k_pool[:, pages] = ksp[:, 0].reshape(L, nb, P, KH, D).to(torch.bfloat16)
        v_pool[:, pages] = vsp[:, 0].reshape(L, nb, P, KH, D).to(torch.bfloat16)
    lengths = torch.tensor([0, 5, 127, 128, 200, 300, 400, 510], dtype=torch.int32, device="cuda")
    step_tokens = torch.randint(0, 256, (B,), generator=gen, device="cuda")
    dk = model.decode_step_paged(params, cfg, step_tokens, lengths, k_pool.clone(),
                                 v_pool.clone(), tables, kernels=True)
    dp = model.decode_step_paged(params, cfg, step_tokens, lengths, k_pool.clone(),
                                 v_pool.clone(), tables, kernels=False)
    rel_decode = _rel(dk, dp)
    ok = (rel_prefill <= E2E_TOL and rel_decode <= E2E_TOL
          and bool(torch.isfinite(lk).all()) and bool(torch.isfinite(dk).all()))
    log(
        f"[numerics] kernel path vs plain path, full model: prefill T={T} "
        f"max|dlogit|/max|logit|={rel_prefill:.3e}, decode step B=8 "
        f"max|dlogit|/max|logit|={rel_decode:.3e} (limit {E2E_TOL}); "
        f"prefill argmax agreement {(lk.argmax(-1) == lp.argmax(-1)).float().mean().item():.3f}, "
        f"decode {(dk.argmax(-1) == dp.argmax(-1)).float().mean().item():.3f}"
    )
    expect(ok, "kernel and plain logits disagree")

    ids = [256] + list(range(200))
    a = m.batcher.generate(ids, max_tokens=32, temperature=0.0)
    b = m.batcher.generate(ids, max_tokens=32, temperature=0.0)
    expect(len(a) == 32 and a == b, f"greedy streams differ: {a} vs {b}")
    log(f"[numerics] two greedy batcher streams of 32 tokens identical: {a[:8]}...")

    # time to first token and decode rate on the idle server
    for n in (250, 1000):
        h = m.batcher.submit(Request(prompt_ids=[256] + [65] * n, max_tokens=2,
                                     temperature=0.0))
        h.tokens()
        log(f"[serve] ttft_ms={h.ttft_ms:.2f} for a {n + 1}-token prompt "
            f"(bucket {eng.bucket_for(n + 1)}) on an idle server, {card}")
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

    # one profiled 16-step decode dispatch with all slots active
    for s in range(eng.num_slots):
        eng.prefill(s, [256] + list(range(300)), temperature=0.7, top_p=0.95)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step(16)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    for s in range(eng.num_slots):
        eng.release(s)
    events = [e for e in prof.key_averages() if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")]
    dev_us = {e.key: e.self_device_time_total for e in events if e.self_device_time_total > 0}
    busy = sum(dev_us.values())
    n_kernels = sum(e.count for e in events if e.self_device_time_total > 0)
    log(f"[profile] 16 decode steps, 8 slots at ~300 rows: wall {wall * 1e3:.2f} ms, "
        f"device busy {busy / 1e3:.2f} ms ({busy / 1e3 / (wall * 1e3):.1%} of wall), "
        f"{n_kernels / 16:.0f} device kernels per step, {card}")
    for key, us in sorted(dev_us.items(), key=lambda kv: -kv[1])[:12]:
        log(f"[profile]   {us / 1e3:9.3f} ms  {key[:110]}")


# -- main ----------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing ran",
              file=sys.stderr)
        return 2
    card = phase_device()
    phase_build()
    measured = phase_kernels()

    from aios_tpu_torch import rpc, services
    from aios_tpu_torch.runtime.model_manager import ModelManager
    from aios_tpu_torch.runtime.service import serve

    manager = ModelManager(num_slots=8)
    server, _, port = serve("127.0.0.1:0", manager, block=False)
    channel = rpc.insecure_channel(f"127.0.0.1:{port}")
    try:
        launches = phase_serve(manager, services.AIRuntimeStub(channel), card)
        phase_numerics(manager, card)
    finally:
        manager.close()
        channel.close()
        server.stop(grace=None)

    kernels = []
    for name, meta in KERNEL_META.items():
        r = measured[name]
        kernels.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
        log(f"[kernels] {name}: ok, {launches[name]} launches while serving, "
            f"{r['measured_at']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
