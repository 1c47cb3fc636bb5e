#!/usr/bin/env python3
"""Host cost of issuing the weight-quantized matmuls K1 and K5 and the
attention kernels K2, K3 and K8, and what a served decode dispatch costs on
the host and the device, for the ``aios_tpu_torch`` under ``--root``.

The decode-step sequences of K1 (TinyLlama-1.1B, 89 launches at M=8 and
M=64) and K5 (Mistral-7B, 129 launches at M=8) are issued through the
wrappers on per-layer views of stacked weights, as ``engine/model.py`` does;
so are a prefill's K2 launches (TinyLlama, 22 at T=512; Mistral-7B, 32 at
T=512 with its 4096-row window), a dense decode step's K8 launches
(TinyLlama, 22 over 8 slots of a 2048-row cache) and a paged decode step's
K3 launches (TinyLlama, 22 over 8 slots of 16 pages of 128 rows). Each
sequence is issued while the stream is held by a device sleep: the host's
time per call is then the issue cost alone (``held`` says the device was
still asleep when the host finished). One issue of each sequence runs
under ``cProfile``; ``cuTensorMapEncodeTiled`` is timed through
``ctypes``.

Then four served configurations at full width, 8 slots, each an engine made
and warmed as ``ModelManager`` makes it: TinyLlama paged (int8 weights,
bf16 pool), Mistral-7B paged (int4 weights, int8 pool, context 8192), and
both over the dense cache with n-gram speculation. For each: the host wall
per decode step (``step(16)``) or speculative round (``spec_step(8)``) with
the slots at ~300 rows, the median of twelve dispatches; one dispatch under
torch.profiler (device busy ms and share, kernels per step or round); and an
8-slot wave through the ``ContinuousBatcher`` (8 requests of 129 tokens,
host-clock tok/s). TinyLlama's paged ``step(16)`` also runs once under
cProfile. The two paged configurations also time admission as the batcher
calls it, from a cold prefix index: a whole-prompt ``prefill`` at buckets
512 and 2048 and a 512-row mid chunk of ``start_chunked_prefill`` at row
1024 (host wall, median of twelve synchronized calls; device busy of one
under torch.profiler; for the chunk also the host's time to return from
``step()``, unsynchronized). Weights are random from a seed.

Run from the repository root on a machine with one CUDA device, here or
against another checkout of the package, to compare two trees on one host
(alternate them: parent, change, change, parent); ``--configs`` names the
served configurations to run (all four by default):
    python3 aios_tpu_torch/tools/issue_cost.py [--root DIR] [--label NAME]
        [--configs tinyllama_paged,mistral_paged,tinyllama_dense_spec,mistral_dense_spec]
Prints profile lines and, last, one JSON object.
"""

from __future__ import annotations

import argparse
import cProfile
import ctypes
import io
import json
import pstats
import statistics
import sys
import time
from pathlib import Path

TINYLLAMA = (22, {"w_qkv": (2048, 2560), "wo": (2048, 2048), "w_gateup": (2048, 11264),
                  "w_down": (5632, 2048)}, (2048, 32000))
MISTRAL = (32, {"w_qkv": (4096, 6144), "wo": (4096, 4096), "w_gateup": (4096, 28672),
                "w_down": (14336, 4096)}, (4096, 32000))
CONFIGS = ("tinyllama_paged", "tinyllama_dense_spec", "mistral_paged", "mistral_dense_spec")
HOLD_CYCLES = 200_000_000  # about 0.1 s of SM clock: longer than any sequence's issue
REPEATS = 30


def _int8_leaves(torch, gen, layers, kn, head):
    leaves = {}
    for key, (K, N) in {**kn, "lm_head": head}.items():
        L = 1 if key == "lm_head" else layers
        q = torch.randint(-127, 128, (L, K, N), generator=gen, device="cuda").to(torch.int8)
        s = torch.rand(L, 1, N, generator=gen, device="cuda") * 3e-4 + 1e-5
        leaves[key] = (q, s, K)
    return leaves


def _int4_leaves(torch, gen, layers, kn, head):
    leaves = {}
    for key, (K, N) in {**kn, "lm_head": head}.items():
        L = 1 if key == "lm_head" else layers
        q = torch.randint(0, 256, (L, K // 2, N), generator=gen, device="cuda").to(torch.uint8)
        s = torch.rand(L, K // 128, 1, N, generator=gen, device="cuda") * 5e-3 + 1e-5
        leaves[key] = (q, s, K)
    return leaves


def _sequence(fn, leaves, layers, xs):
    """One decode step's calls, in the model's order, on per-layer views."""
    for i in range(layers):
        for key in ("w_qkv", "wo", "w_gateup", "w_down"):
            q, s, K = leaves[key]
            fn(xs[K], q[i], s[i])
    q, s, K = leaves["lm_head"]
    fn(xs[K], q[0], s[0])


def held_cost(torch, run, calls):
    """Median host microseconds per call of ``run`` (which issues ``calls``
    wrapper calls) with the stream held, the share of repeats in which the
    device was still held at the end, and a cProfile of one issue."""
    run()  # warm: libraries loaded, counters allocated
    torch.cuda.synchronize()
    per_call, held = [], 0
    for _ in range(REPEATS):
        torch.cuda._sleep(HOLD_CYCLES)
        asleep = torch.cuda.Event()
        asleep.record()
        t0 = time.perf_counter()
        run()
        dt = time.perf_counter() - t0
        held += not asleep.query()
        torch.cuda.synchronize()
        per_call.append(dt / calls * 1e6)
    prof = cProfile.Profile()
    torch.cuda._sleep(HOLD_CYCLES)
    prof.enable()
    run()
    prof.disable()
    torch.cuda.synchronize()
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(10)
    return statistics.median(per_call), held / REPEATS, calls, out.getvalue()


def issue_cost(torch, fn, leaves, layers, M, gen):
    """``held_cost`` of one decode step's matmul calls at M rows."""
    xs = {K: torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16)
          for K in {K for _, _, K in leaves.values()}}
    return held_cost(torch, lambda: _sequence(fn, leaves, layers, xs), 4 * layers + 1)


def flash_cost(torch, fn, gen, layers, T, H, KH, D, window):
    """``held_cost`` of one prefill's K2 calls on per-layer views of stacked
    [L, 1, T, heads, D] q, k and v."""
    q = torch.randn(layers, 1, T, H, D, generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn(layers, 1, T, KH, D, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(layers, 1, T, KH, D, generator=gen, device="cuda").to(torch.bfloat16)

    def run():
        for i in range(layers):
            fn(q[i], k[i], v[i], causal=True, window=window)

    return held_cost(torch, run, layers)


def decode_cost(torch, fn, gen, layers, B, C, H, KH, D):
    """``held_cost`` of one dense decode step's K8 calls on per-layer views
    of a stacked [L, B, C, KH, D] cache, 8 slots at ragged lengths."""
    q = torch.randn(layers, B, H, D, generator=gen, device="cuda").to(torch.bfloat16)
    kc = torch.randn(layers, B, C, KH, D, generator=gen, device="cuda").to(torch.bfloat16)
    vc = torch.randn(layers, B, C, KH, D, generator=gen, device="cuda").to(torch.bfloat16)
    lengths = torch.randint(0, C, (B,), generator=gen, device="cuda").to(torch.int32)

    def run():
        for i in range(layers):
            fn(q[i], kc[i], vc[i], lengths)

    return held_cost(torch, run, layers)


def paged_cost(torch, fn, gen, layers, B, MB, H, KH, D, page=128):
    """``held_cost`` of one paged decode step's K3 calls on per-layer views
    of a stacked [L, N, P, KH, D] pool, 8 slots at ragged lengths over
    shuffled pages of one table."""
    N = 1 + B * MB
    q = torch.randn(layers, B, H, D, generator=gen, device="cuda").to(torch.bfloat16)
    kp = torch.randn(layers, N, page, KH, D, generator=gen, device="cuda").to(torch.bfloat16)
    vp = torch.randn(layers, N, page, KH, D, generator=gen, device="cuda").to(torch.bfloat16)
    tables = (torch.randperm(N - 1, generator=torch.Generator().manual_seed(0))[:B * MB] + 1)
    tables = tables.reshape(B, MB).to(torch.int32).cuda()
    lengths = torch.randint(0, MB * page, (B,), generator=gen, device="cuda").to(torch.int32)

    def run():
        for i in range(layers):
            fn(q[i], kp[i], vp[i], tables, lengths)

    return held_cost(torch, run, layers)


def encode_cost():
    """Microseconds per cuTensorMapEncodeTiled call through ctypes (a
    2048 x 2560 int8 weight in 64 x 64 boxes), and per no-op libcuda call
    (cuDriverGetVersion) through ctypes, on the host."""
    cuda = ctypes.CDLL("libcuda.so.1")
    enc = cuda.cuTensorMapEncodeTiled
    u64, u32 = ctypes.c_uint64, ctypes.c_uint32
    buf = (ctypes.c_uint8 * 192)()
    mp = (ctypes.addressof(buf) + 63) // 64 * 64
    dims, strides = (u64 * 2)(2560, 2048), (u64 * 1)(2560)
    box, unit = (u32 * 2)(64, 64), (u32 * 2)(1, 1)
    ptr = ctypes.c_void_p(1 << 32)  # any 16-byte aligned address: nothing is read
    args = (ctypes.c_void_p(mp), 0, 2, ptr, dims, strides, box, unit, 0, 2, 3, 0)
    if enc(*args) != 0:
        return None, None
    n = 20000
    t0 = time.perf_counter()
    for _ in range(n):
        enc(*args)
    t_enc = (time.perf_counter() - t0) / n * 1e6
    v = ctypes.c_int()
    t0 = time.perf_counter()
    for _ in range(n):
        cuda.cuDriverGetVersion(ctypes.byref(v))
    return t_enc, (time.perf_counter() - t0) / n * 1e6


# the period-40 prompt of chip_smoke.py: the n-gram proposer finds drafts in it
REPEATING = [256] + [(i % 40) * 5 + 33 for i in range(240)]


def _timed(torch, fn, n: int = 12):
    """(median host wall ms of ``n`` synchronized calls, device busy ms of
    one under torch.profiler) of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and e.self_device_time_total > 0) / 1e3
    return statistics.median(walls), busy


def admission(torch, eng):
    """Host wall and device busy of whole-prompt prefills at buckets 512 and
    2048 and of a 512-row mid chunk at row 1024, through the calls the
    batcher makes, slot 0 from a cold index; the mid chunk's host time to
    return from ``step()`` (median of twelve, unsynchronized). Returns
    them and a cProfile of five mid chunks issued back to back."""
    out = {}

    def clear():
        if eng.prefix_index is not None:
            eng.prefix_index.clear()

    def prompt(n):
        return [256] + [(i * 7 + 3) % 256 for i in range(n - 1)]

    for n in (500, 2000):
        ids = prompt(n)

        def admit(ids=ids):
            clear()
            eng.prefill(0, ids, temperature=0.0)
            eng.release(0)

        b = eng.bucket_for(n)
        out[f"prefill_b{b}_ms"], out[f"prefill_b{b}_busy_ms"] = _timed(torch, admit)
    clear()
    pc = eng.start_chunked_prefill(0, prompt(2000), temperature=0.0, chunk=512)
    pc.step()
    pc.step()

    def mid():
        pc.pos = 1024
        pc.step()

    out["chunk_ms"], out["chunk_busy_ms"] = _timed(torch, mid)
    issue = []
    for _ in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mid()
        issue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    out["chunk_issue_ms"] = statistics.median(issue)
    cp = cProfile.Profile()
    cp.enable()
    for _ in range(5):
        mid()
    cp.disable()
    torch.cuda.synchronize()
    eng.release(0)
    buf = io.StringIO()
    pstats.Stats(cp, stream=buf).sort_stats("tottime").print_stats(12)
    return out, buf.getvalue()


def served(torch, cfg, params, spec, label, **kw):
    """Host wall per step or round, device busy per dispatch and the 8-slot
    wave of one engine made with ``kw`` and warmed; see the module
    docstring. Returns (numbers, cProfile text of one dispatch)."""
    from torch.profiler import ProfilerActivity, profile

    from aios_tpu_torch.engine.batching import ContinuousBatcher, Request
    from aios_tpu_torch.engine.engine import TorchEngine

    eng = TorchEngine(cfg, params, num_slots=8, track_history=spec, **kw)
    t0 = time.perf_counter()
    eng.warmup()
    out = {"warmup_s": time.perf_counter() - t0}
    n = 8 if spec else 16
    for s in range(eng.num_slots):
        if spec:
            eng.prefill(s, REPEATING, temperature=0.0)
        else:
            eng.prefill(s, [256] + list(range(300)), temperature=0.7, top_p=0.95)
    dispatch = (lambda: eng.spec_step(n)) if spec else (lambda: eng.step(n))
    dispatch()
    torch.cuda.synchronize()
    walls = []
    for _ in range(12):
        t0 = time.perf_counter()
        dispatch()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / n * 1e3)
    out["ms"], out["ms_all"] = statistics.median(walls), walls
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dispatch()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    out.update(busy_ms=busy / n, busy_share=busy / (wall * 1e3),
               kernels=sum(e.count for e in kernels) / n)
    text = ""
    if label == "tinyllama_paged":
        cp = cProfile.Profile()
        cp.enable()
        dispatch()
        torch.cuda.synchronize()
        cp.disable()
        buf = io.StringIO()
        pstats.Stats(cp, stream=buf).sort_stats("tottime").print_stats(15)
        text = buf.getvalue()
    for s in range(eng.num_slots):
        eng.release(s)
    if eng.paged:
        numbers, chunk_prof = admission(torch, eng)
        out.update(numbers)
        text += f"[{label}] five mid chunks under cProfile\n{chunk_prof}"
    batcher = ContinuousBatcher(eng, speculative=spec)
    prompt = REPEATING if spec else [256] + list(range(100))
    t0 = time.perf_counter()
    hs = [batcher.submit(Request(prompt_ids=prompt, max_tokens=129,
                                     temperature=0.0 if spec else 0.7))
          for _ in range(eng.num_slots)]
    tokens = sum(len(h.tokens()) for h in hs)
    out["wave_tok_s"] = tokens / (time.perf_counter() - t0)
    batcher.shutdown()
    out["graph_captures"] = eng.stats().get("graph_captures")
    eng.close()
    return out, text


def serving(torch, gen, label, configs):
    """``served`` for the configurations named in ``configs``, TinyLlama
    first."""
    from aios_tpu_torch.engine.config import MISTRAL_7B, TINYLLAMA_1_1B
    from aios_tpu_torch.engine.weights import init_params

    out, text = {}, ""
    for cfg, quant, cache, ctx in ((TINYLLAMA_1_1B, "int8", torch.bfloat16, 2048),
                                   (MISTRAL_7B, "int4", torch.int8, 8192)):
        name = "tinyllama" if cfg is TINYLLAMA_1_1B else "mistral"
        keys = {paged: f"{name}_{'paged' if paged else 'dense_spec'}" for paged in (True, False)}
        if not set(keys.values()) & configs:
            continue
        params = init_params(cfg, gen)
        for paged in (True, False):
            key = keys[paged]
            if key not in configs:
                continue
            kw = dict(quantize=quant, cache_dtype=cache, max_context=ctx)
            if paged:
                kw["paged_pool_rows"] = 9 * ctx
            numbers, prof = served(torch, cfg, params, not paged, key, **kw)
            text += prof
            out.update({f"{key}_{k}": v for k, v in numbers.items()})
            print(f"[{label}] {key}: {json.dumps(numbers)}", flush=True)
            torch.cuda.empty_cache()
        del params
        torch.cuda.empty_cache()
    return out, text


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="directory holding the aios_tpu_torch package to measure")
    ap.add_argument("--label", default="")
    ap.add_argument("--configs", default=",".join(CONFIGS),
                    help="comma-separated served configurations to run")
    args = ap.parse_args()
    configs = set(args.configs.split(","))
    if not configs <= set(CONFIGS):
        ap.error(f"--configs takes {', '.join(CONFIGS)}")
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("issue_cost: no CUDA device", file=sys.stderr)
        return 1
    import aios_tpu_torch
    from aios_tpu_torch import ops

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"label": args.label, "package": str(Path(aios_tpu_torch.__file__).parent),
           "card": torch.cuda.get_device_name(0)}
    k1 = _int8_leaves(torch, gen, *TINYLLAMA)
    for M in (8, 64):
        us, held, calls, prof = issue_cost(torch, ops.quantized_matmul, k1, TINYLLAMA[0], M, gen)
        out[f"k1_m{M}_us_per_call"], out[f"k1_m{M}_held"] = us, held
        print(f"[{args.label}] K1 M={M}: {calls} calls, {us:.2f} us each\n{prof}")
    del k1
    k5 = _int4_leaves(torch, gen, *MISTRAL)
    us, held, calls, prof = issue_cost(torch, ops.int4_matmul, k5, MISTRAL[0], 8, gen)
    out["k5_m8_us_per_call"], out["k5_m8_held"] = us, held
    print(f"[{args.label}] K5 M=8: {calls} calls, {us:.2f} us each\n{prof}")
    del k5
    torch.cuda.empty_cache()
    for name, cfg in (("k2_tinyllama_t512", (TINYLLAMA[0], 512, 32, 4, 64, None)),
                      ("k2_mistral_t512", (MISTRAL[0], 512, 32, 8, 128, 4096))):
        us, held, calls, prof = flash_cost(torch, ops.flash_attention, gen, *cfg)
        out[f"{name}_us_per_call"], out[f"{name}_held"] = us, held
        print(f"[{args.label}] K2 {name}: {calls} calls, {us:.2f} us each\n{prof}")
    us, held, calls, prof = decode_cost(torch, ops.decode_attention, gen, TINYLLAMA[0], 8,
                                        2048, 32, 4, 64)
    out["k8_tinyllama_us_per_call"], out["k8_tinyllama_held"] = us, held
    print(f"[{args.label}] K8 TinyLlama step: {calls} calls, {us:.2f} us each\n{prof}")
    us, held, calls, prof = paged_cost(torch, ops.paged_decode_attention, gen, TINYLLAMA[0],
                                       8, 16, 32, 4, 64)
    out["k3_tinyllama_us_per_call"], out["k3_tinyllama_held"] = us, held
    print(f"[{args.label}] K3 TinyLlama step: {calls} calls, {us:.2f} us each\n{prof}")
    torch.cuda.empty_cache()
    out["encode_us"], out["ctypes_noop_us"] = encode_cost()
    numbers, prof = serving(torch, gen, args.label, configs)
    out.update(numbers)
    print(f"[{args.label}] TinyLlama paged step(16) under cProfile\n{prof}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
