#!/usr/bin/env python3
"""First check of the decode and admission graphs on a CUDA device, in about
a minute of card time after the build: a full-width TinyLlama-1.1B engine
(int8 weights, random from a seed) over the paged pool and over the dense
cache captures its graphs at ``warmup``; every admission graph kind is held
against its eager twin (``chip_smoke._admission_graphs``: a bucket, mid and
final chunks, over the pool a prefix hit's tail; bit-identical logits and
cache rows, exact launches, fresh noise, timed both ways); 8 greedy slots
at ~300 rows then
dispatch 16 steps (8 speculative rounds on the dense cache) through the
graph and again through the eager body from the same state, and the
tokens, the last logits and the launch counts must agree; both are timed
on the host clock; sampled slots over a flat distribution must draw other
tokens when one step is replayed from the same state; and one replayed
dispatch runs under torch.profiler (device kernels and busy time per
step). Run from the repository root, before ``chip_smoke.py`` after a
change to the capture:
    python3 aios_tpu_torch/tools/graph_probe.py
Exits 1 if anything disagrees.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from aios_tpu_torch import ops  # noqa: E402
from aios_tpu_torch.engine.config import TINYLLAMA_1_1B  # noqa: E402
from aios_tpu_torch.engine.engine import TorchEngine  # noqa: E402
from aios_tpu_torch.engine.weights import init_params  # noqa: E402
from chip_smoke import REPEATING, _admission_graphs  # noqa: E402
from chip_smoke import _restore as restore, _snapshot as snapshot  # noqa: E402


def against_eager(eng, graph, eager, n: int) -> bool:
    """Dispatch ``n`` through ``graph`` and ``eager`` from one state; print
    and return whether tokens, last logits and launches agree."""
    snap = snapshot(eng)
    runs = []
    for fn in (graph, eager):
        restore(eng, snap)
        for k in ops.KERNELS:
            k.launches = 0
        out = fn(n)
        out = out if isinstance(out, tuple) else (out,)
        runs.append((out, eng.last_logits.clone(),
                     {k.__name__: k.launches for k in ops.KERNELS if k.launches}))
    (a, la, na), (b, lb, nb) = runs
    same = all(np.array_equal(x, y) for x, y in zip(a, b))
    print(f"  graph vs eager over {n}: tokens equal {same}, logits equal "
          f"{torch.equal(la, lb)}, launches {na} / {nb}", flush=True)
    for fn, name in ((graph, "graph"), (eager, "eager")):
        fn(n)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(n)
        torch.cuda.synchronize()
        print(f"  {name}: {(time.perf_counter() - t0) / n * 1e3:.3f} ms per dispatch unit "
              "(host clock)", flush=True)
    return same and torch.equal(la, lb) and na == nb


def main() -> int:
    if not torch.cuda.is_available():
        print("graph_probe: no CUDA device", file=sys.stderr)
        return 1
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    t0 = time.perf_counter()
    ops.build_all()
    print(f"build {time.perf_counter() - t0:.1f}s", flush=True)
    params = init_params(TINYLLAMA_1_1B, torch.Generator(device="cuda").manual_seed(0))
    ok = True
    for paged in (True, False):
        kw = dict(paged_pool_rows=9 * 2048) if paged else {}
        eng = TorchEngine(TINYLLAMA_1_1B, params, quantize="int8", device="cuda", **kw)
        t0 = time.perf_counter()
        eng.warmup()
        print(f"paged={paged}: warmup {time.perf_counter() - t0:.2f}s, {eng.stats()}, "
              f"{eng.admission_graphs()} admission graphs in a shared pool of "
              f"{eng.admission_pool_bytes} B", flush=True)
        _admission_graphs(f"[probe paged={paged}]", SimpleNamespace(engine=eng),
                          torch.cuda.get_device_name(0))
        for s in range(8):
            eng.prefill(s, [256] + list(range(300 - 7 * s)), temperature=0.0)
        ok &= against_eager(eng, eng.step, eng.step_eager, 16)
        for s in range(8):
            eng.release(s)
        if not paged:
            for s in range(8):
                eng.prefill(s, REPEATING[: len(REPEATING) - s], temperature=0.0)
            ok &= against_eager(eng, eng.spec_step, eng.spec_step_eager, 8)
            for s in range(8):
                eng.release(s)
        for s in range(8):
            eng.prefill(s, [256] + list(range(100)), temperature=1e4, top_p=1.0)
        snap = snapshot(eng)
        first = eng.step(1)
        restore(eng, snap)
        differ = int((first != eng.step(1)).sum())
        print(f"  sampled: the replayed step differs in {differ} of 8 slots", flush=True)
        ok &= differ >= 4
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            eng.step(4)
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages() if e.self_device_time_total > 0
               and str(getattr(e, "device_type", "")).endswith("CUDA")]
        print(f"  profiled replays: {sum(e.count for e in dev) / 4} device kernels and "
              f"{sum(e.self_device_time_total for e in dev) / 4e3:.3f} ms busy per step",
              flush=True)
        eng.close()
    print("graph_probe: ok" if ok else "graph_probe: MISMATCH", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
