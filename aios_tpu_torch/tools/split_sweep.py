#!/usr/bin/env python3
"""Device time of the split decode attention kernels at every split count
they can take, on one CUDA device.

Over the dense cache, at the shapes its servers give them: K8
(``decode_attention``) for TinyLlama-1.1B, 8 slots over a 2048-row cache,
and Mistral-7B heads over 8192 rows with its 4096-row window; K9
(``decode_attention_int8``) for Mistral-7B with and without the window;
K6 (``multiquery_decode_attention``) for TinyLlama-1.1B's verify round
(T = 8), at T = 31, and at Mistral-7B's heads with the window; K7
(``multiquery_decode_attention_int8``) for Mistral-7B's verify round (T = 8)
with the window. Each at its headline lengths (those of ``chip_smoke.py``),
all slots full, every slot at length 0 (one visible row: the launch's fixed
cost) and, for K9, K6 and K7, the lengths of a served window (8 slots, ~300
rows each).

K3 (``paged_decode_attention``, bf16 pool) and K4
(``paged_decode_attention_int8``, int8 pool) at the shapes the paged
servers give them: TinyLlama-1.1B over 16 pages of 128 rows a slot;
Mistral-7B over 64 pages, with and without its 4096-row window; all slots
full; every slot at length 0; the lengths of a served decode window.

``split_plan`` is overridden for each count; each output is checked
against the plain version (within ``chip_smoke.TOL``) and against a second
launch, bit for bit, and the script exits 1 if any fails. Times are
``chip_smoke.time_ms`` (median of 20, L2 flushed, stream held). Inputs are
random from a seed.

Designs that were measured and not kept are patches beside this script:
``tools/paged_variants/`` for ``csrc/paged_attention.cu`` and the shared
header (``d64_default_bound``: K3/K4's D = 64 builds at the compiler's
default bound; ``no_least_share``: equal shares at D = 128 too, for K4 and
K9), ``tools/dense_variants/`` for ``csrc/dense_attention.cu``. To time
one, apply it to a copy of the tree (``git apply``) and run this script
there and in the tree, alternating, in one call on the card.

Run from the repository root:
    python3 aios_tpu_torch/tools/split_sweep.py [--only NAME ...]
Prints one line per case and count, and the card as nvidia-smi names it.
"""

from __future__ import annotations

import argparse
import importlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
TINY, MISTRAL = (32, 4, 64), (32, 8, 128)
TINY_LENS = [0, 1, 127, 128, 700, 1500, 2000, 2046]
MISTRAL_LENS = [0, 1, 127, 1000, 4095, 4096, 6000, 8190]
SERVED = [290, 295, 300, 305, 310, 315, 320, 325]  # a served window's slots
CASES = (  # (kernel, label, (H, KH, D), C, window, T (None: one query), lengths)
    ("decode_attention", "TinyLlama C=2048", TINY, 2048, None, None, TINY_LENS),
    ("decode_attention", "Mistral C=8192 window=4096", MISTRAL, 8192, 4096, None,
     MISTRAL_LENS),
    ("decode_attention", "TinyLlama C=2048 all full", TINY, 2048, None, None, [2047] * 8),
    ("decode_attention", "TinyLlama C=2048 all at length 0", TINY, 2048, None, None, [0] * 8),
    ("decode_attention_int8", "Mistral C=8192 window=4096", MISTRAL, 8192, 4096, None,
     MISTRAL_LENS),
    ("decode_attention_int8", "Mistral C=8192 no window", MISTRAL, 8192, None, None,
     MISTRAL_LENS),
    ("decode_attention_int8", "Mistral C=8192 all full, no window", MISTRAL, 8192, None,
     None, [8191] * 8),
    ("decode_attention_int8", "Mistral C=8192 all at length 0", MISTRAL, 8192, None, None,
     [0] * 8),
    ("decode_attention_int8", "Mistral C=8192 window=4096 served, ~300 rows", MISTRAL, 8192,
     4096, None, SERVED),
    ("multiquery_decode_attention", "TinyLlama C=2048 T=8", TINY, 2048, None, 8,
     TINY_LENS[:-1] + [2040]),
    ("multiquery_decode_attention", "TinyLlama C=2048 T=31", TINY, 2048, None, 31,
     TINY_LENS[:-1] + [2017]),
    ("multiquery_decode_attention", "Mistral heads C=8192 window=4096 T=8", MISTRAL, 8192,
     4096, 8, MISTRAL_LENS[:-1] + [8184]),
    ("multiquery_decode_attention", "TinyLlama C=2048 T=8 all full", TINY, 2048, None, 8,
     [2040] * 8),
    ("multiquery_decode_attention", "TinyLlama C=2048 T=8 all at length 0", TINY, 2048, None,
     8, [0] * 8),
    ("multiquery_decode_attention", "TinyLlama C=2048 T=8 served, ~300 rows", TINY, 2048,
     None, 8, SERVED),
    ("multiquery_decode_attention_int8", "Mistral C=8192 window=4096 T=8", MISTRAL, 8192, 4096,
     8, MISTRAL_LENS[:-1] + [8184]),
    ("multiquery_decode_attention_int8", "Mistral C=8192 T=8 all full, no window", MISTRAL,
     8192, None, 8, [8184] * 8),
    ("multiquery_decode_attention_int8", "Mistral C=8192 T=8 all at length 0", MISTRAL, 8192,
     None, 8, [0] * 8),
    ("multiquery_decode_attention_int8", "Mistral C=8192 window=4096 T=8 served, ~300 rows",
     MISTRAL, 8192, 4096, 8, SERVED),
)
PAGE = 128
PAGED_CASES = (  # (kernel, label, H, KH, D, pages per slot, window, lengths)
    ("paged_decode_attention", "TinyLlama C=2048", 32, 4, 64, 16, None,
     [0, 1, 127, 128, 129, 700, 1500, 2047]),
    ("paged_decode_attention", "TinyLlama C=2048 all full", 32, 4, 64, 16, None, [2047] * 8),
    ("paged_decode_attention", "TinyLlama C=2048 all at length 0", 32, 4, 64, 16, None,
     [0] * 8),
    ("paged_decode_attention_int8", "Mistral C=8192 window=4096", 32, 8, 128, 64, 4096,
     [0, 1, 127, 128, 1000, 4095, 4096, 8191]),
    ("paged_decode_attention_int8", "Mistral C=8192 no window", 32, 8, 128, 64, None,
     [0, 1, 127, 128, 1000, 4095, 4096, 8191]),
    ("paged_decode_attention_int8", "Mistral C=8192 all full, no window", 32, 8, 128, 64,
     None, [8191] * 8),
    ("paged_decode_attention_int8", "Mistral C=8192 all at length 0", 32, 8, 128, 64, None,
     [0] * 8),
    ("paged_decode_attention", "TinyLlama C=2048 served, ~300 rows", 32, 4, 64, 16, None,
     SERVED),
    ("paged_decode_attention_int8", "Mistral C=8192 window=4096 served, ~300 rows", 32, 8,
     128, 64, 4096, SERVED),
)


def _paged_operands(torch, gen, H, KH, D, MB, window, lengths, quant):
    """Pools over shuffled pages (page 0 sacrificial: inactive slots and
    pages wholly below the window map it), q, tables and lengths."""
    need = [-(-(n + 1) // PAGE) for n in lengths]
    N = 1 + sum(need) + 3
    perm = (torch.randperm(N - 1, generator=torch.Generator().manual_seed(7)) + 1).tolist()
    tables = torch.zeros(len(lengths), MB, dtype=torch.int32)
    for b, n in enumerate(need):
        first = max(lengths[b] + 1 - window, 0) // PAGE if window else 0
        for i in range(n):
            page = perm.pop()
            if lengths[b] and i >= first:
                tables[b, i] = page
    q = torch.randn(len(lengths), H, D, generator=gen, device="cuda").to(torch.bfloat16)
    if quant:
        pools = [torch.randint(-127, 128, (N, PAGE, KH, D), generator=gen,
                               device="cuda").to(torch.int8) for _ in range(2)]
        pools += [torch.rand(N, PAGE, KH, generator=gen, device="cuda") * 0.015 + 0.005
                  for _ in range(2)]
    else:
        pools = [torch.randn(N, PAGE, KH, D, generator=gen, device="cuda").to(torch.bfloat16)
                 for _ in range(2)]
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return (q, *pools, tables.cuda(), lens)


def _dense_operands(torch, gen, H, KH, D, C, T, lengths, quant):
    """q, the caches (and scales), lengths and, with T, the strides: a slot
    at length 0 is inactive (stride 0, one visible row), as chip_smoke's
    slot 0 is."""
    B = len(lengths)
    q = torch.randn(B, T or 1, H, D, generator=gen, device="cuda").to(torch.bfloat16)
    if quant:
        caches = [torch.randint(-127, 128, (B, C, KH, D), generator=gen,
                                device="cuda").to(torch.int8) for _ in range(2)]
        caches += [torch.rand(B, C, KH, generator=gen, device="cuda") * 0.015 + 0.005
                   for _ in range(2)]
    else:
        caches = [torch.randn(B, C, KH, D, generator=gen, device="cuda").to(torch.bfloat16)
                  for _ in range(2)]
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    if T is None:
        return (q[:, 0].contiguous(), *caches, lens)
    strides = torch.tensor([int(n > 0) for n in lengths], dtype=torch.int32, device="cuda")
    return (q, *caches, lens, strides)


def _sweep(module, name, label, operands, window, plan, failed):
    """One case at every split count, ``module.split_plan`` overridden."""
    import chip_smoke
    import torch
    from aios_tpu_torch import ops
    from aios_tpu_torch.ops import split

    fn, ref_fn = getattr(ops, name), getattr(ops, f"{name}_reference")
    ref = ref_fn(*operands, window=window)
    planned = module.split_plan
    try:
        for n in range(1, split.MAX_SPLITS + 1):
            module.split_plan = lambda *_, n=n: n
            out = fn(*operands, window=window)
            err = (out.float() - ref.float()).abs().max().item()
            same = torch.equal(out, fn(*operands, window=window))
            ms = chip_smoke.time_ms(lambda: fn(*operands, window=window))
            if err > chip_smoke.TOL or not same:
                failed.append((f"{name} {label}", n))
            print(f"[split_sweep] {name} {label}: splits={n}"
                  f"{' (plan)' if n == plan else ''} ms={ms:.4f} max_abs_err={err:.3e} "
                  f"repeat_identical={same}", flush=True)
    finally:
        module.split_plan = planned


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="*", default=None,
                    help="kernels to sweep (default: all six)")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("split_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke

    dattn = importlib.import_module("aios_tpu_torch.ops.decode_attention")
    pattn = importlib.import_module("aios_tpu_torch.ops.paged_attention")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    failed = []  # (case, count) whose output is off its plain version or does not repeat
    wanted = set(args.only) if args.only else None
    for name, label, (H, KH, D), C, window, T, lengths in CASES:
        if wanted is not None and name not in wanted:
            continue
        operands = _dense_operands(torch, gen, H, KH, D, C, T, lengths, name.endswith("int8"))
        _sweep(dattn, name, label, operands, window, dattn.split_plan(C, len(lengths), KH, sms),
               failed)
        del operands
        torch.cuda.empty_cache()

    for name, label, H, KH, D, MB, window, lengths in PAGED_CASES:
        if wanted is not None and name not in wanted:
            continue
        quant = name.endswith("int8")
        operands = _paged_operands(torch, gen, H, KH, D, MB, window, lengths, quant)
        _sweep(pattn, name, label, operands, window,
               pattn.split_plan(MB * PAGE, len(lengths), KH, sms), failed)
        del operands
        torch.cuda.empty_cache()
    print(f"[split_sweep] empty kernel under time_ms: "
          f"{chip_smoke.time_ms(lambda: torch.cuda._sleep(1)):.4f} ms", flush=True)
    if failed:
        print(f"[split_sweep] FAILED (off the plain version by more than {chip_smoke.TOL}, "
              f"or not bit-identical on repeat): {failed}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
