#!/usr/bin/env python3
"""Device time of the split decode attention kernels at every split count
they can take, on one CUDA device.

K8 (``decode_attention``, the dense cache) at the shapes its dense servers
give it: TinyLlama-1.1B, 8 slots over a 2048-row cache; Mistral-7B heads
over 8192 rows with its 4096-row window; all slots full; every slot at
length 0 (one visible row: the launch's fixed cost).

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

Designs of ``csrc/paged_attention.cu`` that were measured and not kept are
patches in ``tools/paged_variants/`` (``d64_default_bound``: the D = 64
builds at the compiler's default bound; ``no_least_share``: equal shares
at D = 128 too). To time one, apply it to a copy of the tree
(``git apply``) and run this script there and in the tree, alternating, in
one call on the card.

Run from the repository root:
    python3 aios_tpu_torch/tools/split_sweep.py
Prints one line per case and count, and the card as nvidia-smi names it.
"""

from __future__ import annotations

import importlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CASES = (  # (label, H, KH, D, C, window, lengths)
    ("TinyLlama C=2048", 32, 4, 64, 2048, None, [0, 1, 127, 128, 700, 1500, 2000, 2046]),
    ("Mistral C=8192 window=4096", 32, 8, 128, 8192, 4096,
     [0, 1, 127, 1000, 4095, 4096, 6000, 8190]),
    ("TinyLlama C=2048 all full", 32, 4, 64, 2048, None, [2047] * 8),
    ("TinyLlama C=2048 all at length 0", 32, 4, 64, 2048, None, [0] * 8),
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
    # the lengths of a served decode window (8 slots, ~300 rows each)
    ("paged_decode_attention", "TinyLlama C=2048 served, ~300 rows", 32, 4, 64, 16, None,
     [290, 295, 300, 305, 310, 315, 320, 325]),
    ("paged_decode_attention_int8", "Mistral C=8192 window=4096 served, ~300 rows", 32, 8,
     128, 64, 4096, [290, 295, 300, 305, 310, 315, 320, 325]),
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


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("split_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from aios_tpu_torch import ops
    from aios_tpu_torch.ops import split

    dattn = importlib.import_module("aios_tpu_torch.ops.decode_attention")
    pattn = importlib.import_module("aios_tpu_torch.ops.paged_attention")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    failed = []  # (case, count) whose output is off its plain version or does not repeat
    planned = dattn.split_plan
    try:
        for label, H, KH, D, C, window, lengths in CASES:
            B = len(lengths)
            q = torch.randn(B, H, D, generator=gen, device="cuda").to(torch.bfloat16)
            kc, vc = (torch.randn(B, C, KH, D, generator=gen, device="cuda").to(torch.bfloat16)
                      for _ in range(2))
            lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            ref = ops.decode_attention_reference(q, kc, vc, lens, window=window)
            plan = planned(C, B, KH, sms)
            for n in range(1, split.MAX_SPLITS + 1):
                dattn.split_plan = lambda *_, n=n: n
                out = ops.decode_attention(q, kc, vc, lens, window=window)
                err = (out.float() - ref.float()).abs().max().item()
                same = torch.equal(out, ops.decode_attention(q, kc, vc, lens, window=window))
                ms = chip_smoke.time_ms(lambda: ops.decode_attention(q, kc, vc, lens, window=window))
                if err > chip_smoke.TOL or not same:
                    failed.append((f"decode_attention {label}", n))
                print(f"[split_sweep] decode_attention {label}: splits={n}"
                      f"{' (plan)' if n == plan else ''} ms={ms:.4f} max_abs_err={err:.3e} "
                      f"repeat_identical={same}", flush=True)
    finally:
        dattn.split_plan = planned

    planned = pattn.split_plan
    try:
        for name, label, H, KH, D, MB, window, lengths in PAGED_CASES:
            quant = name.endswith("int8")
            fn, ref_fn = getattr(ops, name), getattr(ops, f"{name}_reference")
            operands = _paged_operands(torch, gen, H, KH, D, MB, window, lengths, quant)
            ref = ref_fn(*operands, window=window)
            plan = planned(MB * PAGE, len(lengths), KH, sms)
            for n in range(1, split.MAX_SPLITS + 1):
                pattn.split_plan = lambda *_, n=n: n
                out = fn(*operands, window=window)
                err = (out.float() - ref.float()).abs().max().item()
                same = torch.equal(out, fn(*operands, window=window))
                ms = chip_smoke.time_ms(lambda: fn(*operands, window=window))
                if err > chip_smoke.TOL or not same:
                    failed.append((f"{name} {label}", n))
                print(f"[split_sweep] {name} {label}: splits={n}"
                      f"{' (plan)' if n == plan else ''} ms={ms:.4f} "
                      f"max_abs_err={err:.3e} repeat_identical={same}", flush=True)
            del operands, ref
            torch.cuda.empty_cache()
    finally:
        pattn.split_plan = planned
    print(f"[split_sweep] empty kernel under time_ms: "
          f"{chip_smoke.time_ms(lambda: torch.cuda._sleep(1)):.4f} ms", flush=True)
    if failed:
        print(f"[split_sweep] FAILED (off the plain version by more than {chip_smoke.TOL}, "
              f"or not bit-identical on repeat): {failed}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
