#!/usr/bin/env python3
"""Device time of the dense-cache decode attention kernel (K8) at every split
count it can take, on one CUDA device: the shapes its dense servers give it
(TinyLlama-1.1B, 8 slots over a 2048-row cache; Mistral-7B heads over 8192
rows with its 4096-row window), all slots full, and every slot at length 0
(one visible row: the launch's fixed cost). ``split_plan`` is overridden for
each count; each output is checked against ``decode_attention_reference``
and against a second launch, bit for bit. Times are ``chip_smoke.time_ms``
(median of 20, L2 flushed, stream held). Weights are random from a seed.

Run from the repository root:  python3 aios_tpu_torch/tools/split_sweep.py
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


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("split_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from aios_tpu_torch import ops

    dattn = importlib.import_module("aios_tpu_torch.ops.decode_attention")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    planned = dattn.split_plan
    try:
        for label, H, KH, D, C, window, lengths in CASES:
            B = len(lengths)
            q = torch.randn(B, H, D, generator=gen, device="cuda").to(torch.bfloat16)
            kc, vc = (torch.randn(B, C, KH, D, generator=gen, device="cuda").to(torch.bfloat16)
                      for _ in range(2))
            lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            ref = ops.decode_attention_reference(q, kc, vc, lens, window=window)
            plan = planned(C, B, KH, torch.cuda.get_device_properties(0).multi_processor_count)
            for n in range(1, dattn.MAX_SPLITS + 1):
                dattn.split_plan = lambda *_, n=n: n
                out = ops.decode_attention(q, kc, vc, lens, window=window)
                err = (out.float() - ref.float()).abs().max().item()
                same = torch.equal(out, ops.decode_attention(q, kc, vc, lens, window=window))
                ms = chip_smoke.time_ms(lambda: ops.decode_attention(q, kc, vc, lens, window=window))
                print(f"[split_sweep] {label}: splits={n}{' (plan)' if n == plan else ''} "
                      f"ms={ms:.4f} max_abs_err={err:.3e} repeat_identical={same}", flush=True)
    finally:
        dattn.split_plan = planned
    print(f"[split_sweep] empty kernel under time_ms: "
          f"{chip_smoke.time_ms(lambda: torch.cuda._sleep(1)):.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
