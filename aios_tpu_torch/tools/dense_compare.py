#!/usr/bin/env python3
"""Device time and output bits of the dense-cache attention kernels (K6-K9)
of the ``aios_tpu_torch`` under ``--root``, at the shapes the dense servers
give them (those of ``chip_smoke.check_dense_attention``), so that two
checkouts can be compared on one card: run it once per tree, alternating,
and compare the ``sha256`` of each output (equal bits) and ``ms``.

Inputs are made on the device from a seed by this script, in the same order
for every tree; times are this checkout's ``chip_smoke.time_ms`` (CUDA
events, median of 20 runs, the L2 flushed and the stream held before each),
whatever tree is measured.

Run from the repository root on a machine with one CUDA device:
    python3 aios_tpu_torch/tools/dense_compare.py [--root DIR] [--label NAME]
Prints one line per case and, last, one JSON object.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TINY, MISTRAL = (32, 4, 64), (32, 8, 128)
TINY_LENS = [0, 1, 127, 128, 700, 1500, 2000, 2046]
MISTRAL_LENS = [0, 1, 127, 1000, 4095, 4096, 6000, 8190]
STRIDES = [0, 1, 1, 1, 1, 1, 1, 1]
CASES = (  # (kernel, label, geometry, C, window, int8 cache, T, lengths)
    ("decode_attention", "TinyLlama C=2048", TINY, 2048, None, False, None, TINY_LENS),
    ("decode_attention", "Mistral C=8192 window=4096", MISTRAL, 8192, 4096, False, None,
     MISTRAL_LENS),
    ("decode_attention_int8", "Mistral C=8192 window=4096", MISTRAL, 8192, 4096, True, None,
     MISTRAL_LENS),
    ("decode_attention_int8", "Mistral C=8192 no window", MISTRAL, 8192, None, True, None,
     MISTRAL_LENS),
    ("multiquery_decode_attention", "TinyLlama C=2048 T=8", TINY, 2048, None, False, 8,
     TINY_LENS[:-1] + [2040]),
    ("multiquery_decode_attention", "Mistral C=8192 window=4096 T=8", MISTRAL, 8192, 4096,
     False, 8, MISTRAL_LENS[:-1] + [8184]),
    ("multiquery_decode_attention", "TinyLlama C=2048 T=31", TINY, 2048, None, False, 31,
     TINY_LENS[:-1] + [2017]),
    ("multiquery_decode_attention_int8", "Mistral C=8192 window=4096 T=8", MISTRAL, 8192, 4096,
     True, 8, MISTRAL_LENS[:-1] + [8184]),
)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(ROOT),
                    help="directory holding the aios_tpu_torch package to measure")
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("dense_compare: no CUDA device", file=sys.stderr)
        return 1
    from aios_tpu_torch import ops

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"label": args.label, "card": torch.cuda.get_device_name(0), "cases": {}}
    for name, label, (H, KH, D), C, window, quant, T, lengths in CASES:
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
        strides = torch.tensor(STRIDES, dtype=torch.int32, device="cuda")
        fn = getattr(ops, name)
        operands = (q, *caches, lens, strides) if T else (q[:, 0].contiguous(), *caches, lens)
        y = fn(*operands, window=window)
        torch.cuda.synchronize()
        sha = hashlib.sha256(y.view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:16]
        ms = chip_smoke.time_ms(lambda: fn(*operands, window=window))
        out["cases"][f"{name} {label}"] = {"ms": ms, "sha256": sha}
        print(f"[{args.label}] {name} {label}: ms={ms:.4f} sha256={sha}", flush=True)
        del q, caches, y
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
