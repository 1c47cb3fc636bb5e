#!/usr/bin/env python3
"""Device time and output bits of the dense-cache attention kernels (K6-K9)
of the ``aios_tpu_torch`` under ``--root``, at the shapes the dense servers
give them (those of ``chip_smoke.check_dense_attention``, and the lengths
of a served window), so that two checkouts can be compared on one card.

With ``--parent DIR`` it compares this checkout with the one in DIR in one
call: it runs itself on parent, change, change, parent (a process each),
prints each case's times side by side and whether the change's bits equal
the parent's, and exits 1 if K6's, K8's or K9's bits differ (kernels this
tree keeps as they were). Without it, it measures one tree and prints one
line per case and, last, one JSON object.

Inputs are made on the device from a seed by this script, in the same order
for every tree; times are this checkout's ``chip_smoke.time_ms`` (CUDA
events, median of 20 runs, the L2 flushed and the stream held before each),
whatever tree is measured.

Run from the repository root on a machine with one CUDA device:
    python3 aios_tpu_torch/tools/dense_compare.py [--root DIR] [--label NAME]
    python3 aios_tpu_torch/tools/dense_compare.py --parent DIR
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TINY, MISTRAL = (32, 4, 64), (32, 8, 128)
TINY_LENS = [0, 1, 127, 128, 700, 1500, 2000, 2046]
MISTRAL_LENS = [0, 1, 127, 1000, 4095, 4096, 6000, 8190]
STRIDES = [0, 1, 1, 1, 1, 1, 1, 1]
SERVED = [290, 295, 300, 305, 310, 315, 320, 325]  # a served window's slots
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
    ("decode_attention_int8", "Mistral C=8192 window=4096 served", MISTRAL, 8192, 4096, True,
     None, SERVED),
    ("multiquery_decode_attention", "TinyLlama C=2048 T=8 served", TINY, 2048, None, False, 8,
     SERVED),
    ("multiquery_decode_attention", "TinyLlama C=2048 T=3", TINY, 2048, None, False, 3,
     TINY_LENS[:-1] + [2045]),
    ("multiquery_decode_attention_int8", "Mistral C=8192 window=4096 T=8 served", MISTRAL, 8192,
     4096, True, 8, SERVED),
    ("multiquery_decode_attention_int8", "Mistral C=8192 window=4096 T=31", MISTRAL, 8192, 4096,
     True, 31, MISTRAL_LENS[:-1] + [8161]),
)
# K8, K9, K6: bits as the parent's
KEPT = ("decode_attention", "decode_attention_int8", "multiquery_decode_attention")


def compare(parent: str) -> int:
    """Parent, change, change, parent on this card; the change's bits
    against the parent's and the four times of each case."""
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    runs = []
    for label, root in (("parent", parent), ("change", str(ROOT)), ("change", str(ROOT)),
                        ("parent", parent)):
        done = subprocess.run([sys.executable, __file__, "--root", root, "--label", label],
                              capture_output=True, text=True)
        print(done.stdout, end="", flush=True)
        if done.returncode:
            print(done.stderr, file=sys.stderr)
            return done.returncode
        runs.append(json.loads(done.stdout.strip().splitlines()[-1]))
    differ = []
    print(f"[compare] {runs[0]['card']}: ms parent, change, change, parent; bits", flush=True)
    for case in runs[0]["cases"]:
        ms = " ".join(f"{r['cases'][case]['ms']:.4f}" for r in runs)
        shas = {r["label"]: set() for r in runs}
        for r in runs:
            shas[r["label"]].add(r["cases"][case]["sha256"])
        same = shas["parent"] == shas["change"] and len(shas["parent"]) == 1
        if case.split()[0] in KEPT and not same:
            differ.append(case)
        print(f"[compare] {case}: {ms}; bits {'equal' if same else 'differ'}", flush=True)
    if differ:
        print(f"[compare] FAILED: K6/K8/K9 bits differ from the parent's: {differ}", flush=True)
    return 1 if differ else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(ROOT),
                    help="directory holding the aios_tpu_torch package to measure")
    ap.add_argument("--label", default="")
    ap.add_argument("--parent", default=None,
                    help="a checkout to compare this one with, in one call")
    args = ap.parse_args()
    if args.parent:
        return compare(args.parent)
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
