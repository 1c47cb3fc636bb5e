"""Prepare a model for serving by the port: GGUF / HF / synthetic source ->
the port's prepared checkpoint (the twin of ``scripts/prepare_model.py``).

The expensive work (the GGUF parse and dequantization, the HF safetensors
mapping, the quantization) happens once, on the card unless ``--device cpu``
is given; the result is a directory {params.safetensors, aios_model.json,
tokenizer/ for an HF tokenizer} that ``LoadModel`` restores as it is.

Usage:
  python -m aios_tpu_torch.prepare_model /path/model.gguf /var/lib/aios/models/name
  python -m aios_tpu_torch.prepare_model /path/hf_dir     /var/lib/aios/models/name
  python -m aios_tpu_torch.prepare_model synthetic://tinyllama-1.1b out_dir

Options:
  --dtype bf16|f32     dtype of the dense weights (default bf16)
  --quantize int8|int4 store the serving-quantized leaves instead of dense
                       ones (int4 only where the CUDA int4 kernel serves a
                       leaf, int8 elsewhere; the head padded as on the card),
                       so LoadModel skips the quantize pass
  --context N          the max_context recorded in the config
  --device cpu|cuda    where to load and quantize (default: the card)
  --verify             a short greedy generation from the written checkpoint
  --tp N               N > 1 (the tensor-parallel layout) waits for the port
                       of parallel/ and exits with an error
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m aios_tpu_torch.prepare_model",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("source", help="GGUF file, HF dir, or synthetic://preset")
    ap.add_argument("out", help="output checkpoint directory")
    ap.add_argument("--dtype", default="bf16", choices=("bf16", "f32"))
    ap.add_argument("--quantize", default="", choices=("", "int8", "int4"))
    ap.add_argument("--context", type=int, default=0)
    ap.add_argument("--device", default=None, choices=("cpu", "cuda"))
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--tp", type=int, default=1)
    args = ap.parse_args(argv)
    if args.tp != 1:
        ap.error(f"--tp {args.tp}: the tensor-parallel layout waits for the port of "
                 "parallel/ (ROADMAP Queue 1); prepare the single-card layout (--tp 1)")

    import torch

    from .engine import checkpoint as ckpt
    from .engine import model as model_mod
    from .runtime.model_manager import ModelManager

    t0 = time.time()
    mgr = ModelManager(num_slots=1, quantize=False, device=args.device)
    name = Path(args.out).name
    try:
        cfg, params, tokenizer = mgr._load_weights(name, args.source, args.context)
    except (FileNotFoundError, KeyError) as exc:
        print(f"error: cannot load {args.source!r}: {exc}", file=sys.stderr)
        return 2
    if args.context:
        cfg = cfg.scaled(max_context=args.context)
    if args.dtype == "f32":
        params = {k: ({kk: vv.float() for kk, vv in v.items()} if isinstance(v, dict)
                      else v.float()) for k, v in params.items()}
    print(f"loaded {cfg.name}: {cfg.num_params() / 1e9:.2f}B params, vocab {cfg.vocab_size}, "
          f"ctx {cfg.max_context} on {mgr.device} ({time.time() - t0:.1f}s)", file=sys.stderr)
    if args.quantize:
        t0 = time.time()
        params = model_mod.quantize_params(params, mode=args.quantize, target="cuda")
        print(f"quantized to the {args.quantize} serving layout ({time.time() - t0:.1f}s)",
              file=sys.stderr)
    t0 = time.time()
    ckpt.save_model_checkpoint(args.out, cfg, params, tokenizer)
    print(f"checkpoint written to {args.out} ({time.time() - t0:.1f}s)", file=sys.stderr)
    del params

    if args.verify:
        from .engine.engine import TorchEngine

        # read back as LoadModel reads it (dense leaves in bf16)
        cfg2, params2, tok2 = mgr._load_weights(name, args.out, 0)
        eng = TorchEngine(cfg2, params2, num_slots=1, max_context=min(256, cfg2.max_context),
                          device=mgr.device)
        ids = tok2.encode("The quick brown fox")
        out = eng.generate(ids, max_new_tokens=8, temperature=0.0)
        eng.close()
        print(f"verify: generated {len(out)} tokens: {tok2.decode(out)!r}", file=sys.stderr)
        if mgr.device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
