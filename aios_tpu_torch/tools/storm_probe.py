#!/usr/bin/env python3
"""Phase 19 of ``chip_smoke.py`` (the storm plane: two storms, the devprof
gate, ``/debug/profile`` over live traffic, the autoscaler and the
observability's cost) several times in one process, each under
``AIOS_TPU_LOCK_DEBUG=1`` and the phase's faulthandler budget, as
``chip_smoke.py`` runs it once: a check that the on-demand profiler no
longer hangs the process, and the spread of the phase's timing gates.
Run from the repository root on a CUDA device (about a minute a storm after
the build):
    python3 aios_tpu_torch/tools/storm_probe.py [--repeats 4]
Exits 1 on the first failed phase; a hang dumps every thread's stack.
"""

from __future__ import annotations

import argparse
import faulthandler
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--repeats", type=int, default=4)
    args = parser.parse_args()
    faulthandler.enable()
    t0 = time.perf_counter()
    timed = cs._phase_clock(t0)
    card = timed("device", cs.phase_device)
    timed("build", cs.phase_build)
    for i in range(args.repeats):
        timed("storm", cs._lock_debug, f"storm {i}", cs.phase_storm, card)
    print(f"[probe] {args.repeats} storm phases passed in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
