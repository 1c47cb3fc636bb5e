"""One fleet member process: the port's runtime service on ephemeral ports
with the fleet plane armed from the environment (the twin of the JAX
package's ``scripts/fleet_worker.py``).

    python -m aios_tpu_torch.fleet.worker [--device cpu] [--source URI] ...

The caller sets the fleet environment (``AIOS_TPU_FLEET``,
``AIOS_TPU_FLEET_HOST``, ``AIOS_TPU_FLEET_ROLE``, ``AIOS_TPU_FLEET_PEERS``,
the ``AIOS_TPU_FLEET_*_SECS`` windows, ``AIOS_TPU_PREFIX_HOST_BYTES``,
``AIOS_TPU_FAULTS``). The worker loads one model (on the CUDA device
unless ``--device cpu``), binds gRPC and the metrics endpoint on port 0 of
127.0.0.1, and prints ONE ready line

    FLEET_WORKER_READY {"grpc_port": N, "metrics_port": M, "load_s": ..., ...}

then serves until its stdin closes (the parent's shutdown signal) or its
graceful drain ends the process. Either way it prints, last,

    FLEET_WORKER_EXIT {"launches": {kernel: n}, "streams": [...], "pushes": [...], ...}

with the launches each kernel wrapper counted since the ready line. With
``--hold`` the worker loads its model, prints ``FLEET_WORKER_LOADED``, and
waits for one line on stdin, a JSON object of environment variables (a
peer address only known once another member is up) set before the
service starts; the members of a fleet can then load at once and join it
in the order the caller needs. With
``--record`` the line also carries each stream this host's front door
served (token ids and their arrival times at the relay, in seconds since
the submit) and each KV push (pages, bytes, seconds, and the seconds its
crc32 takes on the same pages): what a harness needs to hold a
disaggregated stream to a single-host one token for token.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import threading
import time
from typing import Dict, List

log = logging.getLogger("aios.torch.fleet.worker")

LOADED = "FLEET_WORKER_LOADED "
READY = "FLEET_WORKER_READY "
EXIT = "FLEET_WORKER_EXIT "


class _Recorder:
    """The streams and pushes of one worker process (``--record``)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.streams: List[dict] = []
        self.pushes: List[dict] = []

    def stream(self, request_id: str, handle, t0: float):
        row = {"request_id": request_id, "ids": [], "t": [],
               "handoff": type(handle).__name__ == "HandoffHandle"}
        with self._lock:
            self.streams.append(row)
        return _RecordedHandle(handle, row, t0)

    def push(self, row: dict) -> None:
        with self._lock:
            self.pushes.append(row)

    def snapshot(self) -> dict:
        with self._lock:
            return {"streams": [dict(r) for r in self.streams],
                    "pushes": list(self.pushes)}


class _RecordedHandle:
    """A request handle whose tokens, and the time each reached this host's
    front door, are kept; every other attribute is the handle's own."""

    def __init__(self, handle, row: dict, t0: float) -> None:
        self._handle = handle
        self._row = row
        self._t0 = t0

    def __iter__(self):
        for tok in self._handle:
            self._row["t"].append(time.perf_counter() - self._t0)
            self._row["ids"].append(int(tok))
            yield tok

    def __getattr__(self, name):
        return getattr(self._handle, name)


def _arm_recording(rec: _Recorder) -> None:
    """Route the front door's submits and the plane's pushes through
    ``rec``: the service calls ``disagg.route_submit`` and the handoff
    ``kvx.push_chain`` by module attribute, so wrapping both here sees every
    stream and push of this process."""
    from ..engine import paged
    from . import disagg, kvx

    route_submit = disagg.route_submit
    push_chain = kvx.push_chain

    def recorded_submit(m, req, tenant="anonymous", deadline_s=None):
        t0 = time.perf_counter()
        handle = route_submit(m, req, tenant=tenant, deadline_s=deadline_s)
        return rec.stream(req.request_id, handle, t0)

    def timed_push(addr, model, pairs, peer=""):
        t0 = time.perf_counter()
        accepted = push_chain(addr, model, pairs, peer=peer)
        seconds = time.perf_counter() - t0
        # the crc32 of the same pages, timed apart (the push computes it
        # once per page before the RPC, beside pack_entry)
        t1 = time.perf_counter()
        for _, entry in pairs:
            paged.HostPageStore._entry_crc(entry)
        crc_s = time.perf_counter() - t1
        rec.push({"peer": peer, "pages": len(pairs), "accepted": int(accepted),
                  "bytes": int(sum(sum(a.nbytes for a in e.values()) for _, e in pairs)),
                  "seconds": seconds, "crc_seconds": crc_s})
        return accepted

    disagg.route_submit = recorded_submit
    kvx.push_chain = timed_push


def _launches() -> Dict[str, int]:
    from .. import ops

    return {k.__name__: int(k.launches) for k in ops.KERNELS if k.launches}


def _report(manager, rec, code: int) -> None:
    """Print the exit line: launches, peak device memory, and what ``rec``
    kept."""
    import torch

    out = {"launches": _launches(), "code": code}
    if manager.device.type == "cuda":
        torch.cuda.synchronize(manager.device)
        out["peak_bytes"] = int(torch.cuda.max_memory_allocated(manager.device))
    if rec is not None:
        out.update(rec.snapshot())
    print(EXIT + json.dumps(out), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="the torch device: the CUDA device by default (it raises "
                             "without one); 'cpu' serves the plain PyTorch path")
    parser.add_argument("--name", action="append",
                        help="a served model's name, each loaded from --source in the "
                             "order given (default: fleet-smoke)")
    parser.add_argument("--source", default="synthetic://tiny-test",
                        help="the model source LoadModel takes")
    parser.add_argument("--context", type=int, default=1024, help="context length")
    parser.add_argument("--num-slots", type=int, default=2)
    parser.add_argument("--quantize", default=None, help="int8, int4 or none")
    parser.add_argument("--kv-cache", default=None, help="bf16 or int8")
    parser.add_argument("--paged-kv", default=None,
                        help="the pool's rows (or auto/off), as AIOS_TPU_PAGED_KV")
    parser.add_argument("--hold", action="store_true",
                        help="after LoadModel, read one JSON line of environment "
                             "variables from stdin before serving")
    parser.add_argument("--record", action="store_true",
                        help="keep every front-door stream and KV push for the exit line")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)

    import torch

    from ..runtime.model_manager import ModelManager
    from ..runtime.service import serve
    from . import drain

    paged_kv = args.paged_kv
    if paged_kv is not None and paged_kv.isdigit():
        paged_kv = int(paged_kv)
    manager = ModelManager(num_slots=args.num_slots, device=args.device,
                           quantize=args.quantize, kv_cache=args.kv_cache,
                           paged_kv=paged_kv)
    rec = _Recorder() if args.record else None
    if rec is not None:
        _arm_recording(rec)
    if manager.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(manager.device)
    t0 = time.perf_counter()
    for name in args.name or ["fleet-smoke"]:
        m = manager.load_model(name, args.source, context_length=args.context)
        if m.state != "ready":
            print(f"fleet worker: LoadModel {args.source} as {name} ended {m.state}: "
                  f"{m.error}", file=sys.stderr, flush=True)
            return 1
    load_s = time.perf_counter() - t0
    if args.hold:
        print(LOADED + json.dumps({"load_s": load_s}), flush=True)
        line = sys.stdin.readline()
        if not line:
            return 0  # the parent went away before the go
        for k, v in json.loads(line).items():
            os.environ[k] = str(v)
    server, service, port = serve(address="127.0.0.1:0", manager=manager, block=False,
                                  metrics_port=0)

    def leave(code: int) -> None:
        # the graceful drain's last act: report, then end the process as
        # the coordinator would
        _report(manager, rec, code)
        os._exit(code)

    if drain.COORD is not None:
        drain.arm(manager, exit_fn=leave)
    # the exit line counts the launches of what this process serves, not
    # those of LoadModel's warmup
    from .. import ops

    for k in ops.KERNELS:
        k.launches = 0
    ready = {"grpc_port": port, "metrics_port": service.metrics_port,
             "load_s": load_s, "device": str(manager.device),
             "pages": m.engine.allocator.num_pages if m.engine.allocator else 0,
             "page": m.engine.allocator.page_size if m.engine.allocator else 0}
    if manager.device.type == "cuda":
        ready["peak_bytes"] = int(torch.cuda.max_memory_allocated(manager.device))
    print(READY + json.dumps(ready), flush=True)
    sys.stdin.read()  # the parent closes stdin to shut us down
    _report(manager, rec, 0)
    server.stop(grace=None)
    if service.metrics_server is not None:
        service.metrics_server.shutdown()
    from ..obs import fleet

    if fleet.FLEET is not None:
        fleet.FLEET.stop()
    manager.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
