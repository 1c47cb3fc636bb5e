"""The port's boot layer: its supervisor's topology, the runtime child's
device argument, the metrics-endpoint knobs (each starts the endpoint on
the port it names), and (slow, as the JAX package's own process boot) the five services booted
as processes by ``default_services`` on the CPU."""

import json
import logging
import os
import pathlib
import subprocess
import sys
import urllib.request

import pytest

import chip_smoke
from aios_tpu_torch.boot.supervisor import ServiceDef, default_services, topo_sort

ROOT = pathlib.Path(__file__).resolve().parent.parent
ONE_THREAD = {**os.environ, "OMP_NUM_THREADS": "1"}


def test_default_services_name_the_port():
    defs = default_services()
    assert topo_sort(defs)[-1] == "orchestrator"
    assert set(topo_sort(defs)[:4]) == {"runtime", "memory", "tools", "gateway"}
    for name, d in defs.items():
        assert d.module.startswith("aios_tpu_torch.") and d.args == []
        # each module runs as `python -m`
        assert (ROOT / (d.module.replace(".", "/") + ".py")).exists(), d.module


def test_topo_sort_orders_dependencies():
    services = {
        "a": ServiceDef("a", "m", 1, deps=["b"]),
        "b": ServiceDef("b", "m", 2),
        "c": ServiceDef("c", "m", 3, deps=["a", "b"]),
    }
    order = topo_sort(services)
    assert order.index("b") < order.index("a") < order.index("c")
    with pytest.raises(ValueError):
        topo_sort({"x": ServiceDef("x", "m", 1, deps=["y"]),
                   "y": ServiceDef("y", "m", 2, deps=["x"])})


def test_runtime_child_serves_the_card_unless_asked_for_the_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-device refusal is not reachable")
    r = subprocess.run([sys.executable, "-m", "aios_tpu_torch.runtime.service"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120, env=ONE_THREAD)
    assert r.returncode != 0 and "no CUDA device" in r.stderr, r.stderr[-2000:]
    r = subprocess.run([sys.executable, "-m", "aios_tpu_torch.runtime.service", "--help"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120, env=ONE_THREAD)
    assert r.returncode == 0 and "--device" in r.stdout


@pytest.mark.parametrize("service", ["memory", "tools", "gateway", "orchestrator",
                                     "runtime"])
def test_metrics_port_knob_warns_and_starts_nothing(service, monkeypatch, caplog):
    """The knob starts the endpoint (the name predates it; the test keeps
    its name): unset, nothing starts and nothing is logged; set, the
    endpoint serves on the port it names (0: any free port), as the JAX
    services' does."""
    from aios_tpu_torch.obs.http import maybe_start_metrics_server

    knob = f"AIOS_{service.upper()}_METRICS_PORT"
    monkeypatch.delenv(knob, raising=False)
    with caplog.at_level(logging.WARNING, logger="aios.obs"):
        assert maybe_start_metrics_server(service) == (None, None)
    assert not caplog.records
    monkeypatch.setenv(knob, "0")
    server, port = maybe_start_metrics_server(service)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
            assert json.loads(r.read()) == {"status": "ok", "metrics_port": port}
    finally:
        server.shutdown()
        server.server_close()


def test_booted_memory_service_warns_on_its_metrics_knob(monkeypatch, caplog, tmp_path):
    """The booted memory service starts the endpoint its knob names (the
    name predates the endpoint; the test keeps its name), and its /healthz
    carries the service's own health."""
    from aios_tpu_torch.memory.service import serve

    monkeypatch.setenv("AIOS_MEMORY_METRICS_PORT", "0")
    server, service, _ = serve(address="127.0.0.1:0", data_dir=str(tmp_path), block=False)
    try:
        assert service.metrics_server is not None and service.metrics_port > 0
        url = f"http://127.0.0.1:{service.metrics_port}/healthz"
        with urllib.request.urlopen(url, timeout=10) as r:
            body = json.loads(r.read())
        assert body["status"] == "ok" and body["metrics_port"] == service.metrics_port
    finally:
        server.stop(grace=None)
        service.metrics_server.shutdown()
        service.metrics_server.server_close()


@pytest.mark.slow
def test_supervisor_boots_the_port_and_leaves_nothing(tmp_path):
    out = chip_smoke.stack_boot(str(tmp_path), "synthetic://tiny-test", device="cpu")
    assert out["processes"] >= 5
    assert (tmp_path / "boot" / "clean-shutdown").exists()
