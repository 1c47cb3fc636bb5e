"""The PyTorch port stands alone: it imports neither JAX nor aios_tpu (nor
safetensors, transformers, tokenizers, optax or orbax, none of which is on
the card), and its entry points refuse to fall back to the CPU when no CUDA
device exists."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

# The shapes here are tiny: one intra-op thread is faster and leaves the
# cores to the other test workers; so does every subprocess these tests start.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "aios_tpu_torch"
ONE_THREAD = {**os.environ, "OMP_NUM_THREADS": "1"}


# packages the card does not have, whose formats the port reads itself
OFF_CARD = ("safetensors", "transformers", "tokenizers", "optax", "orbax")


def _is_jax_or_reference(name: str) -> bool:
    # "aios_tpu_torch".startswith("aios_tpu") is true: match whole names
    return (name == "jax" or name.startswith("jax.")
            or name == "aios_tpu" or name.startswith("aios_tpu.")
            or name.split(".")[0] in OFF_CARD)


def test_port_import_pulls_in_no_jax_and_no_aios_tpu():
    # a subprocess: the test process itself already imported jax (conftest)
    code = (
        "import sys\n"
        "import aios_tpu_torch, aios_tpu_torch.runtime.service\n"
        "import aios_tpu_torch.engine.engine, aios_tpu_torch.ops\n"
        "import aios_tpu_torch.engine.spec, aios_tpu_torch.engine.batching\n"
        "import aios_tpu_torch.engine.jsonmode, aios_tpu_torch.engine.jsonschema\n"
        "import aios_tpu_torch.engine.moe, aios_tpu_torch.engine.weights\n"
        "import aios_tpu_torch.ops.decode_attention, aios_tpu_torch.ops.verify_attention\n"
        "import aios_tpu_torch.analysis.locks, aios_tpu_torch.faults.inject\n"
        "import aios_tpu_torch.analysis.core, aios_tpu_torch.analysis.registry\n"
        "import aios_tpu_torch.analysis.rules, aios_tpu_torch.analysis.__main__\n"
        "import aios_tpu_torch.obs.metrics, aios_tpu_torch.obs.instruments\n"
        "import aios_tpu_torch.obs.flightrec, aios_tpu_torch.serving.pool\n"
        "import aios_tpu_torch.serving.router, aios_tpu_torch.serving.admission\n"
        "import aios_tpu_torch.serving.failover, aios_tpu_torch.serving.config\n"
        "import aios_tpu_torch.obs.tracing, aios_tpu_torch.obs.interceptors\n"
        "import aios_tpu_torch.obs.slo, aios_tpu_torch.obs.tsdb, aios_tpu_torch.obs.http\n"
        "import aios_tpu_torch.obs.incidents, aios_tpu_torch.obs.devprof\n"
        "import aios_tpu_torch.serving.autoscale, aios_tpu_torch.loadgen\n"
        "import aios_tpu_torch.engine.safetensors, aios_tpu_torch.engine.checkpoint\n"
        "import aios_tpu_torch.engine.train, aios_tpu_torch.prepare_model\n"
        "import aios_tpu_torch.engine.tokenizer, aios_tpu_torch.engine.config\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n == 'aios_tpu' or n.startswith('aios_tpu.')\n"
        "             or n.split('.')[0] in ('safetensors', 'transformers', 'tokenizers',\n"
        "                                    'optax', 'orbax'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120, env=ONE_THREAD)
    assert r.returncode == 0, r.stdout + r.stderr


HOST_ONLY = ("aios_tpu_torch.memory.service", "aios_tpu_torch.tools.service",
             "aios_tpu_torch.gateway.service", "aios_tpu_torch.orchestrator.main",
             "aios_tpu_torch.agents.run", "aios_tpu_torch.boot.supervisor")


def test_host_only_subpackages_load_no_torch():
    # each service process of the plane, and every agent the spawner starts,
    # imports one of these: none may pay for torch (nor jax, nor aios_tpu)
    code = (
        "import importlib, sys\n"
        f"for name in {HOST_ONLY!r}:\n"
        "    importlib.import_module(name)\n"
        "from aios_tpu_torch import native\n"
        "assert 'torch' not in sys.modules\n"
        "bad = sorted(n for n in sys.modules if n in ('torch', 'jax', 'aios_tpu')\n"
        "             or n.startswith(('torch.', 'jax.', 'aios_tpu.')))\n"
        "print(bad)\n"
        "from aios_tpu_torch import resolve_device\n"
        "assert 'torch' in sys.modules and callable(resolve_device)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120, env=ONE_THREAD)
    assert r.returncode == 0, r.stdout + r.stderr


def test_the_analyzer_loads_no_torch_jax_or_reference():
    # the engine imports analysis.locks at its own import: the package stays
    # light, and running it over the tree (as the CLI does) needs no torch
    code = (
        "import sys\n"
        "from aios_tpu_torch.analysis import __main__ as cli, run_analysis\n"
        "findings = run_analysis()\n"
        "bad = sorted(n for n in sys.modules if n in ('torch', 'jax', 'aios_tpu')\n"
        "             or n.startswith(('torch.', 'jax.', 'aios_tpu.')))\n"
        "print(bad, len(findings))\n"
        "sys.exit(1 if bad or not findings else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120, env=ONE_THREAD)
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_sources_name_no_jax_or_aios_tpu_import():
    offenders = []
    sources = sorted(PKG.rglob("*.py"))
    # the serving plane's and the service plane's subpackages are scanned too
    for sub in ("analysis", "faults", "obs", "serving", "memory", "tools", "handlers",
                "gateway", "orchestrator", "agents", "boot", "native", "loadgen"):
        assert any(p.parent.name == sub for p in sources), sub
    for path in sources + [ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.relative_to(ROOT)}: {n}" for n in names
                          if _is_jax_or_reference(n)]
    assert not offenders, offenders


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-device refusal is not reachable")
    from aios_tpu_torch.engine.config import TINY_TEST
    from aios_tpu_torch.engine.engine import TorchEngine
    from aios_tpu_torch.engine.weights import init_params
    from aios_tpu_torch.runtime.model_manager import ModelManager

    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelManager()
    params = init_params(TINY_TEST, torch.Generator().manual_seed(0), torch.float32, "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchEngine(TINY_TEST, params, paged_pool_rows=256, page_size=16)


def test_wrappers_refuse_devices_they_do_not_serve():
    from aios_tpu_torch import ops

    meta = torch.empty((2, 64), device="meta")
    w = torch.empty((64, 32), dtype=torch.int8, device="meta")
    s = torch.empty((1, 32), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.quantized_matmul(meta, w, s)
    with pytest.raises(ValueError, match="different devices"):
        ops.quantized_matmul(torch.zeros(2, 64), w, s)
