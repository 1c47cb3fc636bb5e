"""The port's service plane is a copy of the JAX package's.

Each module below equals its ``aios_tpu`` source after one fixed rewrite,
``aios_tpu`` -> ``aios_tpu_torch`` wherever it stands as a whole word (the
imports, ``python -m`` module names, paths into the package), except the
hunks listed in ``HUNKS``, each with its reason. An edit to either side that
is not carried to the other fails here instead of drifting silently.
"""

import difflib
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX = ROOT / "aios_tpu"
PORT = ROOT / "aios_tpu_torch"
SUBPACKAGES = ("memory", "tools", "gateway", "orchestrator", "agents", "boot", "native")
# proto stubs and the C++ source: byte for byte, no rewrite
IDENTICAL = tuple(f"proto_gen/{n}_pb2.py" for n in (
    "common", "runtime", "agent", "api_gateway", "memory", "orchestrator", "tools",
)) + ("native/src/aios_native.cpp",)

_WORD = re.compile(r"\baios_tpu\b")

# the port's dev scripts share the tools/ directory; they are not copies
PORT_ONLY = {"tools/dense_compare.py", "tools/graph_probe.py", "tools/issue_cost.py",
             "tools/split_sweep.py", "tools/unicode_classes.py"}

ACCEL_REASON = ("device probe: the port reports the CUDA devices through torch, imported "
                "inside the function as JAX imports jax there; no key goes missing")

HUNKS = {
    "services.py": [
        ("`aios_tpu_torch/protos/` exactly (which in turn are wire-compatible with the\n"
         "reference's agent-core/proto).\n",
         "`aios_tpu/protos/` exactly (which in turn are wire-compatible with the\n"
         "reference's agent-core/proto). The fleet plane's aios.fleet.KvTransfer is not\n"
         "ported yet.\n",
         "the protos live in the JAX package; the fleet plane is not ported"),
        ("    fleet_pb2,\n", "", "the fleet plane (aios.fleet.KvTransfer) is not ported"),
        ('# ---------------------------------------------------------------------------\n'
         '# aios.fleet.KvTransfer — the fleet data plane (aios_tpu_torch/fleet/): cross-host\n'
         '# HostPageStore transfer (pull-on-miss Fetch, push-on-prefill Push) and the\n'
         '# disaggregated prefill->decode Handoff stream. No reference counterpart.\n'
         '# ---------------------------------------------------------------------------\n'
         '\n'
         'KVTRANSFER = ServiceSpec(\n'
         '    "aios.fleet.KvTransfer",\n'
         '    {\n'
         '        "Fetch": Method(\n'
         '            fleet_pb2.FetchRequest, fleet_pb2.PageChunk,\n'
         '            server_streaming=True,\n'
         '        ),\n'
         '        "Push": Method(\n'
         '            fleet_pb2.PageChunk, fleet_pb2.PushAck, client_streaming=True,\n'
         '        ),\n'
         '        "Handoff": Method(\n'
         '            fleet_pb2.HandoffRequest, fleet_pb2.HandoffChunk,\n'
         '            server_streaming=True,\n'
         '        ),\n'
         '    },\n'
         ')\n'
         '\n', "", "the fleet plane (aios.fleet.KvTransfer) is not ported"),
        ('    "kvtransfer": KVTRANSFER,\n', "", "the fleet plane is not ported"),
        ("KvTransferStub = make_stub(KVTRANSFER)\n"
         "KvTransferServicer = make_servicer(KVTRANSFER)\n", "",
         "the fleet plane is not ported"),
    ],
    "boot/hardware.py": [
        ("/proc and /sys. TPU-specific addition: detects attached TPU chips through\n"
         "JAX (deferred import so boot works on hosts without accelerators) — the\n"
         "reference's GPU detection has no TPU notion at all.\n",
         "/proc and /sys. Accelerator addition: detects attached CUDA devices through\n"
         "torch (deferred import so boot works on hosts without accelerators); the\n"
         "fields keep the JAX package's ``tpu_`` names, so the two report alike.\n",
         ACCEL_REASON),
        ("            import jax\n"
         "\n"
         "            info.tpu_devices = [str(d) for d in jax.devices()]\n"
         "            info.tpu_backend = jax.default_backend()\n"
         "        except Exception:  # no accelerator / no jax — boot proceeds\n",
         "            import torch\n"
         "\n"
         "            info.tpu_devices = [\n"
         '                f"cuda:{i} {torch.cuda.get_device_name(i)}"\n'
         "                for i in range(torch.cuda.device_count())\n"
         "            ]\n"
         '            info.tpu_backend = "cuda" if info.tpu_devices else "cpu"\n'
         "        except Exception:  # no accelerator / no torch — boot proceeds\n",
         ACCEL_REASON),
    ],
    "tools/handlers/system.py": [
        ("    # TPU presence (the reference detects GPUs; we detect the TPU chip)\n"
         "    try:\n"
         "        import jax\n"
         "\n"
         '        info["accelerators"] = [str(d) for d in jax.devices()]\n'
         '        info["accelerator_backend"] = jax.default_backend()\n',
         "    # accelerator presence: the port serves on CUDA devices\n"
         "    try:\n"
         "        import torch\n"
         "\n"
         '        info["accelerators"] = [\n'
         '            f"cuda:{i} {torch.cuda.get_device_name(i)}"\n'
         "            for i in range(torch.cuda.device_count())\n"
         "        ]\n"
         '        info["accelerator_backend"] = "cuda" if info["accelerators"] else "cpu"\n',
         ACCEL_REASON),
    ],
    "boot/supervisor.py": [
        ("    env: Dict[str, str] = field(default_factory=dict)\n",
         "    env: Dict[str, str] = field(default_factory=dict)\n"
         "    args: List[str] = field(default_factory=list)  # after -m <module>\n",
         "the runtime child's device argument: `python -m aios_tpu_torch.runtime.service` "
         "serves on the card and raises without one, so a CPU boot passes --device cpu"),
        ('            [sys.executable, "-m", d.module],\n',
         '            [sys.executable, "-m", d.module, *d.args],\n',
         "the runtime child's device argument"),
    ],
    "native/__init__.py": [
        ("from pathlib import Path\n", "",
         "the library is built outside the package tree (native/build.py's OUT)"),
        ('_LIB_PATH = Path(__file__).parent / "libaios_native.so"\n',
         "from .build import OUT as _LIB_PATH\n\n",
         "the library is built outside the package tree (native/build.py's OUT)"),
    ],
    "native/build.py": [
        ('OUT = HERE / "libaios_native.so"\n'
         'LOCK = HERE / ".build.lock"\n',
         "# the checkout's git-ignored build/, never the package tree\n"
         'OUT_DIR = HERE.resolve().parents[1] / "build" / "native"\n'
         'OUT = OUT_DIR / "libaios_native.so"\n'
         'LOCK = OUT_DIR / ".build.lock"\n',
         "g++ writes into the checkout's git-ignored build/native/, never beside the source"),
        ('    with open(LOCK, "w") as lock_fh:\n',
         "    OUT_DIR.mkdir(parents=True, exist_ok=True)\n"
         '    with open(LOCK, "w") as lock_fh:\n',
         "the build directory is made at first use"),
    ],
    "tools/service.py": [
        ("    serve(\n"
         "        executor=ToolExecutor(\n"
         '            audit_path=os.environ.get("AIOS_AUDIT_DB", "/tmp/aios/audit.db")\n'
         "        )\n"
         "    )\n",
         "    # under AIOS_DATA_DIR, the tree a boot gives its services, when set\n"
         '    data_dir = os.environ.get("AIOS_DATA_DIR")\n'
         '    dirs = {"backup_dir": os.path.join(data_dir, "backups"),\n'
         '            "plugin_dir": os.path.join(data_dir, "plugins")} if data_dir else {}\n'
         "    serve(\n"
         "        executor=ToolExecutor(\n"
         '            audit_path=os.environ.get("AIOS_AUDIT_DB", "/tmp/aios/audit.db"),\n'
         "            **dirs,\n"
         "        )\n"
         "    )\n",
         "a booted tools child keeps its backups and plugins under the data directory it "
         "is given (the memory and orchestrator children already do), so a boot writes "
         "nothing outside it"),
    ],
}


def _copied():
    rels = ["_compat.py", "services.py"]
    for sub in SUBPACKAGES:
        rels += sorted(str(p.relative_to(JAX)) for p in (JAX / sub).rglob("*.py"))
    return rels


COPIED = _copied()


def _expected(rel: str) -> str:
    src = _WORD.sub("aios_tpu_torch", (JAX / rel).read_text())
    for old, new, reason in HUNKS.get(rel, ()):
        assert src.count(old) == 1, (
            f"{rel}: the listed hunk ({reason}) no longer matches the JAX source once")
        src = src.replace(old, new)
    return src


@pytest.mark.parametrize("rel", COPIED)
def test_copy_equals_the_reference_but_its_listed_hunks(rel):
    port = PORT / rel
    assert port.exists(), f"{rel} is not in the port"
    want, have = _expected(rel), port.read_text()
    if have != want:
        diff = "".join(difflib.unified_diff(
            want.splitlines(True), have.splitlines(True),
            f"aios_tpu/{rel} (rewritten, listed hunks applied)", f"aios_tpu_torch/{rel}"))
        pytest.fail(f"{rel} drifted from its reference:\n{diff}")


@pytest.mark.parametrize("rel", IDENTICAL)
def test_byte_identical_copies(rel):
    assert (PORT / rel).read_bytes() == (JAX / rel).read_bytes(), rel


def test_every_hunk_names_a_copied_module_and_a_reason():
    for rel, hunks in HUNKS.items():
        assert rel in COPIED, rel
        for old, new, reason in hunks:
            assert old != new and len(reason) > 20, (rel, reason)


def test_the_port_holds_no_module_the_reference_lacks():
    extra = []
    for sub in SUBPACKAGES:
        for p in (PORT / sub).rglob("*.py"):
            rel = str(p.relative_to(PORT))
            if rel not in COPIED and rel not in PORT_ONLY:
                extra.append(rel)
    assert not extra, f"modules in the port's copied subpackages with no reference: {extra}"
