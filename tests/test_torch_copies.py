"""The port's service plane and its observability plane are copies of the
JAX package's.

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
SUBPACKAGES = ("memory", "tools", "gateway", "orchestrator", "agents", "boot", "native",
               "loadgen", "fleet")
# the observability plane's host modules, the autoscaler, the fault points
# (the per-edge network faults too), the gRPC plumbing, the fleet's
# membership plane and the analyzer's AST substrate (obs/devprof.py is
# redesigned for the card, not copied; obs/metrics.py and obs/instruments.py
# carry the port's own catalog; the analyzer's registry and rules are the
# port's own, held to the JAX analyzer by tests/test_torch_analysis.py)
MODULES = ("rpc.py", "faults/inject.py", "faults/net.py", "obs/tracing.py",
           "obs/interceptors.py", "obs/flightrec.py", "obs/slo.py", "obs/tsdb.py",
           "obs/incidents.py", "obs/http.py", "obs/fleet.py", "serving/autoscale.py",
           "analysis/core.py")
# proto stubs and the C++ source: byte for byte, no rewrite
IDENTICAL = tuple(f"proto_gen/{n}_pb2.py" for n in (
    "common", "runtime", "agent", "api_gateway", "memory", "orchestrator", "tools", "fleet",
)) + ("native/src/aios_native.cpp",)

_WORD = re.compile(r"\baios_tpu\b")

# the port's dev scripts share the tools/ directory, and the fleet's worker
# process (the twin of the JAX package's scripts/fleet_worker.py) lives in
# fleet/; they are not copies
PORT_ONLY = {"tools/dense_compare.py", "tools/graph_probe.py", "tools/issue_cost.py",
             "tools/split_sweep.py", "tools/storm_probe.py", "tools/unicode_classes.py",
             "fleet/worker.py"}

PROFILER_REASON = "the port's on-demand capture runs torch.profiler (obs/devprof.py)"
BIND_REASON = ("a metrics port that was asked for and cannot be bound raises rather than "
               "warn, so no endpoint a deployment expects goes missing silently")
PARALLEL_REASON = ("parallel/ is not ported (ROADMAP Queue 1): the port has no multihost "
                   "env contract, so AIOS_TPU_FLEET_PEERS alone seeds the peers and the "
                   "rank is 0")
ENGINE_REASON = ("the port's engine keeps its KV in k_pool and v_pool (and an int8 pool's "
                 "scales), whose page bytes engine.page_bytes() sums, not in a state dict")

NUMBERS_REASON = ("the port's sources name no pull request or issue of the project's history; "
                  "the sentence keeps its point without the number")
PROTOS_REASON = ("the .proto sources live in the JAX package; the port carries only the "
                 "generated modules")

ACCEL_REASON = ("device probe: the port reports the CUDA devices through torch, imported "
                "inside the function as JAX imports jax there; no key goes missing")

HUNKS = {
    "analysis/core.py": [
        ("Every rule (and the migrated source checks in ``tests/test_obs_lint.py``)\n"
         "works from the same three primitives so there is ONE way to read the\n"
         "tree:\n",
         "Every rule works from the same three primitives so there is ONE way to\n"
         "read the tree:\n",
         "the port has no migrated lint tests: its rules are the substrate's only users"),
    ],
    "obs/flightrec.py": [
        ("dispatch counts are identical recorder ON vs OFF (the PR 6/7 invariant,\n"
         "extended to observability).\n",
         "dispatch counts are identical recorder ON vs OFF (the engine's\n"
         "dispatch invariant, extended to observability).\n",
         NUMBERS_REASON),
    ],
    "obs/tsdb.py": [
        ("injected (the PR 16 exposition-merge discipline). Incident bundles\n",
         "injected (the exposition-merge discipline). Incident bundles\n",
         NUMBERS_REASON),
    ],
    "obs/http.py": [
        ("                # replicas in rotation (the ISSUE 8 satellite fix). A\n",
         "                # replicas in rotation. A\n",
         NUMBERS_REASON),
        ('  * ``/debug/profile``   — start a bounded on-demand ``jax.profiler``\n',
         '  * ``/debug/profile``   — start a bounded on-demand ``torch.profiler``\n',
         PROFILER_REASON),
        (('    try:\n'
          '        server, bound = start_metrics_server(\n'
          '            port=metrics_port, host=host, health_fn=health_fn\n'
          '        )\n'
          '        # the service name + ACTUAL port in one startup line: with\n'
          '        # AIOS_<SVC>_METRICS_PORT=0 this log (plus /healthz and the\n'
          '        # fleet announce) is how anything finds the endpoint\n'
          '        log.info("%s metrics endpoint bound on port %d", service_name,\n'
          '                 bound)\n'
          '        from . import fleet, incidents, tsdb\n'
          '\n'
          '        fleet.maybe_start(service_name, bound, host=host)\n'
          '        # the history planes ride the same arming pass: every real\n'
          '        # serving process comes through here, and both are env-gated\n'
          '        # no-ops (module global stays None) unless asked for\n'
          '        tsdb.maybe_start()\n'
          '        incidents.maybe_start()\n'
          '        return server, bound\n'
          '    except (OSError, OverflowError) as exc:  # taken port / port > 65535\n'
          '        # the endpoint is optional: a taken/invalid port must not crash a\n'
          '        # serve() whose gRPC server is already up\n'
          '        log.warning(\n'
          '            "%s metrics endpoint on port %s failed (%s); continuing "\n'
          '            "without it", service_name, metrics_port, exc,\n'
          '        )\n'
          '        return None, None\n'),
         ('    # a port that was asked for and cannot be bound (taken, > 65535)\n'
          '    # raises: a deployment that expects its endpoint must not run without\n'
          '    server, bound = start_metrics_server(\n'
          '        port=metrics_port, host=host, health_fn=health_fn\n'
          '    )\n'
          '    # the service name + ACTUAL port in one startup line: with\n'
          '    # AIOS_<SVC>_METRICS_PORT=0 this log (plus /healthz and the\n'
          '    # fleet announce) is how anything finds the endpoint\n'
          '    log.info("%s metrics endpoint bound on port %d", service_name,\n'
          '             bound)\n'
          '    from . import fleet, incidents, tsdb\n'
          '\n'
          '    fleet.maybe_start(service_name, bound, host=host)\n'
          '    # the history planes ride the same arming pass: every real\n'
          '    # serving process comes through here, and both are env-gated\n'
          '    # no-ops (module global stays None) unless asked for\n'
          '    tsdb.maybe_start()\n'
          '    incidents.maybe_start()\n'
          '    return server, bound\n'),
         BIND_REASON),
    ],
    "obs/fleet.py": [
        (('        """AIOS_TPU_FLEET_PEERS, else the coordinator host (the\n'
          '        multihost env contract) on AIOS_TPU_FLEET_SEED_PORT — one seed\n'
          '        is enough, announce-response gossip converges the rest."""\n'
          '        if self.peers:\n'
          '            return self.peers\n'
          '        from ..parallel import multihost\n'
          '\n'
          '        contract = multihost.env_contract()\n'
          '        if contract is not None and contract.coordinator:\n'
          '            host = contract.coordinator.rsplit(":", 1)[0]\n'
          '            return (f"{host}:{self.seed_port}",)\n'
          '        return ()\n'),
         ('        """AIOS_TPU_FLEET_PEERS — one seed is enough, announce-response\n'
          '        gossip converges the rest. The port has no multihost env\n'
          '        contract, so no coordinator seeds the peers."""\n'
          '        return self.peers\n'),
         PARALLEL_REASON),
        (('    the service name passed in), rank from the multihost env contract,\n'
          '    and the package version."""\n'
          '    from .. import __version__\n'
          '    from ..parallel import multihost\n'
          '\n'
          '    contract = multihost.env_contract()\n'
          '    rank = contract.process_id if contract is not None else 0\n'),
         ('    the service name passed in), rank 0 (the port has no multihost env\n'
          '    contract: one process per rank), and the package version."""\n'
          '    from .. import __version__\n'
          '\n'),
         PARALLEL_REASON),
        ('        "rank": str(rank if rank is not None else 0),\n',
         '        "rank": "0",\n',
         PARALLEL_REASON),
    ],
    "fleet/router.py": [
        (('    """Wire bytes one KV row costs: per-page entry bytes / page size,\n'
          "    derived from the live cache arrays' dtypes and dims (shape/metadata\n"
          '    reads only — no device sync)."""\n'
          '    P = int(engine.allocator.page_size)\n'
          '    per_page = 0\n'
          '    for key in ("k", "v", "k_s", "v_s"):\n'
          '        a = engine.state.get(key) if hasattr(engine.state, "get") else None\n'
          '        if a is not None:\n'
          '            per_page += int(a.nbytes) // max(int(a.shape[1]), 1)\n'
          '    return max(per_page // P, 1)\n'),
         ('    """Wire bytes one KV row costs: per-page entry bytes / page size,\n'
          "    derived from the pool tensors' dtypes and dims (``k_pool``,\n"
          "    ``v_pool`` and an int8 pool's scales, as ``engine.page_bytes()``\n"
          '    sums them: shape/metadata reads only — no device sync)."""\n'
          '    P = int(engine.allocator.page_size)\n'
          '    return max(int(engine.page_bytes()) // P, 1)\n'),
         ENGINE_REASON),
    ],
    "fleet/__init__.py": [
        ('PR 16 built the fleet *telemetry* plane (obs/fleet.py): membership,\n',
         'The fleet *telemetry* plane (obs/fleet.py) carries membership,\n',
         NUMBERS_REASON),
        ('    service (``aios.fleet.KvTransfer``, aios_tpu_torch/protos/fleet.proto)\n',
         '    service (``aios.fleet.KvTransfer``, aios_tpu/protos/fleet.proto)\n',
         PROTOS_REASON),
        ('    PR 16 ``/fleet/announce`` heartbeat; peers score remote prefix\n',
         '    ``/fleet/announce`` heartbeat; peers score remote prefix\n',
         NUMBERS_REASON),
        ('    transfer plane, reusing the PR 10 resume-from-emitted contract, so\n',
         "    transfer plane, reusing failover's resume-from-emitted contract, so\n",
         NUMBERS_REASON),
        ('exactly like the PR 10\n``restore_fail`` path:',
         "exactly like the host\ntier's ``restore_fail`` path:",
         NUMBERS_REASON),
    ],
    "fleet/breaker.py": [
        ('paid a full kvx timeout re-probing it — the retry-every-prefill\nbehavior ISSUE 18 retires.\n',
         'paid a full kvx timeout re-probing it — the retry-every-prefill\nbehavior this module retires.\n',
         NUMBERS_REASON),
    ],
    "fleet/disagg.py": [
        ('applies). The handoff reuses the PR 10 resume-from-emitted contract\n',
         "applies). The handoff reuses failover's resume-from-emitted contract\n",
         NUMBERS_REASON),
        ('simply recomputes the prefill locally — the PR 10\n``restore_fail`` contract',
         "simply recomputes the prefill locally — the host\ntier's ``restore_fail`` contract",
         NUMBERS_REASON),
        ('    first-token-reproducibility limitation as PR 10 failover."""\n',
         '    first-token-reproducibility limitation as failover."""\n',
         NUMBERS_REASON),
    ],
    "fleet/drain.py": [
        ("A kill -9 is already survivable — PR 17's resume ladder re-hands every\n",
         "A kill -9 is already survivable — the handoff's resume ladder re-hands every\n",
         NUMBERS_REASON),
    ],
    "fleet/gprefix.py": [
        ('Each host piggybacks a bounded digest of its prefix caches on the PR 16\n',
         'Each host piggybacks a bounded digest of its prefix caches on the\n',
         NUMBERS_REASON),
    ],
    "fleet/kvx.py": [
        ('the PR 10 ``restore_fail`` contract: a failed transfer is a cache miss,\n',
         "the host tier's ``restore_fail`` contract: a failed transfer is a cache miss,\n",
         NUMBERS_REASON),
    ],
    "faults/net.py": [
        ("PR 17's ``fleet.host_kill`` covers the CLEAN loss (a process dies, exit\n",
         'The ``fleet.host_kill`` point covers the CLEAN loss (a process dies, exit\n',
         NUMBERS_REASON),
    ],
    "services.py": [
        ("`aios_tpu_torch/protos/` exactly (which in turn are wire-compatible with the\n"
         "reference's agent-core/proto).\n",
         "`aios_tpu/protos/` exactly (which in turn are wire-compatible with the\n"
         "reference's agent-core/proto).\n",
         PROTOS_REASON),
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
    rels = ["_compat.py", "services.py", *MODULES]
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
