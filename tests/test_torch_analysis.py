"""The port's analyzer (``aios_tpu_torch.analysis``) against the JAX
package's, and against its own tree.

* Parity: for every rule whose shapes both packages share (``lock-rpc``,
  ``lock-order``, ``guarded-by``, ``silent-except``, ``metric-catalog``,
  ``waiver-reason``) the same fixture sources go through
  ``aios_tpu.analysis.rules.Analyzer`` and the port's ``Analyzer``, each
  with a registry naming the fixture's locks: the same (rule, line)
  findings, waived the same way.
* The torch hazard shapes (``lock-readback`` on ``.item()`` / ``.cpu()`` /
  ``.tolist()`` / ``torch.cuda.synchronize`` ..., ``lock-dispatch`` on a
  graph replay under a bookkeeping lock, ``lock-rpc`` on a thread's join),
  module-level locks, ``graph-warmup`` and the declared knob tuples of
  ``knob-docs``: each seeded violation fires, its waived twin does not.
* The tree is clean through ``python -m aios_tpu_torch.analysis``'s
  ``main([])``; every registry lock is built by a ``make_lock(<name>)`` site
  at its declared place and every such site is declared.
* The runtime half on the port's real locks: under the suite's
  ``AIOS_TPU_LOCK_DEBUG=1`` the engine, batcher, batcher-queue, JSON-mask,
  model-manager, devprof-token, graph-capture and profiler-capture locks
  are DebugLocks, a served wave on ``tiny-test`` raises no inversion, and an
  AB/BA between the engine and batcher locks raises ``LockOrderError``.
"""

import ast
import json
import pathlib
import textwrap
import threading

import pytest
import torch

from aios_tpu.analysis import registry as jreg
from aios_tpu.analysis import rules as jrules
from aios_tpu.analysis.core import ModuleInfo as JModuleInfo
from aios_tpu_torch.analysis import __main__ as analysis_cli
from aios_tpu_torch.analysis import core, locks
from aios_tpu_torch.analysis import registry as reg
from aios_tpu_torch.analysis.core import ModuleInfo
from aios_tpu_torch.analysis.locks import DebugLock, LockOrderError
from aios_tpu_torch.analysis.registry import LOCKS, LockDecl, Registry
from aios_tpu_torch.analysis.rules import RULE_IDS, Analyzer

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIX = "fixture"


def _port_registry(**kw):
    return Registry(
        locks=kw.pop("locks", (
            LockDecl("fix", FIX, "Eng", "_lock"),
            LockDecl("other", FIX, "Other", "_lock"),
        )),
        field_types=kw.pop("field_types", {
            (FIX, "Eng", "other"): (FIX, "Other"),
            (FIX, "Other", "eng"): (FIX, "Eng"),
        }),
        global_types={},
        context_fns=kw.pop("context_fns", {}),
        hook_targets={},
        local_locks={},
        dispatch_hygiene_modules=kw.pop("dispatch_hygiene_modules", ()),
        silent_except_prefixes=kw.pop("silent_except_prefixes", (FIX,)),
        knob_declarations=kw.pop("knob_declarations", ()),
    )


def _jax_registry():
    return jreg.Registry(
        locks=(
            jreg.LockDecl("fix", FIX, "Eng", "_lock"),
            jreg.LockDecl("other", FIX, "Other", "_lock"),
        ),
        field_types={
            (FIX, "Eng", "other"): (FIX, "Other"),
            (FIX, "Other", "eng"): (FIX, "Eng"),
        },
        global_types={},
        context_fns={},
        hook_targets={},
        local_locks={},
        dispatch_hygiene_modules=(),
        silent_except_prefixes=(FIX,),
    )


def _analyze(src, registry=None, rules=None, doc=None):
    mi = ModuleInfo.from_source(textwrap.dedent(src), name=FIX, path="fixture.py")
    return Analyzer([mi], registry or _port_registry(), config_doc=doc).run(rules)


def _jax_analyze(src, rules=None):
    mi = JModuleInfo.from_source(textwrap.dedent(src), name=FIX, path="fixture.py")
    return jrules.Analyzer([mi], _jax_registry()).run(rules)


def _unwaived(findings, rule=None):
    return [f for f in findings if not f.waived and (rule is None or f.rule == rule)]


def _waive(src, line_text, rule):
    return src.replace(line_text, f"{line_text}  # aios: waive({rule}): fixture rationale", 1)


# -- parity with the JAX analyzer on the shapes both packages share ----------

RPC_SRC = """
    class Eng:
        def f(self):
            with self._lock:
                reply = self.runtime_stub.Infer(req)
                time.sleep(0.1)
                fut.result()
                done.wait()
                grpc.channel_ready_future(ch)
"""

CYCLE_SRC = """
    class Eng:
        def a(self):
            with self._lock:
                self.other.take()

        def grab(self):
            with self._lock:  # grab
                pass

    class Other:
        def take(self):
            with self._lock:
                pass

        def b(self):
            with self._lock:
                self.eng.grab()
"""

ACYCLIC_SRC = """
    class Eng:
        def a(self):
            with self._lock:
                self.other.take()

    class Other:
        def take(self):
            with self._lock:
                pass
"""

GUARDED_SRC = """
    class Eng:
        def __init__(self):
            self._live = {}  #: guarded_by _lock
            #: guarded_by _lock
            self._waiting = []

        def good(self):
            with self._lock:
                self._live[1] = "x"
                self._waiting.append(1)

        def bad(self):
            self._live.clear()
            self._waiting = []
            del self._live[2]
"""

SILENT_SRC = """
    class Pool:
        def a(self):
            try:
                self.batcher.shutdown()
            except Exception:
                pass

        def b(self):
            try:
                work()
            except:
                pass

        def c(self):
            try:
                work()
            except (ValueError, BaseException):
                pass

        def d(self):
            try:
                work()
            except ValueError:
                pass

        def e(self):
            try:
                work()
            except Exception as exc:
                log.warning("boom %s", exc)

        def f(self):
            try:
                work()
            except Exception:
                live.abort_reason = "evicted: boom"
"""

METRIC_SRC = """
    import collections
    COUNT = Counter("aios_tpu_fixture_total", "help", ("model",))
    LAT = Histogram("aios_tpu_fixture_seconds", "help")
    by_cat = collections.Counter(e["category"] for e in events)
    OTHER = Gauge("not_ours", "help")
"""

WAIVER_SRC = """
    class Eng:
        def f(self):
            with self._lock:  # aios: waive(lock-rpc)
                time.sleep(1)
            x = 1  # aios: waive(made-up-rule): because
            # aios: waive(lock-order):
            y = 2
"""

PARITY = {
    "lock-rpc": (RPC_SRC, ["reply = self.runtime_stub.Infer(req)", "time.sleep(0.1)"]),
    "lock-order": (CYCLE_SRC, ["with self._lock:  # grab"]),
    "guarded-by": (GUARDED_SRC, ["self._live.clear()", "self._waiting = []"]),
    "silent-except": (SILENT_SRC, ["except Exception:", "except:"]),
    "metric-catalog": (METRIC_SRC, ['LAT = Histogram("aios_tpu_fixture_seconds", "help")']),
    "waiver-reason": (WAIVER_SRC, []),
}


def _key(findings):
    return sorted((f.rule, f.line, f.waived, f.waive_reason) for f in findings)


@pytest.mark.parametrize("rule", sorted(PARITY))
def test_same_findings_as_the_jax_analyzer(rule):
    src, waive_lines = PARITY[rule]
    for text in [src, ACYCLIC_SRC] if rule == "lock-order" else [src]:
        port, jax_ = _analyze(text, rules=[rule]), _jax_analyze(text, rules=[rule])
        assert _key(port) == _key(jax_), (port, jax_)
    assert _unwaived(_analyze(src, rules=[rule]), rule), f"{rule} did not fire"
    # the waived twin: each named line waived in both, the same findings left
    waived = src
    for text in waive_lines:
        waived = _waive(waived, text, rule)
    port, jax_ = _analyze(waived, rules=[rule]), _jax_analyze(waived, rules=[rule])
    assert _key(port) == _key(jax_)
    if waive_lines:
        assert any(f.waived for f in port)
        assert len(_unwaived(port)) < len(_unwaived(_analyze(src, rules=[rule])))


def test_parity_fixture_counts():
    """The parity fixtures fire as many times as they were written to."""
    assert len(_unwaived(_analyze(RPC_SRC), "lock-rpc")) == 5
    assert len(_unwaived(_analyze(GUARDED_SRC), "guarded-by")) == 3
    assert len(_unwaived(_analyze(SILENT_SRC), "silent-except")) == 3
    assert len(_unwaived(_analyze(METRIC_SRC), "metric-catalog")) == 2
    assert len(_unwaived(_analyze(WAIVER_SRC), "waiver-reason")) == 3
    assert len(_unwaived(_analyze(CYCLE_SRC), "lock-order")) == 1
    assert not _unwaived(_analyze(ACYCLIC_SRC), "lock-order")


def test_jit_warmup_is_graph_warmup_on_the_port():
    assert "graph-warmup" in RULE_IDS and "jit-warmup" not in RULE_IDS
    assert [r for r in RULE_IDS if r != "graph-warmup"] == [
        r for r in jrules.RULE_IDS if r != "jit-warmup"]
    found = _analyze("x = 1  # aios: waive(jit-warmup): the JAX rule's name\n")
    assert _unwaived(found, "waiver-reason")


# -- the torch hazard shapes -------------------------------------------------

READBACKS = [
    "toks = self._first.item()",
    "host = out.cpu()",
    "ids = lengths.tolist()",
    "torch.cuda.synchronize(self.device)",
    "arr = t.numpy()",
    'host = t.to("cpu")',
    'host = t.to(device="cpu", copy=True)',
    "ms = start.elapsed_time(end)",
    "done = ev.query()",
    "ev.synchronize()",
    "self.stream.synchronize()",
]


def _locked(line, cls="Eng"):
    return f"""
        class {cls}:
            def f(self):
                with self._lock:
                    {line}
    """


@pytest.mark.parametrize("line", READBACKS)
def test_lock_readback_fires_on_each_torch_shape_and_waives(line):
    found = _unwaived(_analyze(_locked(line)), "lock-readback")
    assert len(found) == 1 and "fix" in found[0].message
    assert not _unwaived(_analyze(_waive(_locked(line), line, "lock-readback")))


@pytest.mark.parametrize("line", [
    'dev = t.to("cuda")', "dev = t.to(self.device)", "y = t.to(torch.bfloat16)",
    "x = np.asarray(host)", "n = len(self._live)", "v = d.get(k)",
])
def test_lock_readback_leaves_other_calls_alone(line):
    assert not _unwaived(_analyze(_locked(line)), "lock-readback")


@pytest.mark.parametrize("line", [
    "self.graphs.replay(key)", "graph.replay()", "self.engine.step(4)",
    "self.engine.prefill(slot, ids)", "self.engine.spec_step()",
    "self.engine.mega_step(8, stops, budgets)", "self.graphs.capture(key, body, prep)",
])
def test_lock_dispatch_fires_under_a_bookkeeping_lock_and_waives(line):
    found = _unwaived(_analyze(_locked(line)), "lock-dispatch")
    assert len(found) == 1
    assert not _unwaived(_analyze(_waive(_locked(line), line, "lock-dispatch")))


def test_the_engine_lock_shelters_dispatch_but_not_readback():
    reg_ = _port_registry(locks=(
        LockDecl("fix", FIX, "Eng", "_lock", forbids=("readback", "rpc")),))
    assert not _unwaived(_analyze(_locked("self.graphs.replay(key)"), reg_))
    assert _unwaived(_analyze(_locked("host = out.cpu()"), reg_), "lock-readback")
    assert reg.DEFAULT.lock_named("engine").forbids == ("readback", "rpc")
    assert reg.DEFAULT.lock_named("batcher").forbids == reg.HAZARDS


@pytest.mark.parametrize("line,fires", [
    ("self._thread.join()", True), ("t.join(5)", True), ("t.join(timeout=1.0)", True),
    ("q.join()", True), ('s = ", ".join(parts)', False), ("p = os.path.join(a, b)", False),
    ("s = sep.join(parts)", False), ('s = f"{x}".join(parts)', False),
])
def test_lock_rpc_counts_a_threads_join_never_str_join(line, fires):
    found = _unwaived(_analyze(_locked(line)), "lock-rpc")
    assert bool(found) == fires


def test_hazards_one_call_level_deep():
    src = """
        class Eng:
            def f(self):
                with self._lock:
                    self._helper()

            def _helper(self):
                return self._first.item()
    """
    found = _unwaived(_analyze(src), "lock-readback")
    assert len(found) == 1 and "_helper" in found[0].message
    waived = src.replace("self._helper()",
                         "self._helper()  # aios: waive(lock-readback): fixture rationale")
    assert not _unwaived(_analyze(waived), "lock-readback")


MODULE_LOCK_SRC = """
    _capture_lock = make_lock("cap")

    def capture(graph):
        with _capture_lock:
            graph.replay()
            n = count.item()

    class Eng:
        def f(self):
            with self._lock:
                capture(g)
"""


def test_a_module_level_lock_is_declared_checked_and_ordered():
    reg_ = _port_registry(locks=(
        LockDecl("fix", FIX, "Eng", "_lock", forbids=("readback", "rpc")),
        LockDecl("cap", FIX, None, "_capture_lock"),
    ))
    found = _analyze(MODULE_LOCK_SRC, reg_)
    assert {(f.rule, f.line) for f in _unwaived(found)} == {
        ("lock-dispatch", 6), ("lock-readback", 7)}
    assert reg_.lock_named("cap").module_level
    # the engine's lock, then the module lock: an edge that closes a cycle
    # once the module lock's body takes the engine's
    cyc = MODULE_LOCK_SRC + """
    def back(eng):
        with _capture_lock:
            eng.f()
"""
    reg_.field_types = {}
    a = Analyzer([ModuleInfo.from_source(textwrap.dedent(cyc), name=FIX,
                                         path="fixture.py")], reg_)
    a.run(["lock-order"])
    assert ("fix", "cap") in a._edges


# -- graph-warmup ------------------------------------------------------------

WARMUP_SRC = """
    class Eng:
        def warmup(self):
            self.capture_step()

        def capture_step(self):
            with self._lock:
                self._dispatcher("step", self._step_body)

        def step(self, n):
            with self._lock:
                run = self._dispatcher("step", self._step_body)
            return run()

        def _dispatcher(self, key, body):
            if key not in self.graphs:
                self._capture(key, body)
            return lambda: self.graphs.replay(key)

        def _capture(self, key, body):
            self.graphs.capture(key, body, self._prepare)
"""


def _hygiene():
    return _port_registry(dispatch_hygiene_modules=(FIX,))


def test_graph_warmup_fires_on_a_capture_a_serving_entry_reaches():
    found = _unwaived(_analyze(WARMUP_SRC, _hygiene()), "graph-warmup")
    assert {f.line for f in found} == {17, 21}
    assert all("serving entry Eng.step" in f.message for f in found)


def test_graph_warmup_waived_at_the_serve_time_capture():
    waived = _waive(WARMUP_SRC, "                self._capture(key, body)", "graph-warmup")
    found = _analyze(waived, _hygiene())
    assert not _unwaived(found, "graph-warmup")
    assert [f.line for f in found if f.waived] == [17]


def test_graph_warmup_clean_when_serving_only_replays():
    src = WARMUP_SRC.replace(
        """            if key not in self.graphs:
                self._capture(key, body)
            return""", """            return""").replace(
        """            with self._lock:
                self._dispatcher("step", self._step_body)""",
        """            with self._lock:
                self._capture("step", self._step_body)""")
    assert not _unwaived(_analyze(src, _hygiene()), "graph-warmup")


def test_graph_warmup_fires_on_a_capture_no_root_reaches():
    src = """
        class Eng:
            def warmup(self):
                pass

            def lazy(self):
                self.graphs.capture("k", body, prep)
    """
    found = _unwaived(_analyze(src, _hygiene()), "graph-warmup")
    assert len(found) == 1 and "not reachable from a warmup root" in found[0].message
    assert not _unwaived(_analyze(_waive(src, 'self.graphs.capture("k", body, prep)',
                                         "graph-warmup"), _hygiene()))


def test_graph_warmup_watches_the_engine_batcher_and_draft_modules():
    assert reg.DISPATCH_HYGIENE_MODULES == (
        "aios_tpu_torch.engine.engine", "aios_tpu_torch.engine.batching",
        "aios_tpu_torch.engine.spec")
    for root in ("warmup", "capture_step", "capture_admission", "capture_draft",
                 "capture_decode_loop"):
        assert reg.WARMUP_ROOT_RE.match(root)
    for entry in ("step", "step_async", "step_masked", "prefill", "spec_step", "jump_step",
                  "mega_step", "spec_step_draft", "start_chunked_prefill"):
        assert reg.SERVING_ENTRY_RE.match(entry)


# -- knob-docs and its declared tuples ----------------------------------------

KNOB_SRC = textwrap.dedent("""
    import os
    FLAG = os.environ.get("AIOS_TPU_FIXTURE_READ", "")
    UNPORTED_KNOBS = ("AIOS_TPU_FIXTURE_LATER",)
    NOT_CARRIED_KNOBS = {"AIOS_TPU_FIXTURE_GATE": "no such path here"}
""")
KNOB_DOC = """
| `AIOS_TPU_FIXTURE_READ` | read |
| `AIOS_TPU_FIXTURE_LATER` | warned |
| `AIOS_TPU_FIXTURE_GATE` | not carried |
"""


def _knob_registry():
    return _port_registry(knob_declarations=((FIX, "UNPORTED_KNOBS"),
                                             (FIX, "NOT_CARRIED_KNOBS")))


def test_knob_docs_accepts_the_declared_tuples():
    assert not _unwaived(_analyze(KNOB_SRC, _knob_registry(), doc=KNOB_DOC), "knob-docs")
    # without the declarations their rows are stale
    undeclared = "\n".join(line for line in KNOB_SRC.splitlines() if "_KNOBS" not in line)
    stale = _unwaived(_analyze(undeclared, _knob_registry(), doc=KNOB_DOC), "knob-docs")
    assert sorted(f.message.split()[2] for f in stale) == [
        "AIOS_TPU_FIXTURE_GATE", "AIOS_TPU_FIXTURE_LATER"]
    assert all(f.path.endswith("CONFIG.md") for f in stale)


def test_knob_docs_fires_both_ways_and_waives():
    found = _unwaived(_analyze(KNOB_SRC, _knob_registry(),
                               doc=KNOB_DOC + "| `AIOS_TPU_FIXTURE_GONE` | old |"),
                      "knob-docs")
    assert len(found) == 1 and "AIOS_TPU_FIXTURE_GONE" in found[0].message
    missing = KNOB_SRC + 'X = os.environ.get("AIOS_TPU_FIXTURE_NEW")\n'
    found = _unwaived(_analyze(missing, _knob_registry(), doc=KNOB_DOC), "knob-docs")
    assert len(found) == 1 and "AIOS_TPU_FIXTURE_NEW" in found[0].message
    waived = _waive(missing, 'X = os.environ.get("AIOS_TPU_FIXTURE_NEW")', "knob-docs")
    assert not _unwaived(_analyze(waived, _knob_registry(), doc=KNOB_DOC), "knob-docs")


def test_the_metric_catalog_is_the_ports():
    assert reg.METRIC_CATALOG_MODULES == {"aios_tpu_torch.obs.instruments",
                                          "aios_tpu_torch.obs.metrics"}
    from aios_tpu_torch.obs import instruments
    names = [lit for lit, _ in core.string_call_args(
        core.module_info_for(instruments).tree, ("Counter", "Gauge", "Histogram"))]
    assert names and all(n.startswith(reg.METRIC_PREFIX) for n in names)
    assert reg.SILENT_EXCEPT_PREFIXES == ("aios_tpu_torch.serving", "aios_tpu_torch.engine")


# -- the real tree, through the CLI entry point ------------------------------

def test_tree_is_clean():
    """Zero unwaived findings on the port's tree, through the exact entry
    point ``python -m aios_tpu_torch.analysis`` uses."""
    assert analysis_cli.main([]) == 0


def test_cli_rule_filter_json_and_waived(capsys):
    assert analysis_cli.main(["--rule", "lock-readback", "--json"]) == 0
    found = json.loads(capsys.readouterr().out)
    assert found and all(f["rule"] == "lock-readback" and f["waived"] and f["waive_reason"]
                         for f in found)
    assert analysis_cli.main(["--waived"]) == 0
    assert "[waived]" in capsys.readouterr().out


def test_cli_list_rules(capsys):
    assert analysis_cli.main(["--list-rules"]) == 0
    assert capsys.readouterr().out.split() == list(RULE_IDS)


def test_every_waiver_in_the_port_states_a_reason():
    for path in sorted((ROOT / "aios_tpu_torch").rglob("*.py")):
        if "analysis" in path.parts:
            continue
        for i, text in enumerate(path.read_text().splitlines(), 1):
            m = core.WAIVE_RE.search(text)
            if m:
                assert m.group(1) in RULE_IDS and len((m.group(2) or "").strip()) > 30, (
                    f"{path.relative_to(ROOT)}:{i}")


# -- the registry against the tree ---------------------------------------------

JAX_ROLES = ("engine", "engine_spill", "prefix_index", "host_store", "batcher",
             "batcher_queue", "json_masks", "pool", "router", "admission", "token_bucket",
             "recorder", "slo", "model_manager", "faults", "failover", "devprof",
             "autoscale", "tsdb", "incidents")
PORT_ROLES = ("engine_dp", "graph_capture", "profile_capture")


def test_the_registry_declares_the_jax_roles_and_the_ports_own():
    names = [d.name for d in LOCKS]
    assert len(names) == len(set(names))
    assert set(names) == set(JAX_ROLES) | set(PORT_ROLES)
    jax_decls = {d.name: d for d in jreg.LOCKS}
    for d in LOCKS:
        if d.name in JAX_ROLES:
            j = jax_decls[d.name]
            assert d.module == j.module.replace("aios_tpu.", "aios_tpu_torch.", 1)
            assert d.attr == j.attr and d.forbids == j.forbids
            assert d.class_name == ("TorchEngine" if j.class_name == "TPUEngine"
                                    else j.class_name)
    assert not {"fleet", "handoff", "quarantine", "drain"} & set(names)
    assert [d.name for d in LOCKS if d.module_level] == ["graph_capture", "profile_capture"]


def _make_lock_sites():
    """(module, class or None, attribute, lock name) of every
    ``<target> = make_lock("<name>")`` in the port outside analysis/."""
    sites = []
    for mi in core.load_package(ROOT / "aios_tpu_torch", ROOT, "aios_tpu_torch"):
        if mi.name.startswith("aios_tpu_torch.analysis"):
            continue
        for node in ast.walk(mi.tree):
            if not (isinstance(node, ast.Call) and core.callee_chain(node)[-1:] == [
                    "make_lock"]):
                continue
            parent = node._aios_parent
            assert isinstance(parent, ast.Assign) and len(parent.targets) == 1, (
                f"{mi.path}:{node.lineno}: make_lock outside a plain assignment")
            t = parent.targets[0]
            name = node.args[0].value
            if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) and (
                    t.value.id == "self"):
                sites.append((mi.name, mi.enclosing_class(node), t.attr, name))
            else:
                assert isinstance(t, ast.Name) and mi.enclosing_function(node) is None, (
                    f"{mi.path}:{node.lineno}")
                sites.append((mi.name, None, t.id, name))
    return sites


def test_registry_locks_all_wired_to_make_lock_and_back():
    """Both directions: every declared lock is built by make_lock(<its
    name>) at its declared module, class and attribute (a module global for
    a module-level lock), and every make_lock site in the port is a
    declared lock, so AIOS_TPU_LOCK_DEBUG checks exactly what the analyzer
    defends."""
    sites = _make_lock_sites()
    declared = {(d.module, d.class_name, d.attr, d.name) for d in LOCKS}
    assert sorted(set(sites), key=str) == sorted(declared, key=str)
    assert len(sites) == len(declared)


# -- the runtime half on the port's real locks -----------------------------------

@pytest.fixture(scope="module")
def tiny_batcher():
    from aios_tpu_torch.engine.batching import ContinuousBatcher
    from aios_tpu_torch.engine.config import TINY_TEST
    from aios_tpu_torch.engine.engine import TorchEngine
    from aios_tpu_torch.engine.weights import init_params

    assert locks.debug_enabled(), "the suite's conftest sets AIOS_TPU_LOCK_DEBUG=1"
    params = init_params(TINY_TEST, torch.Generator().manual_seed(0), dtype=torch.float32,
                         device="cpu")
    eng = TorchEngine(TINY_TEST, params, cache_dtype=torch.float32, device="cpu", num_slots=2,
                      max_context=256, paged_pool_rows=1024)
    assert eng.paged and eng.prefix_index is not None
    batcher = ContinuousBatcher(eng)
    yield eng, batcher
    batcher.shutdown()
    eng.close()


@pytest.fixture
def saved_edges():
    """The process's observed lock-order edges, put back after the test so
    that a deliberate inversion here does not poison later tests."""
    with locks._state_lock:
        saved = dict(locks._edges)
    yield
    with locks._state_lock:
        locks._edges.clear()
        locks._edges.update(saved)


def test_the_hot_locks_are_debug_locks_under_the_suites_flag(tiny_batcher):
    from aios_tpu_torch.engine import graphs
    from aios_tpu_torch.obs import devprof
    from aios_tpu_torch.runtime.model_manager import ModelManager

    eng, batcher = tiny_batcher
    manager = ModelManager(num_slots=2, device="cpu")
    try:
        got = {"engine": eng._lock, "engine_dp": eng._dp_lock,
               "engine_spill": eng._spill_lock, "batcher": batcher._lock,
               "batcher_queue": batcher._qlock, "json_masks": batcher._json_masks_lock,
               "model_manager": manager._lock, "graph_capture": graphs._capture_lock,
               "profile_capture": devprof._capture_lock}
    finally:
        manager.close()
    for name, lk in got.items():
        assert isinstance(lk, DebugLock) and lk.name == name, name


def test_a_served_wave_takes_the_real_locks_in_order(tiny_batcher):
    from aios_tpu_torch.engine.batching import Request

    eng, batcher = tiny_batcher
    errors0 = len(locks.order_errors())
    for _ in range(2):  # the second wave hits the prefix index the first filled
        handles = [batcher.submit(Request(prompt_ids=list(range(1 + i, 140)), max_tokens=6,
                                          temperature=0.0)) for i in range(3)]
        streams = [h.tokens() for h in handles]
        assert all(len(t) == 6 for t in streams) and not any(h.aborted for h in handles)
    assert locks.order_errors()[errors0:] == []
    assert ("engine", "prefix_index") in locks.observed_edges()


def test_an_ab_ba_on_the_engine_and_batcher_locks_raises(tiny_batcher, saved_edges):
    eng, batcher = tiny_batcher

    def engine_then_batcher():
        with eng._lock:
            with batcher._lock:
                pass

    t = threading.Thread(target=engine_then_batcher)
    t.start()
    t.join()
    caught = []

    def batcher_then_engine():
        try:
            with batcher._lock:
                with eng._lock:
                    pass
        except LockOrderError as exc:
            caught.append(exc)

    errors0 = len(locks.order_errors())
    t = threading.Thread(target=batcher_then_engine, name="inverted")
    t.start()
    t.join()
    assert len(caught) == 1
    msg = str(caught[0])
    assert "'engine'" in msg and "'batcher'" in msg and "opposite order" in msg
    assert locks.order_errors()[errors0:] == [
        {"held": "batcher", "acquiring": "engine", "thread": "inverted"}]
    assert not eng._lock.locked() and not batcher._lock.locked()


def test_an_ab_ba_through_the_module_level_capture_lock_raises(saved_edges):
    """The capture lock is taken inside an engine's lock (``GraphSet.capture``
    under ``_capture``); a thread that held the capture lock and then took
    an engine lock would close the cycle."""
    from aios_tpu_torch.engine import graphs

    eng_role = DebugLock("engine")
    with eng_role:
        with graphs._capture_lock:
            pass
    assert ("engine", "graph_capture") in locks.observed_edges()
    with pytest.raises(LockOrderError):
        with graphs._capture_lock:
            with eng_role:
                pass
    assert not graphs._capture_lock.locked()


def test_no_copy_lost_its_field_contracts():
    """Every module of the JAX package (the fleet plane and the analyzer
    aside) carries no more ``#: guarded_by`` pragmas than its counterpart in
    the port: a copy that turned one into a plain comment leaves the
    guarded-by rule blind to that field."""
    jax_root, port_root = ROOT / "aios_tpu", ROOT / "aios_tpu_torch"
    checked = 0
    for path in sorted(jax_root.rglob("*.py")):
        rel = path.relative_to(jax_root).as_posix()
        if rel.startswith(("fleet/", "analysis/")) or rel == "obs/fleet.py":
            continue
        want = path.read_text().count("#: guarded_by")
        if not want:
            continue
        have = (port_root / rel).read_text().count("#: guarded_by")
        assert have >= want, f"{rel}: {have} guarded_by pragmas in the port, {want} in JAX"
        checked += 1
    assert checked >= 14
