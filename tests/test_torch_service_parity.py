"""The port's service plane held to the JAX package's, side by side.

Each test runs one scenario through ``aios_tpu`` and through ``aios_tpu_torch``
in this process (gRPC servers on 127.0.0.1:0) and compares what both give:
memory (events, goals, tasks, patterns, the hybrid search's ranking), tools
(the catalog, idempotent tools on a temp tree, the audit chain's hashes),
the gateway's routing and budget decisions, the orchestrator's task plans,
heuristics, parsers, scheduler and agent router, ``boot.serving_env`` and the
topology, the agents' catalog and ``native`` (against ``hashlib`` too).
"""

import hashlib
import importlib
import itertools
import json
import random
import time

import numpy as np
import pytest
from google.protobuf.json_format import MessageToDict

PKGS = ("aios_tpu", "aios_tpu_torch")


def both(module: str):
    """(the JAX module, the port's module) of ``module``, e.g. 'memory.tiers'."""
    return tuple(importlib.import_module(f"{p}.{module}") for p in PKGS)


def same(fn):
    """fn(package name) on both packages; both results, asserted equal."""
    a, b = (fn(p) for p in PKGS)
    assert a == b
    return a


# -- memory ------------------------------------------------------------------

TEXTS = (
    "restart the nginx service after a config change",
    "disk usage on /var exceeded 90 percent",
    "rotate the TLS certificates before they expire",
    "incident: nginx crashed due to OOM",
    "notes about the mesh topology of the serving pool",
    "the weather in paris is sunny",
    "procedure: clean /tmp when the disk is full",
    "kernel upgrade scheduled for sunday night",
)


def test_embeddings_and_scores_equal():
    ej, ep = both("memory.embeddings")
    for text in TEXTS:
        np.testing.assert_array_equal(ej.embed(text), ep.embed(text))
    q = "nginx disk full"
    for text in TEXTS:
        assert ej.hybrid_score(q, ej.embed(q), text, ej.embed(text)) == ep.hybrid_score(
            q, ep.embed(q), text, ep.embed(text))


@pytest.mark.parametrize("query,collections", [
    ("nginx restart", None), ("disk full", None), ("certificates", ["b"]),
    ("paris weather", ["a", "c"]),
])
def test_longterm_search_ranks_alike(query, collections):
    def run(pkg):
        lt = importlib.import_module(f"{pkg}.memory.tiers").LongTermMemory()
        rng = random.Random(7)
        for text in TEXTS:
            lt.store_memory(text, collection=rng.choice("abc"))
        lt.add_knowledge("nginx tuning", "raise the worker count", source="docs")
        hits = lt.search(query, collections=collections, n_results=5)
        know = lt.search_knowledge("nginx workers")
        return ([(h["content"], h["collection"], round(h["relevance"], 12)) for h in hits],
                [h["content"] for h in know])

    same(run)


def test_working_memory_lifecycle_alike(tmp_path):
    def run(pkg):
        w = importlib.import_module(f"{pkg}.memory.tiers").WorkingMemory(
            str(tmp_path / f"{pkg}.db"))
        w.store_goal({"id": "g1", "description": "fix disk", "status": "in_progress"})
        w.store_goal({"id": "g2", "description": "rotate certs", "status": "pending"})
        w.store_task({"id": "t1", "goal_id": "g1", "description": "check df"})
        w.store_task({"id": "t2", "goal_id": "g1", "description": "clean tmp"})
        active = sorted(g["id"] for g in w.active_goals())
        tasks = sorted(t["description"] for t in w.tasks_for_goal("g1"))
        w.update_goal("g1", "completed", result="done")
        for i in range(12):
            w.store_pattern({"id": f"p{i}", "trigger": f"t{i}", "action": "a",
                             "success_rate": i / 12.0, "uses": i})
        w.update_pattern_stats("p11", success=False)
        p = w.find_pattern("t11")
        removed = w.prune_patterns(cap=4)
        return (active, tasks, sorted(g["id"] for g in w.active_goals()),
                (p["uses"], round(p["success_rate"], 12)), removed,
                w.find_pattern("t0") is None)

    same(run)


def _memory_script(stub, pb) -> dict:
    """One pass over the memory RPCs; the replies with ids and clocks dropped."""
    def d(msg):
        out = MessageToDict(msg, preserving_proto_field_name=True)
        for key in ("timestamp", "id", "created_at", "updated_at", "completed_at",
                    "last_used"):
            out.pop(key, None)
        return out

    for i in range(6):
        stub.PushEvent(pb.Event(category="sys", source=f"s{i}", data_json=b'{"x":1}'))
    events = [
        {k: v for k, v in d(e).items() if k in ("category", "source", "data_json")}
        for e in stub.GetRecentEvents(pb.RecentEventsRequest(count=4)).events
    ]
    stub.UpdateMetric(pb.MetricUpdate(key="cpu", value=55.5))
    metric = stub.GetMetric(pb.MetricRequest(key="cpu")).value
    stub.StoreGoal(pb.GoalRecord(id="g9", description="test goal", status="pending"))
    stub.StoreTask(pb.TaskRecord(id="t9", goal_id="g9", description="step"))
    goals = [g.id for g in stub.GetActiveGoals(pb.Empty()).goals]
    tasks = [t.description for t in stub.GetTasksForGoal(pb.GoalIdRequest(goal_id="g9")).tasks]
    stub.StorePattern(pb.Pattern(id="pp", trigger="disk full", action="clean /tmp",
                                 success_rate=0.9, uses=3))
    stub.UpdatePatternStats(pb.PatternStatsUpdate(id="pp", success=True))
    found = stub.FindPattern(pb.PatternQuery(trigger="disk"))
    stub.StoreAgentState(pb.AgentState(agent_name="system_agent", state_json=b'{"n":1}'))
    state = stub.GetAgentState(pb.AgentStateRequest(agent_name="system_agent")).state_json
    stub.StoreProcedure(pb.Procedure(name="restart service", description="systemctl restart",
                                     steps_json=b"[]"))
    stub.StoreIncident(pb.Incident(description="OOM on nginx", root_cause="memory leak"))
    stub.StoreConfigChange(pb.ConfigChange(file_path="/etc/nginx.conf", content="worker=4",
                                           changed_by="test"))
    stub.AddKnowledge(pb.KnowledgeEntry(title="nginx tuning", content="raise worker count",
                                        source="docs"))
    search = [(r.content, round(r.relevance, 12)) for r in stub.SemanticSearch(
        pb.SemanticSearchRequest(query="nginx memory", n_results=3)).results]
    knowledge = [r.content for r in stub.SearchKnowledge(
        pb.SemanticSearchRequest(query="nginx workers", n_results=3)).results]
    ctx = stub.AssembleContext(pb.ContextRequest(task_description="nginx", max_tokens=50))
    return {"events": events, "metric": metric, "goals": goals, "tasks": tasks,
            "pattern": (found.found, found.pattern.action, found.pattern.uses),
            "state": state, "search": search, "knowledge": knowledge,
            "context": (ctx.total_tokens, [(c.source, c.tokens) for c in ctx.chunks])}


def test_memory_service_rpcs_alike():
    def run(pkg):
        rpc = importlib.import_module(f"{pkg}.rpc")
        services = importlib.import_module(f"{pkg}.services")
        pb = importlib.import_module(f"{pkg}.proto_gen.memory_pb2")
        serve = importlib.import_module(f"{pkg}.memory.service").serve
        server, _, port = serve(address="127.0.0.1:0", block=False)
        channel = rpc.insecure_channel(f"127.0.0.1:{port}")
        try:
            return _memory_script(services.MemoryServiceStub(channel), pb)
        finally:
            channel.close()
            server.stop(grace=None)

    out = same(run)
    assert out["knowledge"] and out["goals"] == ["g9"] and out["pattern"][0]


# -- tools -------------------------------------------------------------------


def _executor(pkg, tmp_path):
    ex = importlib.import_module(f"{pkg}.tools.executor")
    d = tmp_path / pkg
    d.mkdir(exist_ok=True)
    return ex.ToolExecutor(audit_path=str(d / "audit.db"), backup_dir=str(d / "backups"),
                           plugin_dir=str(d / "plugins"))


def test_tool_catalog_alike(tmp_path):
    def run(pkg):
        e = _executor(pkg, tmp_path)
        return {name: (s.description, s.reversible, s.idempotent, s.target_arg,
                       s.requires_confirmation, s.timeout_ms, s.version)
                for name, s in e.registry.items()}

    assert len(same(run)) > 80


def _tree(root):
    rng = random.Random(3)
    for i in range(6):
        sub = root / f"d{i % 2}"
        sub.mkdir(parents=True, exist_ok=True)
        (sub / f"f{i}.txt").write_text(
            "".join(rng.choice("abcdef \n") for _ in range(200 + 50 * i)))


IDEMPOTENT_CALLS = [
    ("fs.list", lambda t: {"path": str(t)}),
    ("fs.list", lambda t: {"path": str(t / "d1"), "limit": 2}),
    ("fs.read", lambda t: {"path": str(t / "d0" / "f2.txt"), "max_bytes": 64}),
    ("fs.stat", lambda t: {"path": str(t / "d1" / "f3.txt")}),
    ("fs.search", lambda t: {"path": str(t), "pattern": "*.txt", "content": "ab"}),
    ("fs.disk_usage", lambda t: {"path": str(t)}),
    ("fs.read", lambda t: {"path": str(t / "missing")}),
    ("no.such_tool", lambda t: {}),
]


def test_idempotent_tools_answer_alike(tmp_path):
    tree = tmp_path / "tree"
    _tree(tree)

    def run(pkg):
        e = _executor(pkg, tmp_path)
        out = []
        for name, args in IDEMPOTENT_CALLS:
            r = e.execute(agent_id="system_agent", tool_name=name,
                          input_json=json.dumps(args(tree)).encode())
            out.append((name, r.success, r.output, r.error))
        return out

    results = same(run)
    assert [ok for _, ok, _, _ in results] == [True] * 6 + [False, False]


def test_tools_service_rpcs_alike(tmp_path):
    def run(pkg):
        rpc = importlib.import_module(f"{pkg}.rpc")
        services = importlib.import_module(f"{pkg}.services")
        pb = importlib.import_module(f"{pkg}.proto_gen.tools_pb2")
        serve = importlib.import_module(f"{pkg}.tools.service").serve
        server, _, port = serve(address="127.0.0.1:0", executor=_executor(pkg, tmp_path),
                                block=False)
        channel = rpc.insecure_channel(f"127.0.0.1:{port}")
        try:
            stub = services.ToolRegistryStub(channel)
            listed = sorted((t.name, t.namespace, t.risk_level, t.idempotent)
                            for t in stub.ListTools(pb.ListToolsRequest()).tools)
            one = MessageToDict(stub.GetTool(pb.GetToolRequest(name="monitor.cpu")))
            r = stub.Execute(pb.ExecuteRequest(tool_name="fs.list", agent_id="system_agent",
                                               input_json=json.dumps(
                                                   {"path": str(tmp_path)}).encode()))
            return listed, one, r.success, sorted(json.loads(r.output_json)["entries"][0])
        finally:
            channel.close()
            server.stop(grace=None)

    same(run)


class _Clock:
    """Deterministic uuid4 / time for the audit ledger of one package."""

    def __init__(self):
        self._n = itertools.count()

    def uuid4(self):
        import uuid

        return uuid.UUID(int=next(self._n))

    @staticmethod
    def time():
        return 1_700_000_000.0


def test_audit_chain_hashes_alike(monkeypatch):
    records = [("system_agent", f"tool.{i % 3}", f"in{i}".encode(), f"out{i}".encode(),
                i % 4 != 0, "autonomy") for i in range(9)]

    def run(pkg):
        audit = importlib.import_module(f"{pkg}.tools.audit")
        clock = _Clock()
        monkeypatch.setattr(audit, "uuid", clock)
        monkeypatch.setattr(audit, "time", clock)
        log = audit.AuditLog()
        for rec in records:
            log.record(*rec)
        rows = log._conn.execute("SELECT prev_hash, hash FROM audit_log ORDER BY seq").fetchall()
        return rows, log.verify_chain()

    rows, verdict = same(run)
    assert verdict == (True, None) and len(rows) == len(records)


def test_capabilities_and_rate_limits_alike():
    def run(pkg):
        caps = importlib.import_module(f"{pkg}.tools.capabilities")
        checker = caps.CapabilityChecker()
        agents = ("system_agent", "network_agent-1", "security_agent", "web_agent", "nobody")
        tools = ("fs.read", "fs.write", "net.ping", "process.kill", "sec.grant",
                 "pkg.install", "monitor.cpu", "plugin.create")
        return [(a, t, checker.check(a, t)) for a in agents for t in tools]

    same(run)


# -- gateway -------------------------------------------------------------------


@pytest.mark.parametrize("keys", [(), ("CLAUDE_API_KEY",), ("OPENAI_API_KEY", "QWEN3_API_KEY"),
                                  ("CLAUDE_API_KEY", "OPENAI_API_KEY", "QWEN3_API_KEY")])
def test_gateway_routing_alike(keys, monkeypatch):
    for var in ("CLAUDE_API_KEY", "OPENAI_API_KEY", "QWEN3_API_KEY"):
        monkeypatch.delenv(var, raising=False)
    for var in keys:
        monkeypatch.setenv(var, "test-key")
    # nothing is sent: only the selection policy is read
    for var in ("CLAUDE_BASE_URL", "OPENAI_BASE_URL", "QWEN3_BASE_URL"):
        monkeypatch.setenv(var, "http://127.0.0.1:9")

    def run(pkg):
        router = importlib.import_module(f"{pkg}.gateway.router").RequestRouter(
            runtime_address="127.0.0.1:9")
        out = {}
        for pref, fallback in itertools.product(("", "claude", "openai", "qwen3", "local",
                                                 "nope"), (True, False)):
            errors = []
            out[(pref, fallback)] = [n for n, _ in router._candidates(pref, fallback, errors)]
            out[(pref, fallback, "errors")] = errors
        return out

    same(run)


def test_budget_decisions_alike():
    def run(pkg):
        budget = importlib.import_module(f"{pkg}.gateway.budget")
        b = budget.BudgetManager(claude_budget=10.0, openai_budget=5.0)
        trail = []
        for provider, tin, tout in (("claude", 1_000_000, 0), ("openai", 200_000, 100_000),
                                    ("claude", 2_000_000, 0), ("openai", 900_000, 400_000),
                                    ("claude", 1_000_000, 0), ("qwen3", 50_000, 5_000)):
            b.record(provider, "m", tin, tout)
            trail.append((round(b.used(provider), 9), b.warning(provider),
                          b.can_afford("claude"), b.can_afford("openai"),
                          b.status()["budget_exceeded"]))
        return trail

    same(run)


# -- orchestrator ----------------------------------------------------------------

GOALS = (
    "check cpu usage", "check memory usage and report status", "ping 10.0.0.1",
    "restart the nginx service", "investigate strange log entries",
    "audit the ssh configuration", "install and configure postgres",
    "design a backup strategy for the cluster", "diagnose network connectivity issues",
    "read the file /etc/hostname", "status of service sshd", "clean up old logs",
    "Summarize how this host is doing for the operator",
)


@pytest.mark.parametrize("description", GOALS)
def test_task_plans_alike(description):
    def run(pkg):
        ge = importlib.import_module(f"{pkg}.orchestrator.goal_engine")
        tp = importlib.import_module(f"{pkg}.orchestrator.task_planner")
        au = importlib.import_module(f"{pkg}.orchestrator.autonomy")
        goal = ge.Goal(id="g", description=description)
        tasks = tp.TaskPlanner().decompose_goal(goal)
        index = {t.id: i for i, t in enumerate(tasks)}
        return (tp.classify_complexity(description),
                [(t.description, t.intelligence_level, t.required_tools,
                  [index[d] for d in t.depends_on], au.heuristic_tool_calls(t))
                 for t in tasks])

    same(run)


REPLIES = (
    '{"thought": "look", "tool_calls": [{"tool": "monitor.cpu", "args": {}}], "done": false}',
    '```json\n{"calls": [{"name": "fs.read", "input": {"path": "/x"}}], "done": true}\n```',
    '<think>hmm</think>[{"tool": "net.ping", "args": {"host": "h"}}]',
    "I will run monitor.memory and then fs.list on /tmp",
    '{"answer": "all good", "done": true}', "", "not json {at all",
)


@pytest.mark.parametrize("reply", REPLIES)
def test_reply_parsing_alike(reply):
    same(lambda pkg: importlib.import_module(
        f"{pkg}.orchestrator.autonomy").parse_tool_calls(reply))


def test_toolcalls_schema_alike():
    catalog = ["monitor.cpu", "fs.read", 'bad"name', "net.ping"]
    same(lambda pkg: json.dumps(importlib.import_module(
        f"{pkg}.orchestrator.autonomy").toolcalls_schema(catalog), sort_keys=True))


def test_cron_matching_alike():
    exprs = ("* * * * *", "*/15 * * * *", "0 3 * * *", "30 2 * * 1-5", "0,30 */2 1 * *",
             "5 4 * * 0", "0 0 1 1 *")
    stamps = [time.gmtime(1_700_000_000 + 1_234_567 * i) for i in range(40)]

    def run(pkg):
        sched = importlib.import_module(f"{pkg}.orchestrator.scheduler")
        return [[sched.matches_cron(e, t) for t in stamps] for e in exprs]

    same(run)


def test_scheduler_fires_alike(tmp_path):
    def run(pkg):
        sched = importlib.import_module(f"{pkg}.orchestrator.scheduler")
        fired = []
        s = sched.GoalScheduler(lambda d, p: fired.append((d, p)) or "gid",
                                db_path=str(tmp_path / f"{pkg}.db"))
        s.create("*/5 * * * *", "sweep temp files", priority=3)
        s.create("0 * * * *", "hourly report")
        t0 = 1_700_000_000 - 1_700_000_000 % 3600
        counts = [s.tick(now=t0 + 60 * i) for i in range(12)]
        return counts, fired

    counts, fired = same(run)
    assert sum(counts) == len(fired) > 0


def test_agent_router_decisions_alike():
    def run(pkg):
        ar = importlib.import_module(f"{pkg}.orchestrator.agent_router")
        ge = importlib.import_module(f"{pkg}.orchestrator.goal_engine")
        r = ar.AgentRouter()
        for aid, ns, done in (("sys-1", ["fs", "service"], 2), ("sys-2", ["fs", "service"], 9),
                              ("net-1", ["net", "monitor"], 4), ("mon-1", ["monitor"], 1)):
            r.register(ar.TrackedAgent(agent_id=aid, agent_type=aid.split("-")[0],
                                       tool_namespaces=ns, tasks_completed=done))
        picks = []
        for i, tools in enumerate((["service"], ["monitor"], ["fs"], ["net", "monitor"],
                                   [], ["pkg"], ["fs", "service"], ["monitor"])):
            t = ge.Task(id=f"t{i}", goal_id="g", description="x", required_tools=tools)
            picks.append(r.route_task(t))
            if i == 3:
                r.task_finished("net-1", True)
        queued = [(aid, getattr(r.next_task_for(aid), "id", None))
                  for aid in ("sys-1", "sys-2", "net-1", "mon-1")]
        return picks, queued

    same(run)


# -- boot ----------------------------------------------------------------------

TOML = (
    "[models]\n"
    'kv_cache = "int8"\n'
    "paged_kv_rows = 8192\n"
    "speculative = true\n"
    'json_mode = "force"\n'
    "guided_toolcalls = true\n"
    'quantize = "1"\n'
    'mesh = "dp=2,tp=2"\n'
    "replicas = 2\n"
    "tenant_tokens_per_sec = 500\n"
    "max_queue = 0\n"
    "decode_pipeline = false\n"
    "mega_ticks = 8\n"
    'paged_kv_rows_bad = "x"\n'
    "[boot]\n"
    "max_restart_attempts = 2\n"
)


@pytest.mark.parametrize("text", [TOML, "", "[models]\npaged_kv_rows = \"lots\"\n"])
def test_serving_env_alike(text, tmp_path, monkeypatch):
    for var in ("AIOS_TPU_KV_CACHE", "AIOS_TPU_PAGED_KV", "AIOS_TPU_QUANTIZE",
                "AIOS_TPU_GUIDED_TOOLCALLS", "AIOS_TPU_JSON_MODE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("AIOS_TPU_REPLICAS", "3")  # env beats config
    path = tmp_path / "config.toml"
    path.write_text(text)

    def run(pkg):
        config = importlib.import_module(f"{pkg}.boot.config")
        cfg = config.load_config(str(path))
        return config.serving_env(cfg), cfg.sections

    env, _ = same(run)
    assert "AIOS_TPU_REPLICAS" not in env


def test_topology_alike():
    sj, sp = both("boot.supervisor")
    dj, dp = sj.default_services(), sp.default_services()
    assert list(dj) == list(dp)
    for name in dj:
        a, b = dj[name], dp[name]
        assert (a.port, a.deps, a.env) == (b.port, b.deps, b.env)
        assert b.module == a.module.replace("aios_tpu.", "aios_tpu_torch.", 1)
        assert b.args == []
    assert sj.topo_sort(dj) == sp.topo_sort(dp)


def test_hardware_report_keys_alike():
    hj, hp = both("boot.hardware")
    a, b = hj.detect(probe_tpu=False), hp.detect(probe_tpu=False)
    assert vars(a) == vars(b)
    sj, sp = both("tools.handlers.system")
    # the port fills the accelerator keys from torch.cuda; none goes missing
    assert sorted(sp.hw_info({})) == sorted(sj.hw_info({}))
    assert sorted(vars(hp.detect())) == sorted(vars(a))


# -- agents and native ------------------------------------------------------------


def test_agent_catalog_alike():
    def run(pkg):
        agents = importlib.import_module(f"{pkg}.agents")
        out = {}
        for t in agents.AGENT_TYPES:
            a = agents.agent_class(t)(name=f"{t}-x")
            out[t] = (a.get_agent_type(), a.get_capabilities(), a.get_tool_namespaces(),
                      a.periodic_interval)
        return out

    assert len(same(run)) == 10


PAYLOADS = [b"", b"abc", bytes(range(256)) * 9, "ünïcode ✓".encode()]


@pytest.mark.parametrize("data", PAYLOADS)
def test_native_hashes_alike(data):
    nj, np_ = both("native")
    if not (nj.available() and np_.available()):
        pytest.skip("no g++ on this host: both packages take their Python path")
    want = hashlib.sha256(data).hexdigest()
    assert nj.sha256_hex(data) == np_.sha256_hex(data) == want
    prev = hashlib.sha256(b"prev").hexdigest()
    assert nj.chain_hash(prev, data) == np_.chain_hash(prev, data)


def test_native_ring_and_bucket_alike():
    nj, np_ = both("native")
    if not (nj.available() and np_.available()):
        pytest.skip("no g++ on this host: both packages take their Python path")

    def run(native):
        ring = native.NativeRing(4)
        for i in range(7):
            ring.push(f"item-{i}".encode() * (i + 1))
        bucket = native.NativeTokenBucket(rate=0.0, capacity=3)
        return (len(ring), ring.total_pushed, ring.recent(6),
                [bucket.try_acquire() for _ in range(5)])

    assert run(nj) == run(np_)
