"""The port's observability plane held to the JAX package's: tracing, the RPC
interceptors and their counts, the SLO engine's evaluations, the tsdb's
answers, the HTTP route index and endpoint, incident bundles, and the
instrument catalog's new families (twins of ``tests/test_obs_lint.py``)."""

import ast
import importlib
import json
import pathlib
import random
import re
import time
import urllib.error
import urllib.request

import grpc
import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKGS = ("aios_tpu", "aios_tpu_torch")


def both(module: str):
    return tuple(importlib.import_module(f"{p}.{module}") for p in PKGS)


def _get(url: str):
    """(status, parsed JSON or text) of a GET, error statuses included."""
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            status, body = r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        status, body = e.code, e.read().decode()
    try:
        return status, json.loads(body)
    except ValueError:
        return status, body


# -- tracing --------------------------------------------------------------------


@pytest.mark.parametrize("value", [
    "00-" + "a" * 32 + "-" + "b" * 16 + "-01", "00-" + "A" * 32 + "-" + "B" * 16 + "-00",
    "", "garbage", "00-" + "a" * 31 + "-" + "b" * 16 + "-01", " 00-" + "c" * 32 + "-"
    + "d" * 16 + "-01 ",
])
def test_traceparent_parsing_alike(value):
    jt, pt = both("obs.tracing")
    assert jt.parse_traceparent(value) == pt.parse_traceparent(value)


def test_span_tree_and_remote_continuation():
    _, pt = both("obs.tracing")
    pt.clear_spans()
    with pt.start_span("goal") as root:
        with pt.start_span("task", k=1) as child:
            assert pt.current_traceparent() == child.traceparent
        assert child.trace_id == root.trace_id and child.parent_id == root.span_id
    with pt.continue_span(root.traceparent, "rpc.server") as srv:
        assert (srv.trace_id, srv.parent_id) == (root.trace_id, root.span_id)
    with pt.continue_span("bogus", "rpc.server") as fresh:
        assert fresh.trace_id != root.trace_id and fresh.parent_id == ""
    assert [s.name for s in pt.recent_spans()] == ["task", "goal", "rpc.server",
                                                  "rpc.server"]
    with pytest.raises(RuntimeError):
        with pt.start_span("boom"):
            raise RuntimeError("x")
    assert pt.recent_spans("boom")[-1].status == "error"


# -- the interceptors ---------------------------------------------------------------


def _echo(pkg):
    """A small service on ``pkg``'s rpc plumbing: Ping (OK), Fail (aborts
    INVALID_ARGUMENT), Count (streams n Status messages)."""
    rpc = importlib.import_module(f"{pkg}.rpc")
    common_pb2 = importlib.import_module(f"{pkg}.proto_gen.common_pb2")
    spec = rpc.ServiceSpec("aios.test.Echo", {
        "Ping": rpc.Method(common_pb2.Empty, common_pb2.Status),
        "Fail": rpc.Method(common_pb2.Empty, common_pb2.Status),
        "Count": rpc.Method(common_pb2.Status, common_pb2.Status, server_streaming=True),
    })

    class Echo(rpc.make_servicer(spec)):
        def Ping(self, request, context):
            return common_pb2.Status(success=True)

        def Fail(self, request, context):
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, "no")

        def Count(self, request, context):
            for i in range(int(request.message or 0)):
                yield common_pb2.Status(success=True, message=str(i))

    server = rpc.create_server(max_workers=4)
    rpc.add_to_server(spec, Echo(), server)
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    return server, rpc.make_stub(spec)(rpc.insecure_channel(f"127.0.0.1:{port}")), common_pb2


def _rpc_counts(pkg):
    """{(family, labels): value} of the aios_tpu_rpc_* series of service
    aios.test.Echo in ``pkg``'s registry (latency as its count)."""
    reg = importlib.import_module(f"{pkg}.obs.metrics").REGISTRY
    out = {}
    for name in ("aios_tpu_rpc_requests_total", "aios_tpu_rpc_errors_total",
                 "aios_tpu_rpc_latency_seconds"):
        m = reg.get(name)
        for key, child in list(m._children.items()):
            labels = dict(zip(m.labelnames, key))
            if labels.get("service") != "aios.test.Echo":
                continue
            value = child._count if hasattr(child, "_count") else child.value
            out[(name, tuple(sorted(labels.items())))] = value
    return out


def _sequence(pkg):
    server, stub, common_pb2 = _echo(pkg)
    try:
        before = _rpc_counts(pkg)
        for _ in range(3):
            assert stub.Ping(common_pb2.Empty()).success
        for _ in range(2):
            with pytest.raises(grpc.RpcError) as e:
                stub.Fail(common_pb2.Empty())
            assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT
        assert len(list(stub.Count(common_pb2.Status(message="4")))) == 4
        after = _rpc_counts(pkg)
    finally:
        server.stop(grace=None)
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def test_rpc_counts_alike():
    got = [_sequence(p) for p in PKGS]
    assert got[0] == got[1]
    req = dict(got[1])
    key = ("aios_tpu_rpc_requests_total",
           (("method", "Ping"), ("service", "aios.test.Echo"), ("side", "server")))
    assert req[key] == 3
    errs = ("aios_tpu_rpc_errors_total", (("code", "INVALID_ARGUMENT"), ("method", "Fail"),
                                          ("service", "aios.test.Echo"), ("side", "client")))
    assert req[errs] == 2


def test_obs_disabled_installs_no_interceptor(monkeypatch):
    monkeypatch.setenv("AIOS_OBS_DISABLED", "1")
    assert _sequence("aios_tpu_torch") == {}


def test_injected_unavailable_flows_through_the_obs_interceptors():
    """The fault interceptor is innermost: an injected UNAVAILABLE carries
    its retry hint and is counted on the server's rpc_* errors."""
    from aios_tpu_torch import faults

    server, stub, common_pb2 = _echo("aios_tpu_torch")
    faults.activate("seed=1;rpc.unavailable=nth:1,retry_after_ms=70")
    try:
        before = _rpc_counts("aios_tpu_torch")
        with pytest.raises(grpc.RpcError) as e:
            stub.Ping(common_pb2.Empty())
        assert e.value.code() == grpc.StatusCode.UNAVAILABLE
        assert ("retry-after-ms", "70") in tuple(e.value.trailing_metadata())
        after = _rpc_counts("aios_tpu_torch")
    finally:
        faults.deactivate()
        server.stop(grace=None)
    key = ("aios_tpu_rpc_errors_total", (("code", "UNAVAILABLE"), ("method", "Ping"),
                                         ("service", "aios.test.Echo"), ("side", "server")))
    assert after[key] - before.get(key, 0) == 1


def test_traceparent_reaches_the_recorder_and_the_decode_span():
    """A client span's traceparent on a StreamInfer to the port's runtime:
    the server's decode span carries its trace id (parented by the RPC
    span), the flight recorder's timeline is opened with it, and
    /debug/requests?trace= finds it."""
    from aios_tpu_torch import rpc, services
    from aios_tpu_torch.obs import flightrec, tracing
    from aios_tpu_torch.proto_gen import runtime_pb2
    from aios_tpu_torch.runtime.model_manager import ModelManager
    from aios_tpu_torch.runtime.service import serve

    manager = ModelManager(num_slots=2, device="cpu")
    server, service, port = serve(address="127.0.0.1:0", manager=manager, block=False,
                                  metrics_port=0)
    try:
        stub = services.AIRuntimeStub(rpc.insecure_channel(f"127.0.0.1:{port}"))
        stub.LoadModel(runtime_pb2.LoadModelRequest(model_name="traced",
                                                    model_path="synthetic://tiny-test"))
        with tracing.start_span("client.goal") as client:
            chunks = list(stub.StreamInfer(runtime_pb2.InferRequest(
                prompt="hello", max_tokens=4, task_id="traced-1")))
        assert chunks[-1].done
        tid = client.trace_id
        decode = [s for s in tracing.recent_spans("runtime.decode") if s.trace_id == tid]
        rpc_span = [s for s in tracing.recent_spans("rpc.server.aios.runtime.AIRuntime/StreamInfer")
                    if s.trace_id == tid]
        assert decode and rpc_span and decode[-1].parent_id == rpc_span[-1].span_id
        assert rpc_span[-1].parent_id == client.span_id
        tl = [t for t in flightrec.RECORDER.recent(model="traced") if t.request_id == "traced-1"]
        assert tl and tl[-1].trace_id == tid
        # the RPC span folds into the timeline as a span event
        assert any(e[1] == "span" for e in tl[-1].events)
        status, body = _get(f"http://127.0.0.1:{service.metrics_port}/debug/requests"
                            f"?trace={tid}")
        assert status == 200 and [r["request_id"] for r in body["requests"]] == ["traced-1"]
        status, body = _get(f"http://127.0.0.1:{service.metrics_port}/debug/trace"
                            f"?model=traced")
        assert status == 200 and tid in json.dumps(body)
        status, metrics = _get(f"http://127.0.0.1:{service.metrics_port}/metrics")
        assert 'aios_tpu_rpc_requests_total{side="server",service="aios.runtime.AIRuntime",' \
               'method="StreamInfer"}' in metrics
    finally:
        server.stop(grace=None)
        service.metrics_server.shutdown()
        service.metrics_server.server_close()
        manager.close()


# -- the SLO engine ------------------------------------------------------------------


def _slo_script(pkg):
    slo = importlib.import_module(f"{pkg}.obs.slo")
    eng = slo.SLOEngine(slo.SLOConfig(ttft_ms=100.0, tpot_ms=20.0, target=0.9,
                                      window_secs=30.0, min_samples=5))
    rng = random.Random(5)
    out = []
    t = 1000.0
    for i in range(120):
        t += rng.uniform(0.1, 1.0)
        ok = rng.random() > 0.08
        ttft = rng.uniform(20, 160) if ok else None
        tpot = rng.uniform(5, 30) if ok and rng.random() > 0.2 else None
        eng.record(f"m{i % 2}", rng.choice(["a", "b", "c"]), ttft_ms=ttft, tpot_ms=tpot,
                   ok=ok, now=t)
        if i % 10 == 9:
            out.append({m: eng.evaluate(m, now=t) for m in eng.models()})
            out.append({m: eng.tenants(m, now=t) for m in eng.models()})
    return out, eng.breaches


def test_slo_evaluations_alike():
    a, b = (_slo_script(p) for p in PKGS)
    assert a == b and a[1] > 0


def test_annotate_health_degrades_on_breach():
    _, slo = both("obs.slo")
    slo.ENGINE.clear()
    try:
        for _ in range(slo.ENGINE.cfg.min_samples):
            slo.ENGINE.record("breachy", ok=False, now=time.monotonic())
        payload = slo.annotate_health({"status": "ok"})
        assert payload["status"] == "degraded" and payload["slo_breached"] == ["breachy"]
    finally:
        slo.ENGINE.clear()


# -- the tsdb --------------------------------------------------------------------------


def _tsdb_script(pkg):
    metrics = importlib.import_module(f"{pkg}.obs.metrics")
    tsdb = importlib.import_module(f"{pkg}.obs.tsdb")
    reg = metrics.MetricsRegistry()
    c = metrics.Counter("aios_tpu_t_requests_total", "c", ("model",), registry=reg)
    g = metrics.Gauge("aios_tpu_t_depth_total", "g", ("model",), registry=reg)
    h = metrics.Histogram("aios_tpu_t_latency_seconds", "h", ("model",), registry=reg)
    db = tsdb.Tsdb(registry=reg, clock=lambda: 0.0)
    rng = random.Random(9)
    t = 100.0
    for i in range(60):
        t += 1.0
        for m in ("a", "b"):
            c.labels(model=m).inc(rng.randint(0, 5))
            g.labels(model=m).set(rng.uniform(0, 10))
            h.labels(model=m).observe(rng.uniform(0.001, 2.0))
        if i == 30:
            c.labels(model="a")._value = 0.0  # a counter reset
        db.sample_once(now=t)
    answers = []
    for name in ("aios_tpu_t_requests_total", "aios_tpu_t_depth_total",
                 "aios_tpu_t_latency_seconds"):
        for verb in tsdb.QUERY_VERBS:
            for matchers in (None, {"model": "a"}):
                try:
                    answers.append(db.query(name, matchers, verb=verb, window=20.0, now=t))
                except ValueError as e:
                    answers.append(str(e))
    answers.append(db.window_snapshot(t - 10, t))
    answers.append(db.series_count())
    return answers


def test_tsdb_answers_alike():
    a, b = (_tsdb_script(p) for p in PKGS)
    assert a == b


# -- the HTTP endpoint ----------------------------------------------------------------


def test_route_index_equals_the_jax_routes():
    jh, ph = both("obs.http")
    assert ph.ROUTES == jh.ROUTES
    server, port = ph.start_metrics_server(port=0)
    try:
        status, body = _get(f"http://127.0.0.1:{port}/debug")
        assert status == 200
        assert [(r["method"], r["route"], r["help"]) for r in body["routes"]] == list(jh.ROUTES)
        for path in ("/metrics/fleet", "/fleet/members", "/debug/trace/fleet",
                     "/debug/tsdb/fleet"):
            status, body = _get(f"http://127.0.0.1:{port}{path}")
            assert status == 404 and body == {"error": "fleet telemetry not armed"}, path
        for path in ("/fleet/announce", "/fleet/drain"):
            req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=b"{}",
                                         method="POST")
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=10)
            assert e.value.code == 404
        assert _get(f"http://127.0.0.1:{port}/livez") == (200, {"status": "alive"})
        status, _ = _get(f"http://127.0.0.1:{port}/debug/tsdb")
        assert status in (200, 404)
    finally:
        server.shutdown()
        server.server_close()


def test_every_route_of_the_index_is_served():
    """Each GET row of ROUTES answers something other than the handler's
    unknown-path 404 (a fleet route's 404 carries its JSON reason)."""
    _, ph = both("obs.http")
    server, port = ph.start_metrics_server(port=0)
    try:
        for method, route, _ in ph.ROUTES:
            if method != "GET":
                continue
            status, body = _get(f"http://127.0.0.1:{port}{route}")
            assert status != 404 or isinstance(body, dict), route
    finally:
        server.shutdown()
        server.server_close()


def test_profile_route_gates(tmp_path, monkeypatch):
    _, ph = both("obs.http")
    server, port = ph.start_metrics_server(port=0)
    try:
        monkeypatch.delenv("AIOS_TPU_DEVPROF_DUMP_DIR", raising=False)
        assert _get(f"http://127.0.0.1:{port}/debug/profile?secs=0.2")[0] == 403
        monkeypatch.setenv("AIOS_TPU_DEVPROF_DUMP_DIR", str(tmp_path))
        status, body = _get(f"http://127.0.0.1:{port}/debug/profile?secs=0.5")
        assert status == 200 and body["profiling"]
        assert _get(f"http://127.0.0.1:{port}/debug/profile?secs=0.5")[0] == 409
        from aios_tpu_torch.obs import devprof

        deadline = time.monotonic() + 30
        while devprof.capture_status()["busy"] and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not devprof.capture_status()["busy"] and not devprof.capture_status()["error"]
        assert (pathlib.Path(body["path"]) / "trace.json").exists()
    finally:
        server.shutdown()
        server.server_close()


def test_a_port_that_cannot_bind_raises():
    _, ph = both("obs.http")
    server, port = ph.start_metrics_server(port=0)
    try:
        with pytest.raises(OSError):
            ph.maybe_start_metrics_server("runtime", port)
    finally:
        server.shutdown()
        server.server_close()


def test_healthz_answers_503_on_an_slo_breach():
    _, ph = both("obs.http")
    from aios_tpu_torch.obs import slo

    server, port = ph.start_metrics_server(
        port=0, health_fn=lambda: slo.annotate_health({"status": "ok"}))
    slo.ENGINE.clear()
    try:
        assert _get(f"http://127.0.0.1:{port}/healthz")[0] == 200
        for _ in range(slo.ENGINE.cfg.min_samples):
            slo.ENGINE.record("hz", ok=False, now=time.monotonic())
        status, body = _get(f"http://127.0.0.1:{port}/healthz")
        assert status == 503 and body["slo_breached"] == ["hz"]
        status, body = _get(f"http://127.0.0.1:{port}/debug/slo")
        assert status == 200 and body["models"]["hz"]["objectives"]["availability"]["breached"]
    finally:
        slo.ENGINE.clear()
        server.shutdown()
        server.server_close()


# -- incident bundles ---------------------------------------------------------------------


def test_incident_bundle_freezes_the_tsdb_window_and_devprof(monkeypatch):
    from aios_tpu_torch.obs import flightrec, incidents, tsdb

    monkeypatch.setenv("AIOS_TPU_INCIDENT_WINDOW_SECS", "1")
    monkeypatch.setenv("AIOS_TPU_INCIDENT_COOLDOWN_SECS", "0")
    ring = tsdb.Tsdb()
    ring.sample_once()
    prev_ring = tsdb.install(ring)
    store = incidents.IncidentStore(incidents.IncidentConfig())
    prev = incidents.install(store)
    try:
        flightrec.RECORDER.snapshot("inc-model", "manual", sync=True)
        deadline = time.monotonic() + 10
        while not store.incidents() and time.monotonic() < deadline:
            time.sleep(0.05)
        (bundle,) = store.incidents()
        assert bundle["cause"] == "manual" and bundle["model"] == "inc-model"
        assert bundle["tsdb"]["armed"] and bundle["tsdb"]["series"]
        assert "models" in bundle["devprof"] and "capture" in bundle["devprof"]
        assert bundle["flightrec"]["snapshot_id"] is not None
    finally:
        incidents.install(prev)
        tsdb.install(prev_ring)


# -- the catalog's families (twins of tests/test_obs_lint.py) ---------------------------

NEW_FAMILIES = ("aios_tpu_rpc_", "aios_tpu_slo_", "aios_tpu_devprof_", "aios_tpu_autoscale_",
                "aios_tpu_tsdb_", "aios_tpu_incidents_", "aios_tpu_process_info")
NAME_RE = re.compile(r"^aios_tpu_[a-z0-9_]+$")
UNIT_SUFFIXES = ("_seconds", "_bytes", "_total", "_ratio", "_per_second", "_pages", "_info")


def _families(pkg):
    importlib.import_module(f"{pkg}.obs.instruments")
    reg = importlib.import_module(f"{pkg}.obs.metrics").REGISTRY
    return {m.name: (m.kind, tuple(m.labelnames)) for m in reg.collect()
            if m.name.startswith(NEW_FAMILIES)}


def test_new_families_complete_and_typed_as_in_jax():
    jax_fams, port_fams = (_families(p) for p in PKGS)
    assert len(port_fams) == 19
    assert port_fams == jax_fams


def test_port_catalog_naming_conventions():
    importlib.import_module("aios_tpu_torch.obs.instruments")
    from aios_tpu_torch.obs.metrics import REGISTRY

    for m in REGISTRY.collect():
        if not m.name.startswith("aios_tpu_"):
            continue
        assert NAME_RE.match(m.name) and m.name.endswith(UNIT_SUFFIXES), m.name
        if m.kind == "histogram":
            assert m.name.endswith("_seconds"), m.name
        if m.kind == "counter":
            assert m.name.endswith("_total"), m.name
        assert m.help.strip(), m.name
        assert len(m.labelnames) <= 4 and all(re.match(r"^[a-z][a-z0-9_]*$", n)
                                              for n in m.labelnames), m.name


def test_closed_enums_equal_the_jax_modules():
    pairs = [("obs.slo", "OBJECTIVES"), ("obs.tsdb", "QUERY_VERBS"),
             ("obs.tsdb", "SERIES_KINDS"), ("obs.incidents", "TRIGGER_CAUSES"),
             ("serving.autoscale", "ACTIONS"), ("serving.autoscale", "CAUSES"),
             ("serving.autoscale", "LADDER"), ("obs.devprof", "GRAPH_KINDS"),
             ("obs.flightrec", "SNAPSHOT_CAUSES")]
    for mod, name in pairs:
        j, p = both(mod)
        assert getattr(p, name) == getattr(j, name), (mod, name)


def test_devprof_call_sites_use_graph_kind_literals():
    """Every ``_devprof_note`` / ledger ``note`` call site of the port's
    engine passes a literal GRAPH_KINDS member, and the gauges register by
    iterating the enum over the per-model ledger set."""
    from aios_tpu_torch.obs import devprof

    src = (ROOT / "aios_tpu_torch" / "engine" / "engine.py").read_text()
    tree = ast.parse(src)
    kinds = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr in ("_devprof_note", "note") and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                kinds.add(arg.value)
            elif not (isinstance(arg, ast.Name) and arg.id == "kind"):
                pytest.fail(f"line {node.lineno}: a devprof kind that is not a literal")
    assert kinds and kinds <= set(devprof.GRAPH_KINDS), kinds
    reg = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
               and n.name == "_register_devprof_gauges")
    used = {n.attr if isinstance(n, ast.Attribute) else n.id for n in ast.walk(reg)
            if isinstance(n, (ast.Name, ast.Attribute))}
    assert {"GRAPH_KINDS", "ledgers_for", "DEVPROF_DISPATCHES", "DEVPROF_DEVICE_SECONDS",
            "DEVPROF_MFU", "DEVPROF_HBM_UTIL"} <= used


def test_a_tsdb_pass_reads_no_tensor(monkeypatch):
    """The sampler reads every registered gauge, the engines' and the
    batchers' included: each reads host mirrors, never a device tensor (on
    the card a readback there would synchronize the stream every pass)."""
    from aios_tpu_torch.engine.batching import ContinuousBatcher, Request
    from aios_tpu_torch.engine.config import TINY_TEST
    from aios_tpu_torch.engine.engine import TorchEngine
    from aios_tpu_torch.engine.weights import init_params
    from aios_tpu_torch.obs import tsdb

    monkeypatch.setenv("AIOS_TPU_DEVPROF", "1")
    params = init_params(TINY_TEST, torch.Generator().manual_seed(0), dtype=torch.float32,
                         device="cpu")
    eng = TorchEngine(TINY_TEST, params, num_slots=2, max_context=128, device="cpu",
                      paged_pool_rows=512, page_size=16, prefix_host_bytes=1 << 20)
    b = ContinuousBatcher(eng, chunk_steps=2)
    try:
        b.submit(Request(prompt_ids=[3, 4, 5], max_tokens=4, temperature=0.0)).tokens()
        reads = []
        for name in ("item", "cpu", "tolist", "numpy", "__float__", "__int__"):
            real = getattr(torch.Tensor, name)

            def spy(self, *a, _real=real, _name=name, **kw):
                reads.append(_name)
                return _real(self, *a, **kw)

            monkeypatch.setattr(torch.Tensor, name, spy)
        ring = tsdb.Tsdb()
        assert ring.sample_once() > 0
        assert reads == []
    finally:
        monkeypatch.undo()
        b.shutdown()
        eng.close()
