"""The port's storm (``aios_tpu_torch/loadgen``) held to the JAX package's.

The trace builder is a pure function of (scenario, seed), so every committed
scenario gives the same calls and fingerprint through both packages. The
mini storm of ``tests/test_loadgen.py`` then runs over the live gRPC service
of each package, on the CPU, with the same weights (the JAX synthetic
``tiny-test`` weights, handed to the port's manager), and both give the same
deterministic verdict: tenant counts, shed counts and the greedy streams'
hashes.
"""

import dataclasses
import importlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCENARIOS = sorted((ROOT / "scenarios").glob("*.toml"))
PKGS = ("aios_tpu", "aios_tpu_torch")


def both(module: str):
    return tuple(importlib.import_module(f"{p}.{module}") for p in PKGS)


@pytest.mark.parametrize("path", SCENARIOS, ids=lambda p: p.name)
def test_committed_scenarios_load_and_trace_alike(path):
    js, ps = both("loadgen.scenario")
    jt, pt = both("loadgen.trace")
    a, b = js.load_scenario(str(path)), ps.load_scenario(str(path))
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    ca, cb = jt.build_trace(a), pt.build_trace(b)
    assert [dataclasses.asdict(c) for c in ca] == [dataclasses.asdict(c) for c in cb]
    assert jt.trace_fingerprint(ca) == pt.trace_fingerprint(cb)
    # a pure function of (scenario, seed): a second build is the same trace
    assert pt.trace_fingerprint(pt.build_trace(b)) == pt.trace_fingerprint(cb)


def test_target_routing_alike():
    jd, pd = both("loadgen.driver")
    for n in (1, 2, 3, 5):
        for tenant in ("chat", "agents", "batch", "scraper", "probes", "x" * 40):
            assert jd.target_of(tenant, n) == pd.target_of(tenant, n)


def _outcomes(pkg, calls):
    """A fixed outcome set: the abusive tenant shed on quota, the deadline
    tenant shed on its deadline, every other call completed with a text."""
    Outcome = importlib.import_module(f"{pkg}.loadgen.driver").Outcome
    out = []
    for c in calls:
        if c.klass == "abusive":
            out.append(Outcome(call=c, status="shed", shed_cause="quota", retry_after_ms=250))
        elif c.deadline_ms:
            out.append(Outcome(call=c, status="shed", shed_cause="deadline"))
        else:
            out.append(Outcome(call=c, text=f"t{c.task_id}", ttft_ms=12.0, wall_ms=80.0,
                               chunks=5))
    return out


@pytest.mark.parametrize("path", SCENARIOS, ids=lambda p: p.name)
def test_reports_alike(path):
    def run(pkg):
        lg = importlib.import_module(f"{pkg}.loadgen")
        sc = lg.load_scenario(str(path))
        calls = lg.build_trace(sc)
        return lg.build_report(sc, calls, _outcomes(pkg, calls), {})

    a, b = (run(p) for p in PKGS)
    assert a == b and a["pass"]


# -- the mini storm over each package's live service --------------------------------


def _mini(pkg):
    sc_mod = importlib.import_module(f"{pkg}.loadgen.scenario")
    return sc_mod.StormScenario(
        name="mini", seed=3, duration_secs=1.2, model="storm-mini",
        replicas=1, context=256, num_slots=2,
        tenant_tokens_per_sec=1.0, tenant_burst_tokens=300.0,
        tenants=(
            sc_mod.TenantSpec(name="chat", klass="interactive", rps=2.5,
                              prompt_p50=30, prompt_max=60, max_tokens=6,
                              streaming=True),
            sc_mod.TenantSpec(name="storm", klass="abusive", rps=5.0,
                              arrival="burst", peak_ratio=4.0,
                              period_secs=1.0, burst_secs=0.4,
                              prompt_p50=100, max_tokens=60,
                              quota_storm=True),
        ),
    )


@pytest.fixture(scope="module")
def jax_weights():
    from aios_tpu.engine import model as jm
    from aios_tpu.engine.config import TINY_TEST

    params = jm.init_params(TINY_TEST, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), params)


def _storm(pkg, monkeypatch, jax_weights):
    """The mini storm over ``pkg``'s runtime service (the port's on the CPU,
    with the JAX package's synthetic weights): the report and outcomes."""
    lg = importlib.import_module(f"{pkg}.loadgen")
    mm = importlib.import_module(f"{pkg}.runtime.model_manager")
    service_mod = importlib.import_module(f"{pkg}.runtime.service")
    slo_mod = importlib.import_module(f"{pkg}.obs.slo")
    sc = _mini(pkg)
    monkeypatch.setenv("AIOS_TPU_TENANT_TOKENS_PER_SEC", str(sc.tenant_tokens_per_sec))
    monkeypatch.setenv("AIOS_TPU_TENANT_BURST_TOKENS", str(sc.tenant_burst_tokens))
    if pkg == "aios_tpu_torch":
        from aios_tpu_torch.engine.weights import params_from_jax

        def same_weights(cfg, gen, dtype, device):
            return {k: v for k, v in _to(params_from_jax(jax_weights, device), dtype).items()}

        monkeypatch.setattr(mm, "init_params", same_weights)
        manager = mm.ModelManager(num_slots=sc.num_slots, device="cpu")
    else:
        manager = mm.ModelManager(num_slots=sc.num_slots, warm_compile=False)
    server = service = None
    slo_mod.ENGINE.clear()
    try:
        manager.load_model(sc.model, "synthetic://tiny-test", context_length=sc.context)
        server, service, port = service_mod.serve(
            address="127.0.0.1:0", manager=manager, block=False, metrics_port=0)
        driver = lg.StormDriver(f"127.0.0.1:{port}", sc.model,
                                metrics_port=service.metrics_port)
        try:
            driver.warmup(n=1)
            calls = lg.build_trace(sc)
            outcomes = driver.run(calls, join_timeout=120)
            surface = driver.slo_surface()
        finally:
            driver.close()
        return lg.build_report(sc, calls, outcomes, surface), outcomes
    finally:
        if server is not None:
            server.stop(grace=None)
        if service is not None and service.metrics_server is not None:
            service.metrics_server.shutdown()
            service.metrics_server.server_close()
        manager.unload_model(sc.model)
        slo_mod.ENGINE.clear()


def _to(tree, dtype):
    if isinstance(tree, dict):
        return {k: _to(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def test_mini_storm_verdict_equals_the_jax_storms(monkeypatch, jax_weights):
    """The JAX test's mini storm through both services: the same
    deterministic verdict (trace, per-tenant counts, quota sheds, greedy
    stream hashes), every quota shed with a retry-after, and the live
    /debug/slo surface of the port naming the storm's model."""
    (jrep, _), (prep, pouts) = (_storm(p, monkeypatch, jax_weights) for p in PKGS)
    assert prep["verdict"] == jrep["verdict"]
    v = prep["verdict"]
    assert v["stuck"] == 0 and v["errors"] == 0 and v["pass"]
    assert v["tenants"]["chat"]["completed"] == v["tenants"]["chat"]["submitted"]
    assert v["tenants"]["storm"]["shed"] > 0
    shed = [o for o in pouts if o.status == "shed"]
    assert shed and all(o.shed_cause == "quota" and o.retry_after_ms > 0 for o in shed)
    assert "storm-mini" in prep["measured"]["slo_surface"]["models"]
