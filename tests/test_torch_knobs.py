"""The serving knobs on the port: each knob of the JAX stack that the port
does not honour yet logs one warning naming it when a ``ModelManager`` is
built, and so does each knob that does not carry over, with its reason;
every ``AIOS_TPU_*`` row of ``docs/CONFIG.md`` is read by the port or is one
of those; the honoured ones log none (the decode loop's six change the engine
and the batcher that LoadModel builds, as in the JAX stack), and
``AIOS_TPU_SAMPLE_POOL`` sizes the
sampler's candidate pool with the JAX package's errors, read once when an
engine is built. The port imports no ``ml_dtypes`` (the host tier keeps
bf16 pages as their uint16 bits)."""

import ast
import logging
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from aios_tpu.engine import sampling as jsampling
from aios_tpu_torch.engine import sampling
from aios_tpu_torch.engine.config import TINY_TEST
from aios_tpu_torch.engine.engine import TorchEngine
from aios_tpu_torch.engine.weights import init_params
from aios_tpu_torch.runtime import model_manager
from aios_tpu_torch.runtime.model_manager import ModelManager

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
LOGGER = "aios.torch.runtime.models"
NOT_HONOURED = "does not honour it yet"

# the decode loop's knobs, honoured since the pipelined loop, the unified
# step, the megagraph and window+sink compression were ported
DECODE_LOOP = {"AIOS_TPU_DECODE_PIPELINE": "1", "AIOS_TPU_UNIFIED_STEP": "1",
               "AIOS_TPU_MEGA_TICKS": "8", "AIOS_TPU_KV_COMPRESS_AFTER": "100",
               "AIOS_TPU_KV_SINK_PAGES": "2", "AIOS_TPU_KV_WINDOW_PAGES": "3"}
# the SLO autoscaler's knobs, honoured since serving/autoscale.py was ported
AUTOSCALE = {"AIOS_TPU_AUTOSCALE": "1", "AIOS_TPU_AUTOSCALE_MAX_REPLICAS": "2",
             "AIOS_TPU_AUTOSCALE_UP_BURN": "1.5", "AIOS_TPU_AUTOSCALE_COOLDOWN_SECS": "5"}
# the fleet plane's knobs, honoured since obs/fleet.py and fleet/ were ported
FLEET = ["AIOS_TPU_FLEET"] + [f"AIOS_TPU_FLEET_{k}" for k in (
    "PEERS", "INTERVAL_SECS", "SUSPECT_SECS", "DEAD_SECS", "SEED_PORT", "SCRAPE_TIMEOUT",
    "TARGET", "KVX_CHUNK_BYTES", "KVX_TIMEOUT_SECS", "KVX_BUDGET_BYTES", "KVX_GBPS",
    "GPREFIX_MAX", "OVERLAP_GAIN", "HANDOFF_RETRIES", "BREAKER_THRESHOLD",
    "BREAKER_COOLDOWN_SECS", "BREAKER_MAX_COOLDOWN_SECS", "BREAKER_PROBES",
    "BREAKER_LAT_SECS", "DRAIN_TIMEOUT_SECS", "DRAIN_PUSH_BYTES")]
# multi-card, sequence-parallel and multihost knobs: they wait for the port
# of parallel/
UNPORTED = ["AIOS_TPU_SEQ_PREFILL_MIN", "AIOS_TPU_MESH", "AIOS_TPU_SEQ_PREFILL_IMPL",
            "AIOS_TPU_SEQ_SHARD_KV", "AIOS_TPU_COORDINATOR", "AIOS_TPU_MULTIHOST",
            "AIOS_TPU_NUM_PROCESSES", "AIOS_TPU_PROCESS_ID"]
# the Pallas and crossover gates, whose JAX paths the port has no twin for
NOT_CARRIED = ["AIOS_TPU_NO_PALLAS", "AIOS_TPU_PALLAS_QMM", "AIOS_TPU_RAGGED_MIN_C",
               "AIOS_TPU_INT8_RAGGED"]
NOT_CARRIED_SAYS = "does not carry over to the PyTorch port"
HONOURED = {"AIOS_TPU_PREFIX_HOST_BYTES": "1073741824", "AIOS_TPU_HOST_RESTORE_MIN_PAGES": "2",
            "AIOS_TPU_SAMPLE_POOL": "16", "AIOS_TPU_REPLICAS": "2",
            "AIOS_TPU_PREFIX_RADIX": "0", "AIOS_TPU_PREFIX_CACHE": "1",
            "AIOS_TPU_JUMP_AHEAD": "1", "AIOS_TPU_KV_CACHE": "bf16",
            "AIOS_TPU_MAX_QUEUE": "4", "AIOS_TPU_DRAFT_MODEL": "tinyllama",
            "AIOS_TPU_MOE_IMPL": "gather", "AIOS_TPU_MOE_GATHER": "1", **DECODE_LOOP,
            **AUTOSCALE, **{k: "1" for k in FLEET}}


@pytest.fixture
def clean_env(monkeypatch):
    for name in list(os.environ):
        if name.startswith("AIOS_TPU_") and name not in ("AIOS_TPU_LOCK_DEBUG",):
            monkeypatch.delenv(name)
    return monkeypatch


def _warnings(caplog):
    return [r.getMessage() for r in caplog.records
            if r.name == LOGGER and NOT_HONOURED in r.getMessage()]


@pytest.mark.parametrize("knob", UNPORTED)
def test_each_unported_knob_warns_once_by_name(clean_env, caplog, knob):
    clean_env.setenv(knob, "1")
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        ModelManager(num_slots=2, device="cpu")
    got = _warnings(caplog)
    assert len(got) == 1 and got[0].startswith(knob + " is set")


def test_all_unported_knobs_at_once(clean_env, caplog):
    for knob in UNPORTED:
        clean_env.setenv(knob, "1")
    clean_env.setenv("AIOS_TPU_MESH", "")  # empty means unset
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        ModelManager(num_slots=2, device="cpu")
    named = sorted(m.split(" ")[0] for m in _warnings(caplog))
    assert named == sorted(k for k in UNPORTED if k != "AIOS_TPU_MESH")
    assert model_manager.unported_knobs_set() == named


@pytest.mark.parametrize("knob", sorted(HONOURED))
def test_honoured_knobs_log_no_such_warning(clean_env, caplog, knob):
    clean_env.setenv(knob, HONOURED[knob])
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        ModelManager(num_slots=2, device="cpu")
    assert _warnings(caplog) == []


def test_sample_pool_sizes_the_candidate_pool(clean_env):
    clean_env.setenv("AIOS_TPU_SAMPLE_POOL", "16")
    assert sampling.topk_cap() == jsampling.topk_cap() == 16
    params = init_params(TINY_TEST, torch.Generator().manual_seed(0), dtype=torch.float32,
                         device="cpu")
    eng = TorchEngine(TINY_TEST, params, device="cpu", num_slots=2)
    assert eng.sample_pool == 16
    clean_env.setenv("AIOS_TPU_SAMPLE_POOL", "3")
    assert eng.sample_pool == 16  # read once, when the engine was built
    # a flat distribution at a high temperature: every draw is among the 16
    # largest logits, and most of those 16 are drawn
    logits = torch.linspace(0.0, 1e-3, TINY_TEST.vocab_size)[None].expand(512, -1).contiguous()
    gen = torch.Generator().manual_seed(3)
    toks = sampling.sample(logits, gen, torch.full((512,), 5.0), torch.ones(512),
                           pool=eng.sample_pool)
    top = set(torch.topk(logits[0], 16).indices.tolist())
    assert set(toks.tolist()) <= top and len(set(toks.tolist())) >= 12
    clean_env.delenv("AIOS_TPU_SAMPLE_POOL")
    assert sampling.topk_cap() == jsampling.topk_cap() == 64


@pytest.mark.parametrize("raw,message", [("0", "must be >= 1"), ("-3", "must be >= 1"),
                                         ("x", "is not an integer"),
                                         ("1.5", "is not an integer")])
def test_sample_pool_errors_are_the_jax_errors(clean_env, raw, message):
    clean_env.setenv("AIOS_TPU_SAMPLE_POOL", raw)
    with pytest.raises(ValueError) as want:
        jsampling.topk_cap()
    with pytest.raises(ValueError, match=message) as got:
        sampling.topk_cap()
    assert str(got.value) == str(want.value)
    params = init_params(TINY_TEST, torch.Generator().manual_seed(0), dtype=torch.float32,
                         device="cpu")
    with pytest.raises(ValueError, match=message):
        TorchEngine(TINY_TEST, params, device="cpu", num_slots=2)


def test_port_imports_no_ml_dtypes():
    code = ("import sys\n"
            "import aios_tpu_torch.engine.engine, aios_tpu_torch.engine.paged\n"
            "import aios_tpu_torch.runtime.service, aios_tpu_torch.runtime.model_manager\n"
            "sys.exit(1 if 'ml_dtypes' in sys.modules else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stdout + r.stderr
    offenders = []
    for path in sorted((ROOT / "aios_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.name}: {n}" for n in names if n.split(".")[0] == "ml_dtypes"]
    assert not offenders, offenders


def test_decode_loop_knobs_are_honoured_not_listed():
    assert not set(DECODE_LOOP) & set(model_manager.UNPORTED_KNOBS)
    assert sorted(model_manager.UNPORTED_KNOBS) == sorted(UNPORTED)


def _knob_strings(tree):
    pattern = re.compile(r"AIOS_TPU_[A-Z0-9_]+")
    return {n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and pattern.fullmatch(n.value)}


def test_every_config_knob_is_read_warned_or_not_carried():
    """Each AIOS_TPU_* row of docs/CONFIG.md is read somewhere in the port,
    or warns when set (UNPORTED_KNOBS), or is declared not to carry over
    with a one-line reason (NOT_CARRIED_KNOBS); the groups do not overlap
    and name only rows of the document."""
    doc = set(re.findall(r"AIOS_TPU_[A-Z0-9_]+", (ROOT / "docs/CONFIG.md").read_text()))
    declared = {"UNPORTED_KNOBS", "NOT_CARRIED_KNOBS"}
    read = set()
    for path in sorted((ROOT / "aios_tpu_torch").rglob("*.py")):
        tree = ast.parse(path.read_text())
        if path.name == "model_manager.py":
            tree.body = [n for n in tree.body if not (
                isinstance(n, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id in declared for t in n.targets))]
        read |= _knob_strings(tree)
    unported, not_carried = set(model_manager.UNPORTED_KNOBS), set(
        model_manager.NOT_CARRIED_KNOBS)
    assert sorted(not_carried) == sorted(NOT_CARRIED)
    assert not unported & not_carried
    assert (unported | not_carried) <= doc
    assert not (not_carried & read), "a knob declared not to carry over is read"
    assert doc - read - unported - not_carried == set()
    assert sorted(doc - read) == sorted(set(UNPORTED + NOT_CARRIED) - read)
    for knob, reason in model_manager.NOT_CARRIED_KNOBS.items():
        assert reason.strip() and "\n" not in reason, knob


def test_fleet_knob_warns_once_on_a_cpu_manager(clean_env, caplog):
    """Since the fleet plane was ported, AIOS_TPU_FLEET=1 draws no warning
    from a CPU manager, and ``serve()`` arms the plane: the membership
    registry, the handoff rung and the drain coordinator."""
    from aios_tpu_torch.fleet import disagg, drain, kvx
    from aios_tpu_torch.obs import fleet
    from aios_tpu_torch.runtime.service import serve

    clean_env.setenv("AIOS_TPU_FLEET", "1")
    clean_env.setenv("AIOS_TPU_FLEET_HOST", "knob-host")
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        manager = ModelManager(num_slots=2, device="cpu")
    assert [m for m in (r.getMessage() for r in caplog.records if r.name == LOGGER)
            if "AIOS_TPU_FLEET" in m] == []
    assert fleet.FLEET is None and disagg.PLANE is None and drain.COORD is None
    server, service, _ = serve("127.0.0.1:0", manager, block=False, metrics_port=0)
    try:
        assert fleet.FLEET is not None and fleet.FLEET.identity["host"] == "knob-host"
        assert fleet.FLEET.metrics_addr == f"127.0.0.1:{service.metrics_port}"
        assert disagg.PLANE is not None and drain.COORD is not None
        assert drain.phase() == "serving"
    finally:
        server.stop(grace=None)
        service.metrics_server.shutdown()
        service.metrics_server.server_close()
        if fleet.FLEET is not None:
            fleet.FLEET.stop()
        fleet.install(None)
        disagg.disarm()
        drain.disarm()
        fleet.clear_stats_providers()
        fleet.clear_digest_providers()
        fleet.set_transfer_addr("")
        kvx.reset_channels()


@pytest.mark.parametrize("knob", NOT_CARRIED)
def test_each_not_carried_knob_warns_once_with_its_reason(clean_env, caplog, knob):
    clean_env.setenv(knob, "1")
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        ModelManager(num_slots=2, device="cpu")
    got = [r.getMessage() for r in caplog.records
           if r.name == LOGGER and NOT_CARRIED_SAYS in r.getMessage()]
    assert got == [f"{knob} is set but {NOT_CARRIED_SAYS} "
                   f"({model_manager.NOT_CARRIED_KNOBS[knob]}); serving without it"]
    assert _warnings(caplog) == []


def _load(monkeypatch, env, caplog, level=logging.INFO):
    """LoadModel of tiny-test at a pageable context with ``env`` set; the
    managed model and the log."""
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    manager = ModelManager(num_slots=2, device="cpu")
    with caplog.at_level(level):
        managed = manager.load_model("tiny", "synthetic://tiny-test", context_length=1024)
    return manager, managed


@pytest.mark.parametrize("knob", sorted(DECODE_LOOP))
def test_decode_loop_knob_changes_the_engine(clean_env, caplog, knob):
    """Each decode-loop knob, set alone (with compression's threshold for
    its sink and window pages), warns of nothing and changes what LoadModel
    builds as it does in the JAX stack: the batcher's pipeline, the
    engine's unified step and megagraph cap (the pool reports K),
    compression armed at the sink + window floor with the JAX message."""
    env = {knob: DECODE_LOOP[knob]}
    if knob in ("AIOS_TPU_KV_SINK_PAGES", "AIOS_TPU_KV_WINDOW_PAGES"):
        env["AIOS_TPU_KV_COMPRESS_AFTER"] = "100"
    manager, managed = _load(clean_env, env, caplog)
    try:
        eng = managed.engine
        assert _warnings(caplog) == []
        assert managed.batcher.pipeline == (knob == "AIOS_TPU_DECODE_PIPELINE")
        assert eng.unified_step == (knob == "AIOS_TPU_UNIFIED_STEP")
        assert eng.mega_ticks == (8 if knob == "AIOS_TPU_MEGA_TICKS" else 0)
        assert ("mega_k" in managed.pool.stats()) == (knob == "AIOS_TPU_MEGA_TICKS")
        armed = "AIOS_TPU_KV_COMPRESS_AFTER" in env
        assert eng.kv_compress_armed == armed
        if armed:
            sink = int(env.get("AIOS_TPU_KV_SINK_PAGES", 1))
            window = int(env.get("AIOS_TPU_KV_WINDOW_PAGES", 8))
            assert (eng.kv_sink_pages, eng.kv_window_pages) == (sink, window)
            assert eng.kv_compress_after == (sink + window) * eng.allocator.page_size
            msgs = [r.getMessage() for r in caplog.records]
            assert any(f"raised to sink+window floor {eng.kv_compress_after}" in m
                       for m in msgs)
            assert any("window+sink KV compression armed" in m for m in msgs)
    finally:
        manager.unload_model("tiny")


@pytest.mark.parametrize("case", ["dense", "sliding-window"])
def test_compression_disarmed_with_the_jax_warning(clean_env, caplog, case):
    """AIOS_TPU_KV_COMPRESS_AFTER over the dense cache, or on a model with
    a sliding window, leaves compression disarmed with the JAX engine's
    warning."""
    clean_env.setenv("AIOS_TPU_KV_COMPRESS_AFTER", "256")
    params = init_params(TINY_TEST, torch.Generator().manual_seed(0), dtype=torch.float32,
                         device="cpu")
    cfg, kw = TINY_TEST, dict(paged_pool_rows=1024, page_size=16)
    if case == "dense":
        kw = {}
    else:
        cfg = TINY_TEST.scaled(sliding_window=32)
    with caplog.at_level(logging.WARNING):
        eng = TorchEngine(cfg, params, device="cpu", num_slots=2, **kw)
    assert eng.kv_compress_after == 256 and not eng.kv_compress_armed
    want = ("needs a paged, unreplicated KV pool" if case == "dense"
            else "is redundant under a model sliding window")
    assert any(want in r.getMessage() for r in caplog.records)
    eng.close()


def test_moe_knobs_are_honoured_not_listed():
    assert not {"AIOS_TPU_MOE_IMPL", "AIOS_TPU_MOE_GATHER"} & set(model_manager.UNPORTED_KNOBS)


@pytest.mark.parametrize("raw", ["bogus", "GATHER", "sparse"])
def test_a_bad_moe_impl_serves_dense_as_in_jax(clean_env, raw):
    """AIOS_TPU_MOE_IMPL names a path or falls through to dense, in both
    packages, and beats the engine's static gather; both packages' MoE
    FFNs run the dense function for it."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from aios_tpu.engine import model as jm
    from aios_tpu.engine import moe as jmoe
    from aios_tpu.engine.config import TINY_MOE as JAX_TINY_MOE
    from aios_tpu_torch.engine import model as tm
    from aios_tpu_torch.engine import moe as tmoe
    from aios_tpu_torch.engine.config import TINY_MOE

    clean_env.setenv("AIOS_TPU_MOE_IMPL", raw)
    assert tmoe.resolve_impl("gather") == "dense"
    jp = jm.init_params(JAX_TINY_MOE, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = {k: torch.from_numpy(np.array(v[0])) for k, v in jp["layers"].items()}
    jl = {k: v[0] for k, v in jp["layers"].items()}
    h = np.random.default_rng(2).standard_normal((1, 3, 64)).astype(np.float32)
    calls = []
    for mod in (jmoe, tmoe):
        real = mod.moe_ffn_dense

        def spy(*a, _real=real, _mod=mod.__name__, **k):
            calls.append(_mod)
            return _real(*a, **k)

        clean_env.setattr(mod, "moe_ffn_dense", spy)
    want = jm._mlp(jnp.asarray(h), jl, JAX_TINY_MOE, moe_impl="gather")
    got = tm._mlp(torch.from_numpy(h), tp, TINY_MOE, moe_impl="gather")
    assert calls == ["aios_tpu.engine.moe", "aios_tpu_torch.engine.moe"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
