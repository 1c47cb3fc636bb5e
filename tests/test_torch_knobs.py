"""The serving knobs on the port: each knob of the JAX stack that the port
does not honour yet logs one warning naming it when a ``ModelManager`` is
built, the honoured ones log none (the decode loop's six change the engine
and the batcher that LoadModel builds, as in the JAX stack), and
``AIOS_TPU_SAMPLE_POOL`` sizes the
sampler's candidate pool with the JAX package's errors, read once when an
engine is built. The port imports no ``ml_dtypes`` (the host tier keeps
bf16 pages as their uint16 bits)."""

import ast
import logging
import os
import pathlib
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
UNPORTED = ["AIOS_TPU_SEQ_PREFILL_MIN", "AIOS_TPU_MESH"]
HONOURED = {"AIOS_TPU_PREFIX_HOST_BYTES": "1073741824", "AIOS_TPU_HOST_RESTORE_MIN_PAGES": "2",
            "AIOS_TPU_SAMPLE_POOL": "16", "AIOS_TPU_REPLICAS": "2",
            "AIOS_TPU_PREFIX_RADIX": "0", "AIOS_TPU_PREFIX_CACHE": "1",
            "AIOS_TPU_JUMP_AHEAD": "1", "AIOS_TPU_KV_CACHE": "bf16",
            "AIOS_TPU_MAX_QUEUE": "4", "AIOS_TPU_DRAFT_MODEL": "tinyllama",
            "AIOS_TPU_MOE_IMPL": "gather", "AIOS_TPU_MOE_GATHER": "1", **DECODE_LOOP,
            **AUTOSCALE}


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
    assert sorted(model_manager.UNPORTED_KNOBS) == sorted(
        ["AIOS_TPU_SEQ_PREFILL_MIN", "AIOS_TPU_MESH"])


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
