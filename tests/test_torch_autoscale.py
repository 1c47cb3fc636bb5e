"""The port's SLO autoscaler (``serving/autoscale.py``) held to the JAX
package's: one signal sequence under one fake clock gives the same actions
through both controllers; on the CPU it scales a real pool of the port's
engines up and walks the degrade ladder with greedy streams identical to an
untouched control pool; and ``ModelManager`` attaches it under
``AIOS_TPU_AUTOSCALE`` with scale-ups that share replica 0's weights."""

import importlib
import random
import threading
import time

import pytest
import torch

torch.set_num_threads(1)

PKGS = ("aios_tpu", "aios_tpu_torch")


class _StubEngine:
    def __init__(self) -> None:
        self.closed = False

    def close(self) -> None:
        self.closed = True


class _StubReplica:
    def __init__(self, idx: int, engine) -> None:
        self.idx, self.engine = idx, engine


class _StubPool:
    """The surface the controller drives, with no engines behind it."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.replicas = [_StubReplica(0, _StubEngine())]
        self.degrade_level = 0
        self.autoscaler = None

    def set_degrade_level(self, level: int) -> int:
        self.degrade_level = max(0, min(int(level), 3))
        return self.degrade_level

    def add_replica(self, engine) -> int:
        self.replicas.append(_StubReplica(len(self.replicas), engine))
        return len(self.replicas) - 1

    def remove_replica(self, drain_timeout: float = 30.0):
        if len(self.replicas) <= 1:
            return None
        return self.replicas.pop()


def _script(pkg, monkeypatch):
    """A seeded burn sequence (overload, plateau, recovery, a kill-switch
    flip) through ``pkg``'s controller: (tick results, journal)."""
    auto = importlib.import_module(f"{pkg}.serving.autoscale")
    slo = importlib.import_module(f"{pkg}.obs.slo")
    monkeypatch.delenv("AIOS_TPU_AUTOSCALE_KILL", raising=False)
    eng = slo.SLOEngine(slo.SLOConfig(ttft_ms=100.0, tpot_ms=50.0, target=0.9,
                                      window_secs=20.0, min_samples=4))
    pool = _StubPool(f"auto-parity-{pkg}")
    ctl = auto.AutoscaleController(
        pool, auto.AutoscaleConfig(max_replicas=3, hold_ticks=2, cooldown_secs=3.0),
        engine_factory=_StubEngine, slo_engine=eng)
    rng = random.Random(13)
    t = 500.0
    results = []
    for i in range(90):
        t += 1.0
        bad = 0.9 if i < 35 else (0.3 if i < 50 else 0.0)
        for _ in range(3):
            slow = rng.random() < bad
            eng.record(pool.name, "tenant", ttft_ms=400.0 if slow else 20.0,
                       tpot_ms=10.0, ok=True, now=t)
        if i == 70:
            monkeypatch.setenv("AIOS_TPU_AUTOSCALE_KILL", "1")
        if i == 75:
            monkeypatch.delenv("AIOS_TPU_AUTOSCALE_KILL")
        results.append(ctl.tick(now=t))
    journal = [{k: v for k, v in a.items()} for a in ctl.actions()]
    return results, journal, len(pool.replicas), pool.degrade_level


def test_action_sequences_alike(monkeypatch):
    a, b = (_script(p, monkeypatch) for p in PKGS)
    assert a == b
    actions = [e["action"] for e in b[1]]
    assert "scale_up" in actions and "degrade" in actions and "restore" in actions


def test_cold_pool_is_quiescent():
    auto = importlib.import_module("aios_tpu_torch.serving.autoscale")
    slo = importlib.import_module("aios_tpu_torch.obs.slo")
    eng = slo.SLOEngine(slo.SLOConfig(min_samples=4))
    ctl = auto.AutoscaleController(_StubPool("cold"), auto.AutoscaleConfig(),
                                   engine_factory=_StubEngine, slo_engine=eng)
    assert [ctl.tick(now=float(i)) for i in range(5)] == ["idle"] * 5
    assert ctl.actions() == []


# -- a real pool of the port's engines on the CPU -------------------------------------


def _pool_kit():
    from aios_tpu_torch.engine.batching import ContinuousBatcher, Request
    from aios_tpu_torch.engine.config import TINY_TEST
    from aios_tpu_torch.engine.engine import TorchEngine
    from aios_tpu_torch.engine.weights import init_params
    from aios_tpu_torch.serving import ReplicaPool, ServingConfig

    cfg = TINY_TEST.scaled(name="auto-cpu", max_context=256)
    params = init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.float32,
                         device="cpu")

    def make_engine():
        return TorchEngine(cfg, params, num_slots=4, max_context=256,
                           cache_dtype=torch.float32, track_history=True, device="cpu")

    def make_pool():
        return ReplicaPool(
            cfg.name, [make_engine()],
            lambda e: ContinuousBatcher(e, chunk_steps=2, admit_chunk_steps=2,
                                        speculative=True),
            ServingConfig(replicas=1))

    def wave(pool, n=6, max_tokens=24):
        handles = [pool.submit(Request(prompt_ids=[3 + i, 7, 11, 13], priority=1,
                                       max_tokens=max_tokens, temperature=0.0,
                                       request_id=f"auto-{i}"))
                   for i in range(n)]
        return [h.tokens() for h in handles]

    return make_engine, make_pool, wave


def test_overload_scales_up_then_degrades_with_identical_streams():
    """The closed loop of the JAX storm's autoscale arm on the CPU: tight
    targets make real latencies burn, the controller scales to its ceiling
    of 2 and walks the ladder while a greedy wave is in flight, and every
    stream equals an untouched control pool's."""
    from aios_tpu_torch.obs import flightrec
    from aios_tpu_torch.obs.slo import SLOConfig, SLOEngine
    from aios_tpu_torch.serving import AutoscaleConfig, AutoscaleController

    make_engine, make_pool, wave = _pool_kit()
    control = make_pool()
    try:
        want = wave(control)
    finally:
        control.shutdown()
    tight = SLOEngine(SLOConfig(ttft_ms=0.01, tpot_ms=0.01, target=0.99, window_secs=600,
                                min_samples=4))
    pool = make_pool()
    built = []

    def factory():
        eng = make_engine()
        built.append(eng)
        return eng

    ctl = AutoscaleController(pool, AutoscaleConfig(max_replicas=2, hold_ticks=1,
                                                    cooldown_secs=0.0, interval_secs=0.02),
                              engine_factory=factory, slo_engine=tight)
    try:
        wave(pool, n=4, max_tokens=8)
        for tl in flightrec.RECORDER.recent(model=pool.name, limit=64):
            tight.observe(tl)
        stop = threading.Event()

        def ticker():
            while not stop.wait(0.02):
                ctl.tick()

        th = threading.Thread(target=ticker, daemon=True)
        th.start()
        try:
            during = wave(pool)
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline and (len(pool.replicas) < 2
                                                   or pool.degrade_level < 3):
                time.sleep(0.05)
        finally:
            stop.set()
            th.join(timeout=5)
        after = wave(pool)
        actions = ctl.actions()
        assert actions[0]["action"] == "scale_up" and len(pool.replicas) == 2
        rungs = [a["rung"] for a in actions if a["action"] == "degrade"]
        assert rungs[:3] == ["spec_off", "jump_off", "shed_best_effort"]
        assert during == want and after == want
        # the scale-up's engine shares nothing it should not: its own pool
        assert built and built[0].k_pool.data_ptr() != pool.replicas[0].engine.k_pool.data_ptr()
    finally:
        pool.shutdown()
    assert not (ctl._thread and ctl._thread.is_alive())


def test_manager_attaches_the_autoscaler_over_shared_weights(monkeypatch):
    from aios_tpu_torch.runtime.model_manager import ModelManager

    monkeypatch.setenv("AIOS_TPU_AUTOSCALE", "1")
    monkeypatch.setenv("AIOS_TPU_AUTOSCALE_MAX_REPLICAS", "2")
    monkeypatch.setenv("AIOS_TPU_AUTOSCALE_INTERVAL_SECS", "3600")
    manager = ModelManager(num_slots=2, device="cpu")
    try:
        m = manager.load_model("auto-m", "synthetic://tiny-test", context_length=256)
        ctl = m.pool.autoscaler
        assert ctl is not None and ctl.cfg.max_replicas == 2 and ctl.engine_factory
        eng = ctl.engine_factory()
        try:
            base = m.pool.replicas[0].engine
            for key, leaf in base.params["layers"].items():
                if isinstance(leaf, torch.Tensor):
                    assert eng.params["layers"][key].data_ptr() == leaf.data_ptr(), key
            assert eng.k_pool.data_ptr() != base.k_pool.data_ptr()
        finally:
            eng.close()
    finally:
        manager.unload_model("auto-m")
    assert not ctl._thread.is_alive()
