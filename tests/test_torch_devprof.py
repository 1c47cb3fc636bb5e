"""The port's device ledger (``obs/devprof.py``) held to the JAX package's.

On the CPU the ledger times a dispatch by the host clock (its bodies run
inline); the counts, the sampling schedule and the analytic cost are what
these tests hold: the same engine calls give the JAX ledger's per-kind
dispatch counts, greedy streams and dispatch counts are the same with
devprof on and off (the JAX invariant), and the analytic FLOPs of a step, a
prefill bucket and a chunk are what ``FlopCounterMode`` counts on the plain
path's eager forward.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from aios_tpu.engine import model as jm
from aios_tpu.engine.config import TINY_TEST as JAX_TINY
from aios_tpu.engine.engine import TPUEngine
from aios_tpu_torch.engine.batching import ContinuousBatcher, Request
from aios_tpu_torch.engine.config import TINY_TEST
from aios_tpu_torch.engine.engine import TorchEngine
from aios_tpu_torch.engine.weights import params_from_jax
from aios_tpu_torch.obs import devprof

torch.set_num_threads(1)

CTX = 256
PAGE = 16


@pytest.fixture(scope="module")
def jax_params():
    return jm.init_params(JAX_TINY, jax.random.PRNGKey(4), dtype=jnp.float32)


@pytest.fixture(scope="module")
def torch_params(jax_params):
    return params_from_jax(jax.tree.map(np.asarray, jax_params))


@pytest.fixture
def armed(monkeypatch):
    monkeypatch.setenv("AIOS_TPU_DEVPROF", "1")
    monkeypatch.setenv("AIOS_TPU_DEVPROF_SAMPLE", "1")


def _prompt(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(1, 500, n)]


def _script(eng):
    """One fixed sequence of engine calls: two whole-prompt prefills, decode
    dispatches of 4 and 1 steps, a chunked admission with a decode step
    between its chunks, and a prompt whose leading blocks hit the prefix
    index (its history backfill and tail chunk)."""
    eng.prefill(0, _prompt(1, 20), temperature=0.0)
    eng.prefill(1, _prompt(2, 33), temperature=0.0)
    eng.step(4)
    for _ in range(3):
        eng.step(1)
    eng.release(1)
    pc = eng.start_chunked_prefill(1, _prompt(3, 150), temperature=0.0, chunk=64)
    while pc.step() is None:
        eng.step(1)
    eng.step(2)
    eng.release(0)
    eng.prefill(0, _prompt(3, 150)[:140] + [7, 7, 7], temperature=0.0)
    eng.step(1)


DECODE_KINDS = ("step", "masked", "mega", "spec", "draft_spec", "jump")


def _settle(b, eng) -> None:
    """Wait until the batcher has collected every decode dispatch its
    engine ran: a pipelined one issued past the last token lands at a later
    idle tick (and without a ledger, until none is in flight)."""
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        snap = eng.devprof_snapshot()
        if snap is None:
            if b._pending is None:
                return
        elif all(g["dispatches"] == b.dispatches_by_graph.get(k, 0)
                 for k, g in snap["graphs"].items() if k in DECODE_KINDS):
            return
        time.sleep(0.01)


def _counts(snap):
    return {k: v["dispatches"] for k, v in snap["graphs"].items()}


def test_dispatch_counts_equal_the_jax_ledger(armed, jax_params, torch_params):
    port = TorchEngine(TINY_TEST, torch_params, num_slots=2, max_context=CTX, device="cpu",
                       cache_dtype=torch.float32, paged_pool_rows=4 * CTX, page_size=PAGE)
    ref = TPUEngine(JAX_TINY, jax_params, num_slots=2, max_context=CTX,
                    cache_dtype=jnp.float32, paged_pool_rows=4 * CTX, page_size=PAGE)
    try:
        _script(port)
        _script(ref)
        got, want = _counts(port.devprof_snapshot()), _counts(ref.devprof_snapshot())
        assert got == want
        assert {"prefill", "step", "chunk", "hist"} <= set(got)
        snap = port.devprof_snapshot()["graphs"]
        # sampled every dispatch (SAMPLE=1) but the history copy, which is
        # counted and never timed, as in the JAX engine
        for kind, g in snap.items():
            assert g["samples"] == (0 if kind == "hist" else g["dispatches"]), kind
            if kind != "hist":
                assert g["sampled_seconds"] > 0 and g["est_flops"] > 0, kind
        assert port.devprof_est_s("step") > 0
    finally:
        port.close()
        ref.close()


def _waves(torch_params, pipeline):
    eng = TorchEngine(TINY_TEST, torch_params, num_slots=2, max_context=CTX, device="cpu",
                      cache_dtype=torch.float32, paged_pool_rows=4 * CTX, page_size=PAGE)
    b = ContinuousBatcher(eng, chunk_steps=4, admit_chunk_steps=2, pipeline=pipeline,
                          prefill_chunk=64)
    try:
        streams = []
        for i, n in enumerate((12, 90, 30, 140)):
            h = b.submit(Request(prompt_ids=_prompt(10 + i, n), max_tokens=9,
                                 temperature=0.0))
            streams.append(h.tokens())
        _settle(b, eng)
        stats = {k: v for k, v in eng.stats().items() if not k.endswith("seconds")}
        return streams, stats, dict(b.dispatches_by_graph), eng.devprof_snapshot()
    finally:
        b.shutdown()
        eng.close()


@pytest.mark.parametrize("pipeline", [False, True])
def test_streams_and_dispatches_identical_devprof_on_and_off(torch_params, monkeypatch,
                                                             pipeline):
    monkeypatch.delenv("AIOS_TPU_DEVPROF", raising=False)
    off = _waves(torch_params, pipeline)
    monkeypatch.setenv("AIOS_TPU_DEVPROF", "1")
    monkeypatch.setenv("AIOS_TPU_DEVPROF_SAMPLE", "2")
    on = _waves(torch_params, pipeline)
    assert off[3] is None
    assert on[0] == off[0]
    if not pipeline:
        # the sync loop's dispatches are the requests' own; a pipelined one
        # issued ahead past a retirement depends on thread timing
        assert on[1] == off[1] and on[2] == off[2]
    # the ledger's count of each kind is the batcher's (decode) and the
    # engine's (admission)
    graphs = on[3]["graphs"]
    for kind, n in on[2].items():
        assert graphs[kind]["dispatches"] == n, kind
    assert graphs["prefill"]["dispatches"] == on[1]["prefills"]
    assert graphs["chunk"]["dispatches"] == on[1]["prefill_chunks"]
    assert graphs["step"]["samples"] >= 1 and graphs["prefill"]["samples"] >= 1


def test_megagraph_charges_its_ticks_that_ran(armed, torch_params):
    eng = TorchEngine(TINY_TEST, torch_params, num_slots=2, max_context=CTX, device="cpu",
                      cache_dtype=torch.float32, paged_pool_rows=4 * CTX, page_size=PAGE,
                      mega_ticks=8)
    try:
        eng.prefill(0, _prompt(1, 20), temperature=0.0)
        # as a capture registers the bucket's static cost on the card: a
        # dispatch still charges only the ticks that ran
        eng._devprof.register("mega", ("mega", 8), eng.devprof_cost("mega", n=8), 0.0)
        lens = eng._active_lens().copy()
        stops = np.full((2, 4), -1, np.int32)
        _, _, k = eng.mega_step(8, stops, np.array([3, 0], np.int32))
        assert k == 3
        g = eng.devprof_snapshot()["graphs"]["mega"]
        want = eng.devprof_cost("mega", lens=lens, n=k)
        assert g["dispatches"] == 1 and g["est_flops"] == pytest.approx(want[0])
        assert g["est_bytes"] == pytest.approx(want[1])
    finally:
        eng.close()


def test_ledger_api_matches_the_jax_module():
    from aios_tpu.obs import devprof as jd

    for name in ("GRAPH_KINDS", "CAPTURE_MAX_SECS"):
        assert getattr(devprof, name) == getattr(jd, name)
    for led_mod in (jd, devprof):
        led = led_mod.DevprofLedger(f"api-{led_mod.__name__}", device_kind="", sample_n=3)
        assert [led.note("step") for _ in range(7)] == [True, False, False, True, False,
                                                        False, True]
        with pytest.raises(ValueError):
            led.register("bogus", None, None, 0.0)
        assert led.peaks is None and led.mean_s("step") is None
    assert devprof.resolve_peaks("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    assert devprof.resolve_peaks("NVIDIA A100-SXM4-80GB") is None


def test_ratios_only_on_a_known_card():
    led = devprof.DevprofLedger("ratio-card", device_kind="NVIDIA H100 80GB HBM3", sample_n=1)
    led.note("step", cost=(1e12, 1e9))
    led.sample("step", None, 0.01, cost=(1e12, 1e9))
    g = led.snapshot()["graphs"]["step"]
    assert g["mfu"] == pytest.approx(1e12 / 0.01 / 989e12, rel=1e-3)
    assert g["hbm_bw_util"] == pytest.approx(1e9 / 0.01 / 3.35e12, rel=1e-3)
    plain = devprof.DevprofLedger("ratio-cpu", device_kind="", sample_n=1)
    plain.note("step", cost=(1e12, 1e9))
    plain.sample("step", None, 0.01, cost=(1e12, 1e9))
    assert "mfu" not in plain.snapshot()["graphs"]["step"]


# -- the analytic cost against FlopCounterMode on the plain path --------------------------


def _engine(torch_params):
    eng = TorchEngine(TINY_TEST, torch_params, num_slots=2, max_context=CTX, device="cpu",
                      cache_dtype=torch.float32, paged_pool_rows=4 * CTX, page_size=PAGE)
    eng.prefill(0, _prompt(1, 20), temperature=0.0)
    eng.prefill(1, _prompt(2, 40), temperature=0.0)
    return eng


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def _pair_flops(eng, pairs) -> float:
    """QK^T and PV over ``pairs`` (query row, attended row) pairs."""
    cfg = eng.cfg
    return 4.0 * cfg.num_layers * cfg.num_heads * cfg.head_dim * pairs


def test_step_flops_match_the_flop_counter(armed, torch_params):
    """A decode step as the engine charges a graph's own shape (every slot
    at the full context): every slot's row through the projections and the
    lm_head, attending the plain path's gathered view of the whole
    context."""
    eng = _engine(torch_params)
    try:
        got = _counted(eng._step_body)
        assert eng.devprof_cost("step")[0] == pytest.approx(got, rel=0.01)
    finally:
        eng.close()


@pytest.mark.parametrize("bucket", [16, 64])
def test_prefill_bucket_flops_match_the_flop_counter(armed, torch_params, bucket):
    """A whole-prompt prefill at a bucket: the plain attention scores the
    full T x T block before the causal mask, the kernel (and
    ``devprof_cost``) only the causal pairs; the masked pairs are added
    back row by row."""
    eng = _engine(torch_params)
    try:
        ids = _prompt(5, bucket - 3)
        with eng._lock:
            eng.allocator.ensure(0, len(ids))
            eng._stage_admission(0, ids, 0, len(ids), len(ids), 0.0, 1.0, bucket)
        got = _counted(lambda: eng._prefill_body(bucket))
        masked = sum(bucket - (i + 1) for i in range(bucket))
        charged = eng.devprof_cost("prefill", ("prefill", bucket))[0]
        assert charged + _pair_flops(eng, masked) == pytest.approx(got, rel=0.01)
    finally:
        eng.close()


@pytest.mark.parametrize("final", [False, True])
def test_chunk_flops_match_the_flop_counter(armed, torch_params, final):
    """A chunk of 64 rows from row 64: each row attends the plain path's
    view of the slot's whole context, the kernel (and ``devprof_cost``)
    only the rows up to its own; the rest are added back row by row."""
    eng = _engine(torch_params)
    try:
        ids = _prompt(6, 128)
        b, start, C = 64, 64, eng.max_context
        with eng._lock:
            eng.allocator.ensure(0, start + b)
            eng._stage_admission(0, ids[start:start + b], start, b, len(ids), 0.0, 1.0, b)
        got = _counted(lambda: eng._chunk_body(b, final))
        masked = sum(C - (start + i + 1) for i in range(b))
        charged = eng.devprof_cost("chunk", ("chunk", b, final), start=start)[0]
        assert charged + _pair_flops(eng, masked) == pytest.approx(got, rel=0.01)
    finally:
        eng.close()


@pytest.mark.parametrize("pipeline", [False, True])
def test_megagraph_decode_events_carry_the_jax_fields(torch_params, armed, pipeline):
    """A megagraph dispatch's recorder events hold the JAX batcher's fields
    (the devprof kind names the ledger's graph, never an event field)."""
    from aios_tpu_torch.obs import flightrec

    eng = TorchEngine(TINY_TEST, torch_params, num_slots=2, max_context=CTX, device="cpu",
                      cache_dtype=torch.float32, paged_pool_rows=4 * CTX, page_size=PAGE,
                      mega_ticks=4)
    b = ContinuousBatcher(eng, chunk_steps=4, admit_chunk_steps=2, pipeline=pipeline)
    try:
        rec = flightrec.RECORDER.begin("mega-events", "mega-1", "tenant")
        req = Request(prompt_ids=_prompt(7, 20), max_tokens=9, temperature=0.0)
        req.rec = rec
        assert len(b.submit(req).tokens()) == 9
        _settle(b, eng)
        fields = [f for _, kind, f in rec.events if kind == "decode"]
        assert fields and all(set(f) <= {"n", "occ", "gap_ms", "dur_ms", "pipelined",
                                         "dev_us"} for f in fields), fields
        assert b.dispatches_by_graph.get("mega", 0) == \
            eng.devprof_snapshot()["graphs"]["mega"]["dispatches"]
    finally:
        b.shutdown()
        eng.close()


class _FakeProfile:
    """Stands in for torch.profiler.profile: records whether every tracked
    engine was quiesced when the capture started and stopped it."""

    events: list = []
    engines: list = []

    def __init__(self, activities):
        pass

    def start(self):
        self.events.append(("start", [e.held for e in self.engines]))

    def stop(self):
        self.events.append(("stop", [e.held for e in self.engines]))

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            f.write('{"traceEvents": []}')


def _capture_done(timeout=60.0):
    deadline = time.monotonic() + timeout
    while devprof.capture_status()["busy"] and time.monotonic() < deadline:
        time.sleep(0.01)
    return devprof.capture_status()


def test_a_capture_starts_and_stops_the_profiler_with_every_engine_quiesced(
        monkeypatch, tmp_path):
    """/debug/profile's capture thread starts and stops the profiler only
    while it holds every live engine's dispatch lock: on the card a stop
    that raced a graph replay on a serving thread hung the process (the
    capture thread in the profiler's stop, the scheduler in ``replay``).
    The window between them runs with the engines free."""
    import contextlib

    class Engine:
        def __init__(self):
            self.held = False

        @contextlib.contextmanager
        def quiesced(self):
            self.held = True
            try:
                yield
            finally:
                self.held = False

    engines = [Engine(), Engine()]
    for e in engines:
        devprof.track_engine(e)
    _FakeProfile.events, _FakeProfile.engines = [], engines
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    monkeypatch.setenv("AIOS_TPU_DEVPROF_DUMP_DIR", str(tmp_path))
    try:
        out = devprof.start_capture(0.05)
        st = _capture_done()
        assert not st["busy"] and not st["error"], st
        assert _FakeProfile.events == [("start", [True, True]), ("stop", [True, True])]
        assert not any(e.held for e in engines)
        assert (tmp_path / out["path"].split("/")[-1] / "trace.json").exists()
    finally:
        _FakeProfile.engines = []
        for e in engines:
            devprof._ENGINES.discard(e)


def test_a_capture_waits_for_a_dispatch_in_flight(torch_params, monkeypatch, tmp_path):
    """A real engine: while its lock is held (a dispatch in flight) the
    capture does not start the profiler; it starts once the lock is free."""
    eng = TorchEngine(TINY_TEST, torch_params, cache_dtype=torch.float32, device="cpu",
                      num_slots=2, max_context=CTX)
    _FakeProfile.events, _FakeProfile.engines = [], []
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    monkeypatch.setenv("AIOS_TPU_DEVPROF_DUMP_DIR", str(tmp_path))
    try:
        with eng._lock:
            devprof.start_capture(0.05)
            time.sleep(0.3)
            assert _FakeProfile.events == [] and devprof.capture_status()["busy"]
        st = _capture_done()
        assert not st["busy"] and not st["error"], st
        assert [kind for kind, _ in _FakeProfile.events] == ["start", "stop"]
    finally:
        eng.close()
