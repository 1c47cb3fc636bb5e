"""Grammar-constrained decoding in the port against the JAX package, on the
CPU: ``model.verify_step_paged`` (f32 and int8 pools, a window, an inactive
slot, a slot at the C-2 clamp); the engine's ``step_masked`` and
``jump_step`` against ``TPUEngine``'s over the page pool and the dense cache
(tokens, lengths, last tokens, history and cache rows); the batcher against
the JAX batcher on the mix of tests/test_structured_fastpath.py (two
schemas, ``json_mode`` and an unconstrained stream; greedy streams
token-identical, jump-ahead on and off, and >= 2x fewer decode dispatches
with it on a schema-forced wave), sampled schema streams that conform; and
the gRPC service (a schema served, its two INVALID_ARGUMENT cases, forced
JSON mode, a stream that stays unconstrained).

Tolerances: logits at 1e-4, f32 cache rows within 1e-5 (the K/V rows both
models compute differ by f32 sums in another order), int8 cache bytes
equal, tokens equal. The CUDA graphs and kernels of these dispatches run on
the card (``chip_smoke.py``, ``phase_constrained``)."""

import json
import os

import grpc
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aios_tpu.engine import model as jm
from aios_tpu.engine.batching import ContinuousBatcher as JaxBatcher
from aios_tpu.engine.batching import Request as JaxRequest
from aios_tpu.engine.config import TINY_TEST as JAX_TINY
from aios_tpu.engine.engine import TPUEngine
from aios_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from aios_tpu_torch import rpc, services
from aios_tpu_torch.engine import jsonmode, jsonschema
from aios_tpu_torch.engine import model as tm
from aios_tpu_torch.engine.batching import ContinuousBatcher, Request
from aios_tpu_torch.engine.config import TINY_TEST
from aios_tpu_torch.engine.engine import JUMP_BUCKETS, TorchEngine
from aios_tpu_torch.engine.paged import PoolExhausted
from aios_tpu_torch.engine.tokenizer import ByteTokenizer
from aios_tpu_torch.engine.weights import params_from_jax
from aios_tpu_torch.proto_gen import runtime_pb2
from aios_tpu_torch.runtime.model_manager import ModelManager
from aios_tpu_torch.runtime.service import serve

# The shapes here are tiny: one intra-op thread is faster and leaves the
# cores to the other test workers.
torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
L, KH, D = TINY_TEST.num_layers, TINY_TEST.num_kv_heads, TINY_TEST.head_dim
V = TINY_TEST.vocab_size


@pytest.fixture(scope="module")
def jax_params():
    return jm.init_params(JAX_TINY, jax.random.PRNGKey(0), dtype=jnp.float32)


@pytest.fixture(scope="module")
def torch_params(jax_params):
    return params_from_jax(jax.tree.map(np.asarray, jax_params))


def _same_cache(got: np.ndarray, want: np.ndarray) -> None:
    if want.dtype == np.int8:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


# -- the paged verify forward ---------------------------------------------------


@pytest.mark.parametrize("window", [None, 24], ids=["full", "window24"])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_verify_step_paged_matches_jax(jax_params, torch_params, quant, window):
    """Four slots of four 16-row pages (C = 64), five tokens each: slots at
    3 and 30 rows, one at C-2 whose last rows clamp onto C-1, and an
    inactive one that writes page 0, row P-1: the logits and the whole pool
    (and scales) after the forward, as the JAX function's."""
    jcfg, tcfg = JAX_TINY.scaled(sliding_window=window), TINY_TEST.scaled(sliding_window=window)
    rng = np.random.default_rng(7)
    N, P, B, T, MB = 20, 16, 4, 5, 4
    shape = (L, N, P, KH, D)
    if quant:
        (kq, ks), (vq, vs) = (tuple(np.array(a) for a in jm.quantize_kv(
            jnp.asarray(rng.normal(size=shape).astype(np.float32)))) for _ in range(2))
        state = [kq, vq, ks, vs]
    else:
        state = [rng.normal(size=shape).astype(np.float32) for _ in range(2)]
    tables = rng.permutation(np.arange(1, N))[:B * MB].reshape(B, MB).astype(np.int32)
    lengths = np.array([3, 30, MB * P - 2, 17], np.int32)
    active = np.array([True, True, True, False])
    tokens = rng.integers(0, V, (B, T)).astype(np.int32)
    jstate = [jnp.asarray(a) for a in state]
    out = jm.verify_step_paged(
        jax_params, jcfg, jnp.asarray(tokens), jnp.asarray(lengths), jstate[0], jstate[1],
        jnp.asarray(tables), cache_scales=(jstate[2], jstate[3]) if quant else None,
        active=jnp.asarray(active))
    jl = np.asarray(out[0])
    jcaches = [np.asarray(a) for a in out[1:3]] + (
        [np.asarray(a) for a in out[3]] if quant else [])
    tstate = [torch.from_numpy(a.copy()) for a in state]
    tl = tm.verify_step_paged(
        torch_params, tcfg, torch.from_numpy(tokens).long(), torch.from_numpy(lengths),
        tstate[0], tstate[1], torch.from_numpy(tables), active=torch.from_numpy(active),
        cache_scales=(tstate[2], tstate[3]) if quant else None)
    assert tl.shape == (B, T, V)
    np.testing.assert_allclose(tl.numpy(), jl, **LOGIT_TOL)
    for got, want in zip(tstate, jcaches):
        _same_cache(got.numpy(), want)
    # the rows really were written: slot 0's five rows changed
    page = tables[0, 0]
    assert not np.array_equal(tstate[0].numpy()[:, page, 3:8], state[0][:, page, 3:8])


def test_verify_step_paged_kernel_flag_takes_the_same_plain_path_on_cpu(torch_params):
    """On CPU tensors ``kernels=True`` runs the wrappers' plain twins, which
    are the ``*_reference`` functions ``kernels=False`` calls by name."""
    rng = np.random.default_rng(8)
    pools = [torch.from_numpy(rng.normal(size=(L, 9, 16, KH, D)).astype(np.float32))
             for _ in range(2)]
    tables = torch.arange(1, 9, dtype=torch.int32).reshape(2, 4)
    lengths = torch.tensor([5, 40], dtype=torch.int32)
    tokens = torch.from_numpy(rng.integers(0, V, (2, 4)))
    a = tm.verify_step_paged(torch_params, TINY_TEST, tokens, lengths, pools[0].clone(),
                             pools[1].clone(), tables, kernels=True)
    b = tm.verify_step_paged(torch_params, TINY_TEST, tokens, lengths, pools[0].clone(),
                             pools[1].clone(), tables, kernels=False)
    assert torch.equal(a, b)


# -- the engine's masked step and jump ----------------------------------------------

CACHES = {"f32": (jnp.float32, torch.float32), "int8": (jnp.int8, torch.int8)}
PROMPTS = [[256] + list(range(40, 75)), [256, 7, 8, 9], [256] + list(range(100, 117))]


def _engine_pair(jax_params, torch_params, layout: str, cache: str, **over):
    kw = dict(num_slots=4, max_context=128)
    if layout == "paged":
        kw.update(paged_pool_rows=5 * 128, page_size=16, prefix_cache=False)
    kw.update(over)
    jdt, tdt = CACHES[cache]
    return (TPUEngine(JAX_TINY, jax_params, cache_dtype=jdt, **kw),
            TorchEngine(TINY_TEST, torch_params, cache_dtype=tdt, device="cpu", **kw))


def _mask_rows(rng, slots, allowed: int = 40):
    """An additive row per slot that admits ``allowed`` random tokens."""
    rows = {}
    for s in slots:
        row = np.full(V, jsonmode.NEG_INF, np.float32)
        row[rng.choice(V, allowed, replace=False)] = 0.0
        rows[s] = row
    return rows


def _assert_state_matches(jeng, port, slots):
    """Lengths (device and host), last tokens, history and the cache rows of
    ``slots`` up to their lengths, as the JAX engine's."""
    st = {k: np.asarray(v) for k, v in jeng.state.items() if k != "key"}
    np.testing.assert_array_equal(port._host_lengths, jeng._host_lengths)
    for s in slots:
        n = int(port._host_lengths[s])
        assert int(port.lengths[s]) == n == int(st["lengths"][s])
        assert int(port.last_tokens[s]) == int(st["last_tokens"][s])
        np.testing.assert_array_equal(port.history[s, :n + 1].numpy(), st["history"][s, :n + 1])
        names = [("k_pool", "k"), ("v_pool", "v")]
        if port.quant_cache:
            names += [("k_scales", "k_s"), ("v_scales", "v_s")]
        for name, key in names:
            got, want = getattr(port, name).numpy(), st[key]
            if port.paged:
                np.testing.assert_array_equal(port.allocator.tables, jeng.allocator.tables)
                pages = port.allocator.tables[s, :port.allocator.blocks_for(n)]
                got = got[:, pages].reshape(L, -1, *got.shape[3:])[:, :n]
                want = want[:, pages].reshape(L, -1, *want.shape[3:])[:, :n]
            else:
                got, want = got[:, s, :n], want[:, s, :n]
            _same_cache(got, want)


@pytest.mark.parametrize("cache", ["f32", "int8"])
@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_step_masked_and_jump_step_match_jax(jax_params, torch_params, layout, cache):
    """Three greedy slots and an inactive one: a masked step (two slots
    constrained, one with a zero row), a jump at bucket 4 (counts 3, 0, 4;
    the slot with 0 keeps its state), a plain step, a jump at bucket 16
    (counts 12, 7, 0), and masked steps after it: the same tokens, lengths,
    last tokens, history and cache rows as TPUEngine's."""
    jeng, port = _engine_pair(jax_params, torch_params, layout, cache)
    rng = np.random.default_rng(11)
    try:
        for s, p in enumerate(PROMPTS):
            assert port.prefill(s, p, temperature=0.0) == jeng.prefill(s, p, temperature=0.0)
        active = list(range(len(PROMPTS)))
        for step in range(3):
            rows = _mask_rows(rng, [0, 1 + step % 2])
            full = np.zeros((4, V), np.float32)
            for s, row in rows.items():
                full[s] = row
            want = np.asarray(jeng.step_masked(full))
            got = port.step_masked(rows)
            assert got.shape == (1, 4)
            np.testing.assert_array_equal(got[0, :3], want[0, :3])
            for s, row in rows.items():
                assert row[got[0, s]] == 0.0  # an allowed token
            _assert_state_matches(jeng, port, active)
        before = (int(port.lengths[1]), int(port.last_tokens[1]),
                  port.history[1].clone())
        for forced_len, counts in ((4, [3, 0, 4, 0]), (12, [12, 7, 0, 0])):
            forced = rng.integers(0, 256, (4, forced_len)).astype(np.int32)
            jeng.jump_step(forced, np.asarray(counts, np.int32))
            port.jump_step(forced, np.asarray(counts))
            _assert_state_matches(jeng, port, active)
            for s, c in enumerate(counts[:3]):
                if c:
                    assert int(port.last_tokens[s]) == int(forced[s, c - 1])
            if forced_len == 4:  # counts 0: slot 1 left exactly as it was
                assert (int(port.lengths[1]), int(port.last_tokens[1])) == before[:2]
                # the history but its sacrificial last column
                assert torch.equal(port.history[1, :-1], before[2][:-1])
                np.testing.assert_array_equal(port.step(1)[0, :3], jeng.step(1)[0, :3])
            rows = _mask_rows(rng, [0, 2])
            full = np.zeros((4, V), np.float32)
            for s, row in rows.items():
                full[s] = row
            np.testing.assert_array_equal(port.step_masked(rows)[0, :3],
                                          np.asarray(jeng.step_masked(full))[0, :3])
            _assert_state_matches(jeng, port, active)
        stats = port.stats()
        assert stats["jump_dispatches"] == 2 and stats["jump_tokens"] == 26
        assert stats["decode_steps"] == jeng.decode_steps
        assert stats["graph_captures"] == 0  # the CPU runs the bodies eagerly
        assert set(port._mask_rows) == {0, 2}
        assert not port.step_mask[1].any() and not port.step_mask[3].any()
    finally:
        jeng.close()
        port.close()


def test_jump_step_buckets_and_refuses_a_longer_run(torch_params):
    port = TorchEngine(TINY_TEST, torch_params, num_slots=2, max_context=64,
                       cache_dtype=torch.float32, device="cpu")
    port.prefill(0, [1, 2, 3], temperature=0.0)
    port.jump_step(np.array([[5, 6], [0, 0]]), np.array([2, 0]))  # bucket 4
    assert port.slot_length(0) == 5 and int(port.last_tokens[0]) == 6
    assert port.history[0, 4].item() == 5 and port.history[0, 5].item() == 6
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        port.jump_step(np.zeros((2, JUMP_BUCKETS[-1] + 1)), np.zeros(2))
    with pytest.raises(ValueError, match="not in"):
        port.capture_jump(8)
    port.close()


def test_paged_jump_backs_its_rows_first_or_leaves_the_state(torch_params):
    """Over the pool a jump backs kb + 1 rows of every active slot before it
    dispatches; when the pool cannot, PoolExhausted leaves the device state
    and the host lengths untouched."""
    port = TorchEngine(TINY_TEST, torch_params, num_slots=2, max_context=64,
                       paged_pool_rows=64, page_size=16, cache_dtype=torch.float32,
                       prefix_cache=False, device="cpu")
    port.prefill(0, list(range(1, 31)), temperature=0.0)  # 2 of the 4 pages
    port.prefill(1, list(range(1, 9)), temperature=0.0)  # 1 page
    assert port.allocator.free_pages == 1
    # bucket 4 backs 5 rows: slot 0's rows 30..34 take the free page, slot
    # 1's 8..12 fit its own
    port.jump_step(np.full((2, 3), 7), np.array([3, 0]))
    assert port.slot_length(0) == 33 and port.allocator.free_pages == 0
    saved = (port.lengths.clone(), port.last_tokens.clone(), port._host_lengths.copy())
    with pytest.raises(PoolExhausted):  # bucket 16: slot 0's rows 33..49 need a page
        port.jump_step(np.full((2, 16), 7), np.array([0, 16]))
    assert torch.equal(port.lengths, saved[0]) and torch.equal(port.last_tokens, saved[1])
    np.testing.assert_array_equal(port._host_lengths, saved[2])
    port.close()


def test_force_pending_token_replaces_the_first_token(jax_params, torch_params):
    jeng, port = _engine_pair(jax_params, torch_params, "paged", "f32")
    try:
        for eng in (jeng, port):
            eng.prefill(0, PROMPTS[0], temperature=0.0)
            eng.force_pending_token(0, ord("{"))
        assert int(port.last_tokens[0]) == ord("{")
        assert port.history[0, len(PROMPTS[0])].item() == ord("{")
        np.testing.assert_array_equal(port.step(4)[:, 0], np.asarray(jeng.step(4))[:, 0])
    finally:
        jeng.close()
        port.close()


def test_warmup_on_cpu_captures_nothing(torch_params):
    port = TorchEngine(TINY_TEST, torch_params, num_slots=2, max_context=64,
                       cache_dtype=torch.float32, device="cpu")
    port.warmup(masked_step=True)
    port.capture_masked()
    port.capture_jump(4)
    assert port.stats()["graph_captures"] == 0 and not port.graphs.graphs
    port.close()


# -- the batcher against the JAX batcher --------------------------------------------

# the schemas of tests/test_structured_fastpath.py
TOOL_SCHEMA = {
    "type": "object",
    "properties": {
        "tool": {"type": "string", "enum": ["read_file", "write_file", "list_dir"]},
        "path": {"type": "string", "enum": ["slash_tmp", "slash_etc"]},
        "recursive": {"type": "boolean"},
    },
    "required": ["tool", "path", "recursive"],
}
MIXED_SCHEMA = {
    "type": "object",
    "properties": {"name": {"type": "string"}, "count": {"type": "integer"}},
    "required": ["name", "count"],
}


def _schema_req(i, schema=TOOL_SCHEMA, **kw):
    tok = ByteTokenizer()
    req = dict(prompt_ids=tok.encode(f"emit json {i}"), max_tokens=64, temperature=0.0,
               stop_ids=(tok.eos_id,), json_schema=schema)
    req.update(kw)
    return req


def _mix():
    """The mixed batch of the JAX test: two schemas, json_mode, and one
    unconstrained stream."""
    tok = ByteTokenizer()
    return [_schema_req(0), _schema_req(1, schema=MIXED_SCHEMA),
            dict(prompt_ids=tok.encode("emit json 2"), max_tokens=48, temperature=0.0,
                 stop_ids=(tok.eos_id,), json_mode=True),
            dict(prompt_ids=tok.encode("plain"), max_tokens=20, temperature=0.0)]


LAYOUTS = {"paged": dict(paged_pool_rows=5 * 128, page_size=16, prefix_cache=False),
           "dense": {}}


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def jax_streams(request, jax_params):
    """The JAX batcher's greedy streams (jump-ahead on) for the mix, then a
    schema-forced wave of two tool-call requests."""
    eng = TPUEngine(JAX_TINY, jax_params, num_slots=4, max_context=128,
                    cache_dtype=jnp.float32, **LAYOUTS[request.param])
    b = JaxBatcher(eng, chunk_steps=4, admit_chunk_steps=2, tokenizer=JaxByteTokenizer(),
                   jump_ahead=True)
    try:
        mix = [h.tokens() for h in [b.submit(JaxRequest(**r)) for r in _mix()]]
        wave = [h.tokens() for h in
                [b.submit(JaxRequest(**_schema_req(10 + i))) for i in range(2)]]
    finally:
        b.shutdown()
        eng.close()
    return request.param, mix, wave


def _port_streams(torch_params, layout: str, jump: bool):
    eng = TorchEngine(TINY_TEST, torch_params, num_slots=4, max_context=128,
                      cache_dtype=torch.float32, device="cpu", **LAYOUTS[layout])
    b = ContinuousBatcher(eng, tokenizer=ByteTokenizer(), jump_ahead=jump)
    try:
        mix = [h.tokens() for h in [b.submit(Request(**r)) for r in _mix()]]
        before = eng.decode_steps
        wave = [h.tokens() for h in [b.submit(Request(**_schema_req(10 + i)))
                                     for i in range(2)]]
        assert b.last_error is None
        return mix, wave, eng.decode_steps - before, eng.stats()
    finally:
        b.shutdown()
        eng.close()


def test_constrained_batcher_streams_match_jax(jax_streams, torch_params):
    """Greedy streams token-identical to the JAX batcher's, jump-ahead on
    and off, over the pool and the dense cache; the schema replies parse
    and end in a terminal state of the schema's machine; the jump arm
    takes >= 2x fewer decode dispatches on the schema-forced wave."""
    layout, want_mix, want_wave = jax_streams
    tok = ByteTokenizer()
    arms = {jump: _port_streams(torch_params, layout, jump) for jump in (False, True)}
    for jump, (mix, wave, _, _) in arms.items():
        assert mix == want_mix, jump
        assert wave == want_wave, jump
    on, off = arms[True], arms[False]
    assert off[2] >= 2 * on[2], (off[2], on[2])
    assert on[3]["jump_dispatches"] > 0 and on[3]["jump_tokens"] >= 2 * on[3]["jump_dispatches"]
    assert "jump_dispatches" not in off[3]
    for out, schema in zip(want_mix[:2] + want_wave, [TOOL_SCHEMA, MIXED_SCHEMA] * 1
                           + [TOOL_SCHEMA] * 2):
        text = tok.decode([t for t in out if t != tok.eos_id])
        assert isinstance(json.loads(text), dict)
        machine = jsonschema.SchemaMachine(*jsonschema.compile_schema(schema))
        st = machine.start()
        for byte in text.encode():
            st = machine.step(st, byte)
        assert machine.terminal(st), text
    assert isinstance(json.loads(tok.decode([t for t in want_mix[2] if t != tok.eos_id])),
                      dict)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sampled_schema_streams_conform(torch_params, layout):
    eng = TorchEngine(TINY_TEST, torch_params, num_slots=4, max_context=128,
                      cache_dtype=torch.float32, device="cpu", **LAYOUTS[layout])
    b = ContinuousBatcher(eng, tokenizer=ByteTokenizer())
    tok = ByteTokenizer()
    try:
        hs = [b.submit(Request(**_schema_req(i, temperature=0.9, top_p=0.9)))
              for i in range(4)]
        for h in hs:
            parsed = json.loads(tok.decode([t for t in h.tokens() if t != tok.eos_id]))
            assert parsed["tool"] in TOOL_SCHEMA["properties"]["tool"]["enum"]
            assert parsed["path"] in ("slash_tmp", "slash_etc")
            assert isinstance(parsed["recursive"], bool)
        assert eng.stats()["jump_dispatches"] > 0
    finally:
        b.shutdown()
        eng.close()


def test_batcher_refuses_constrained_requests_it_cannot_serve(torch_params):
    eng = TorchEngine(TINY_TEST, torch_params, num_slots=2, max_context=64,
                      cache_dtype=torch.float32, device="cpu")
    plain = ContinuousBatcher(eng)
    with pytest.raises(ValueError, match="tokenizer"):
        plain.submit(Request(prompt_ids=[1], json_mode=True))
    plain.shutdown()
    b = ContinuousBatcher(eng, tokenizer=ByteTokenizer())
    with pytest.raises(ValueError, match="scalar roots"):
        b.submit(Request(prompt_ids=[1], json_schema={"type": "string"}))
    with pytest.raises(ValueError, match="minimal completion"):
        b.submit(Request(prompt_ids=[1], max_tokens=2, json_schema=TOOL_SCHEMA))
    b.shutdown()
    eng.close()


# -- the gRPC service ---------------------------------------------------------------


@pytest.fixture(scope="module")
def runtime(torch_params):
    manager = ModelManager(num_slots=2, device="cpu")
    server, _, port = serve(address="127.0.0.1:0", manager=manager, block=False)
    channel = rpc.insecure_channel(f"127.0.0.1:{port}")
    stub = services.AIRuntimeStub(channel)
    assert stub.LoadModel(runtime_pb2.LoadModelRequest(
        model_name="tiny", model_path="synthetic://tiny-test")).status == "ready"
    yield stub, manager
    manager.close()
    channel.close()
    server.stop(grace=None)


def test_infer_with_a_json_schema_parses(runtime):
    stub, _ = runtime
    r = stub.Infer(runtime_pb2.InferRequest(prompt="call a tool", max_tokens=96,
                                            json_schema=json.dumps(TOOL_SCHEMA)))
    parsed = json.loads(r.text)
    assert parsed["tool"] in TOOL_SCHEMA["properties"]["tool"]["enum"]
    assert set(parsed) == {"tool", "path", "recursive"}


@pytest.mark.parametrize("schema,why", [
    ("{not json", "invalid json_schema"), ("[1, 2]", "invalid json_schema"),
    (json.dumps({"type": "tuple"}), "unsupported json_schema"),
    (json.dumps({"type": "string"}), "unsupported json_schema"),
])
def test_bad_schemas_are_invalid_argument(runtime, schema, why):
    stub, _ = runtime
    with pytest.raises(grpc.RpcError) as err:
        stub.Infer(runtime_pb2.InferRequest(prompt="x", max_tokens=8, json_schema=schema))
    assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    assert err.value.details().startswith(why)


def test_forced_json_mode_constrains_infer_and_not_streams(runtime, monkeypatch):
    stub, manager = runtime
    monkeypatch.setenv("AIOS_TPU_JSON_MODE", "force")
    m = manager.get("tiny")
    seen = []
    orig = m.submit
    monkeypatch.setattr(m, "submit", lambda req, **kw: seen.append(req) or orig(req, **kw))
    r = stub.Infer(runtime_pb2.InferRequest(prompt="status?", max_tokens=48))
    assert isinstance(json.loads(r.text), dict)
    chunks = list(stub.StreamInfer(runtime_pb2.InferRequest(prompt="status?", max_tokens=8)))
    assert chunks[-1].done
    assert [(q.json_mode, q.json_schema) for q in seen] == [(True, None), (False, None)]


def test_forced_json_mode_env_values(monkeypatch):
    from aios_tpu_torch.runtime.model_manager import json_mode_forced

    for value, want in (("force", True), ("1", True), ("on", True), ("", False),
                        ("off", False)):
        monkeypatch.setenv("AIOS_TPU_JSON_MODE", value)
        assert json_mode_forced() is want
    assert os.environ["AIOS_TPU_JSON_MODE"] == "off"
