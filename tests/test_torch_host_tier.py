"""The port's prefix-cache host tier against the JAX package: the
``HostPageStore`` under one seeded sequence of puts, probes, peeks, exports
and discards, the KVX1 wire format byte for byte (a bf16 page, an int8 page
with f32 scales) and its damaged framings, and the engines' spill and
restore: cold -> forced spill -> resubmit on ``TINY_TEST`` (page 32, a pool
of 8 pages, f32 and int8 pools), with the restore floor, the router's
discounted overlap rows, both fault points, ``export_prefix`` and
``prefix_digest`` beside the JAX engine's; then what only the port has to
show: an export restored on a second engine, the spill backlog's cap, the
tier left out when no budget is set, the metric families summed over
replicas, and the manager's knobs.

Tolerances: hashes, pages, counters, bytes, crcs and greedy streams exactly;
exported K/V within 1e-5 of JAX's (int8 codes within one step, the scales
within 1e-5 relative); a restored admission's logits bit for bit against the
pool hit it replaces."""

import logging
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from aios_tpu import faults as jfaults
from aios_tpu.engine import model as jm
from aios_tpu.engine import paged as jpaged
from aios_tpu.engine.config import TINY_TEST as JAX_TINY
from aios_tpu.engine.engine import TPUEngine
from aios_tpu_torch import faults as tfaults
from aios_tpu_torch.engine import engine as tengine_mod
from aios_tpu_torch.engine import paged as tpaged
from aios_tpu_torch.engine.config import TINY_TEST
from aios_tpu_torch.engine.engine import TorchEngine
from aios_tpu_torch.engine.weights import params_from_jax
from aios_tpu_torch.obs import instruments as obs
from aios_tpu_torch.runtime.model_manager import ModelManager

# The shapes here are tiny: one intra-op thread is faster and leaves the
# cores to the other test workers.
torch.set_num_threads(1)

PAGE = 32
HOST_BYTES = 64 << 20


@pytest.fixture(autouse=True)
def _no_faults():
    yield
    jfaults.deactivate()
    tfaults.deactivate()


# -- the store --------------------------------------------------------------------


def _bf16_pair(rng, shape):
    """The same bf16 page for both packages: ml_dtypes bfloat16 (JAX) and its
    uint16 bits (the port)."""
    bits = rng.integers(0, 1 << 16, shape, dtype=np.uint16)
    bits &= 0xBFFF  # no inf or nan patterns, so the values compare sanely
    return bits.view(ml_dtypes.bfloat16), bits.copy()


def _entry_pair(rng, kind: str):
    """A host-tier entry [L=2, P=4, KH=2, D=8] for each package."""
    shape = (2, 4, 2, 8)
    if kind == "bf16":
        (jk, tk), (jv, tv) = _bf16_pair(rng, shape), _bf16_pair(rng, shape)
        return {"k": jk, "v": jv}, {"k": tk, "v": tv}
    if kind == "int8":
        e = {"k": rng.integers(-127, 128, shape, dtype=np.int8),
             "v": rng.integers(-127, 128, shape, dtype=np.int8),
             "k_s": rng.random(shape[:3], dtype=np.float32),
             "v_s": rng.random(shape[:3], dtype=np.float32)}
    else:
        e = {"k": rng.standard_normal(shape, dtype=np.float32),
             "v": rng.standard_normal(shape, dtype=np.float32)}
    return e, {k: a.copy() for k, a in e.items()}


def _store_ops(seed: int, n: int = 80):
    rng = np.random.default_rng(seed)
    keys = [bytes([i]) * 32 for i in range(12)]
    out = []
    for _ in range(n):
        r = rng.random()
        if r < 0.45:
            out.append(("put", keys[int(rng.integers(0, 12))]))
        else:
            start = int(rng.integers(0, 10))
            chain = keys[start:start + int(rng.integers(1, 6))]
            op = ("match", "peek", "export", "discard", "restored")[int(rng.integers(0, 5))]
            out.append((op, chain))
    return out


def _drive_store(mod, pairs, ops, side: int, budget: int):
    """Run ``ops`` on ``mod``'s store (entries drawn in turn from ``pairs``,
    JAX's when side is 0, the port's when 1); returns what each op gave and
    the state after it."""
    store = mod.HostPageStore(budget)
    trace, k = [], 0
    for op, arg in ops:
        if op == "put":
            store.put(arg, pairs[k % len(pairs)][side])
            k += 1
            got = None
        elif op == "match":
            got = [h for h, _ in store.match_chain(arg)]
        elif op == "peek":
            got = store.peek_chain(arg)
        elif op == "export":
            got = [(h, crc) for h, crc, _ in store.export_chain(arg, budget_bytes=3 * 1024)]
        else:
            store.discard(arg, restored=op == "restored")
            got = None
        trace.append((op, got, list(store._entries), store.bytes_resident, store.spills,
                      store.restores, store.hits, store.misses, store.corruptions,
                      store.stored_hashes(4)))
    crcs = {h: store._crcs[h] for h in store._entries}
    return trace, crcs


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_store_sequence_matches_jax(kind, seed):
    rng = np.random.default_rng(100 + seed)
    pairs = [_entry_pair(rng, kind) for _ in range(5)]
    ops = _store_ops(seed)
    budget = 5 * tpaged.HostPageStore._entry_bytes(pairs[0][1])  # LRU evictions happen
    want, want_crcs = _drive_store(jpaged, pairs, ops, 0, budget)
    got, got_crcs = _drive_store(tpaged, pairs, ops, 1, budget)
    assert got == want and got_crcs == want_crcs
    assert any(t[1] for t in got if t[0] == "match")  # some probe hit
    for jp, tp in pairs:
        assert (tpaged.HostPageStore._entry_crc(tp) == jpaged.HostPageStore._entry_crc(jp))


@pytest.mark.parametrize("threads", [1, 4])
def test_threaded_checksums_truncate_where_a_serial_pass_does(monkeypatch, threads):
    """A chain whose third page rotted: the checksums on the host-copy
    threads keep the first two, drop the third, count it and stop, as the
    JAX store's serial pass does."""
    monkeypatch.setattr(tpaged, "HOST_COPY_MIN_BYTES", 0)
    monkeypatch.setattr(tpaged, "HOST_COPY_THREADS", threads)
    rng = np.random.default_rng(12)
    pairs = [_entry_pair(rng, "f32") for _ in range(5)]
    keys = [bytes([i]) * 32 for i in range(5)]
    out = []
    for mod, side in ((jpaged, 0), (tpaged, 1)):
        store = mod.HostPageStore(1 << 20)
        for h, pair in zip(keys, pairs):
            store.put(h, {k: a.copy() for k, a in pair[side].items()})
        store._entries[keys[2]]["v"][0, 0, 0, 0] += 1.0  # rot after the crc was taken
        got = [h for h, _ in store.match_chain(keys)]
        out.append((got, list(store._entries), store.corruptions, store.hits,
                    [(h, c) for h, c, _ in store.export_chain(keys)]))
    assert out[0] == out[1] and out[1][0] == keys[:2] and out[1][2] == 1
    assert tpaged.host_map(lambda x: x * x, range(10), 1 << 30) == [x * x for x in range(10)]


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_corrupt_fault_truncates_the_chain_as_jax(kind):
    """``host_store.corrupt`` on the first probe that matches: both stores
    drop the flipped entry, count it, and hand out nothing."""
    rng = np.random.default_rng(5)
    pairs = [_entry_pair(rng, kind) for _ in range(3)]
    keys = [bytes([i]) * 32 for i in range(3)]
    out = []
    for mod, fmod, side in ((jpaged, jfaults, 0), (tpaged, tfaults, 1)):
        store = mod.HostPageStore(1 << 20)
        for h, pair in zip(keys, pairs):
            store.put(h, {k: a.copy() for k, a in pair[side].items()})
        fmod.activate("host_store.corrupt=nth:1")
        got = store.match_chain(keys)
        fmod.deactivate()
        out.append((got, list(store._entries), store.corruptions, store.hits, store.misses,
                    store.bytes_resident, [h for h, _ in store.match_chain(keys[1:])]))
    assert out[0] == out[1] and out[1][0] == [] and out[1][2] == 1


def test_failed_spill_hook_is_a_plain_eviction():
    alloc = tpaged.PageAllocator(6, PAGE, 1, 4)
    index = tpaged.RadixPrefixIndex(alloc, max_pages=8)

    def spill(evicted):
        raise RuntimeError("no staging")

    index.spill = spill
    hashes = tpaged.chain_hashes(list(range(3 * PAGE + 1)), PAGE, 3)
    alloc.ensure(0, 3 * PAGE)
    index.put(hashes, [int(p) for p in alloc.tables[0, :3]])
    alloc.free_slot(0)
    assert index.reclaim(3) == 3 and alloc.pages_in_use() == 0


@pytest.mark.parametrize("index_name", ["PrefixIndex", "RadixPrefixIndex"])
def test_digest_matches_jax(index_name):
    out = []
    for mod in (jpaged, tpaged):
        alloc = mod.PageAllocator(24, 4, 3, 8)
        index = getattr(mod, index_name)(alloc, max_pages=20)
        for s, ids in enumerate(([1] * 17, [1] * 9 + [2] * 8, [3] * 13)):
            hashes = mod.chain_hashes(ids, 4, (len(ids) - 1) // 4)
            alloc.ensure(s, len(ids))
            index.put(hashes, [int(alloc.tables[s, b]) for b in range(len(hashes))])
        out.append([index.digest(n) for n in (0, 3, 100)])
    assert out[0] == out[1] and out[1][2]


# -- the wire format ------------------------------------------------------------------


def test_bf16_page_bytes_equal_jax():
    rng = np.random.default_rng(9)
    jpage, tpage = _entry_pair(rng, "bf16")
    want = jpaged.pack_entry(jpage)
    got = tpaged.pack_entry(tpage)
    assert want.startswith(b"KVX1\x02\x01k\x03<V2") and got == want
    back = tpaged.unpack_entry(want)
    assert {k: (a.dtype, a.shape) for k, a in back.items()} == {
        k: (np.dtype(np.uint16), a.shape) for k, a in tpage.items()}
    assert all(back[k].tobytes() == tpage[k].tobytes() for k in tpage)
    jback = jpaged.unpack_entry(got)  # JAX reads the port's bytes as its own
    assert all(jback[k].tobytes() == jpage[k].tobytes() for k in jpage)
    assert tpaged.HostPageStore._entry_crc(back) == jpaged.HostPageStore._entry_crc(jpage)


def test_int8_page_with_scales_bytes_equal_jax():
    rng = np.random.default_rng(10)
    jpage, tpage = _entry_pair(rng, "int8")
    want = jpaged.pack_entry(jpage)
    assert tpaged.pack_entry(tpage) == want
    back = tpaged.unpack_entry(want)
    jback = jpaged.unpack_entry(tpaged.pack_entry(tpage))
    for k in ("k", "v", "k_s", "v_s"):
        assert back[k].dtype == tpage[k].dtype and back[k].tobytes() == tpage[k].tobytes()
        assert jback[k].tobytes() == jpage[k].tobytes()
    back["k"][0, 0, 0, 0] ^= 1  # writable copies
    assert tpaged.pack_entry(tpage) == want  # insertion order does not matter
    assert tpaged.pack_entry(dict(reversed(list(tpage.items())))) == want


@pytest.mark.parametrize("damage", ["magic", "truncated", "trailing"])
def test_unpack_rejects_damaged_framing(damage):
    payload = tpaged.pack_entry(_entry_pair(np.random.default_rng(3), "f32")[1])
    bad = {"magic": b"XXXX" + payload[4:], "truncated": payload[:-7],
           "trailing": payload + b"\x00"}[damage]
    with pytest.raises(ValueError):
        tpaged.unpack_entry(bad)
    with pytest.raises(ValueError):
        jpaged.unpack_entry(bad)  # the reference refuses the same bytes


# -- the engines ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_params():
    return jm.init_params(JAX_TINY, jax.random.PRNGKey(1), dtype=jnp.float32)


@pytest.fixture(scope="module")
def torch_params(jax_params):
    return params_from_jax(jax.tree.map(np.asarray, jax_params))


def _port(torch_params, host_bytes=HOST_BYTES, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_context", 256)
    kw.setdefault("paged_pool_rows", 256)
    kw.setdefault("page_size", PAGE)
    kw.setdefault("cache_dtype", torch.float32)
    return TorchEngine(TINY_TEST, torch_params, device="cpu", prefix_host_bytes=host_bytes, **kw)


def _jax(jax_params, host_bytes=HOST_BYTES, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_context", 256)
    kw.setdefault("paged_pool_rows", 256)
    kw.setdefault("page_size", PAGE)
    kw.setdefault("cache_dtype", jnp.float32)
    return TPUEngine(JAX_TINY, jax_params, prefix_host_bytes=host_bytes, **kw)


def _drain(eng, backlog):
    deadline = time.time() + 20
    while backlog() and time.time() < deadline:
        time.sleep(0.01)
    assert not backlog(), "spill backlog never drained"


def _force_spill(eng, seed: int, backlog):
    """A 200-token prompt of its own needs 7 of the 8 pages: the allocator's
    reclaim evicts (and spills) the coldest index entries."""
    rng = np.random.default_rng(seed)
    eng.prefill(0, [int(t) for t in rng.integers(1, 500, 6 * PAGE + 8)], temperature=0.0)
    eng.release(0)
    _drain(eng, backlog)


HOST_KEYS = ("prefix_rows_reused", "prefix_rows_restored", "host_tier_bytes",
             "host_tier_spills", "host_tier_restores", "host_tier_hits", "host_tier_misses",
             "host_tier_corrupt")


def _scenario(eng, fmod, backlog):
    """One script for either engine: cold, the pool's overlap rows, a forced
    spill, the discounted overlap rows, a restored resubmit, the floor (8
    pages) keeping the tier out, both fault points (each after a fresh
    spill) ending in a recompute, then export and digest."""
    rng = np.random.default_rng(7)
    prompt = [int(t) for t in rng.integers(1, 500, 100)]  # 3 full blocks
    gen = lambda: eng.generate(prompt, max_new_tokens=16, temperature=0.0)  # noqa: E731
    stat = lambda: {k: eng.stats()[k] for k in HOST_KEYS}  # noqa: E731
    r = {"cold": gen(), "rows_pool": eng.prefix_overlap_rows(prompt)}
    _force_spill(eng, 1, backlog)
    r.update(spilled=stat(), rows_host=eng.prefix_overlap_rows(prompt),
             digest_spilled=eng.prefix_digest())
    r["restored"] = gen()
    r["after_restore"] = stat()
    _force_spill(eng, 2, backlog)
    eng.host_restore_min_pages = 8
    r.update(rows_floor=eng.prefix_overlap_rows(prompt), floor=gen(), after_floor=stat())
    eng.host_restore_min_pages = 1
    _force_spill(eng, 3, backlog)
    fmod.activate("host_store.corrupt=nth:1")
    r["corrupt"] = gen()
    fmod.deactivate()
    r["after_corrupt"] = stat()
    _force_spill(eng, 4, backlog)
    fmod.activate("host_store.restore_fail=nth:1")
    r["restore_fail"] = gen()
    fmod.deactivate()
    r["after_fail"] = stat()
    r["export"] = eng.export_prefix(prompt)
    r["digest"] = eng.prefix_digest()
    r["digest_3"] = eng.prefix_digest(3)
    return r


@pytest.fixture(scope="module")
def jax_runs(jax_params):
    out = {}
    for name, cd in (("f32", jnp.float32), ("int8", jnp.int8)):
        eng = _jax(jax_params, cache_dtype=cd)
        try:
            out[name] = _scenario(eng, jfaults, lambda e=eng: e._spill_pending)
        finally:
            jfaults.deactivate()
            eng.close()
    return out


@pytest.mark.parametrize("quant", ["f32", "int8"])
def test_spill_restore_matches_the_jax_engine(jax_runs, torch_params, quant):
    want = jax_runs[quant]
    eng = _port(torch_params, cache_dtype=torch.int8 if quant == "int8" else torch.float32)
    free_around = []
    restore = eng._restore_from_host

    def counted(*a, **kw):
        # pages the pool can hand out: free ones and those only the index
        # holds (the restore's allocation may reclaim some of the latter)
        def obtainable():
            return eng.allocator.free_pages + eng.prefix_index.reclaimable()

        before = obtainable()
        got = restore(*a, **kw)
        free_around.append((before, obtainable(), len(got)))
        return got

    eng._restore_from_host = counted
    got = _scenario(eng, tfaults, eng.spill_backlog)
    eng.close()
    # streams: cold, restored, below the floor and both recomputes are one
    assert got["cold"] == want["cold"]
    for k in ("restored", "floor", "corrupt", "restore_fail"):
        assert got[k] == want[k] == want["cold"], k
    for k in ("spilled", "after_restore", "after_floor", "after_corrupt", "after_fail"):
        assert got[k] == want[k], k
    assert got["after_restore"]["prefix_rows_restored"] == 2 * PAGE
    assert got["after_floor"]["prefix_rows_restored"] == 2 * PAGE  # the floor kept it out
    assert got["after_corrupt"]["host_tier_corrupt"] == 1
    # the rows: the pool's, then one block in the pool and two at a discount
    assert got["rows_pool"] == want["rows_pool"] == 3 * PAGE
    assert got["rows_host"] == want["rows_host"] == PAGE + int(2 * PAGE * 0.5)
    assert got["rows_floor"] == want["rows_floor"] == PAGE
    assert got["digest_spilled"] == want["digest_spilled"]
    assert got["digest"] == want["digest"] and got["digest_3"] == want["digest_3"]
    # the injected restore failure gave its pages back
    fail = [f for f in free_around if f[2] == 0]
    assert fail and fail[-1][0] == fail[-1][1]
    assert [h for h, _ in got["export"]] == [h for h, _ in want["export"]]
    assert len(got["export"]) == 3
    for (_, g), (_, w) in zip(got["export"], want["export"]):
        assert sorted(g) == sorted(w)
        for k in g:
            if g[k].dtype == np.int8:
                assert np.abs(g[k].astype(np.int32) - w[k].astype(np.int32)).max() <= 1
            else:
                np.testing.assert_allclose(g[k], np.asarray(w[k]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("threaded", [False, True], ids=["serial", "threaded"])
def test_export_restores_on_a_second_engine(torch_params, monkeypatch, threaded):
    """KVX1 across engines: a chain exported from one engine, packed,
    unpacked and put into a second engine's store, is restored there, and
    that admission's first-token logits equal the first engine's pool hit's
    bit for bit (the same page bytes, the same tail chunk); the same with
    the checksums, the spill's and export's page copies and the restore's
    staging on the host-copy threads."""
    if threaded:
        monkeypatch.setattr(tpaged, "HOST_COPY_MIN_BYTES", 0)
        monkeypatch.setattr(tpaged, "HOST_COPY_THREADS", 4)
    prompt = [int(t) for t in np.random.default_rng(21).integers(1, 500, 150)]
    a = _port(torch_params, num_slots=4, paged_pool_rows=1024)
    b = _port(torch_params, num_slots=4, paged_pool_rows=1024)

    def admit(eng):
        pc = eng.start_chunked_prefill(0, prompt, temperature=0.0, chunk=256)
        while pc.step() is None:
            pass
        eng.release(0)
        return pc.pos - len(prompt) + len(prompt), pc.first_logits

    admit(a)  # cold: registers 4 blocks
    _, hit = admit(a)
    assert a.prefix_rows_reused == 4 * PAGE
    for h, e in a.export_prefix(prompt):
        b.host_store.put(h, tpaged.unpack_entry(tpaged.pack_entry(e)))
    assert b.prefix_overlap_rows(prompt) == 2 * PAGE  # 4 host blocks at the discount
    _, restored = admit(b)
    assert b.prefix_rows_restored == 4 * PAGE and b.prefix_rows_reused == 0
    assert torch.equal(restored, hit)
    assert len(b.host_store) == 0 and b.prefix_overlap_rows(prompt) == 4 * PAGE
    a.close()
    b.close()


def test_spill_backlog_cap_drops_to_a_plain_eviction(torch_params, caplog):
    eng = _port(torch_params)
    eng.spill_cap_bytes = 1  # no page fits
    eng.generate(list(range(1, 101)), max_new_tokens=4, temperature=0.0)
    with caplog.at_level(logging.WARNING, logger="aios.torch.engine"):
        _force_spill(eng, 1, eng.spill_backlog)
    assert eng.spill_drops == 2 and len(eng.host_store) == 0
    assert "spill backlog" in caplog.text
    assert eng.allocator.pages_in_use() == len(eng.prefix_index.snapshot())
    eng.close()


def test_no_budget_no_tier(torch_params):
    """Unset, the served path is the one before the tier: no store, no
    worker thread, no hook, no stats keys; an eviction just frees."""
    for kw in ({"host_bytes": 0}, {"host_bytes": None}, {"paged_pool_rows": None}):
        eng = _port(torch_params, **kw)
        assert eng.host_store is None and eng._spill_thread is None
        assert eng.host_staging_bytes() == 0
        assert eng.prefix_index is None or eng.prefix_index.spill is None
        assert not any(k.startswith("host_tier") for k in eng.stats())
        eng.close()
    cfg = TINY_TEST.scaled(prefix_host_bytes=1 << 20)  # the config's budget
    eng = TorchEngine(cfg, torch_params, device="cpu", num_slots=2, max_context=256,
                      paged_pool_rows=256, page_size=PAGE, cache_dtype=torch.float32)
    assert eng.host_store.max_bytes == 1 << 20 and eng._spill_thread.is_alive()
    thread = eng._spill_thread
    eng.close()
    assert not thread.is_alive() and len(eng.host_store) == 0


def test_host_families_sum_over_replicas(torch_params):
    cfg = TINY_TEST.scaled(name="host-tier-sum")
    engines = [TorchEngine(cfg, torch_params, device="cpu", num_slots=2, max_context=256,
                           paged_pool_rows=256, page_size=PAGE, cache_dtype=torch.float32,
                           prefix_host_bytes=HOST_BYTES) for _ in range(2)]
    for i, eng in enumerate(engines):
        eng.generate(list(range(1, 101)), max_new_tokens=4, temperature=0.0)
        _force_spill(eng, i, eng.spill_backlog)
    spills = sum(e.host_store.spills for e in engines)
    assert spills == 4
    assert obs.PREFIX_HOST_SPILLS.labels(model=cfg.name).value == spills
    assert obs.PREFIX_HOST_BYTES.labels(model=cfg.name).value == sum(
        e.host_store.bytes_resident for e in engines)
    for eng in engines:
        eng.close()


def test_manager_parses_the_tier_knobs(monkeypatch, caplog):
    monkeypatch.setenv("AIOS_TPU_PREFIX_HOST_BYTES", "1e6")
    monkeypatch.setenv("AIOS_TPU_HOST_RESTORE_MIN_PAGES", "3")
    m = ModelManager(num_slots=2, device="cpu")
    assert (m.prefix_host_bytes, m.host_restore_min_pages) == (1000000, 3)
    for var, bad in (("AIOS_TPU_PREFIX_HOST_BYTES", "-5"), ("AIOS_TPU_PREFIX_HOST_BYTES", "x"),
                     ("AIOS_TPU_HOST_RESTORE_MIN_PAGES", "0")):
        monkeypatch.setenv(var, bad)
        with caplog.at_level(logging.WARNING, logger="aios.torch.runtime.models"):
            caplog.clear()
            m = ModelManager(num_slots=2, device="cpu")
        assert var in caplog.text and "ignored" in caplog.text
        assert getattr(m, "prefix_host_bytes" if "BYTES" in var else "host_restore_min_pages") \
            is None
        monkeypatch.delenv(var)


def test_every_replica_gets_its_own_store(monkeypatch):
    """The variable reaches each replica's engine (it wins over the config),
    each with a store of its own, as each has its own pool."""
    monkeypatch.setenv("AIOS_TPU_PREFIX_HOST_BYTES", str(8 << 20))
    monkeypatch.setenv("AIOS_TPU_HOST_RESTORE_MIN_PAGES", "2")
    monkeypatch.setenv("AIOS_TPU_REPLICAS", "2")
    m = ModelManager(num_slots=2, device="cpu")
    try:
        mm = m.load_model("tiny", "synthetic://tiny-test", context_length=1024)
        engines = [r.engine for r in mm.pool.replicas]
        assert len(engines) == 2
        stores = [e.host_store for e in engines]
        assert all(s is not None and s.max_bytes == 8 << 20 for s in stores)
        assert stores[0] is not stores[1]
        assert all(e.host_restore_min_pages == 2 for e in engines)
        stats = mm.pool.stats()
        assert stats["host_tier_capacity_bytes"] == 2 * (8 << 20)
    finally:
        m.close()
    monkeypatch.setenv("AIOS_TPU_PREFIX_HOST_BYTES", "0")  # 0 forces it off
    monkeypatch.setenv("AIOS_TPU_REPLICAS", "1")
    m = ModelManager(num_slots=2, device="cpu")
    try:
        assert m.load_model("tiny", "synthetic://tiny-test", context_length=1024
                            ).engine.host_store is None
    finally:
        m.close()


def test_batcher_records_restored_rows(torch_params):
    """The prefill record carries ``restored_rows`` beside ``cached_rows``."""
    from aios_tpu_torch.engine.batching import ContinuousBatcher, Request
    from aios_tpu_torch.obs import flightrec

    eng = _port(torch_params)
    prompt = [int(t) for t in np.random.default_rng(7).integers(1, 500, 100)]
    eng.generate(prompt, max_new_tokens=4, temperature=0.0)
    _force_spill(eng, 1, eng.spill_backlog)
    was = flightrec.RECORDER.enabled
    flightrec.RECORDER.enabled = True
    b = ContinuousBatcher(eng, prefill_chunk=0)
    try:
        h = b.submit(Request(prompt_ids=prompt, max_tokens=4, temperature=0.0))
        h.tokens()
    finally:
        b.shutdown()
        flightrec.RECORDER.enabled = was
    assert b.last_error is None and eng.prefix_rows_restored == 2 * PAGE
    tl = flightrec.RECORDER.recent(TINY_TEST.name, limit=1)[-1]
    prefill = [f for _, kind, f in tl.events if kind == "prefill"]
    assert prefill and prefill[0]["restored_rows"] == 2 * PAGE
    assert prefill[0]["cached_rows"] == PAGE
    assert any(kind == "restore" for _, _, kind, _ in
               flightrec.RECORDER.model_events(TINY_TEST.name))
    eng.close()


def test_engine_module_imports_no_ml_dtypes():
    assert "ml_dtypes" not in tengine_mod.__dict__ and "ml_dtypes" not in tpaged.__dict__
