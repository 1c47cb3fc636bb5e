"""The port's single-card trainer on the CPU against the JAX package's:
optax's schedule, the loss, ``forward_full(with_aux=True)``, three train
steps dense and mixture-of-experts (clipping exercised), remat on and off,
``train_loop``'s crash resume, and the refusal of a mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aios_tpu.engine import model as jm
from aios_tpu.engine import train as jt
from aios_tpu.engine.config import TINY_MOE as JAX_MOE
from aios_tpu.engine.config import TINY_TEST as JAX_TINY
from aios_tpu_torch.engine import model as tm
from aios_tpu_torch.engine import moe as tmoe
from aios_tpu_torch.engine import train as tt
from aios_tpu_torch.engine.config import TINY_MOE, TINY_TEST
from aios_tpu_torch.engine.weights import init_params, params_from_jax

# The shapes here are tiny: one intra-op thread is faster and leaves the
# cores to the other test workers.
torch.set_num_threads(1)

CONFIGS = {"dense": (JAX_TINY, TINY_TEST), "moe": (JAX_MOE, TINY_MOE)}


def _pair(kind, seed=0):
    """The same f32 params in both packages: (jax tree, port tree)."""
    jcfg, _ = CONFIGS[kind]
    jp = jm.init_params(jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _batch(cfg, B=2, T=16, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.float32)
    mask[-1, T // 2:] = 0.0
    return tokens, mask


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield prefix + k, (v.detach().numpy() if isinstance(v, torch.Tensor)
                               else np.asarray(v))


@pytest.mark.parametrize("warmup,total", [(1, 6), (3, 10), (10, 10), (4, 2), (0, 5)])
def test_schedule_equals_optax(warmup, total):
    sched = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=3e-4, warmup_steps=warmup,
        decay_steps=max(total, warmup + 1))
    opt = tt.make_optimizer(warmup_steps=warmup, total_steps=total)
    for count in range(total + 4):
        np.testing.assert_allclose(opt.schedule(count), float(sched(count)), rtol=1e-6,
                                   atol=1e-12, err_msg=str(count))
    assert opt.schedule(0) == 0.0 or warmup == 0


def test_token_cross_entropy_equals_jax():
    tokens, mask = _batch(TINY_TEST)
    logits = np.random.default_rng(1).standard_normal((2, 16, 512)).astype(np.float32)
    jn, jd = jt.token_cross_entropy(jnp.asarray(logits), jnp.asarray(tokens), jnp.asarray(mask))
    tn, td = tt.token_cross_entropy(torch.from_numpy(logits), torch.from_numpy(tokens),
                                    torch.from_numpy(mask))
    np.testing.assert_allclose(tn.item(), float(jn), rtol=1e-6)
    assert td.item() == float(jd) == 23.0


@pytest.mark.parametrize("kind,T", [("dense", 16), ("moe", 16), ("moe", 512)])
def test_forward_full_with_aux_equals_jax(kind, T):
    """(logits, aux) of the training forward; at 2 x 512 tokens the MoE
    sublayers take the capacity dispatch, as JAX's do."""
    jcfg, tcfg = CONFIGS[kind]
    jp, tp = _pair(kind)
    tokens, _ = _batch(tcfg, T=T)
    jl, ja = jm.forward_full(jp, jcfg, jnp.asarray(tokens), None, False, True)
    with torch.no_grad():
        tl, ta = tm.forward_full(tp, tcfg, torch.from_numpy(tokens), kernels=False,
                                 with_aux=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ta.item(), float(ja), rtol=1e-5)
    assert (ta.item() == 0.0) == (kind == "dense")
    assert tmoe.resolve_impl(None, 2 * T, allow_dispatch=True) == (
        "dispatch" if 2 * T >= 1024 else "dense")


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_three_train_steps_equal_jax(kind):
    """Losses and grad norms within 1e-5 relative at each step, the clip
    active (limit 0.5 under norms of ~3), the first step's rate 0, and each
    leaf within 1e-5 of JAX's in relative Frobenius norm after 3 steps
    (elementwise, Adam's normalized update turns f32 summation-order noise
    in near-zero gradients into visible differences of single entries)."""
    jcfg, tcfg = CONFIGS[kind]
    jp, tp = _pair(kind)
    tokens, mask = _batch(tcfg)
    kw = dict(warmup_steps=1, total_steps=4, grad_clip=0.5)
    ji, js = jt.make_train_step(jcfg, optimizer=jt.make_optimizer(**kw))
    ti, ts = tt.make_train_step(tcfg, optimizer=tt.make_optimizer(**kw))
    jstate, tstate = ji(jp), ti(tp)
    jstep = jax.jit(js)
    losses = []
    for _ in range(3):
        jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(tokens), "loss_mask": jnp.asarray(mask)})
        tstate, tmet = ts(tstate, {"tokens": torch.from_numpy(tokens),
                                   "loss_mask": torch.from_numpy(mask)})
        for key in ("loss", "grad_norm", "moe_aux"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), rtol=1e-5,
                                       err_msg=key)
        assert float(tmet["grad_norm"]) > 0.5
        losses.append(float(tmet["loss"]))
    assert losses[0] == losses[1] > losses[2]  # step 1 ran at rate 0
    assert tstate["step"] == int(jstate["step"]) == 3 and tstate["opt_state"]["count"] == 3
    want = dict(_flat(jax.tree.map(np.asarray, jstate["params"])))
    got = dict(_flat(tstate["params"]))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert np.linalg.norm(got[k] - v) <= 1e-5 * np.linalg.norm(v), k


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_remat_gives_the_same_logits_and_gradients(kind):
    _, tcfg = CONFIGS[kind]
    _, tp = _pair(kind)
    tokens, mask = _batch(tcfg)
    out = []
    for remat in (False, True):
        params = {k: ({kk: vv.clone().requires_grad_() for kk, vv in v.items()}
                      if isinstance(v, dict) else v.clone().requires_grad_())
                  for k, v in tp.items()}
        logits, aux = tm.forward_full(params, tcfg, torch.from_numpy(tokens), kernels=False,
                                      with_aux=True, remat=remat)
        nll, denom = tt.token_cross_entropy(logits, torch.from_numpy(tokens),
                                            torch.from_numpy(mask))
        loss = nll / denom + 0.01 * aux
        leaves = [p for _, p in sorted(_named(params))]
        out.append((logits.detach(), torch.autograd.grad(loss, leaves)))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def _named(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _batches(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16))),
             "loss_mask": torch.ones(2, 16)} for _ in range(n)]


def test_a_resumed_run_equals_the_straight_run(tmp_path):
    """Four steps straight, and two steps then a crash (the process ends
    after its save) and a fresh ``train_loop`` over the other two batches
    from the checkpoint: the same params, moments and count, bit for bit."""
    opt = tt.make_optimizer(warmup_steps=1, total_steps=10)
    batches = _batches(TINY_TEST, 4)

    def fresh():
        return init_params(TINY_TEST, torch.Generator().manual_seed(2), torch.float32, "cpu")

    straight = tt.train_loop(TINY_TEST, fresh(), batches, optimizer=opt)
    d = str(tmp_path / "train")
    first = tt.train_loop(TINY_TEST, fresh(), batches, optimizer=opt, checkpoint_dir=d,
                          save_every=100, max_steps=2)
    assert first["step"] == 2
    resumed = tt.train_loop(TINY_TEST, fresh(), batches[2:], optimizer=opt, checkpoint_dir=d,
                            save_every=100)
    assert resumed["step"] == straight["step"] == 4
    assert resumed["opt_state"]["count"] == 4
    want, got = dict(_flat(straight)), dict(_flat(resumed))
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_train_loop_resume_like_jax(tmp_path):
    """The JAX package's ``test_train_loop_resume`` on the port's manager:
    3 steps saving every 2 (checkpoints 2 and 3), then a fresh call that
    continues from step 3 to 5, one loss reported per step."""
    opt = tt.make_optimizer(warmup_steps=1, total_steps=10)
    params = init_params(TINY_TEST, torch.Generator().manual_seed(2), torch.float32, "cpu")
    d = tmp_path / "train"
    losses = []
    state = tt.train_loop(TINY_TEST, params, _batches(TINY_TEST, 3), optimizer=opt,
                          checkpoint_dir=str(d), save_every=2,
                          on_metrics=lambda s, m: losses.append(float(m["loss"])))
    assert state["step"] == 3 and len(losses) == 3
    assert sorted(p.name for p in d.iterdir()) == ["2", "3"]
    state2 = tt.train_loop(TINY_TEST, params, _batches(TINY_TEST, 2, seed=1), optimizer=opt,
                           checkpoint_dir=str(d), save_every=10)
    assert state2["step"] == 5


def test_a_mesh_and_unknown_sequence_parallelism_are_refused():
    with pytest.raises(NotImplementedError, match="parallel/"):
        tt.make_train_step(TINY_TEST, mesh=object())
    with pytest.raises(ValueError, match="'ring' or 'ulysses'"):
        tt.make_train_step(TINY_TEST, seq_parallel="tree")
