"""Prepared checkpoints and train-state checkpoints on the port, on the CPU:
the round trips, ``LoadModel`` of a prepared directory (JAX's streams; int8
and int4 leaves served without a quantize pass, as quantizing at load
serves them), the ``prepare_model`` command, the refusal of a JAX (orbax)
checkpoint and of int4 leaves the CUDA kernel cannot serve, a draft given
as a prepared directory, and the ``CheckpointManager``'s retention, resume
and torn saves (the twins of ``tests/test_checkpoint.py``)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aios_tpu.engine import checkpoint as jckpt
from aios_tpu.engine import model as jm
from aios_tpu.engine.config import TINY_TEST as JAX_TINY
from aios_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from aios_tpu_torch import prepare_model
from aios_tpu_torch.engine import checkpoint as ckpt
from aios_tpu_torch.engine import model as tm
from aios_tpu_torch.engine import safetensors as tst
from aios_tpu_torch.engine.config import TINY_TEST
from aios_tpu_torch.engine.engine import TorchEngine
from aios_tpu_torch.engine.tokenizer import (ByteLevelBPE, ByteTokenizer, HFTokenizer,
                                             SentencePieceBPE, tokenizer_from_dict,
                                             tokenizer_to_dict)
from aios_tpu_torch.engine.weights import init_params
from aios_tpu_torch.runtime import model_manager as tmm
from test_torch_hf import assert_loaded_equal, greedy_pair, hf_dir, jax_load

# The shapes here are tiny: one intra-op thread is faster and leaves the
# cores to the other test workers; so does the subprocess.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
# every leaf's K a multiple of 128 and N of 16: int4 under the CPU's rules
# and the CUDA kernel's alike, so quantizing at load and preparing agree
WIDE = TINY_TEST.scaled(name="tiny-wide", hidden_size=128, head_dim=32, intermediate_size=256)


def _params(cfg=TINY_TEST, seed=0, dtype=torch.float32):
    return init_params(cfg, torch.Generator().manual_seed(seed), dtype, "cpu")


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _equal(a, b):
    fa, fb = dict(_flat(a)), dict(_flat(b))
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


# -- serving weights ----------------------------------------------------------------


def test_params_roundtrip(tmp_path):
    params = _params()
    ckpt.save_params(str(tmp_path), params)
    assert ckpt.is_checkpoint_dir(str(tmp_path))
    _equal(ckpt.load_params(str(tmp_path), device="cpu"), params)
    like = {k: v for k, v in params.items()}
    like["embed"] = params["embed"].bfloat16()
    back = ckpt.load_params(str(tmp_path), like=like)
    assert back["embed"].dtype == torch.bfloat16
    assert torch.equal(back["embed"], params["embed"].bfloat16())


def test_model_checkpoint_roundtrip_and_manager_load(tmp_path):
    params = _params(seed=1)
    d = str(tmp_path / "model")
    ckpt.save_model_checkpoint(d, TINY_TEST, params, ByteTokenizer())
    assert ckpt.is_model_checkpoint(d)
    meta = json.loads((tmp_path / "model" / ckpt.MODEL_META_NAME).read_text())
    assert meta["format"] == ckpt.FORMAT and meta["serving_quantized"] is None
    assert meta["prepared_tp"] == 1 and set(meta) == {"format", "config", "tokenizer",
                                                      "serving_quantized", "prepared_tp"}
    cfg2, params2, tok2 = ckpt.load_model_checkpoint(d, "cpu")
    assert cfg2 == TINY_TEST and isinstance(tok2, ByteTokenizer)
    _equal(params2, params)
    manager = tmm.ModelManager(num_slots=2, device="cpu", quantize=False)
    try:
        # served in bf16, the serving dtype of every source
        m = manager.load_model("from-ckpt", d, context_length=64)
        assert m.state == "ready" and m.config.max_context == 64
        assert m.engine.params["embed"].dtype == torch.bfloat16
        bf16 = {k: ({kk: vv.bfloat16() for kk, vv in v.items()} if isinstance(v, dict)
                    else v.bfloat16()) for k, v in params.items()}
        ref = TorchEngine(TINY_TEST, bf16, num_slots=2, max_context=64, device="cpu")
        out = m.batcher.generate([1, 2, 3], max_tokens=4, temperature=0.0)
        assert out == ref.generate([1, 2, 3], max_new_tokens=4, temperature=0.0)
    finally:
        manager.close()


def test_tokenizers_round_trip_through_dicts(tmp_path):
    pieces = ["▁", "h", "e", "l", "o", "lo", "llo", "ello", "hello", "▁hello"]
    sp = SentencePieceBPE(tokens=["<unk>", "<s>", "</s>", *pieces, "<0x41>"],
                          scores=[0.0, 0.0, 0.0, *([-1.0] * len(pieces)), 0.0],
                          token_types=[2, 3, 3, *([1] * len(pieces)), 6])
    bl = ByteLevelBPE(tokens=["a", "b", "ab", "<|x|>"], merges=["a b"], token_types=[1, 1, 1, 3],
                      eos_id=3)
    for tok in (sp, bl, ByteTokenizer()):
        back = tokenizer_from_dict(json.loads(json.dumps(tokenizer_to_dict(tok))))
        assert type(back) is type(tok)
        for text in ("hello", "abba<|x|>"):
            assert back.encode(text) == tok.encode(text)
    assert sp.decode(sp.encode("hello", add_bos=False)) == "hello"


def test_prepared_hf_checkpoint_carries_its_tokenizer_and_gives_the_jax_streams(tmp_path):
    """``prepare_model`` of an HF directory (bf16, in this process): the
    tokenizer's files travel into the checkpoint, which serves after the
    source is gone; its leaves, config and ids equal the JAX manager's
    load of the source, and the greedy streams equal JAX's."""
    src, out = tmp_path / "hf", tmp_path / "prepared"
    hf_dir(src, "llama", "llama")
    jcfg, jparams, jtok = jax_load(src, name="prepared")
    assert prepare_model.main([str(src), str(out), "--device", "cpu"]) == 0
    assert (out / "tokenizer" / "tokenizer.json").is_file()
    for f in src.iterdir():
        f.unlink()
    src.rmdir()
    manager = tmm.ModelManager(num_slots=2, device="cpu")
    try:
        m = manager.load_model("m", str(out), context_length=128)
        assert isinstance(m.tokenizer, HFTokenizer)
        assert_loaded_equal(m, jcfg, jparams, jtok)
        prompts = [jtok.encode("the cat sat on a mat")]
        want, got = greedy_pair(jcfg, jparams, m.config, m.engine.params, prompts)
        assert got == want
    finally:
        manager.close()


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_prepared_quantized_checkpoint_serves_without_requantize(tmp_path, mode):
    """The serving leaves are stored; LoadModel serves them as they are
    (``quantize_seconds`` 0, the same bytes as quantizing at load) and
    decodes the streams of an engine that quantizes the dense leaves."""
    params = _params(WIDE, seed=31, dtype=torch.bfloat16)
    d = str(tmp_path / f"prepared-{mode}")
    ckpt.save_model_checkpoint(d, WIDE, tm.quantize_params(params, mode=mode, target="cuda"),
                               ByteTokenizer())
    assert json.loads(Path(d, ckpt.MODEL_META_NAME).read_text())["serving_quantized"] == mode
    manager = tmm.ModelManager(num_slots=2, device="cpu", quantize=mode)
    try:
        m = manager.load_model("m", d, context_length=64)
        eng = m.engine
        assert eng.quantized and eng.quantize_seconds == 0.0
        assert ("q4" if mode == "int4" else "q") in eng.params["layers"]["w_qkv"]
        ref = TorchEngine(WIDE, params, num_slots=2, max_context=64, quantize=mode, device="cpu",
                          paged_pool_rows=3 * 64, page_size=16)
        assert ref.quantize_seconds > 0
        _equal(eng.params, ref.params)
        prompt = [1, 5, 9, 2]
        got = m.batcher.generate(prompt, max_tokens=8, temperature=0.0)
        assert got == ref.generate(prompt, max_new_tokens=8, temperature=0.0)
    finally:
        manager.close()


def test_int4_leaves_the_kernel_cannot_serve_are_refused_before_writing(tmp_path):
    """Quantized under the CPU's rules, TINY_TEST's K = 64 leaves get int4
    groups of 64, which K5 does not serve: nothing is written. Under the
    kernel's rules (``target="cuda"``) they fall back to int8 and save."""
    params = _params()
    loose = tm.quantize_params(params, mode="int4", target="cpu")
    with pytest.raises(ValueError, match=r"CUDA int4 kernel cannot serve \(w_qkv"):
        ckpt.save_model_checkpoint(str(tmp_path / "a"), TINY_TEST, loose, ByteTokenizer())
    assert not (tmp_path / "a").exists()
    strict = tm.quantize_params(params, mode="int4", target="cuda")
    assert "q" in strict["layers"]["w_qkv"] and "q4" in strict["layers"]["w_down"]
    ckpt.save_model_checkpoint(str(tmp_path / "b"), TINY_TEST, strict, ByteTokenizer())
    with pytest.raises(ValueError, match="parallel/"):
        ckpt.save_model_checkpoint(str(tmp_path / "c"), TINY_TEST, strict, ByteTokenizer(), tp=2)


def test_prepare_model_command(tmp_path):
    """``python -m aios_tpu_torch.prepare_model`` in a subprocess (on the
    CPU, f32, int8): a checkpoint the port loads, padded for the kernels;
    ``--tp 2`` exits with an error naming parallel/."""
    out = tmp_path / "prepared"
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT), "HOME": str(tmp_path),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "aios_tpu_torch.prepare_model", "synthetic://tiny-test",
         str(out), "--dtype", "f32", "--quantize", "int8", "--device", "cpu", "--verify"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "verify: generated 8 tokens" in proc.stderr
    cfg, params, _ = ckpt.load_model_checkpoint(str(out), "cpu")
    assert cfg == TINY_TEST and params["layers"]["w_qkv"]["q"].dtype == torch.int8
    assert params["final_norm"].dtype == torch.float32
    proc = subprocess.run(
        [sys.executable, "-m", "aios_tpu_torch.prepare_model", "synthetic://tiny-test",
         str(tmp_path / "tp"), "--tp", "2"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 2 and "parallel/" in proc.stderr
    assert not (tmp_path / "tp").exists()


def test_a_jax_checkpoint_is_refused_by_name(tmp_path):
    d = tmp_path / "jax-ckpt"
    params = jm.init_params(JAX_TINY, jax.random.PRNGKey(0), dtype=jnp.float32)
    jckpt.save_model_checkpoint(str(d), JAX_TINY, params, JaxByteTokenizer())
    manager = tmm.ModelManager(num_slots=2, device="cpu")
    try:
        with pytest.raises(ValueError, match="aios-tpu-model-v1.*JAX package.*prepare_model"):
            manager.load_model("j", str(d))
        assert manager.get("j").state == "error"
    finally:
        manager.close()


def test_a_draft_given_as_a_prepared_directory_serves_draft_speculation(tmp_path, monkeypatch):
    d = str(tmp_path / "draft")
    ckpt.save_model_checkpoint(d, TINY_TEST, tm.quantize_params(_params(seed=3), mode="int8"),
                               ByteTokenizer())
    for name in ("AIOS_TPU_SPECULATIVE", "AIOS_TPU_REPLICAS"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("AIOS_TPU_DRAFT_MODEL", d)
    manager = tmm.ModelManager(num_slots=2, device="cpu")
    try:
        m = manager.load_model("m", "synthetic://tiny-test", context_length=64)
        assert m.engine.draft is not None and m.engine.draft.quant_mode == "int8"
        assert m.batcher.spec_proposers == ("draft", "ngram")
        out = m.batcher.generate([1, 2, 3, 1, 2, 3], max_tokens=12, temperature=0.0)
        assert len(out) == 12 and m.engine.spec_proposer_rounds["draft"] > 0
    finally:
        manager.close()


# -- train state --------------------------------------------------------------------


def test_checkpoint_manager_retention_and_restore(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), max_to_keep=2)
    tree = {"a": torch.arange(4, dtype=torch.float32), "step": 0}
    for s in (1, 2, 3):
        assert mgr.save(s, {"a": tree["a"] * s, "step": s})
    assert mgr.latest_step() == 3 and mgr.all_steps() == [2, 3]
    assert not mgr.save(3, tree) and not mgr.save(2, tree)  # orbax skips these too
    back = mgr.restore(like=tree)
    assert back["step"] == 3 and isinstance(back["step"], int)
    np.testing.assert_allclose(back["a"].numpy(), np.arange(4) * 3)
    assert torch.equal(mgr.restore(step=2, device="cpu")["a"], tree["a"] * 2)
    mgr.close()


def test_a_torn_save_is_never_the_latest_step(tmp_path, monkeypatch):
    mgr = ckpt.CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": torch.ones(8)})

    def crash(tensors, path, metadata=None):
        Path(path).with_name("partial").write_bytes(b"\0" * 16)
        raise OSError("disk gone mid-save")

    monkeypatch.setattr(tst, "save_file", crash)
    with pytest.raises(OSError):
        mgr.save(2, {"a": torch.zeros(8)})
    assert mgr.latest_step() == 1
    # a process killed mid-save leaves its temporary directory: ignored,
    # then cleared by the next manager
    os.makedirs(tmp_path / ".tmp-3-999")
    (tmp_path / ".tmp-3-999" / ckpt.STATE_NAME).write_bytes(b"torn")
    assert mgr.latest_step() == 1
    monkeypatch.undo()
    mgr2 = ckpt.CheckpointManager(str(tmp_path))
    assert not (tmp_path / ".tmp-3-999").exists() and mgr2.latest_step() == 1
    assert torch.equal(mgr2.restore(device="cpu")["a"], torch.ones(8))


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_a_stored_head_short_of_the_kernels_pad_is_padded_inert(mode):
    """A head quantized under the CPU's rules (40 columns) is padded to a
    multiple of HEAD_PAD as the CUDA engine loads it: zero weight columns,
    the real columns' logits unchanged."""
    g = torch.Generator().manual_seed(5)
    params = {"layers": {}, "embed": torch.randn(40, 256, generator=g),
              "lm_head": torch.randn(256, 40, generator=g)}
    q = tm.quantize_params(params, mode=mode, target="cpu")
    padded = tm.pad_serving_head(q)
    assert next(iter(padded["lm_head"].values())).shape[-1] == 48
    x = torch.randn(3, 256, generator=g)
    a, b = tm.matmul(x, q["lm_head"]), tm.matmul(x, padded["lm_head"])
    assert torch.equal(b[:, :40], a) and not b[:, 40:].any()
    assert tm.pad_serving_head(padded) is padded
