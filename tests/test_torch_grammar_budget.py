"""A constrained request whose max_tokens runs past its cache rows still
closes its structure: the port's batcher bounds the grammar's remaining
budget by the rows the slot has left (``ContinuousBatcher._grammar_budget``),
so the closing walk ends the JSON before ``_emit`` retires the request at the
cache end. The orchestrator's reasoning rounds ask 2048 tokens of a
TinyLlama served at 2048 rows, so without it a long reply is cut
mid-string and does not parse (the JAX batcher bounds it by max_tokens
alone). Streams whose budget fits the cache are unchanged
(``tests/test_torch_constrained.py`` holds them to the JAX batcher's)."""

import json

import pytest
import torch

from aios_tpu_torch.engine.batching import ContinuousBatcher, Request
from aios_tpu_torch.engine.config import TINY_TEST
from aios_tpu_torch.engine.engine import TorchEngine
from aios_tpu_torch.engine.tokenizer import ByteTokenizer
from aios_tpu_torch.engine.weights import init_params

torch.set_num_threads(1)

CONTEXT = 128
THOUGHT = {"type": "object", "properties": {"thought": {"type": "string"},
                                            "done": {"type": "boolean"}},
           "required": ["thought", "done"]}


@pytest.fixture(scope="module")
def params():
    return init_params(TINY_TEST, torch.Generator().manual_seed(0), torch.float32, "cpu")


@pytest.mark.parametrize("layout", ["paged", "dense"])
@pytest.mark.parametrize("temperature,prompt_len", [(0.0, 40), (0.9, 40), (0.9, 100)])
def test_reply_closes_before_the_cache_end(params, layout, temperature, prompt_len):
    kw = dict(paged_pool_rows=4 * CONTEXT, page_size=16, prefix_cache=False) \
        if layout == "paged" else {}
    eng = TorchEngine(TINY_TEST, params, num_slots=2, max_context=CONTEXT,
                      cache_dtype=torch.float32, device="cpu", **kw)
    tok = ByteTokenizer()
    b = ContinuousBatcher(eng, tokenizer=tok)
    try:
        prompt = tok.encode("think aloud " * 20)[:prompt_len]
        handles = [b.submit(Request(prompt_ids=prompt, max_tokens=4 * CONTEXT,
                                    temperature=temperature, stop_ids=(tok.eos_id,),
                                    json_schema=THOUGHT)) for _ in range(3)]
        outs = [h.tokens() for h in handles]
        assert b.last_error is None
    finally:
        b.shutdown()
        eng.close()
    room = CONTEXT - 1 - len(prompt)
    for out in outs:
        # never past the rows the cache holds, and the structure is whole
        assert len(out) <= room + 1
        reply = json.loads(tok.decode([t for t in out if t != tok.eos_id]))
        assert isinstance(reply["thought"], str) and isinstance(reply["done"], bool)
