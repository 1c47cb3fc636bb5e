"""Tokenizers and chat templating (the parts the synthetic-weight path uses).

A copy of ``BaseTokenizer``, ``ByteTokenizer`` and ``render_chat`` from
``aios_tpu/engine/tokenizer.py``. The GGUF/HF BPE tokenizers arrive with real
weight loading.
"""

from __future__ import annotations

from typing import List, Optional, Sequence


class BaseTokenizer:
    bos_id: Optional[int] = None
    eos_id: Optional[int] = None

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        raise NotImplementedError

    def decode(self, ids: Sequence[int]) -> str:
        raise NotImplementedError

    @property
    def vocab_size(self) -> int:
        raise NotImplementedError


class ByteTokenizer(BaseTokenizer):
    """256-symbol byte tokenizer — synthetic models, benches, smoke tests."""

    bos_id = 256
    eos_id = 257

    @property
    def vocab_size(self) -> int:
        return 258

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = list(text.encode("utf-8"))
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8", errors="replace")


def render_chat(family: str, prompt: str, system_prompt: str = "") -> str:
    """Render a single-turn chat for the given model family."""
    fam = family.lower()
    if "tinyllama" in fam or "zephyr" in fam:
        parts = []
        if system_prompt:
            parts.append(f"<|system|>\n{system_prompt}</s>\n")
        parts.append(f"<|user|>\n{prompt}</s>\n<|assistant|>\n")
        return "".join(parts)
    if "mistral" in fam:
        sys = f"{system_prompt}\n\n" if system_prompt else ""
        return f"[INST] {sys}{prompt} [/INST]"
    if "qwen" in fam or "deepseek" in fam or "chatml" in fam:
        parts = []
        if system_prompt:
            parts.append(f"<|im_start|>system\n{system_prompt}<|im_end|>\n")
        parts.append(f"<|im_start|>user\n{prompt}<|im_end|>\n<|im_start|>assistant\n")
        return "".join(parts)
    sys = f"System: {system_prompt}\n\n" if system_prompt else ""
    return f"{sys}User: {prompt}\n\nAssistant:"
