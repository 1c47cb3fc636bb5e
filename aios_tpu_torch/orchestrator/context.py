"""Prompt context assembly with token budgeting.

Reference parity (agent-core/src/context.rs:46-122): merges a system prompt
with relevance-scored chunks under a token budget using the 4-chars-per-token
estimate (context.rs:64-66,119-122). The memory service's AssembleContext is
the cross-process variant; this one builds prompts inside the orchestrator.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

CHARS_PER_TOKEN = 4


def estimate_tokens(text: str) -> int:
    return max(1, len(text) // CHARS_PER_TOKEN)


@dataclass
class ContextChunk:
    source: str
    content: str
    relevance: float = 0.5


@dataclass
class ContextAssembler:
    system_prompt: str = ""
    max_tokens: int = 2048
    chunks: List[ContextChunk] = field(default_factory=list)

    def add(self, source: str, content: str, relevance: float = 0.5) -> None:
        self.chunks.append(ContextChunk(source, content, relevance))

    def assemble(self, task_description: str = "") -> str:
        """Highest-relevance chunks first until the budget is spent."""
        budget = self.max_tokens
        parts: List[str] = []
        if self.system_prompt:
            parts.append(self.system_prompt)
            budget -= estimate_tokens(self.system_prompt)
        if task_description:
            line = f"Task: {task_description}"
            parts.append(line)
            budget -= estimate_tokens(line)
        for chunk in sorted(self.chunks, key=lambda c: -c.relevance):
            cost = estimate_tokens(chunk.content) + 2
            if cost > budget:
                continue
            parts.append(f"[{chunk.source}] {chunk.content}")
            budget -= cost
        return "\n\n".join(parts)

    def total_tokens(self) -> int:
        return estimate_tokens(self.assemble())
