"""Request routing: provider selection, fallback chains, response cache.

Reference parity (api-gateway/src/router.rs):
  * selection: preferred provider first, else claude > openai > qwen3 >
    local by availability AND budget (router.rs:179-204);
  * per-provider fallback chains on error when allow_fallback
    (router.rs:55-93);
  * response cache keyed by prompt hash, TTL 1 h, ~1000-entry LRU
    (router.rs:206-248).
"""

from __future__ import annotations

import collections
import hashlib
import threading
import time
from typing import Dict, List, Optional, Tuple

from .budget import BudgetManager
from .providers import (
    ClaudeClient,
    InferResult,
    LocalRuntimeClient,
    ProviderError,
    openai_client,
    qwen3_client,
)

PRIORITY = ["claude", "openai", "qwen3", "local"]
FALLBACK_CHAINS: Dict[str, List[str]] = {
    "claude": ["openai", "qwen3", "local"],
    "openai": ["claude", "qwen3", "local"],
    "qwen3": ["local"],
    "local": [],
}

CACHE_TTL = 3600.0
CACHE_MAX = 1000


class ResponseCache:
    def __init__(self, ttl: float = CACHE_TTL, max_entries: int = CACHE_MAX):
        self.ttl = ttl
        self.max_entries = max_entries
        self._store: "collections.OrderedDict[str, Tuple[float, InferResult]]" = (
            collections.OrderedDict()
        )
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key(prompt: str, system: str, max_tokens: int, temperature: float) -> str:
        blob = f"{prompt}\x00{system}\x00{max_tokens}\x00{temperature:.3f}"
        return hashlib.sha256(blob.encode()).hexdigest()

    def get(self, key: str) -> Optional[InferResult]:
        with self._lock:
            entry = self._store.get(key)
            if entry is None:
                self.misses += 1
                return None
            ts, result = entry
            if time.monotonic() - ts > self.ttl:
                del self._store[key]
                self.misses += 1
                return None
            self._store.move_to_end(key)
            self.hits += 1
            return result

    def put(self, key: str, result: InferResult) -> None:
        with self._lock:
            self._store[key] = (time.monotonic(), result)
            self._store.move_to_end(key)
            while len(self._store) > self.max_entries:
                self._store.popitem(last=False)


class RequestRouter:
    def __init__(
        self,
        budget: Optional[BudgetManager] = None,
        runtime_address: Optional[str] = None,
    ):
        self.providers = {
            "claude": ClaudeClient(),
            "openai": openai_client(),
            "qwen3": qwen3_client(),
            "local": LocalRuntimeClient(runtime_address),
        }
        self.budget = budget or BudgetManager()
        self.cache = ResponseCache()
        self.last_errors: Dict[str, str] = {}

    def _usable(self, name: str) -> bool:
        provider = self.providers[name]
        return provider.available() and self.budget.can_afford(name)

    def _selection_order(self, preferred: str, allow_fallback: bool) -> List[str]:
        if preferred and preferred in self.providers:
            order = [preferred]
            if allow_fallback:
                order += [p for p in FALLBACK_CHAINS[preferred] if p not in order]
            return order
        # no/unknown preference: global priority by availability & budget
        order = [p for p in PRIORITY if self._usable(p)]
        return order or ["local"]

    def _candidates(self, preferred: str, allow_fallback: bool, errors: List[str]):
        """Yield (name, provider) for each usable candidate in policy order —
        the ONE selection policy shared by route() and route_stream()."""
        for name in self._selection_order(preferred, allow_fallback):
            if not self._usable(name):
                errors.append(f"{name}: unavailable or over budget")
                continue
            yield name, self.providers[name]

    def _record_and_cache(
        self, name, result: InferResult, agent, task_id, use_cache, cache_key
    ) -> None:
        self.budget.record(
            name,
            result.model,
            result.input_tokens,
            result.output_tokens,
            agent=agent,
            task_id=task_id,
        )
        if use_cache:
            self.cache.put(cache_key, result)

    @staticmethod
    def _honors_schema(provider, json_schema: str) -> bool:
        """Cache eligibility: a schema-keyed entry may only hold a response
        from a provider that actually HONORS the schema."""
        return not json_schema or getattr(
            provider, "supports_json_schema", False
        )

    def route(
        self,
        prompt: str,
        system: str = "",
        max_tokens: int = 1024,
        temperature: float = 0.7,
        preferred: str = "",
        allow_fallback: bool = True,
        agent: str = "",
        task_id: str = "",
        use_cache: bool = True,
        json_schema: str = "",
    ) -> InferResult:
        # a schema-constrained response is NOT interchangeable with the
        # unconstrained response for the same prompt — key the cache on it
        cache_key = self.cache.key(
            prompt, system + "\x00" + json_schema, max_tokens, temperature
        )
        if use_cache:
            hit = self.cache.get(cache_key)
            if hit is not None:
                return hit

        errors: List[str] = []
        for name, provider in self._candidates(preferred, allow_fallback, errors):
            try:
                result = provider.infer(
                    prompt, system, max_tokens, temperature,
                    json_schema=json_schema,
                )
            except ProviderError as exc:
                self.last_errors[name] = str(exc)
                errors.append(f"{name}: {exc}")
                if not allow_fallback:
                    break
                continue
            # a provider that IGNORES the schema returns unconstrained
            # text; caching it under the schema-keyed entry would serve
            # non-conforming responses to later schema requests
            honors = self._honors_schema(provider, json_schema)
            self._record_and_cache(
                name, result, agent, task_id, use_cache and honors, cache_key
            )
            return result
        raise ProviderError("all providers failed: " + "; ".join(errors))

    def route_stream(
        self,
        prompt: str,
        system: str = "",
        max_tokens: int = 1024,
        temperature: float = 0.7,
        preferred: str = "",
        allow_fallback: bool = True,
        agent: str = "",
        task_id: str = "",
        use_cache: bool = True,
        json_schema: str = "",
        register_call=None,
        client_alive=None,
    ):
        """Route with live streaming: yields (text_delta, provider_name).

        Providers exposing ``stream_infer`` (the local TPU runtime) pipe
        their token stream straight through — the first delta arrives while
        generation is still running. Cloud providers without a streaming
        client fall back to infer-then-rechunk (64-char pieces, matching
        the reference's StreamInfer behavior). Fallback to the next
        provider happens only before the first delta is emitted; after
        that, a mid-stream failure surfaces to the caller.

        ``register_call`` (optional) receives each in-flight downstream
        gRPC call so the gateway servicer can cancel it from its RPC-
        termination callback — the only abort path when this generator is
        parked in next() with no delta flowing (a disconnect then never
        raises GeneratorExit here). ``client_alive`` (optional callable)
        reports whether the consumer still exists: a provider failure with
        a dead consumer aborts routing instead of falling back (no cloud
        spend for nobody); it also distinguishes a deliberate
        disconnect-cancel from a genuine runtime CANCELLED failure, which
        DOES fall back.
        """
        # same composite key as route() so the two paths share hits
        cache_key = self.cache.key(
            prompt, system + "\x00" + json_schema, max_tokens, temperature
        )
        if use_cache:
            hit = self.cache.get(cache_key)
            if hit is not None:
                for i in range(0, len(hit.text), 64):
                    yield hit.text[i : i + 64], hit.provider
                return

        errors: List[str] = []
        for name, provider in self._candidates(preferred, allow_fallback, errors):
            if hasattr(provider, "stream_infer"):
                # the runtime's incremental detokenizer emits ~one delta per
                # generated token, so len(pieces) IS the completion token
                # count; the chunk wire format carries no usage fields
                # (runtime.proto InferChunk, reference parity). Recording
                # happens in the finally so a client that disconnects
                # mid-stream (GeneratorExit) still pays for what streamed;
                # only COMPLETE responses enter the cache.
                pieces: List[str] = []
                completed = False
                try:
                    try:
                        for delta in provider.stream_infer(
                            prompt, system, max_tokens, temperature,
                            json_schema=json_schema,
                            register_call=register_call,
                        ):
                            pieces.append(delta)
                            yield delta, name
                        completed = True
                        if not pieces:
                            # empty completion (immediate EOS): still hand
                            # the consumer the serving provider's name so
                            # the terminal done-chunk isn't unattributed
                            yield "", name
                    except ProviderError as exc:
                        self.last_errors[name] = str(exc)
                        if pieces:  # mid-stream failure: don't restart
                            raise
                        if client_alive is not None and not client_alive():
                            # OUR consumer is gone (the disconnect cancel
                            # tore the downstream call): falling back would
                            # spend another provider — possibly cloud
                            # budget — for a dead client
                            raise
                        errors.append(f"{name}: {exc}")
                        if not allow_fallback:
                            break
                        continue
                finally:
                    if pieces:
                        honors = self._honors_schema(
                            provider, json_schema
                        )
                        self._record_and_cache(
                            name,
                            InferResult(
                                text="".join(pieces),
                                input_tokens=0,
                                output_tokens=len(pieces),
                                model=f"{name}-stream",
                                provider=name,
                            ),
                            agent,
                            task_id,
                            use_cache and completed and honors,
                            cache_key,
                        )
                return
            try:
                result = provider.infer(
                    prompt, system, max_tokens, temperature,
                    json_schema=json_schema,
                )
            except ProviderError as exc:
                self.last_errors[name] = str(exc)
                errors.append(f"{name}: {exc}")
                if not allow_fallback:
                    break
                continue
            # record BEFORE yielding: the provider call is already paid for
            # even if the client disconnects during the rechunk relay
            honors = self._honors_schema(provider, json_schema)
            self._record_and_cache(
                name, result, agent, task_id, use_cache and honors, cache_key
            )
            if not result.text:
                yield "", name  # attribute the terminal chunk (see above)
            for i in range(0, len(result.text), 64):
                yield result.text[i : i + 64], name
            return
        raise ProviderError("all providers failed: " + "; ".join(errors))
