"""Provider clients: Claude, OpenAI, Qwen3 (OpenAI-compat), local TPU runtime.

Reference parity (api-gateway/src/{claude,openai}.rs + router.rs):
  * Claude native Messages API, default model claude-sonnet-4-20250514
    (claude.rs:54-67), key from CLAUDE_API_KEY;
  * OpenAI chat completions, default gpt-5, key from OPENAI_API_KEY;
  * Qwen3 = OpenAI-compatible endpoint (default api.viwoapp.net,
    model qwen3:30b-128k), key from QWEN3_API_KEY;
  * local = the reference hits llama-server HTTP on 127.0.0.1:8082; here it
    is the TPU runtime's gRPC Infer — always available, no key.

Base URLs are env-overridable (CLAUDE_BASE_URL etc.) which is also how the
offline test suite stubs them.
"""

from __future__ import annotations

import json
import os
import urllib.error
import urllib.request
from dataclasses import dataclass
from typing import Optional, Tuple


class ProviderError(Exception):
    pass




@dataclass
class InferResult:
    text: str
    input_tokens: int
    output_tokens: int
    model: str
    provider: str


def _post_json(url: str, payload: dict, headers: dict, timeout: float) -> dict:
    req = urllib.request.Request(
        url,
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **headers},
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read().decode("utf-8", "replace"))
    except urllib.error.HTTPError as exc:
        body = exc.read().decode("utf-8", "replace")[:500]
        raise ProviderError(f"HTTP {exc.code} from {url}: {body}") from exc
    except (OSError, ValueError) as exc:
        raise ProviderError(f"request to {url} failed: {exc}") from exc


class ClaudeClient:
    name = "claude"

    def __init__(self):
        self.api_key = os.environ.get("CLAUDE_API_KEY", "")
        self.base_url = os.environ.get("CLAUDE_BASE_URL", "https://api.anthropic.com")
        self.model = os.environ.get("CLAUDE_MODEL", "claude-sonnet-4-20250514")
        self.timeout = float(os.environ.get("CLAUDE_TIMEOUT", "120"))

    def available(self) -> bool:
        return bool(self.api_key)

    def infer(self, prompt: str, system: str, max_tokens: int,
              temperature: float, json_schema: str = "") -> InferResult:
        payload = {
            "model": self.model,
            "max_tokens": max_tokens or 1024,
            "messages": [{"role": "user", "content": prompt}],
            "temperature": temperature,
        }
        if system:
            payload["system"] = system
        data = _post_json(
            f"{self.base_url}/v1/messages",
            payload,
            {"x-api-key": self.api_key, "anthropic-version": "2023-06-01"},
            self.timeout,
        )
        try:
            text = "".join(
                b.get("text", "") for b in data["content"] if b.get("type") == "text"
            )
            usage = data.get("usage", {})
            return InferResult(
                text=text,
                input_tokens=usage.get("input_tokens", 0),
                output_tokens=usage.get("output_tokens", 0),
                model=data.get("model", self.model),
                provider=self.name,
            )
        except (KeyError, TypeError) as exc:
            raise ProviderError(f"malformed claude response: {exc}") from exc


class OpenAICompatClient:
    """OpenAI chat-completions protocol (used by both openai and qwen3)."""

    def __init__(self, name: str, key_env: str, base_env: str, default_base: str,
                 model_env: str, default_model: str):
        self.name = name
        self.api_key = os.environ.get(key_env, "")
        self.base_url = os.environ.get(base_env, default_base)
        self.model = os.environ.get(model_env, default_model)
        self.timeout = 120.0

    def available(self) -> bool:
        return bool(self.api_key)

    def infer(self, prompt: str, system: str, max_tokens: int,
              temperature: float, json_schema: str = "") -> InferResult:
        messages = []
        if system:
            messages.append({"role": "system", "content": system})
        messages.append({"role": "user", "content": prompt})
        data = _post_json(
            f"{self.base_url}/v1/chat/completions",
            {
                "model": self.model,
                "messages": messages,
                "max_tokens": max_tokens or 1024,
                "temperature": temperature,
            },
            {"Authorization": f"Bearer {self.api_key}"},
            self.timeout,
        )
        try:
            text = data["choices"][0]["message"]["content"]
            usage = data.get("usage", {})
            return InferResult(
                text=text or "",
                input_tokens=usage.get("prompt_tokens", 0),
                output_tokens=usage.get("completion_tokens", 0),
                model=data.get("model", self.model),
                provider=self.name,
            )
        except (KeyError, IndexError, TypeError) as exc:
            raise ProviderError(f"malformed {self.name} response: {exc}") from exc


def openai_client() -> OpenAICompatClient:
    return OpenAICompatClient(
        "openai", "OPENAI_API_KEY", "OPENAI_BASE_URL",
        "https://api.openai.com", "OPENAI_MODEL", "gpt-5",
    )


def qwen3_client() -> OpenAICompatClient:
    return OpenAICompatClient(
        "qwen3", "QWEN3_API_KEY", "QWEN3_BASE_URL",
        "https://api.viwoapp.net", "QWEN3_MODEL", "qwen3:30b-128k",
    )


class LocalRuntimeClient:
    """The TPU runtime as a gateway provider (final fallback, always on).

    Honors the runtime's backoff convention: a shed or crash-abort comes
    back as RESOURCE_EXHAUSTED / UNAVAILABLE with ``retry-after-ms``
    trailing metadata, and this client sleeps the hinted backoff (with
    jitter — a fleet of gateways must not resubmit in lockstep) and
    retries up to ``AIOS_TPU_RUNTIME_RETRY_ATTEMPTS`` times (default 2).
    Errors WITHOUT the hint (wrong model name, invalid schema, a genuine
    outage) propagate immediately — only the runtime's explicit
    "try again later" is worth waiting on."""

    name = "local"
    supports_json_schema = True  # grammar-guided decoding in the engine

    def __init__(self, address: Optional[str] = None):
        from ..services import service_address

        self.address = address or service_address("runtime")
        self._stub = None
        self._channel = None

    def available(self) -> bool:
        return True  # router.rs treats local as always-available

    def _get_stub(self):
        if self._stub is None:
            from .. import rpc
            from ..services import AIRuntimeStub

            # ONE persistent channel, reused across stub rebuilds and
            # retries: gRPC channels reconnect on their own after an
            # UNAVAILABLE, so rebuilding the channel per failure would
            # either leak sockets (dereference) or — worse — close() a
            # channel the gateway's OTHER worker threads have healthy
            # in-flight RPCs on (close cancels every call in progress)
            if self._channel is None:
                self._channel = rpc.insecure_channel(self.address)
            self._stub = AIRuntimeStub(self._channel)
        return self._stub

    @staticmethod
    def _retry_attempts() -> int:
        import os

        raw = os.environ.get("AIOS_TPU_RUNTIME_RETRY_ATTEMPTS", "").strip()
        try:
            return max(int(raw), 0) if raw else 2
        except ValueError:
            return 2

    @staticmethod
    def _retry_after_ms(exc) -> Optional[int]:
        """The runtime's retry-after-ms trailing metadata, or None when
        the error carries no backoff hint (not retryable)."""
        import grpc

        if exc.code() not in (
            grpc.StatusCode.UNAVAILABLE, grpc.StatusCode.RESOURCE_EXHAUSTED
        ):
            return None
        try:
            md = exc.trailing_metadata() or ()
        except Exception:  # noqa: BLE001 - metadata is advisory
            return None
        for k, v in md:
            if k == "retry-after-ms":
                try:
                    return max(int(v), 1)
                except (TypeError, ValueError):
                    return None
        return None

    @staticmethod
    def _backoff(hint_ms: int) -> None:
        import random as _random
        import time as _time

        # jittered: 0.5x..1.5x the hint, capped — the hint is already
        # the runtime's own drain estimate
        _time.sleep(min(hint_ms, 30_000) / 1e3 * (0.5 + _random.random()))

    def infer(self, prompt: str, system: str, max_tokens: int,
              temperature: float, json_schema: str = "") -> InferResult:
        import grpc

        from ..proto_gen import runtime_pb2

        attempts = self._retry_attempts()
        request = runtime_pb2.InferRequest(
            prompt=prompt,
            system_prompt=system,
            max_tokens=max_tokens or 512,
            temperature=temperature,
            # structured output rides through to the TPU engine's
            # grammar-guided decoding; cloud providers ignore it
            json_schema=json_schema,
        )
        for attempt in range(attempts + 1):
            try:
                resp = self._get_stub().Infer(request, timeout=120)
                break
            except grpc.RpcError as exc:
                self._stub = None
                hint = self._retry_after_ms(exc)
                if hint is None or attempt >= attempts:
                    raise ProviderError(
                        f"local runtime: {exc.details()}"
                    ) from exc
                self._backoff(hint)
        return InferResult(
            text=resp.text,
            input_tokens=max(0, resp.tokens_used),
            output_tokens=0,
            model=resp.model_used or "local",
            provider=self.name,
        )

    def stream_infer(self, prompt: str, system: str, max_tokens: int,
                     temperature: float, json_schema: str = "",
                     register_call=None):
        """Yield text deltas live from the runtime's StreamInfer.

        This is the true-streaming path the reference never had: its
        inference.rs:261 buffers the whole completion and re-chunks it, a
        quirk the runtime service here already fixed — so the gateway pipes
        the live token stream instead of replicating the buffer-then-chunk
        behavior (router.route_stream).
        """
        import grpc

        from ..proto_gen import runtime_pb2

        request = runtime_pb2.InferRequest(
            prompt=prompt,
            system_prompt=system,
            max_tokens=max_tokens or 512,
            temperature=temperature,
            json_schema=json_schema,
        )
        attempts = self._retry_attempts()
        stream = None
        emitted = False
        try:
            for attempt in range(attempts + 1):
                try:
                    stream = self._get_stub().StreamInfer(
                        request, timeout=300
                    )
                    if register_call is not None:
                        # hand the call to the servicer so its
                        # RPC-termination callback can cancel it
                        # cross-thread while this generator is parked in
                        # next() (cancel is thread-safe on gRPC calls)
                        register_call(stream)
                    for chunk in stream:
                        if chunk.text:
                            emitted = True
                            yield chunk.text
                        if chunk.done:
                            return
                    return
                except grpc.RpcError as exc:
                    # CANCELLED can be our own disconnect-cancel
                    # (register_call path) OR a genuine runtime failure
                    # (server restart kills in-flight RPCs with
                    # CANCELLED) — the router tells them apart via its
                    # client_alive probe, not here
                    if exc.code() != grpc.StatusCode.CANCELLED:
                        self._stub = None
                    hint = self._retry_after_ms(exc)
                    if emitted or hint is None or attempt >= attempts:
                        # once a delta reached the consumer a blind
                        # resubmit would replay text — the runtime's own
                        # in-pool failover already covers mid-stream
                        # crashes transparently; only a shed/crash BEFORE
                        # the first delta retries here
                        raise ProviderError(
                            f"local runtime: {exc.details()}"
                        ) from exc
                    self._backoff(hint)
        finally:
            # our consumer can vanish mid-stream (the gateway's client
            # disconnected -> GeneratorExit lands here): cancel the
            # downstream call so the runtime aborts its decode and frees
            # the slot, instead of streaming to an abandoned iterator
            # until max_tokens. No-op on a completed call.
            if stream is not None:
                stream.cancel()
