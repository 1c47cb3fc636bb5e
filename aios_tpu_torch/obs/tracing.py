"""Span-based tracing with W3C traceparent context propagation.

Spans form the goal -> task -> agent -> RPC -> decode hierarchy
(docs/OBSERVABILITY.md): a span opened inside another span on the same
thread becomes its child (contextvars), and the current span's identity
crosses process/service boundaries as a ``traceparent`` gRPC metadata
entry (``00-<trace_id>-<span_id>-01``) injected by the client
interceptor and re-parented by the server interceptor.

Finished spans land in a bounded in-process ring (``recent_spans``) —
enough for tests, debugging, and the management console to reconstruct
recent request trees without an external collector; an exporter callback
can be attached for anything heavier.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import re
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Tuple

_TRACEPARENT_RE = re.compile(
    r"^[0-9a-f]{2}-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$"
)

_current: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "aios_obs_current_span", default=None
)

_MAX_FINISHED = 2048
_finished: "deque[Span]" = deque(maxlen=_MAX_FINISHED)
_finished_lock = threading.Lock()
_exporter: Optional[Callable[["Span"], None]] = None


def _new_trace_id() -> str:
    return os.urandom(16).hex()


def _new_span_id() -> str:
    return os.urandom(8).hex()


@dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_id: str = ""
    start: float = field(default_factory=time.time)
    end: float = 0.0
    status: str = "ok"  # ok | error
    attributes: Dict[str, object] = field(default_factory=dict)

    def set_attribute(self, key: str, value: object) -> None:
        self.attributes[key] = value

    @property
    def duration_s(self) -> float:
        return max(0.0, (self.end or time.time()) - self.start)

    @property
    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"


def current_span() -> Optional[Span]:
    return _current.get()


def current_traceparent() -> Optional[str]:
    span = _current.get()
    return span.traceparent if span is not None else None


def parse_traceparent(value: str) -> Optional[Tuple[str, str]]:
    """``traceparent`` header -> (trace_id, parent_span_id), or None."""
    m = _TRACEPARENT_RE.match(value.strip().lower()) if value else None
    return (m.group(1), m.group(2)) if m else None


def set_exporter(fn: Optional[Callable[[Span], None]]) -> None:
    """Attach a finished-span callback (None clears). The ring keeps
    filling either way. The default exporter (installed by the obs
    package) feeds the flight recorder so finished RPC spans fold into
    request timelines; deployments may replace it."""
    global _exporter
    _exporter = fn


def get_exporter() -> Optional[Callable[[Span], None]]:
    return _exporter


def recent_spans(name: str = "", limit: int = 100) -> List[Span]:
    """Most-recent finished spans, newest last; ``name`` is a substring
    filter."""
    with _finished_lock:
        spans = list(_finished)
    if name:
        spans = [s for s in spans if name in s.name]
    return spans[-limit:]


def clear_spans() -> None:
    """Drop the finished-span ring (test isolation)."""
    with _finished_lock:
        _finished.clear()


def _finish(span: Span, token, parent: Optional[Span]) -> None:
    span.end = time.time()
    try:
        _current.reset(token)
    except ValueError:
        # a generator finalized from a DIFFERENT context (a cancelled
        # stream handler torn down by the gRPC machinery) can't reset the
        # token. Restore the parent explicitly in this context; the
        # original thread may still hold the finished span — that's why
        # continue_span() never trusts ambient context for its fresh-root
        # fallback (server entry points on reused pool threads).
        _current.set(parent)
    with _finished_lock:
        _finished.append(span)
    exporter = _exporter
    if exporter is not None:
        try:
            exporter(span)
        except Exception:  # noqa: BLE001 - exporters must not break serving
            pass


@contextlib.contextmanager
def _run_span(span: Span, parent: Optional[Span]) -> Iterator[Span]:
    token = _current.set(span)
    try:
        yield span
    except BaseException as exc:
        span.status = "error"
        span.attributes.setdefault("error", repr(exc)[:200])
        raise
    finally:
        _finish(span, token, parent)


def start_span(name: str, **attributes: object):
    """Open a span as a child of the current one (same thread), or as a
    new trace root when there is none. Context manager."""
    parent = _current.get()
    span = Span(
        name=name,
        trace_id=parent.trace_id if parent else _new_trace_id(),
        span_id=_new_span_id(),
        parent_id=parent.span_id if parent else "",
        attributes=dict(attributes),
    )
    return _run_span(span, parent)


def continue_span(
    traceparent: Optional[str], name: str, **attributes: object
):
    """Open a span continuing a remote trace (server side of an RPC).
    A missing/malformed traceparent starts a FRESH ROOT — deliberately
    ignoring ambient context: server entry points run on reused pool
    threads, and a stale span left by a cross-context generator teardown
    (see _finish) must not adopt unrelated requests into a dead trace."""
    parsed = parse_traceparent(traceparent or "")
    if parsed is None:
        trace_id, parent_id = _new_trace_id(), ""
    else:
        trace_id, parent_id = parsed
    span = Span(
        name=name,
        trace_id=trace_id,
        span_id=_new_span_id(),
        parent_id=parent_id,
        attributes=dict(attributes),
    )
    return _run_span(span, None)
