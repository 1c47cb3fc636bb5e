"""Transparent in-flight failover: a crashed replica must not cost the
client its stream.

A copy of ``aios_tpu/serving/failover.py`` over the port's ``Request`` and
``RequestHandle``. On the port the resumed prompt re-admits through the
batcher like any prompt: over the page pool its leading blocks are a radix
prefix hit (the dead attempt's admission published them) and its tail goes
through the chunk path.

Before this module, a replica scheduler crash aborted every outstanding
request (``batching._abort_all``) and the client got a truncated stream
plus an error status — correct, but the recovery the spawner-style
respawn makes possible was left to the client. Production engines treat
fault tolerance as a serving feature (RTP-LLM, PAPERS.md): here the pool
wraps every eligible request in a :class:`FailoverHandle` that, when the
stream dies with a RETRYABLE abort (``scheduler_failed`` always;
``evicted`` only when a sibling replica exists to re-route to):

  1. waits out a bounded exponential backoff with jitter;
  2. resubmits ``prompt + already-emitted tokens`` through the pool's
     router — the radix PrefixIndex and host KV tier make the re-prefill
     a cache hit (page-table update / memcpy), not a recompute;
  3. resumes the client stream at the exact next token (prefill of the
     grown prompt samples precisely the token the dead replica would
     have produced next — greedy streams are token-identical to a
     fault-free run).

One flight-recorder timeline spans every attempt: the batcher's
``_rec_close`` defers the terminal event to this controller for claimed
aborts (see :meth:`FailoverHandle.claims`), each resubmission lands a
``failover`` event, and TTFT/TPOT accumulate across attempts — failover
latency counts against the SLOs, by design. A retry budget that
exhausts surfaces as an aborted handle whose ``retry_after_ms`` the
runtime service returns as ``UNAVAILABLE`` + ``retry-after-ms`` trailing
metadata (the admission-shed convention) — never a silent truncation.

Grammar-constrained requests (``json_mode`` / ``json_schema``) are NOT
wrapped: their first post-prefill token is sampled unmasked and then
grammar-forced, which a mid-stream resume cannot reproduce without
masked prefill; they keep the pre-failover abort behavior (retryable
status + retry-after, so clients resubmit). docs/FAULTS.md documents
the limitation.
"""

from __future__ import annotations

import logging
import random
import time
from typing import List, Optional

from ..analysis.locks import make_lock
from ..engine.batching import Request, RequestHandle
from ..obs import flightrec
from ..obs import instruments as obs

log = logging.getLogger("aios.torch.serving")

# ceiling on one backoff sleep: a deep retry chain must not park the
# client's stream for longer than its deadline could plausibly cover
MAX_BACKOFF_S = 5.0

FAILOVER_OUTCOMES = ("resumed", "exhausted")


def build_resume_request(pool, req: Request, emitted: List[int],
                         failover=None) -> Request:
    """The resume-from-emitted contract (shared, in the JAX package, with
    the fleet handoff plane): rebuild ``req`` as
    ``prompt + already-emitted tokens`` with the remaining token budget.

    Resumes from the ADMISSION-TRUNCATED prompt, not the raw one: the
    engine kept only the last max_context-1 prompt ids, and appending
    emitted tokens to the RAW prompt would shift the truncation window
    by ``len(emitted)`` — a different conditioning context than the
    fault-free run's KV. From the truncated base, base + emitted <=
    max_context-1 always holds (a stream at the cap retires instead of
    aborting), so the resubmit is never re-truncated and greedy identity
    is preserved."""
    base, _ = pool._route_ids(req)
    return Request(
        prompt_ids=list(base) + list(emitted),
        max_tokens=max(req.max_tokens - len(emitted), 1),
        temperature=req.temperature,
        top_p=req.top_p,
        stop_ids=req.stop_ids,
        request_id=req.request_id,
        priority=req.priority,
        rec=req.rec,  # ONE timeline spans every attempt
        failover=failover,
    )


class FailoverHandle:
    """Caller-side view of a failover-protected request: iterates like
    :class:`~aios_tpu_torch.engine.batching.RequestHandle`, transparently
    splicing resumed attempts into one token stream."""

    def __init__(self, pool, req: Request, tenant: str,
                 retries: int, backoff_ms: float) -> None:
        self._pool = pool
        self._req = req
        self._tenant = tenant
        self.retries = retries
        self.backoff_ms = backoff_ms
        #: guarded_by _lock
        self._inner: Optional[RequestHandle] = None  # set by the pool
        self._emitted: List[int] = []
        self._attempts = 0
        self._t0 = time.monotonic()
        self._ttft_at = 0.0
        self._lock = make_lock("failover")
        #: guarded_by _lock
        self._terminal_abort = ""
        #: guarded_by _lock
        self._cancelled = False
        # evicted re-routes only when a SIBLING can host the request —
        # retrying on the same starved replica would just evict another
        # victim (and possibly this request again, in a loop the budget
        # pays for without progress)
        self._retryable = ("scheduler_failed",) + (
            ("evicted",) if len(pool.replicas) > 1 else ()
        )

    # -- scheduler-side contract (called by batching._rec_close) ------------

    def claims(self, abort_reason: str) -> bool:
        """Whether this controller will own the aborted request's
        terminal event (the batcher then skips finishing the timeline).
        Conservative: claiming and then NOT retrying is handled (the
        controller finishes the timeline itself); finishing here and
        then retrying would freeze the record mid-recovery."""
        with self._lock:
            if self._cancelled:
                return False
        return (
            flightrec.abort_cause(abort_reason) in self._retryable
            and self._attempts < self.retries
            and not (self._pool._draining or self._pool._closed)
        )

    # -- RequestHandle surface ----------------------------------------------

    def __iter__(self):
        while True:
            with self._lock:
                inner = self._inner
            for tok in inner:
                if not self._ttft_at:
                    self._ttft_at = time.monotonic()
                self._emitted.append(tok)
                yield tok
            reason = inner._live.abort_reason
            if not reason:
                return  # retired / cancelled: a normal end of stream
            if not self._resume(reason):
                return  # terminal abort: self.aborted reflects it

    def tokens(self) -> List[int]:
        return list(self)

    def cancel(self) -> None:
        with self._lock:
            self._cancelled = True
            inner = self._inner
        if inner is None:
            return
        inner.cancel()
        # a crash and a client disconnect are correlated (the stalled
        # stream is WHY the client gave up): if the inner attempt is
        # already dead with an abort this controller claimed (the
        # batcher deferred the terminal event to us) and the consumer
        # will never drive _resume, the timeline must not be left
        # unfinished — no ring entry, no SLO sample, no snapshot
        live = inner._live
        if live.done and live.abort_reason and not self._terminal_abort:
            self._terminal(
                live.abort_reason, flightrec.abort_cause(live.abort_reason)
            )

    @property
    def aborted(self) -> bool:
        return bool(self._terminal_abort)

    @property
    def abort_reason(self) -> str:
        return self._terminal_abort

    @property
    def retry_after_ms(self) -> int:
        """Client backoff hint once the in-pool budget is spent: the
        next backoff step this controller WOULD have taken — the client
        inherits the retry chain where the pool left off."""
        if not self._terminal_abort:
            return 0
        cause = flightrec.abort_cause(self._terminal_abort)
        if cause not in flightrec.RETRYABLE_ABORT_CAUSES:
            return 0
        return int(min(
            self.backoff_ms * (2 ** self._attempts), MAX_BACKOFF_S * 1e3
        ))

    @property
    def ttft_ms(self) -> float:
        if not self._ttft_at:
            return 0.0
        return (self._ttft_at - self._t0) * 1000.0

    # -- the failover core ---------------------------------------------------

    def _resume(self, reason: str) -> bool:
        """Attempt one failover resubmission. Runs on the CONSUMER's
        thread (the stream is already stalled on the dead attempt, and
        the backoff sleep must not block any scheduler). Returns True
        when a new attempt is live; False finishes the timeline as
        aborted and surfaces the terminal state."""
        cause = flightrec.abort_cause(reason)
        with self._lock:
            cancelled = self._cancelled
        if (
            cancelled
            or cause not in self._retryable
            or self._attempts >= self.retries
            or self._pool._draining
            or self._pool._closed
        ):
            return self._terminal(reason, cause)
        self._attempts += 1
        # exponential backoff + jitter: a crash that killed N in-flight
        # requests wakes N consumers at once — the jitter de-synchronizes
        # their re-prefill storm on the surviving replicas
        delay_s = min(
            self.backoff_ms / 1e3 * (2 ** (self._attempts - 1)),
            MAX_BACKOFF_S,
        ) * (0.5 + random.random())
        time.sleep(delay_s)
        resumed = build_resume_request(
            self._pool, self._req, self._emitted, failover=self
        )
        try:
            handle = self._pool.submit_failover(
                resumed, cause=cause, attempt=self._attempts,
                backoff_ms=round(delay_s * 1e3, 1),
            )
        except Exception as exc:  # noqa: BLE001 - the pool may be mid-teardown
            log.warning(
                "%s: failover attempt %d for %s failed to resubmit (%s)",
                self._pool.name, self._attempts,
                self._req.request_id or "<anon>", exc,
            )
            return self._terminal(reason, cause)
        with self._lock:
            self._inner = handle
            cancelled = self._cancelled
        if cancelled:
            handle.cancel()
        obs.SERVING_FAILOVERS.labels(
            model=self._pool.name, outcome="resumed"
        ).inc()
        log.warning(
            "%s: request %s failed over (attempt %d/%d, cause %s, "
            "%d tokens already streamed)",
            self._pool.name, self._req.request_id or "<anon>",
            self._attempts, self.retries, cause, len(self._emitted),
        )
        return True

    def _terminal(self, reason: str, cause: str) -> bool:
        """No further attempt will run: finish the timeline this
        controller claimed and surface the abort. Idempotent — cancel()
        and a racing _resume may both arrive here for one request."""
        with self._lock:
            if self._terminal_abort:
                return False
            self._terminal_abort = reason
        # "exhausted" means the RETRY BUDGET was the blocker — a client
        # cancel mid-crash or a draining pool terminates retryable
        # causes too, and counting those would false-alarm the RUNBOOK's
        # "exhausted flat = no client saw the crash" drill verdict
        if cause in self._retryable and self._attempts >= self.retries:
            obs.SERVING_FAILOVERS.labels(
                model=self._pool.name, outcome="exhausted"
            ).inc()
        # finish() is itself idempotent for the case where the batcher
        # already closed the timeline (unclaimed causes, e.g.
        # prompt_too_large on a resumed attempt)
        flightrec.RECORDER.finish(
            self._req.rec, "aborted", abort_reason=reason
        )
        return False
