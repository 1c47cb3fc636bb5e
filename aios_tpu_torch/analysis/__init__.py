"""Concurrency and dispatch-discipline analysis for the port's serving plane.

Static half: an AST rule engine (``python -m aios_tpu_torch.analysis``,
also a tier-1 test, ``tests/test_torch_analysis.py``) over every module of
``aios_tpu_torch`` (the generated ``proto_gen`` stubs aside). What is
specific to the port (its locks, the shapes of a dispatch, a readback and
a blocking wait under torch, the modules each rule watches) is declared in
:mod:`.registry`; the rules in :mod:`.rules` are generic.

Rule catalog (the ``--rule`` filter and waiver pragmas use these ids):

  * ``lock-dispatch`` / ``lock-readback`` / ``lock-rpc``: no device
    dispatch, no device-to-host readback and no blocking RPC or wait inside
    a declared lock's body, call-graph-aware one level deep. Each lock
    declares what it forbids; the engine lock and the graph-capture lock
    shelter dispatch by design, so they forbid only readback and RPC.
    The shapes: a dispatch is a graph ``replay`` or ``capture``, the
    engine's ``_dispatcher`` / ``_capture``, or the engine's dispatching
    surface (``step``, ``step_async``, ``step_masked``, ``prefill``,
    ``spec_step``, ``jump_step``, ``mega_step``, ``spec_step_draft``,
    ``start_chunked_prefill``, their eager twins, ``generate``); a readback
    is ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
    ``.to("cpu")``, ``torch.cuda.synchronize`` or an event's or stream's
    ``synchronize`` / ``elapsed_time`` / ``query``; a blocking wait is a
    gRPC stub call, ``channel_ready_future``, ``.result()``, ``.wait()``,
    ``sleep`` or a thread's (or queue's) ``join``. The rule is lexical: a
    host numpy array's ``.tolist()`` matches too, and is waived with the
    contract that makes it host memory.
  * ``lock-order``: the static acquired-while-holding graph over the
    declared locks must be acyclic.
  * ``guarded-by``: fields annotated ``#: guarded_by <lock-attr>`` may be
    mutated only under that lock (or in ``__init__``).
  * ``graph-warmup``: every graph capture (``_capture(...)``,
    ``GraphSet.capture(...)``) in ``engine/engine.py``,
    ``engine/batching.py`` and ``engine/spec.py`` is reachable from a
    warmup root (``warmup``, ``capture_*``), and no serving entry (the
    dispatching surface above) reaches it except through such a root or a
    call waived for this rule: the graphs are captured at ``LoadModel``
    and ``graph_captures`` stays flat while serving.
  * ``silent-except``: broad ``except Exception`` / ``BaseException`` /
    bare handlers in ``aios_tpu_torch.serving`` and
    ``aios_tpu_torch.engine`` record the failure (re-raise, log, or land an
    abort/terminal cause).
  * ``knob-docs``: every ``AIOS_TPU_*`` string in the tree is a row of
    ``docs/CONFIG.md``, and every row is read by the tree or named by one
    of the declared tuples of knobs the port does not read
    (``runtime/model_manager.UNPORTED_KNOBS``, which warn when set, and
    ``NOT_CARRIED_KNOBS``, each with its reason).
  * ``metric-catalog``: ``aios_tpu_*`` instruments are constructed only in
    ``obs/instruments.py`` / ``obs/metrics.py``, never at point of use.
  * ``waiver-reason``: a waiver pragma without justification text (or with
    an unknown rule id) is itself a finding, never a waiver.

Waivers: ``# aios: waive(<rule-id>): <reason>`` on the finding's line, on
the governing ``with`` line, or on a comment line of its own just above.
The reason states the contract that makes the finding safe (which memory
is on the host, which counter makes a serve-time capture visible, why a
handler may swallow); a pragma without one waives nothing.

Runtime half: :mod:`.locks`, named, order-checking debug locks that the
declared locks switch to under ``AIOS_TPU_LOCK_DEBUG=1`` (the test suite
runs with it on, and ``chip_smoke.py`` turns it on for its stack and storm
phases).

Import note: this package stays import-light (no torch, no obs): the
engine imports ``locks.make_lock`` at module import time.
"""

from .core import Finding, ModuleInfo, module_info_for  # noqa: F401
from .locks import (  # noqa: F401
    DebugLock, LockOrderError, debug_enabled, make_lock, observed_edges,
    order_errors, watchdog_trips,
)
from .registry import DEFAULT, LOCKS, Registry  # noqa: F401
from .rules import RULE_IDS, Analyzer, run_analysis  # noqa: F401
