"""The autonomy loop: tick-driven task execution with a fallback ladder.

Reference parity (agent-core/src/autonomy.rs — the densest component, SURVEY
section 2e). Semantics preserved:

  * tick every 500 ms (AutonomyConfig, autonomy.rs:22-36): decompose pending
    goals -> take <=3 unblocked tasks -> dispatch each through the ladder
    agent-route -> cluster spillover -> heuristic direct-execute -> AI
    reasoning loop (autonomy_tick:331-691);
  * the reasoning loop is multi-round observe->think->act with per-level
    caps: max rounds 1/1/3/5 and token budgets 2048/2048/8192/16384 for
    reactive/operational/tactical/strategic (596-607); the model signals
    completion with {"done": true} (279-286); a malformed-JSON reply gets
    one self-correction round (290-328); each round's prompt embeds prior
    tool results truncated at 1000 chars (230-276);
  * AI backend chain: api-gateway (preferred provider qwen3, 544-546) then
    the local runtime as fallback;
  * prompts include the live tool catalog fetched over gRPC with a static
    fallback list (988-1055), memory context chunks (848-880), the goal's
    conversation history (884-900), a self-evolution instruction to
    plugin.create missing tools (906-910), and a strict JSON tool_calls
    format spec (912-927);
  * heuristic executor bypasses AI entirely for cpu/memory/disk/ping/dns/
    fs-read/service-status/email and explicit tool_calls in the task input
    (1149-1248);
  * result recording: zero tool calls -> awaiting_input with a question to
    the user, max 3 assistant messages then fail (2431-2480); ANY failed
    tool call fails the task (2488-2528); parallel dispatch capped at 3
    concurrent AI tasks (Semaphore(3), 376,632);
  * housekeeping: requeue tasks from dead agents, detect goal completion
    (695-733).

Lock discipline mirrors the reference: shared state is touched only for
selection/recording; inference and tool execution run unlocked
(autonomy.rs:335,588-590,619).
"""

from __future__ import annotations

import json
import logging
import re
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from .agent_router import AgentRouter
from .cluster import ClusterManager, RemoteExecutor, cluster_enabled
from .goal_engine import GoalEngine, Task
from .task_planner import (
    OPERATIONAL,
    REACTIVE,
    STRATEGIC,
    TACTICAL,
    TaskPlanner,
    extract_json_array,
    strip_think_tags,
)
from .telemetry import Decision, DecisionLogger, ResultAggregator, TaskOutcome

log = logging.getLogger("aios.autonomy")

MAX_ROUNDS = {REACTIVE: 1, OPERATIONAL: 1, TACTICAL: 3, STRATEGIC: 5}
TOKEN_BUDGETS = {REACTIVE: 2048, OPERATIONAL: 2048, TACTICAL: 8192,
                 STRATEGIC: 16384}


class InferenceCancelled(Exception):
    """An in-flight AI inference was aborted on purpose (its goal was
    cancelled) — not a backend failure: no fallback, no task failure."""


def _call_with_budget(
    backend, prompt: str, level: str, budget: int, json_schema: str = "",
    cancel_event=None,
) -> str:
    """Invoke an infer backend, passing the token budget when it takes one
    and the structured-output schema / cancel event when accepted.

    Production closures (orchestrator/main.py) have signature
    (prompt, level, max_tokens, json_schema="", cancel_event=None);
    two-arg callables are grandfathered so injected fakes keep working.
    """
    import inspect

    takes_schema = False
    takes_cancel = False
    try:
        sig = inspect.signature(backend)
        params = sig.parameters.values()
        # json_schema/cancel_event are always passed BY KEYWORD, so they
        # must not count toward the positional-budget slot (a backend like
        # f(prompt, level, json_schema="") takes no budget)
        positional = [
            p for p in params
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
            and p.name not in ("json_schema", "cancel_event")
        ]
        takes_budget = len(positional) >= 3 or any(
            p.kind is p.VAR_POSITIONAL for p in params
        )
        var_kw = any(p.kind is p.VAR_KEYWORD for p in params)
        takes_schema = "json_schema" in sig.parameters or var_kw
        takes_cancel = "cancel_event" in sig.parameters or var_kw
    except (TypeError, ValueError):
        takes_budget = True
    kw = {}
    if json_schema and takes_schema:
        kw["json_schema"] = json_schema
    if cancel_event is not None and takes_cancel:
        kw["cancel_event"] = cancel_event
    if takes_budget:
        return backend(prompt, level, budget, **kw)
    return backend(prompt, level, **kw)
TOOL_RESULT_TRUNCATE = 1000
MAX_AI_MESSAGES = 3  # awaiting_input cap (autonomy.rs:2431-2480)
MAX_PARALLEL_AI = 3

STATIC_TOOL_CATALOG = [
    "fs.read", "fs.write", "fs.list", "fs.search", "fs.disk_usage",
    "process.list", "process.info", "service.status", "service.restart",
    "net.ping", "net.dns", "net.interfaces", "monitor.cpu", "monitor.memory",
    "monitor.disk", "monitor.logs", "sec.scan", "pkg.search", "web.http_request",
    "plugin.create", "email.send",
]

TOOL_CALL_FORMAT = """\
Respond with ONLY a JSON object in this exact format:
{"thought": "short reasoning",
 "tool_calls": [{"tool": "namespace.name", "args": {...}}],
 "done": false}
Set "done": true with empty tool_calls when the task is complete, and put
your final answer in "thought". If no listed tool fits, you may create one
with {"tool": "plugin.create", "args": {"name": "...", "code": "def main(input_data): ..."}}.
"""


def guided_toolcalls() -> bool:
    """AIOS_TPU_GUIDED_TOOLCALLS=1: reasoning-round replies are
    grammar-guided to the tool_calls shape (tool names constrained to the
    live catalog) via the gateway/runtime json_schema field — the first
    round parses by construction instead of relying on the JSON-repair
    round. Opt-in: the reference has no equivalent (it re-prompts,
    autonomy.rs:290-328), and cloud providers ignore the schema."""
    import os

    return os.environ.get("AIOS_TPU_GUIDED_TOOLCALLS", "").lower() in (
        "1", "true", "on",
    )


def _enum_safe(name: str) -> bool:
    """The engine's schema compiler rejects enum values needing JSON string
    escapes (jsonschema._check_enum_value); a single unsafe tool name must
    not poison every guided reasoning call."""
    return bool(name) and '"' not in name and "\\" not in name and all(
        ord(c) >= 0x20 for c in name
    )


def toolcalls_schema(catalog: List[str]) -> dict:
    """The reasoning-reply schema (engine/jsonschema.py subset): thought,
    tool_calls with catalog-enum tool names + free-form args, done.
    Unsafe names are dropped from the enum; if none survive, the tool
    field degrades to a free string (still shape-guided, not name-guided).
    """
    safe = [t for t in catalog if _enum_safe(t)]
    if len(safe) < len(catalog):
        log.warning(
            "guided tool_calls: %d catalog names unsafe for the enum",
            len(catalog) - len(safe),
        )
    tool_node = (
        {"type": "string", "enum": safe} if safe else {"type": "string"}
    )
    return {
        "type": "object",
        "properties": {
            "thought": {"type": "string"},
            "tool_calls": {
                "type": "array",
                "items": {
                    "type": "object",
                    "properties": {
                        "tool": tool_node,
                        "args": {"type": "object"},
                    },
                    "required": ["tool"],
                },
            },
            "done": {"type": "boolean"},
        },
        "required": ["done"],
    }


@dataclass
class AutonomyConfig:
    tick_interval: float = 0.5
    max_tasks_per_tick: int = 3
    max_parallel_ai: int = MAX_PARALLEL_AI
    preferred_provider: str = "qwen3"  # autonomy.rs:544-546


# ---------------------------------------------------------------------------
# Tool-call parsing (autonomy.rs parse_tool_calls:1538, extract_json:1711,
# natural-language fallback:1973)
# ---------------------------------------------------------------------------


def extract_json_object(text: str) -> Optional[dict]:
    text = strip_think_tags(text)
    candidates = [text.strip()]
    fence = re.search(r"```(?:json)?\s*(.*?)```", text, flags=re.S)
    if fence:
        candidates.insert(0, fence.group(1).strip())
    brace = re.search(r"\{.*\}", text, flags=re.S)
    if brace:
        candidates.append(brace.group(0))
    for cand in candidates:
        try:
            parsed = json.loads(cand)
            if isinstance(parsed, dict):
                return parsed
        except ValueError:
            continue
    return None


def parse_tool_calls(text: str) -> Tuple[List[dict], bool, str]:
    """-> (tool_calls, done, thought). Tolerates several reply shapes."""
    obj = extract_json_object(text)
    # only treat it as a structured reply if it has reply-shaped keys —
    # otherwise fall through (incidental braces in prose must not short-
    # circuit the natural-language fallback)
    if obj is not None and not (
        obj.keys() & {"tool_calls", "calls", "done", "thought", "answer"}
    ):
        obj = None
    if obj is not None:
        raw_calls = obj.get("tool_calls") or obj.get("calls") or []
        calls = []
        for c in raw_calls:
            if isinstance(c, dict) and (c.get("tool") or c.get("name")):
                calls.append(
                    {
                        "tool": c.get("tool") or c.get("name"),
                        "args": c.get("args") or c.get("input") or {},
                    }
                )
        done = bool(obj.get("done"))
        thought = str(obj.get("thought") or obj.get("answer") or "")
        return calls, done, thought

    arr = extract_json_array(text)
    if arr:
        calls = [
            {"tool": c.get("tool") or c.get("name"),
             "args": c.get("args") or c.get("input") or {}}
            for c in arr
            if isinstance(c, dict) and (c.get("tool") or c.get("name"))
        ]
        if calls:
            return calls, False, ""

    # natural-language fallback: `namespace.name({...})` or `use X`
    nl_calls = []
    for m in re.finditer(r"\b([a-z]+\.[a-z_.]+)\s*\(\s*(\{.*?\})?\s*\)", text):
        args = {}
        if m.group(2):
            try:
                args = json.loads(m.group(2))
            except ValueError:
                pass
        nl_calls.append({"tool": m.group(1), "args": args})
    return nl_calls, False, ""


# ---------------------------------------------------------------------------
# Heuristic direct execution (autonomy.rs try_heuristic_execution:1149-1248)
# ---------------------------------------------------------------------------


def heuristic_tool_calls(task: Task) -> Optional[List[dict]]:
    """Direct tool mapping for trivial requests; None -> needs AI."""
    if isinstance(task.input, dict) and task.input.get("tool_calls"):
        return [
            {"tool": c.get("tool"), "args": c.get("args", {})}
            for c in task.input["tool_calls"]
            if isinstance(c, dict) and c.get("tool")
        ]
    low = task.description.lower()
    if "cpu" in low and ("check" in low or "usage" in low or "load" in low):
        return [{"tool": "monitor.cpu", "args": {}}]
    if "memory" in low and ("check" in low or "usage" in low):
        return [{"tool": "monitor.memory", "args": {}}]
    if ("disk" in low and ("usage" in low or "space" in low or "check" in low)):
        return [{"tool": "monitor.disk", "args": {}}]
    m = re.search(r"\bping\s+([a-zA-Z0-9_.:-]+)", low)
    if m:
        return [{"tool": "net.ping", "args": {"host": m.group(1)}}]
    m = re.search(r"\b(?:dns|resolve)\s+(?:for\s+)?([a-zA-Z0-9_.-]+\.[a-z]{2,})", low)
    if m:
        return [{"tool": "net.dns", "args": {"host": m.group(1)}}]
    m = re.search(r"\bread\s+(?:the\s+)?file\s+(\S+)", task.description,
                  flags=re.I)
    if m:
        return [{"tool": "fs.read", "args": {"path": m.group(1).strip("'\"`")}}]
    m = re.search(r"\bstatus\s+of\s+(?:service\s+)?([a-zA-Z0-9_.@-]+)", low)
    if m and "service" in low:
        return [{"tool": "service.status", "args": {"name": m.group(1)}}]
    if "send" in low and "email" in low and task.input.get("to"):
        return [{"tool": "email.send", "args": dict(task.input)}]
    return None


# ---------------------------------------------------------------------------
# The loop
# ---------------------------------------------------------------------------


class AutonomyLoop:
    def __init__(
        self,
        engine: GoalEngine,
        planner: TaskPlanner,
        router: AgentRouter,
        execute_tool: Callable[[str, str, dict], dict],
        gateway_infer: Optional[Callable[..., str]] = None,
        runtime_infer: Optional[Callable[..., str]] = None,
        memory_context: Optional[Callable[[str, int], str]] = None,
        tool_catalog: Optional[Callable[[], List[str]]] = None,
        aggregator: Optional[ResultAggregator] = None,
        decisions: Optional[DecisionLogger] = None,
        cluster: Optional[ClusterManager] = None,
        remote: Optional[RemoteExecutor] = None,
        config: Optional[AutonomyConfig] = None,
    ):
        """Dependencies are injected as callables so the loop is fully
        testable without sockets:
          execute_tool(tool_name, agent_id, args) -> {"success", "output",
          "error"}; gateway/runtime_infer(prompt, level) -> text.
        """
        self.engine = engine
        self.planner = planner
        self.router = router
        self.execute_tool = execute_tool
        self.gateway_infer = gateway_infer
        self.runtime_infer = runtime_infer
        self.memory_context = memory_context
        self.tool_catalog = tool_catalog
        self.aggregator = aggregator or ResultAggregator()
        self.decisions = decisions or DecisionLogger()
        self.cluster = cluster
        self.remote = remote or RemoteExecutor()
        self.config = config or AutonomyConfig()
        self._ai_semaphore = threading.Semaphore(self.config.max_parallel_ai)
        self._pool = ThreadPoolExecutor(
            max_workers=self.config.max_parallel_ai * 2,
            thread_name_prefix="autonomy",
        )
        self._in_flight: set = set()
        # task_id -> (goal_id, Event): in-flight AI inferences abortable
        # by CancelGoal (notify_goal_cancelled); registered per reasoning
        # task for its loop's duration
        self._cancel_watch: Dict[str, Tuple[str, threading.Event]] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.ticks = 0

    # -- tick ---------------------------------------------------------------

    def tick(self) -> int:
        """One autonomy tick; returns the number of tasks dispatched."""
        self.ticks += 1
        # 1. decompose pending goals
        for goal in self.engine.list_goals(status_filter="pending"):
            self.engine.set_goal_status(goal.id, "planning")
            try:
                tasks = self.planner.decompose_goal(goal)
                self.engine.add_tasks(goal.id, tasks)
            except Exception as exc:  # noqa: BLE001
                log.error("decomposition failed for %s: %s", goal.id, exc)
                self.engine.set_goal_status(goal.id, "failed")

        # 2. pick unblocked tasks and dispatch through the ladder
        dispatched = 0
        for task in self.engine.unblocked_pending_tasks(
            limit=self.config.max_tasks_per_tick
        ):
            with self._lock:
                if task.id in self._in_flight:
                    continue
                self._in_flight.add(task.id)
            self._dispatch(task)
            dispatched += 1

        # 3. housekeeping
        self.run_housekeeping()
        return dispatched

    def _dispatch(self, task: Task) -> None:
        # ladder step 1: a live registered agent that covers the namespaces
        agent_id = self.router.route_task(task)
        if agent_id is not None:
            self.engine.set_task_status(task.id, "assigned", agent=agent_id)
            self.decisions.log(Decision(
                context=f"dispatch {task.description[:60]}",
                options=["agent", "cluster", "heuristic", "ai"],
                chosen=f"agent:{agent_id}",
                reasoning="capable live agent available",
            ))
            with self._lock:
                self._in_flight.discard(task.id)
            return

        # ladder step 2: cluster spillover
        if cluster_enabled() and self.cluster is not None:
            node = self.cluster.least_loaded()
            if node is not None:
                try:
                    self.remote.submit_remote_goal(
                        node.address, task.description,
                    )
                    self.engine.complete_task(
                        task.id, output={"delegated_to_node": node.node_id}
                    )
                    self.decisions.log(Decision(
                        context=f"dispatch {task.description[:60]}",
                        options=["cluster", "heuristic", "ai"],
                        chosen=f"cluster:{node.node_id}",
                        reasoning="no local agent; least-loaded node",
                    ))
                    with self._lock:
                        self._in_flight.discard(task.id)
                    return
                except Exception as exc:  # noqa: BLE001
                    log.warning("cluster spillover failed: %s", exc)

        # ladder step 3: heuristics (no AI)
        calls = heuristic_tool_calls(task)
        if calls is not None:
            self.engine.set_task_status(task.id, "in_progress")
            self._pool.submit(self._run_heuristic, task, calls)
            return

        # ladder step 4: AI reasoning loop
        self.engine.set_task_status(task.id, "in_progress")
        self._pool.submit(self._run_reasoning_guarded, task)

    # -- heuristic path -----------------------------------------------------

    def _run_heuristic(self, task: Task, calls: List[dict]) -> None:
        try:
            results, any_failure = self._execute_calls(task, calls)
            if any_failure:
                error = "; ".join(
                    r.get("error", "") for r in results if not r.get("success")
                )
                self._record_failure(task, f"heuristic tool failure: {error}")
            else:
                self._record_success(task, {"tool_results": results},
                                     model="heuristic")
        finally:
            with self._lock:
                self._in_flight.discard(task.id)

    # -- AI reasoning loop --------------------------------------------------

    def _run_reasoning_guarded(self, task: Task) -> None:
        with self._ai_semaphore:  # Semaphore(3), autonomy.rs:376,632
            try:
                self.run_reasoning_loop(task)
            except Exception as exc:  # noqa: BLE001
                log.exception("reasoning loop crashed for %s", task.id)
                self._record_failure(task, f"reasoning loop error: {exc}")
            finally:
                with self._lock:
                    self._in_flight.discard(task.id)

    def _ai_infer(
        self, prompt: str, level: str, json_schema: str = "",
        cancel_event=None,
    ) -> Optional[str]:
        """gateway (preferred qwen3) -> runtime fallback chain.

        Every call carries the per-level reasoning token budget
        (TOKEN_BUDGETS; autonomy.rs:596-607 enforces 2048/2048/8192/16384
        max_tokens by level) — backends forward it as the InferRequest /
        ApiInferRequest max_tokens field. Two-arg backends (legacy tests,
        simple fakes) are still accepted. ``cancel_event`` aborts an
        in-flight inference when its goal is cancelled (no fallback then —
        a deliberate abort is not a backend failure).
        """
        budget = TOKEN_BUDGETS.get(level, TOKEN_BUDGETS[OPERATIONAL])
        for backend in (self.gateway_infer, self.runtime_infer):
            if backend is None:
                continue
            try:
                return _call_with_budget(
                    backend, prompt, level, budget, json_schema,
                    cancel_event=cancel_event,
                )
            except InferenceCancelled:
                return None
            except Exception as exc:  # noqa: BLE001
                log.warning("AI backend failed: %s", exc)
                continue
        return None

    def _catalog(self) -> List[str]:
        if self.tool_catalog is not None:
            try:
                catalog = self.tool_catalog()
                if catalog:
                    return catalog
            except Exception:  # noqa: BLE001
                pass
        return STATIC_TOOL_CATALOG  # autonomy.rs:1039-1055

    def _build_prompt(self, task: Task, round_results: List[dict],
                      round_idx: int, catalog: Optional[List[str]] = None) -> str:
        parts = [
            "You are the aiOS autonomy loop executing a system task.",
            f"Task: {task.description}",
            f"Intelligence level: {task.intelligence_level}",
        ]
        if self.memory_context is not None:
            try:
                ctx = self.memory_context(task.description, 512)
                if ctx:
                    parts.append(f"Relevant memory:\n{ctx}")
            except Exception:  # noqa: BLE001
                pass
        history = self.engine.messages_for_goal(task.goal_id, limit=6)
        if history:
            rendered = "\n".join(f"{m.role}: {m.content[:300]}" for m in history)
            parts.append(f"Conversation so far:\n{rendered}")
        parts.append(
            "Available tools: " + ", ".join(catalog or self._catalog())
        )
        if round_results:
            rendered = json.dumps(round_results)[:TOOL_RESULT_TRUNCATE * 3]
            parts.append(
                "Results of your previous tool calls (truncated):\n" + rendered
            )
            parts.append(
                'Continue the task, or finish with {"done": true, "thought": "<final answer>"}.'
            )
        parts.append(TOOL_CALL_FORMAT)
        return "\n\n".join(parts)

    def notify_goal_cancelled(self, goal_id: str) -> None:
        """CancelGoal hook: abort any IN-FLIGHT AI inference working for
        the dead goal right now (the between-rounds is_abandoned check
        only stops FUTURE rounds; this stops the current one)."""
        with self._lock:
            events = [
                ev for gid, ev in self._cancel_watch.values()
                if gid == goal_id
            ]
        for ev in events:
            ev.set()

    def run_reasoning_loop(self, task: Task) -> None:
        """Multi-round observe->think->act (autonomy.rs:100-224)."""
        cancel_event = threading.Event()
        with self._lock:
            self._cancel_watch[task.id] = (task.goal_id, cancel_event)
        try:
            self._run_reasoning_rounds(task, cancel_event)
        finally:
            with self._lock:
                self._cancel_watch.pop(task.id, None)

    def _run_reasoning_rounds(
        self, task: Task, cancel_event: threading.Event
    ) -> None:
        level = task.intelligence_level or OPERATIONAL
        max_rounds = MAX_ROUNDS.get(level, 1)
        all_results: List[dict] = []
        made_any_call = False
        final_thought = ""

        guided = guided_toolcalls()
        for round_idx in range(max_rounds):
            if self.engine.is_abandoned(task.id, task.goal_id):
                # the goal was cancelled (or the task externally
                # terminated) between rounds: stop burning AI tokens and
                # executing tools for a dead goal — a strategic task would
                # otherwise run up to 5 more rounds against its 16k budget
                log.info(
                    "reasoning loop for task %s stops: goal %s is "
                    "cancelled/terminal", task.id, task.goal_id,
                )
                return
            # ONE catalog fetch per round, shared by the schema enum and
            # the prompt's tool list (plugin.create can add tools
            # mid-loop; the enum must match what the prompt advertises)
            catalog = self._catalog()
            schema_json = (
                json.dumps(toolcalls_schema(catalog)) if guided else ""
            )
            prompt = self._build_prompt(task, all_results, round_idx, catalog)
            reply = self._ai_infer(prompt, level, schema_json,
                                   cancel_event=cancel_event)
            if reply is None:
                if self.engine.is_abandoned(task.id, task.goal_id):
                    # the in-flight inference was ABORTED by CancelGoal
                    # (notify_goal_cancelled), not a backend failure
                    return
                self._record_failure(task, "no AI backend available")
                return

            calls, done, thought = parse_tool_calls(reply)
            if not calls and not done and thought == "":
                # malformed reply: one JSON self-correction round
                # (autonomy.rs:290-328)
                correction = (
                    "Your previous reply was not valid JSON.\n"
                    f"Previous reply:\n{reply[:800]}\n\n" + TOOL_CALL_FORMAT
                )
                reply = self._ai_infer(correction, level, schema_json,
                                       cancel_event=cancel_event)
                if reply is None:
                    if self.engine.is_abandoned(task.id, task.goal_id):
                        return
                    self._record_failure(task, "no AI backend available")
                    return
                calls, done, thought = parse_tool_calls(reply)

            if thought:
                final_thought = thought

            if cancel_event.is_set():
                # the cancel raced the reply's arrival (result landed in
                # the same poll window): do NOT execute this round's tool
                # calls — they may side-effect (fs.write, email, plugins)
                # for a goal the user just killed
                return

            if calls:
                made_any_call = True
                results, any_failure = self._execute_calls(task, calls)
                all_results.extend(results)
                if any_failure:
                    # ANY tool failure fails the task (autonomy.rs:2488-2528)
                    error = "; ".join(
                        r.get("error", "") for r in results if not r.get("success")
                    )
                    self._record_failure(task, f"tool call failed: {error}")
                    return

            if done:
                break

        if not made_any_call:
            # zero tool calls across all rounds -> awaiting input
            self._record_awaiting_input(task, final_thought)
            return

        self._record_success(
            task,
            {"tool_results": all_results[-10:], "answer": final_thought},
            model="ai",
        )

    def _execute_calls(
        self, task: Task, calls: List[dict]
    ) -> Tuple[List[dict], bool]:
        results = []
        any_failure = False
        for call in calls[:10]:
            tool = call.get("tool", "")
            args = call.get("args", {}) or {}
            try:
                res = self.execute_tool(tool, "autonomy-loop", args)
            except Exception as exc:  # noqa: BLE001
                res = {"success": False, "output": {}, "error": str(exc)}
            ok = bool(res.get("success"))
            any_failure = any_failure or not ok
            out = json.dumps(res.get("output", {}))[:TOOL_RESULT_TRUNCATE]
            results.append(
                {"tool": tool, "success": ok, "output": out,
                 "error": res.get("error", "")}
            )
        return results, any_failure

    # -- result recording (autonomy.rs record_ai_result:2380-2583) ----------

    def _record_success(self, task: Task, output: dict, model: str) -> None:
        self.engine.complete_task(task.id, output=output)
        self.engine.add_message(
            task.goal_id, "assistant",
            str(output.get("answer") or f"completed: {task.description[:80]}"),
        )
        self.aggregator.record(
            task.goal_id,
            TaskOutcome(task_id=task.id, success=True, output=output,
                        model_used=model),
        )
        self.engine.check_goal_completion(task.goal_id)

    def _record_failure(self, task: Task, error: str) -> None:
        self.engine.set_task_status(task.id, "failed", error=error)
        self.aggregator.record(
            task.goal_id,
            TaskOutcome(task_id=task.id, success=False, error=error),
        )
        self.engine.check_goal_completion(task.goal_id)

    def _record_awaiting_input(self, task: Task, question: str) -> None:
        """Zero tool calls -> ask the user; 3 strikes then fail."""
        n_assistant = self.engine.count_messages(task.goal_id, role="assistant")
        if n_assistant >= MAX_AI_MESSAGES:
            self._record_failure(
                task, "no actionable tool calls after repeated attempts"
            )
            return
        self.engine.add_message(
            task.goal_id, "assistant",
            question or f"Need more information to proceed with: {task.description}",
        )
        self.engine.set_metadata(task.goal_id, "awaiting_input", True)
        self.engine.set_task_status(task.id, "pending")  # retried after reply

    # -- housekeeping (autonomy.rs:695-733) ---------------------------------

    def run_housekeeping(self) -> None:
        for agent in self.router.dead_agents():
            for task in self.router.requeue_from(agent.agent_id):
                self.engine.set_task_status(task.id, "pending")
                log.info("requeued task %s from dead agent %s", task.id,
                         agent.agent_id)
        # tasks assigned to agents that died mid-flight
        for task in list(self.engine.tasks.values()):
            if task.status == "assigned" and task.assigned_agent:
                agent = self.router.get(task.assigned_agent)
                if agent is None or not agent.alive:
                    self.engine.set_task_status(task.id, "pending")
        for goal in self.engine.active_goals():
            self.engine.check_goal_completion(goal.id)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        def loop():
            while not self._stop.wait(self.config.tick_interval):
                try:
                    self.tick()
                except Exception:  # noqa: BLE001
                    log.exception("autonomy tick failed")

        self._thread = threading.Thread(target=loop, name="autonomy-loop",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        self._pool.shutdown(wait=False)
