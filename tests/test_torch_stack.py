"""The port's full service plane on the CPU: memory, tools, the runtime
(``synthetic://tiny-test`` on the plain PyTorch path), the gateway's local
provider and the orchestrator with a live autonomy loop, wired over real
localhost gRPC in one process, as ``chip_smoke.phase_stack`` builds it on the
card (the same helpers). The scenarios of ``tests/test_e2e.py`` run here in
the fast tier (the port's CPU engine compiles nothing), and so does the
guided reasoning goal: every reply the runtime's constrained decoding gives
parses, and its tool calls run over the tools gRPC."""

import json
import os
import subprocess

import pytest
import torch

import chip_smoke
from aios_tpu_torch.proto_gen import common_pb2, memory_pb2

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOAL_DEADLINE = 60.0  # seconds any goal here may take to be terminal


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    from aios_tpu_torch.runtime.model_manager import ModelManager

    tmp = tmp_path_factory.mktemp("torch-stack")
    with pytest.MonkeyPatch.context() as mp:
        def setenv(k, v):
            if v is None:
                mp.delenv(k, raising=False)
            else:
                mp.setenv(k, v)

        manager = ModelManager(num_slots=2, device="cpu")
        st = chip_smoke.Stack(str(tmp), manager, setenv)
        st.timeout = GOAL_DEADLINE
        try:
            st.start()
            # the reasoning prompt (catalog, format, history) needs the room
            st.model = st.load("synthetic://tiny-test", context_length=2048)
            yield st
        finally:
            st.stop()
            manager.close()


def test_registry_holds_only_read_only_tools(stack):
    assert sorted(stack.executor.registry) == sorted(chip_smoke.READ_ONLY_TOOLS)
    assert all(spec.idempotent for spec in stack.executor.registry.values())


def test_heuristic_goal_end_to_end(stack):
    """goal -> planner -> autonomy heuristic -> real tools gRPC -> completed."""
    p50 = chip_smoke.stack_heuristic(stack, n=3)
    assert 0 < p50 < GOAL_DEADLINE * 1e3


def test_agent_routed_goal_end_to_end(stack):
    """A live SystemAgent thread polls, executes via tools, reports back."""
    assert chip_smoke.stack_agent(stack) > 0


def test_runtime_infer_through_gateway(stack):
    """The gateway's local provider reaches the port's runtime (Infer and
    StreamInfer), beside direct runtime Infers of the same prompts."""
    out = chip_smoke.stack_infer(stack, n=2)
    assert out["direct_p50"] > 0 and out["gateway_p50"] > 0
    assert out["stream_chunks"] >= 1


def test_memory_accumulates_tool_calls(stack):
    stack.memory.UpdateMetric(memory_pb2.MetricUpdate(key="e2e.alive", value=1.0))
    got = stack.memory.GetMetric(memory_pb2.MetricRequest(key="e2e.alive"))
    assert got.value == 1.0
    # the goals above ran tools through the registry: its audit chain holds them
    assert stack.executor.audit.count() > 0
    assert stack.executor.audit.verify_chain() == (True, None)


def test_runtime_lists_the_stack_model(stack):
    models = stack.runtime.ListModels(common_pb2.Empty())
    assert [m.model_name for m in models.models] == [chip_smoke.STACK_MODEL]
    health = stack.runtime.HealthCheck(common_pb2.Empty())
    assert health.details["backend"] == "torch-cpu"


def test_guided_reasoning_goal_replies_parse(stack):
    g = chip_smoke.stack_guided(stack, stack.model)
    assert g["status"] in chip_smoke.TERMINAL_GOAL
    assert g["rounds"] >= 1 and g["runtime_calls"] == g["rounds"]
    # every reply came through the masked step (and jumps) of the batcher
    assert g["masked_steps"] + g["jumps"] > 0
    assert os.environ.get("AIOS_TPU_GUIDED_TOOLCALLS") is None


def test_console_answers(stack):
    out = chip_smoke.stack_console(stack)
    assert "active_goals" in out["status"]
    assert chip_smoke.STACK_MODEL in out["serving"]["models"]


def test_aiosctl_smoke_against_live_stack(stack):
    """The operator CLI against the port's stack: every service up, the
    runtime's counters through the console, submit + cancel round-trip."""
    env = dict(
        os.environ,
        AIOS_CONSOLE=f"http://127.0.0.1:{stack.console.bound_port}",
        **{f"AIOS_{n.upper()}_ADDR": f"127.0.0.1:{p}" for n, p in stack.ports.items()},
    )
    ctl = os.path.join(ROOT, "scripts", "aiosctl.sh")

    def run(*args):
        r = subprocess.run(["bash", ctl, *args], env=env, capture_output=True, text=True,
                           timeout=30)
        assert r.returncode == 0 or args[0] == "cancel", r.stdout + r.stderr
        return r

    lines = run("status").stdout.strip().splitlines()
    assert len(lines) == 6 and all(line.endswith(" up") for line in lines), lines
    payload = json.loads(run("serving").stdout)
    assert payload["models"][chip_smoke.STACK_MODEL]["num_slots"] == 2.0
    assert json.loads(run("health").stdout.strip().splitlines()[0])["healthy"] is True
    goal_id = json.loads(run("submit", "aiosctl cancel-me goal").stdout)["goal_id"]
    cancelled = run("cancel", goal_id)
    if cancelled.returncode == 0:
        assert json.loads(cancelled.stdout)["cancelled"] is True
    # the goal may end before the cancel lands; either way it is terminal
    st = stack.orch.GetGoalStatus(common_pb2.GoalId(id=goal_id))
    assert st.goal.status in chip_smoke.TERMINAL_GOAL
