"""The orchestrator — goal engine, task planner, agent router, autonomy loop,
scheduler, event bus, proactive generator, cluster manager, console.

Reference: agent-core/src/ (SURVEY.md section 2 rows 2a-2q).
"""
