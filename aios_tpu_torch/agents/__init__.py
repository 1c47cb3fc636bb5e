"""The Python agent framework + the 10 system agents.

Reference: agent-core/python/aios_agent/ (SURVEY.md section 2.2). The
reference README claims 8 agents; the actual set is these 10
(agents/__init__.py:5-27 in the reference) — preserved here.
"""

AGENT_TYPES = [
    "system",
    "network",
    "security",
    "package",
    "monitoring",
    "learning",
    "storage",
    "task",
    "web",
    "creator",
]


def agent_class(agent_type: str):
    """Resolve an agent type name to its class (lazy imports)."""
    from . import catalog

    return catalog.CLASSES[agent_type]
