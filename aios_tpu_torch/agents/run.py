"""Agent process entry point: `python -m aios_tpu_torch.agents.run`.

Reads AIOS_AGENT_TYPE / AIOS_AGENT_NAME from the environment (set by the
spawner, agent_spawner.rs:183-190) or from --type/--name args.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--type", default=os.environ.get("AIOS_AGENT_TYPE", ""))
    parser.add_argument("--name", default=os.environ.get("AIOS_AGENT_NAME", ""))
    args = parser.parse_args()
    if not args.type:
        parser.error("agent type required (--type or AIOS_AGENT_TYPE)")

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    from . import agent_class

    cls = agent_class(args.type)
    agent = cls(name=args.name or None)
    agent.run(block=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
