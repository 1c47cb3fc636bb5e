"""CLI: ``python -m aios_tpu_torch.analysis`` — run the concurrency &
dispatch-discipline rules over the tree.

Exit status 1 when any UNWAIVED finding remains (waived findings print
with their justification but never fail the run). The tier-1 test
(``tests/test_torch_analysis.py::test_tree_is_clean``) calls
:func:`main` directly, so CI and local runs cannot diverge.

    python -m aios_tpu_torch.analysis              # human-readable report
    python -m aios_tpu_torch.analysis --json       # machine-readable findings
    python -m aios_tpu_torch.analysis --rule lock-order --rule guarded-by
    python -m aios_tpu_torch.analysis --list-rules
    python -m aios_tpu_torch.analysis --waived     # include waived findings
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Sequence

from .rules import RULE_IDS, run_analysis


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m aios_tpu_torch.analysis",
        description="static concurrency/dispatch-discipline analyzer "
                    "(rule catalog: the aios_tpu_torch.analysis docstring)",
    )
    parser.add_argument(
        "--rule", action="append", dest="rules", metavar="RULE",
        choices=RULE_IDS,
        help="run only this rule (repeatable); default: all",
    )
    parser.add_argument(
        "--json", action="store_true",
        help="emit findings as a JSON array",
    )
    parser.add_argument(
        "--waived", action="store_true",
        help="also print waived findings (always included in --json)",
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="print rule ids and exit",
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        for r in RULE_IDS:
            print(r)
        return 0

    findings = run_analysis(rules=args.rules)
    unwaived = [f for f in findings if not f.waived]
    waived = [f for f in findings if f.waived]

    if args.json:
        print(json.dumps([f.as_dict() for f in findings], indent=2))
    else:
        for f in unwaived:
            print(f.render())
        if args.waived:
            for f in waived:
                print(f"{f.render()}  # {f.waive_reason}")
        print(
            f"aios_tpu_torch.analysis: {len(unwaived)} finding(s), "
            f"{len(waived)} waived",
            file=sys.stderr,
        )
    return 1 if unwaived else 0


if __name__ == "__main__":
    raise SystemExit(main())
