"""``python -m repro_torch.analysis`` — run every static pass over the port.

Exit status: 0 clean, 1 unsuppressed findings, 2 internal error (the
reference's). It needs no card: lint is pure AST, the tiles are
arithmetic, and the contracts run each step at SMOKE size on the plain
backend (and on ``"cuda"`` too where a card is present).

    python -m repro_torch.analysis                  # lint src + tiles + contracts
    python -m repro_torch.analysis path/to/file.py  # lint specific paths only
    python -m repro_torch.analysis --no-contracts   # skip the zoo's steps
    python -m repro_torch.analysis --archs granite-3-8b gemma2-2b
    python -m repro_torch.analysis --hbm-budget-mb 512   # + a decode step's bytes
    python -m repro_torch.analysis --list-rules
"""
from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.analysis import contracts, rules, tiles

DEFAULT_LINT_PATHS = ("src/repro_torch",)


def main(argv=None) -> int:
    try:
        return _main(argv)
    except SystemExit:
        raise
    except Exception as e:  # noqa: BLE001 — exit 2: the checker itself failed
        print(f"internal error: {e!r}", file=sys.stderr)
        return 2


def _main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repo-specific static contract checker "
                    "(lint + serving-step contracts + tuning-table tiles)",
    )
    parser.add_argument(
        "paths", nargs="*",
        help=f"files/dirs to lint (default: {', '.join(DEFAULT_LINT_PATHS)})",
    )
    parser.add_argument("--no-lint", action="store_true")
    parser.add_argument("--no-contracts", action="store_true")
    parser.add_argument("--no-tiles", action="store_true")
    parser.add_argument(
        "--archs", nargs="+", default=None,
        help="zoo archs for the contract pass (default: every "
             "decoder-only arch)",
    )
    parser.add_argument(
        "--backends", nargs="+",
        default=("torch", "cuda") if torch.cuda.is_available() else ("torch",),
        help="engine backends to run the contracts under (default: torch, "
             "and cuda where a card is present)",
    )
    parser.add_argument(
        "--hbm-budget-mb", type=float, default=None,
        help="optionally fail if an arch's eager decode step moves more "
             "than this many MB through its kernel calls "
             "(roofline/cost.py's counts)",
    )
    parser.add_argument("--list-rules", action="store_true")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rid, summary in sorted(rules.RULES.items()):
            print(f"{rid}  {summary}")
        return 0

    failed = False

    if not args.no_lint:
        lint_paths = args.paths or list(DEFAULT_LINT_PATHS)
        findings = rules.lint_paths(lint_paths)
        for f in findings:
            print(f)
        n_files = sum(1 for _ in rules.iter_python_files(lint_paths))
        print(f"lint: {len(findings)} finding(s) over {n_files} file(s)")
        failed |= bool(findings)

    if not args.no_tiles:
        tfindings = tiles.validate_tuning_tables()
        for f in tfindings:
            print(f)
        n_tables = len(tiles.discover_tables())
        print(f"tiles: {len(tfindings)} finding(s) over {n_tables} table(s) "
              "+ csrc constants + shared memory + selection sweep")
        failed |= bool(tfindings)

    if not args.no_contracts:
        budget = (
            args.hbm_budget_mb * 1e6 if args.hbm_budget_mb is not None
            else None
        )
        violations, checked = contracts.check_zoo(
            backends=tuple(args.backends), archs=args.archs,
            hbm_budget_bytes=budget,
        )
        for v in violations:
            print(v)
        print(f"contracts: {len(violations)} violation(s) over {checked} "
              "(arch, backend/variant) cells "
              f"x {len(contracts.STEP_KINDS)} step kinds")
        failed |= bool(violations)

    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
