"""CLI: ``python -m repro_torch.analysis [paths...]``.

Exit status 0 iff every finding is pragma-annotated (``# sync:`` /
``# dtype:`` / ``# det:`` with a non-empty reason). Suppressed findings
are listed with ``-v`` for auditing; parse errors and empty-reason
pragmas always fail.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.analysis import all_checkers, run_analysis


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static sync/dtype/determinism analysis of the port")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files or directories to check (default: "
                         "src/repro_torch)")
    ap.add_argument("--checkers", default=",".join(all_checkers()),
                    help="comma-separated subset: sync,dtype,det")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="also list pragma-suppressed findings")
    args = ap.parse_args(argv)

    names = [c.strip() for c in args.checkers.split(",") if c.strip()]
    unknown = set(names) - set(all_checkers())
    if unknown:
        ap.error(f"unknown checkers: {sorted(unknown)} "
                 f"(expected a subset of {sorted(all_checkers())})")

    active, suppressed, errors = run_analysis(
        args.paths or ["src/repro_torch"], checkers=names)
    for f in errors:
        print(f.format())
    for f in active:
        print(f.format())
    if args.verbose:
        for f in suppressed:
            print(f"{f.format()}  [suppressed by pragma]")
    print(f"repro_torch.analysis: {len(active)} finding(s), "
          f"{len(suppressed)} pragma-annotated, {len(errors)} error(s)",
          file=sys.stderr)
    return 1 if (active or errors) else 0


if __name__ == "__main__":
    sys.exit(main())
