"""concheck — lock-discipline static analysis for the port's async fleet.

Usage:
    python -m repro_torch.analysis.concheck [PATH ...] [--graph-out FILE] [--verbose]

Checks every ``.py`` file under the given paths (default: the
``repro_torch`` package, ``src/repro_torch``) with the rules in
``repro_torch.analysis.static_check`` and exits 1 if any violation is
found, 0 otherwise.  ``--graph-out`` writes the extracted static
lock-acquisition graph as JSON.

Waive a finding inline with a reasoned ``# concheck: disable=<rule>`` on the
offending line.  Rules: guarded-by, lock-order, blocking-under-lock,
cond-wait-loop, thread-join, busy-wait.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.analysis.static_check import RULES, check_paths

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*", default=[PACKAGE_DIR],
                    help="files/directories to check (default: src/repro_torch)")
    ap.add_argument("--graph-out", metavar="FILE", default=None,
                    help="write the static lock-order graph JSON here")
    ap.add_argument("--verbose", action="store_true",
                    help="also print the lock graph and per-rule counts")
    args = ap.parse_args(argv)

    result = check_paths(args.paths)

    if args.graph_out:
        with open(args.graph_out, "w", encoding="utf-8") as fh:
            json.dump(result.graph, fh, indent=2, sort_keys=True)
        print(f"concheck: lock graph ({len(result.graph['nodes'])} locks, "
              f"{len(result.graph['edges'])} edges) -> {args.graph_out}")

    if args.verbose:
        print("lock-order edges:")
        for e in result.graph["edges"]:
            print(f"  {e['from']} -> {e['to']}   ({e['at']})")
        counts = {r: 0 for r in RULES}
        for v in result.violations:
            counts[v.rule] = counts.get(v.rule, 0) + 1
        print("rule hits:", {k: v for k, v in counts.items() if v})

    for v in result.violations:
        print(str(v))

    if result.violations:
        print(f"concheck: {len(result.violations)} violation(s)")
        return 1
    print("concheck: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
