"""Driver: ``python -m repro_torch.analysis [--strict] [--mc] [--only PASS ...]``.

Runs the rules / locks / schema passes (those three by default), prints
every violation as ``path:line: [RULE-ID] message``, and exits non-zero if
any fired — the CI contract. ``--strict`` additionally fails on stale
``# analysis: ignore[...]`` comments so escapes can't outlive the code they
excused. ``--mc`` (or ``--only mc``) adds the model-checking pass: bounded
exhaustive exploration of the protocol under faults, with ``--mc-policy`` /
``--mc-states`` / ``--mc-depth`` / ``--mc-seconds`` setting the budget and
``--mc-fixture`` pointing it at a fixture module's world (used by the
mutation-fixture tests to prove the checker rediscovers seeded historical
bugs). ``--paths`` / ``--doc`` point a pass at other files (used by the
fixture tests to prove each rule fires).
"""
from __future__ import annotations

import argparse
import importlib.util
import pathlib
import sys
from typing import List

from repro_torch.analysis import locks, rules, schema
from repro_torch.analysis.base import Violation


def _core_paths() -> List[pathlib.Path]:
    spec = importlib.util.find_spec("repro_torch.core")
    core = pathlib.Path(spec.origin).parent
    return sorted(core.glob("*.py"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repo-native static analysis: layering linter, "
                    "lock-order race detector, wire-schema checker")
    ap.add_argument("--strict", action="store_true",
                    help="also fail on stale ignore comments")
    ap.add_argument("--only", action="append",
                    choices=["rules", "locks", "schema", "mc"],
                    help="run only this pass (repeatable; default: "
                         "rules+locks+schema, plus mc with --mc)")
    ap.add_argument("--paths", nargs="+", default=None,
                    help="files for the rules/locks passes "
                         "(default: src/repro_torch/core/*.py)")
    ap.add_argument("--doc", default=None,
                    help="protocol doc for the schema pass "
                         "(default: docs/protocol.md)")
    ap.add_argument("--mc", action="store_true",
                    help="also run the model-checking pass")
    ap.add_argument("--mc-policy", action="append", default=None,
                    help="policy world(s) for the mc pass (repeatable; "
                         "default: sync, staleness:1, local:2)")
    ap.add_argument("--mc-states", type=int, default=4000,
                    help="mc state budget per world (default 4000)")
    ap.add_argument("--mc-depth", type=int, default=50,
                    help="mc depth budget (default 50)")
    ap.add_argument("--mc-seconds", type=float, default=12.0,
                    help="mc wall-clock budget per world (default 12)")
    ap.add_argument("--mc-fixture", default=None,
                    help="explore a fixture module's world (the module must "
                         "expose configure() -> MCConfig) instead of the "
                         "default policy worlds")
    args = ap.parse_args(argv)
    only = set(args.only or ["rules", "locks", "schema"])
    if args.mc:
        only.add("mc")

    violations: List[Violation] = []
    if "rules" in only:
        paths = args.paths or _core_paths()
        vs, stale = rules.check_paths(paths)
        violations.extend(vs)
        if args.strict:
            violations.extend(stale)
    if "locks" in only:
        violations.extend(locks.check(args.paths or locks.default_paths()))
    if "schema" in only:
        violations.extend(schema.run(doc_path=args.doc))
    if "mc" in only:
        from repro_torch.analysis.mc import run_mc
        stats = {}
        violations.extend(run_mc(
            args.mc_policy, max_states=args.mc_states,
            max_depth=args.mc_depth, max_seconds=args.mc_seconds,
            fixture=args.mc_fixture, stats_out=stats))
        for label, st in stats.items():
            print(f"# mc[{label}]: {st.states} states, "
                  f"{st.transitions} transitions, "
                  f"{st.states_per_sec:.0f} states/s, "
                  f"depth {st.max_depth}, "
                  f"reduction x{st.reduction_factor:.1f}"
                  f"{', TRUNCATED' if st.truncated else ' (exhaustive)'}")

    for v in violations:
        print(v)
    names = "+".join(sorted(only))
    if violations:
        print(f"# repro_torch.analysis [{names}]: {len(violations)} violation(s)",
              flush=True)
        return 1
    print(f"# repro_torch.analysis [{names}]: clean", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
