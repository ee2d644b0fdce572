"""The ``mc`` analysis pass: bounded model checking as a CI leg.

``run_mc`` explores one bounded world per aggregation policy (or a fixture's
world) under a fixed state/depth/time budget and converts every violation
into a ``repro_torch.analysis.base.Violation`` — with the counterexample shrunk to
a 1-minimal trace and inlined as a replayable JSON payload, so a CI failure
IS the repro.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.base import Violation
from repro_torch.analysis.mc.explore import MCReport, explore
from repro_torch.analysis.mc.shrink import repro_payload, shrink
from repro_torch.analysis.mc.world import MCConfig

RULES = {
    "MC-CONSERVE": "ticket conservation broke under some interleaving",
    "MC-ADMIT": "an applied update exceeded the policy's staleness bound",
    "MC-COMMIT": "a model version slot was committed twice (or skipped)",
    "MC-WAKE": "a parked volunteer had no live wake registration",
    "MC-SNAPSHOT": "server state did not survive snapshot/restore",
    "MC-DEADLOCK": "reachable state with no enabled action, run incomplete",
    "MC-ASSERT": "a protocol assertion failed during exploration",
    "MC-OWNER": "a ring slice had zero or multiple serving gateways",
    "MC-FORWARD": "acknowledged work lost across a gateway failover",
}

_RULE_BY_INVARIANT = {
    "ticket-conservation": "MC-CONSERVE",
    "admission-soundness": "MC-ADMIT",
    "single-commit-per-slot": "MC-COMMIT",
    "no-lost-wake": "MC-WAKE",
    "snapshot-durability": "MC-SNAPSHOT",
    "deadlock-freedom": "MC-DEADLOCK",
    "internal-assertion": "MC-ASSERT",
    "single-owner-per-slice": "MC-OWNER",
    "no-lost-forward": "MC-FORWARD",
}

DEFAULT_POLICIES: Tuple[str, ...] = ("sync", "staleness:1", "local:2")


def default_config(policy: str) -> MCConfig:
    """The shipped per-policy worlds the CI leg explores: 3 volunteers, the
    full fault alphabet on a small budget — one crash with rejoin, one
    dropped notification, lease expiry live (finite visibility timeout),
    heartbeat/release races enabled."""
    if policy == "sync":
        return MCConfig(policy=policy, n_volunteers=3, n_versions=2, n_mb=2,
                        visibility_timeout=10.0, crashable=("w0",),
                        max_crashes=1, rejoin=True, max_drops=1,
                        allow_release=True, allow_heartbeat=True)
    if policy.startswith("staleness"):
        return MCConfig(policy=policy, n_volunteers=3, n_versions=2, n_mb=2,
                        visibility_timeout=10.0, crashable=("w0",),
                        max_crashes=1, rejoin=True, max_dups=1,
                        allow_release=True, allow_heartbeat=True)
    return MCConfig(policy=policy, n_volunteers=3, n_versions=2, n_mb=2,
                    visibility_timeout=10.0, leavable=("w2",), max_leaves=1,
                    max_drops=1, gc_keep=2, allow_release=True)


def _load_fixture_config(path: str) -> MCConfig:
    import importlib.util
    import pathlib
    p = pathlib.Path(path)
    spec = importlib.util.spec_from_file_location(f"mc_fixture_{p.stem}", p)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.configure()


def check_config(cfg: MCConfig, *, label: str, max_states: int,
                 max_depth: int, max_seconds: float,
                 fixture: Optional[str] = None,
                 do_shrink: bool = True) -> Tuple[List[Violation], MCReport]:
    # shallow-first: bugs in these bounded worlds sit at small depths, but a
    # DFS given a large depth budget dives down expiry-zombie tails before
    # trying the shallow fault corners — a cheap low-depth pre-pass finds
    # them whatever depth the caller configured, then the full-budget pass
    # provides the coverage the stats report
    shallow = min(16, max_depth)
    report = None
    if shallow < max_depth:
        report = explore(cfg, max_states=max_states, max_depth=shallow,
                         max_seconds=max(1.0, max_seconds / 3))
    if report is None or not report.violations:
        report = explore(cfg, max_states=max_states, max_depth=max_depth,
                         max_seconds=max_seconds)
    violations = []
    for v in report.violations:
        trace = v.trace
        if do_shrink and trace:
            trace = shrink(cfg, trace, v.invariant)
        payload = repro_payload(cfg, trace, v.invariant, v.message,
                                fixture=fixture)
        rule = _RULE_BY_INVARIANT.get(v.invariant, "MC-ASSERT")
        violations.append(Violation(
            rule, label, 0,
            f"[{v.invariant}] {v.message} — minimized {len(trace)}-step "
            f"counterexample (replay with repro_torch.core.chaos --replay): "
            f"{json.dumps(payload, separators=(',', ':'))}"))
    return violations, report


def run_mc(policies: Optional[Sequence[str]] = None, *,
           max_states: int = 4000, max_depth: int = 50,
           max_seconds: float = 12.0,
           fixture: Optional[str] = None,
           stats_out: Optional[Dict[str, Any]] = None) -> List[Violation]:
    """The analysis-driver entry point: explore each policy's default world
    (or the fixture world) within budget; return analysis Violations."""
    out: List[Violation] = []
    if fixture is not None:
        cfg = _load_fixture_config(fixture)
        violations, report = check_config(
            cfg, label=fixture, max_states=max_states, max_depth=max_depth,
            max_seconds=max_seconds, fixture=fixture)
        out.extend(violations)
        if stats_out is not None:
            stats_out[fixture] = report.stats
        return out
    for policy in (policies or DEFAULT_POLICIES):
        cfg = default_config(policy)
        violations, report = check_config(
            cfg, label=f"mc({policy})", max_states=max_states,
            max_depth=max_depth, max_seconds=max_seconds)
        out.extend(violations)
        if stats_out is not None:
            stats_out[policy] = report.stats
    return out
