"""Bounded explicit-state exploration (DFS) over an ``MCWorld``.

The explorer expands every enabled action of every reached state, branching
by capture/restore (each edge therefore also exercises the snapshot/restore
recovery path), dedups via the canonical fingerprint, and checks the
invariant catalog so that every concrete generated state is covered:
history-dependent invariants (whose inputs — the applied/commit logs — the
fingerprint deliberately excludes) run on every transition BEFORE dedup can
prune it; state-based invariants run once per new state, which covers every
deduped duplicate by proxy because the fingerprint includes all of their
inputs; the wire-codec round-trip probe is sampled. Violations are recorded
with the exact action trace that reached them.

Termination classification per path:

- **complete**   — ``ds.latest_version`` reached the policy's update target.
- **stranded**   — no progress action enabled, but some parked volunteer's
  wait condition already holds (a wake was eaten by an injected fault); the
  real engines recover this with timed waits — not a protocol bug.
- **fleet-exhausted** — every volunteer crashed/left/retired; the server
  correctly waits for volunteers that will never come. Not a protocol bug.
- **deadlock**   — none of the above: live parked volunteers, nothing
  enabled, conditions unmet. Reported as a ``deadlock-freedom`` violation.

Budgets (states / depth / wall seconds) bound the search; hitting one is
recorded in the stats (``truncated``) so CI output never silently passes off
a partial search as exhaustive.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from repro_torch.analysis.mc.fingerprint import fingerprint, raw_fingerprint
from repro_torch.analysis.mc.invariants import DEADLOCK, Invariant, check_all
from repro_torch.analysis.mc.world import MCConfig, MCWorld

Action = Tuple[str, ...]

# Invariants over state the fingerprint fully includes (queues, waiters,
# watches, driver/session views): two states that dedup to the same
# fingerprint agree on every input of these predicates, so checking them
# once per NEW state checks them on every generated state by proxy.
_STATE_BASED = frozenset({"ticket-conservation", "no-lost-wake"})
# The wire round-trip probe is a pure self-check of the codec (no protocol
# state feeds it that the others miss) — sampled every Nth new state.
_SAMPLED = frozenset({"snapshot-durability"})
_SAMPLE_EVERY = 8


def _split(invariants: List[Invariant]):
    """(every-transition, per-new-state, sampled). History-dependent
    invariants (the applied/commit logs are deliberately NOT in the
    fingerprint) and any caller-supplied invariant default to the
    every-transition bucket — the sound choice."""
    fast = [i for i in invariants
            if i.name not in _STATE_BASED and i.name not in _SAMPLED]
    slow = [i for i in invariants if i.name in _STATE_BASED]
    sampled = [i for i in invariants if i.name in _SAMPLED]
    return fast, slow, sampled


@dataclass
class Violation:
    invariant: str
    message: str
    trace: Tuple[Action, ...]


@dataclass
class MCStats:
    states: int = 1             # distinct states stored (root included)
    transitions: int = 0        # concrete actions executed
    dedup_hits: int = 0         # successors merged into a visited state
    symmetry_hits: int = 0      # ...of which only by volunteer relabeling
    por_skipped: int = 0        # non-head note fates not branched (POR)
    max_depth: int = 0
    completes: int = 0
    stranded: int = 0
    fleet_exhausted: int = 0
    truncated: bool = False
    elapsed: float = 0.0

    @property
    def states_per_sec(self) -> float:
        return self.states / self.elapsed if self.elapsed > 0 else 0.0

    @property
    def reduction_factor(self) -> float:
        """Merged-or-skipped successors per stored state — how much smaller
        the stored graph is than the raw interleaving tree."""
        saved = self.dedup_hits + self.por_skipped
        return (self.states + saved) / self.states if self.states else 1.0


@dataclass
class MCReport:
    config: MCConfig
    stats: MCStats
    violations: List[Violation] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations


def explore(cfg: MCConfig, *,
            invariants: Optional[List[Invariant]] = None,
            max_states: int = 20000,
            max_depth: int = 60,
            max_seconds: float = 30.0,
            first_violation: bool = True,
            world: Optional[MCWorld] = None) -> MCReport:
    invariants = cfg.default_invariants() if invariants is None else invariants
    fast, slow, sampled = _split(invariants)
    # a caller-provided world lets tests inspect exploration-global state
    # afterwards (e.g. ``sent_types``, the wire-coverage ledger)
    world = cfg.make_world() if world is None else world
    stats = MCStats()
    report = MCReport(cfg, stats)
    t0 = time.perf_counter()

    def record(name: str, msg: str, trace: Tuple[Action, ...]) -> None:
        report.violations.append(Violation(name, msg, trace))

    root_violation = check_all(world, invariants)
    if root_violation is not None:
        record(root_violation[0], root_violation[1], ())
        if first_violation:
            stats.elapsed = time.perf_counter() - t0
            return report

    track_raw = world.symmetry_possible()
    visited = {fingerprint(world)}
    raw_seen = {raw_fingerprint(world)} if track_raw else set()
    # stack of (capture, depth, trace); the capture is the parent state
    stack = [(world.capture(), 0, ())]

    while stack:
        if stats.states >= max_states or \
                time.perf_counter() - t0 > max_seconds:
            stats.truncated = True
            break
        cap, depth, trace = stack.pop()
        world.restore(cap)
        actions = world.enabled_actions()
        if not world.progress_possible(actions):
            if world.fleet_exhausted():
                stats.fleet_exhausted += 1
            elif world.poll_ready():
                stats.stranded += 1
            else:
                record(DEADLOCK,
                       "run incomplete, no action enabled, no parked "
                       "volunteer's wait condition satisfied "
                       f"(volunteers: {[world.drivers[v].state for v in world.vids]})",
                       trace)
                if first_violation:
                    break
            continue
        # POR accounting: only the head pending note's fate is branched;
        # the other queued notifications' fates are deferred, not explored
        stats.por_skipped += max(0, len(world.pending) - 1) * \
            (1 + (world.drops < cfg.max_drops) + (world.dups < cfg.max_dups))
        for action in actions:
            world.restore(cap)
            try:
                world.apply(action)
            except AssertionError as e:
                record("internal-assertion",
                       f"protocol assertion failed on {action}: {e}",
                       trace + (action,))
                if first_violation:
                    stack.clear()
                    break
                continue
            stats.transitions += 1
            v = check_all(world, fast)
            if v is not None:
                record(v[0], v[1], trace + (action,))
                if first_violation:
                    stack.clear()
                    break
                continue
            fp = fingerprint(world)
            if fp in visited:
                stats.dedup_hits += 1
                if track_raw:
                    raw = raw_fingerprint(world)
                    if raw not in raw_seen:
                        stats.symmetry_hits += 1
                        raw_seen.add(raw)
                continue
            visited.add(fp)
            if track_raw:
                raw_seen.add(raw_fingerprint(world))
            stats.states += 1
            stats.max_depth = max(stats.max_depth, depth + 1)
            v = check_all(world, slow)
            if v is None and sampled and stats.states % _SAMPLE_EVERY == 0:
                v = check_all(world, sampled)
            if v is not None:
                record(v[0], v[1], trace + (action,))
                if first_violation:
                    stack.clear()
                    break
                continue
            if world.complete():
                stats.completes += 1
                continue
            if depth + 1 >= max_depth:
                stats.truncated = True
                continue
            stack.append((world.capture(), depth + 1, trace + (action,)))

    stats.elapsed = time.perf_counter() - t0
    return report
