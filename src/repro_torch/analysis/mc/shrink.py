"""Counterexample replay, shrinking, and runnable-repro emission.

``replay`` re-executes an action trace against a fresh world, validating at
each step that the action is still enabled and checking every invariant —
deterministically, so the same trace always produces the same verdict (the
bit-determinism the regression tests assert).

``shrink`` is greedy delta-debugging over the trace: repeatedly try dropping
chunks (then single actions) and keep any candidate that still (a) stays
applicable end-to-end and (b) violates the SAME invariant. The result is
1-minimal: removing any single remaining action loses the violation.

``repro_payload`` / ``repro_script`` package a shrunk trace as JSON plus a
self-contained Python script that replays it through the chaos harness
(``repro_torch.core.chaos.replay_mc_trace``) — a violation found by exhaustive
search becomes an ordinary runnable regression artifact.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.mc.fingerprint import fingerprint
from repro_torch.analysis.mc.invariants import DEADLOCK, Invariant, check_all
from repro_torch.analysis.mc.world import MCConfig

Action = Tuple[str, ...]


class Replay:
    """Outcome of replaying one trace: the violation (if any), the step it
    fired at, and the final state fingerprint (the determinism observable)."""

    def __init__(self, violation: Optional[Tuple[str, str]], step: int,
                 final_fingerprint: bytes, applied: int):
        self.violation = violation
        self.step = step
        self.final_fingerprint = final_fingerprint
        self.applied = applied

    @property
    def invariant(self) -> Optional[str]:
        return self.violation[0] if self.violation else None

    @property
    def message(self) -> Optional[str]:
        return self.violation[1] if self.violation else None


def replay(cfg: MCConfig, trace: Sequence[Action], *,
           invariants: Optional[List[Invariant]] = None,
           check_deadlock: bool = True) -> Replay:
    """Deterministically re-execute ``trace`` from the initial state.

    Stops at the first invariant violation. A trace step that is no longer
    enabled (shrinking removed something it depended on) ends the replay
    with no violation. After the last action, the stuck/deadlock
    classification runs exactly as in the explorer, so deadlock
    counterexamples replay too.
    """
    invariants = cfg.default_invariants() if invariants is None else invariants
    world = cfg.make_world()
    v = check_all(world, invariants)
    if v is not None:
        return Replay(v, 0, fingerprint(world), 0)
    for i, action in enumerate(trace):
        action = tuple(action)
        if action not in set(world.enabled_actions()):
            return Replay(None, i, fingerprint(world), i)
        try:
            world.apply(action)
        except AssertionError as e:
            return Replay(("internal-assertion", str(e)), i + 1,
                          fingerprint(world), i + 1)
        v = check_all(world, invariants)
        if v is not None:
            return Replay(v, i + 1, fingerprint(world), i + 1)
    if check_deadlock and not world.progress_possible() and \
            not world.fleet_exhausted() and not world.poll_ready():
        return Replay((DEADLOCK, "no action enabled, run incomplete"),
                      len(trace), fingerprint(world), len(trace))
    return Replay(None, len(trace), fingerprint(world), len(trace))


def shrink(cfg: MCConfig, trace: Sequence[Action], invariant: str, *,
           invariants: Optional[List[Invariant]] = None,
           max_replays: int = 500) -> Tuple[Action, ...]:
    """Greedy ddmin: smallest sub-trace still violating ``invariant``."""
    budget = [max_replays]

    def still_fails(cand: Sequence[Action]) -> bool:
        if budget[0] <= 0:
            return False
        budget[0] -= 1
        return replay(cfg, cand, invariants=invariants).invariant == invariant

    current: List[Action] = [tuple(a) for a in trace]
    # coarse pass: drop halving-sized chunks first (fast on long traces)
    chunk = max(1, len(current) // 2)
    while chunk >= 1:
        i = 0
        while i < len(current):
            cand = current[:i] + current[i + chunk:]
            if still_fails(cand):
                current = cand
            else:
                i += chunk
        if chunk == 1:
            break
        chunk //= 2
    # fine pass: guarantee 1-minimality
    changed = True
    while changed and budget[0] > 0:
        changed = False
        for i in reversed(range(len(current))):
            cand = current[:i] + current[i + 1:]
            if still_fails(cand):
                current = cand
                changed = True
    return tuple(current)


# ---------------------------------------------------------------------------
# runnable repro artifacts
# ---------------------------------------------------------------------------

def repro_payload(cfg: MCConfig, trace: Sequence[Action], invariant: str,
                  message: str, *,
                  fixture: Optional[str] = None) -> Dict[str, Any]:
    """JSON-serializable counterexample. ``fixture`` (a path to a module
    exposing ``configure() -> MCConfig``) carries configs that embed live
    policy objects the JSON form cannot."""
    return {
        "config": cfg.to_json(),
        "fixture": fixture,
        "invariant": invariant,
        "message": message,
        "trace": [list(a) for a in trace],
    }


def load_payload_config(payload: Dict[str, Any]) -> MCConfig:
    if payload.get("fixture"):
        import importlib.util
        import pathlib
        path = pathlib.Path(payload["fixture"])
        spec = importlib.util.spec_from_file_location(path.stem, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.configure()
    return MCConfig.from_json(payload["config"])


def replay_payload(payload: Dict[str, Any], *,
                   invariants: Optional[List[Invariant]] = None) -> Replay:
    return replay(load_payload_config(payload), payload["trace"],
                  invariants=invariants)


_SCRIPT = '''#!/usr/bin/env python
"""Minimized model-checker counterexample (auto-generated).

Replays an exhaustively-found protocol violation through the chaos
harness: PYTHONPATH=src python this_script.py
"""
import json

from repro_torch.core.chaos import replay_mc_trace

PAYLOAD = json.loads(r"""
{payload}
""")

out = replay_mc_trace(PAYLOAD)
assert out.violation is not None, "counterexample no longer reproduces"
assert out.invariant == PAYLOAD["invariant"], (out.invariant, out.message)
print(f"reproduced at step {{out.step}}: [{{out.invariant}}] {{out.message}}")
'''


def repro_script(payload: Dict[str, Any]) -> str:
    return _SCRIPT.format(payload=json.dumps(payload, indent=1))
