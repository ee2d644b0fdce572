"""repro_torch.analysis — the repo-native static-analysis layer.

Four passes, each runnable standalone or together via
``python -m repro_torch.analysis`` (CI runs ``--strict``, which also fails on
stale ignore comments):

- ``rules``  — layering & invariant linter over ``src/repro_torch/core/``
  (REPRO-TIME / REPRO-LAYER / REPRO-SESSION / REPRO-EXCEPT).
- ``locks``  — lock-order race detector: static acquisition-graph cycle
  check with transitive same-module call resolution, plus a runtime half
  (``repro_torch.analysis.runtime``) active during
  ``ANALYSIS_INSTRUMENT=1 gateway --smoke`` (LOCK-ORDER / LOCK-SELF /
  LOCK-BLOCK / PARKED-HOLDER).
- ``schema`` — wire-schema exhaustiveness checker (SCHEMA-*), including
  the SCHEMA-MC cross-check that every wire type is modeled by the model
  checker.
- ``mc``     — bounded explicit-state model checker (``repro_torch.analysis.mc``,
  opt-in via ``--mc``): exhaustive exploration of real sessions against a
  real endpoint under message reordering, drops/dups, lease expiry,
  crash/rejoin, and heartbeat/release races, checking the invariant
  catalog and shrinking any counterexample to a replayable trace (MC-*).

Rule catalog and how-to: docs/analysis.md. Findings can be excused in
place with ``# analysis: ignore[RULE-ID]``.
"""
from repro_torch.analysis.base import Violation
from repro_torch.analysis.runtime import Analysis, MonitoredLock

__all__ = ["Violation", "Analysis", "MonitoredLock"]
