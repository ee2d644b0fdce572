"""repro_torch.analysis — the runtime half of the repo's analysis layer.

Port of ``repro/analysis``: ``base`` (the ``Violation`` record and the
``# analysis: ignore[RULE-ID]`` escape hatch) and ``runtime`` (the lock and
parked-holder monitor that ``repro_torch.core.gateway``'s ``_make_lock`` /
``_monitor`` seam installs under ``ANALYSIS_INSTRUMENT=1``: LOCK-ORDER /
LOCK-SELF / LOCK-BLOCK / PARKED-HOLDER). The static passes of the reference
(``rules``, ``locks``, ``schema``) and its model checker (``mc``) are not
ported yet (ROADMAP Queue 1 item 5); without ``locks`` the monitor checks
runtime-against-runtime lock orders only.
"""
from repro_torch.analysis.base import Violation
from repro_torch.analysis.runtime import Analysis, MonitoredLock

__all__ = ["Violation", "Analysis", "MonitoredLock"]
