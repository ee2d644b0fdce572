"""Lock-order race detector (pass "locks") — the runtime half.

The static graph (``repro_torch.analysis.locks``) proves the DECLARED acquisition
order is acyclic; this module checks the claims static analysis cannot see:
the orders threads actually take, blocking calls made while a dispatch lock
is held, and the parked-holder invariant distilled from PR 5's step-aside
deadlock.

``repro_torch.core.gateway`` creates its locks through a ``_make_lock`` seam.
With ``ANALYSIS_INSTRUMENT=1`` in the environment — which every spawned
server/volunteer subprocess inherits, so the whole ``gateway --smoke``
topology is covered — the seam returns ``MonitoredLock``s from the
process-wide ``Analysis`` singleton, and ``gateway.main()`` fails the
process if any violation was recorded. CI runs one smoke leg this way.

Named invariants:

- **LOCK-ORDER** — two locks observed in both orders across the run, or an
  observed order inverting the static graph: a deadlock waiting for the
  right thread interleaving.
- **LOCK-SELF** — re-acquiring a held non-reentrant lock. Raised
  immediately (certain deadlock) instead of hanging the process.
- **LOCK-BLOCK** — a blocking call (socket recv, snapshot fsync) while
  holding a *guard* lock (the gateway's dispatch lock): one slow client or
  disk stalls every other connection. Blocking sites self-report via
  ``note_blocking``.
- **PARKED-HOLDER** — a volunteer entered an UNTIMED notification wait
  while holding a leased ticket. If that ticket is the last progressable
  task, nothing can ever wake it — PR 5's step-aside deadlock. Timed waits
  + heartbeats (and the release-to-the-back step-aside) are the fix this
  regression guard protects.
"""
from __future__ import annotations

import sys
import threading
from typing import List, Optional, Set, Tuple

from repro_torch.analysis.base import Violation


class MonitoredLock:
    """``threading.Lock`` wrapper that records acquisition order through its
    owning ``Analysis``. Covers the Lock surface the core uses (``with``,
    ``acquire``/``release``/``locked``)."""

    def __init__(self, mon: "Analysis", name: str, guard: bool = False):
        self._mon = mon
        self.name = name
        self.guard = guard
        self._lock = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        held = self._mon._held()
        if any(h is self for h in held):
            self._mon._record("LOCK-SELF",
                              f"re-acquiring held lock {self.name} — a "
                              f"non-reentrant lock self-deadlocks here")
            raise RuntimeError(f"analysis: re-acquire of held {self.name}")
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            for h in held:
                self._mon._edge(h.name, self.name)
            held.append(self)
        return ok

    def release(self) -> None:
        held = self._mon._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is self:
                del held[i]
                break
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "MonitoredLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False


class Analysis:
    """Process-wide runtime monitor. ``Analysis.instrument()`` is the
    singleton entry the gateway's ``_make_lock`` seam uses (it also loads
    the static lock graph to check observed orders against); tests
    construct instances directly with whatever static edges they want."""

    _singleton: Optional["Analysis"] = None

    def __init__(self,
                 static_edges: Optional[Set[Tuple[str, str]]] = None):
        self._tls = threading.local()
        self._mu = threading.Lock()          # guards edges + violations
        self._edges: Set[Tuple[str, str]] = set()
        self._static = set(static_edges or ())
        self.violations: List[Violation] = []
        self.locks_made = 0
        self.parks = 0
        self.blocking_notes = 0

    @classmethod
    def instrument(cls) -> "Analysis":
        if cls._singleton is None:
            from repro_torch.analysis import locks as _locks
            try:
                static = _locks.static_edges(_locks.default_paths())
            except Exception as e:           # pragma: no cover - defensive
                # instrumentation must never take the server down; without
                # the static graph, runtime-vs-runtime inversions still fire
                print(f"# analysis-instrument: static graph unavailable "
                      f"({e!r})", file=sys.stderr)
                static = set()
            cls._singleton = cls(static)
        return cls._singleton

    @classmethod
    def reset(cls) -> None:
        """Drop the singleton (tests only)."""
        cls._singleton = None

    # -- lock bookkeeping ---------------------------------------------------
    def make_lock(self, name: str, guard: bool = False) -> MonitoredLock:
        self.locks_made += 1
        return MonitoredLock(self, name, guard)

    def _held(self) -> List[MonitoredLock]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def _record(self, rule: str, message: str) -> None:
        with self._mu:
            self.violations.append(Violation(rule, "<runtime>", 0, message))

    def _edge(self, a: str, b: str) -> None:
        if a == b:
            return
        with self._mu:
            first = (a, b) not in self._edges
            self._edges.add((a, b))
            runtime_inv = first and (b, a) in self._edges
            static_inv = first and (b, a) in self._static
        if runtime_inv or static_inv:
            source = "the static graph" if static_inv and not runtime_inv \
                else "an earlier observed order"
            self._record("LOCK-ORDER",
                         f"acquired {b} while holding {a}, but {source} "
                         f"takes {a} after {b} — deadlock-prone inversion")

    # -- invariant hooks (called from instrumented core sites) ---------------
    def note_blocking(self, kind: str) -> None:
        """A blocking call (socket recv, snapshot fsync, lease wait) is about
        to run on this thread; violation if a guard lock is held."""
        self.blocking_notes += 1
        guards = [h.name for h in self._held() if h.guard]
        if guards:
            self._record("LOCK-BLOCK",
                         f"blocking call ({kind}) while holding "
                         f"{', '.join(guards)} — stalls every other "
                         f"connection behind the dispatch lock")

    def note_park(self, who: str, *, holding: bool, timed: bool) -> None:
        """A volunteer is about to block on a notification wait. Violation
        if it holds a leased ticket and the wait has no timeout: the
        PARKED-HOLDER (PR 5 step-aside deadlock) regression guard."""
        self.parks += 1
        if holding and not timed:
            self._record("PARKED-HOLDER",
                         f"{who}: untimed notification wait while holding a "
                         f"leased ticket — if that ticket is the last "
                         f"progressable task nothing can wake this "
                         f"volunteer (PR 5 step-aside deadlock)")

    # -- reporting ----------------------------------------------------------
    def report(self, stream=None) -> int:
        """Print findings; 1 if any violation was recorded, else 0."""
        stream = sys.stderr if stream is None else stream
        with self._mu:
            vs = list(self.violations)
            n_edges = len(self._edges)
        if vs:
            for v in vs:
                print(v, file=stream)
            print(f"# analysis-instrument: {len(vs)} violation(s)",
                  file=stream, flush=True)
            return 1
        print(f"# analysis-instrument: clean — {self.locks_made} lock(s), "
              f"{n_edges} order edge(s), {self.blocking_notes} blocking "
              f"site(s) checked, {self.parks} park(s) checked", flush=True)
        return 0
