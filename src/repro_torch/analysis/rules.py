"""Layering & invariant linter (pass "rules"): the REPRO rule catalog.

AST-based, importing nothing from the code under test. The conventions PRs
1-5 established are load-bearing — all wall-clock time flows through
``LeaseClock``, engines reach ``QueueServer``/``DataServer`` only through
``VolunteerSession``/``ServerEndpoint``, session state is mutated only by
``VolunteerSession`` itself, and protocol dispatch never swallows errors —
but until this pass nothing enforced them. Each rule has an id; a finding
can be excused in place with ``# analysis: ignore[RULE-ID]`` (see
``repro_torch.analysis.base``; strict mode fails on stale ignores). Rationale,
examples, and the full catalog live in docs/analysis.md.

The driver's default path set is ``src/repro_torch/core/*.py`` — the protocol
kernel where these rules are invariants, not style. Seeded fixtures under
``tests/fixtures/analysis/`` prove every rule fires.
"""
from __future__ import annotations

import ast
import pathlib
from typing import Iterable, List, Tuple

from repro_torch.analysis.base import Violation, apply_ignores, parse_ignores

# -- REPRO-TIME -------------------------------------------------------------
# Wall-clock reads outside queue.py's clock classes. Lease deadlines are
# meaningful only relative to ONE time authority; a stray time.monotonic()
# compares against the wrong clock in virtual-time engines and splits the
# authority in real-time ones. time.sleep is deliberately allowed: sleeping
# is pacing, not reading the lease clock.
WALL_CLOCK_FNS = {"time", "monotonic", "perf_counter",
                  "time_ns", "monotonic_ns", "perf_counter_ns"}
CLOCK_HOME_STEM = "queue"            # LeaseClock implementations live here
CLOCK_CLASS_SUFFIX = "Clock"

# -- REPRO-LAYER ------------------------------------------------------------
# Engine modules calling the consumer/producer protocol directly on a
# QueueServer/DataServer. Engines own time, compute, and waiting; protocol
# moves must go through VolunteerSession (client half) or ServerEndpoint
# (server half) so every rule lives in exactly one place. Server-AUTHORITY
# ops (expire_all, next_deadline, snapshot/restore, shard membership) and
# pure reads (depth, drained, latest_version, counters) are the owner's
# business and stay direct.
ENGINE_STEMS = {"coordinator", "simulator", "gateway", "chaos", "browser",
                "traces"}
SERVER_ATTRS = {"qs", "ds", "queue_server", "data_server"}
CONSUMER_OPS = {"lease", "ack", "nack", "extend", "publish", "subscribe",
                "unsubscribe", "kick", "drop_consumer", "declare",
                "publish_model", "watch_version", "put", "delete",
                "gc_models"}

# -- REPRO-SESSION ----------------------------------------------------------
# VolunteerSession state mutated from outside its own methods. The session
# is the protocol state machine; an engine poking e.g. ``sess.task = None``
# desynchronizes it from the server's lease table (the ticket stays leased
# with nobody driving it). Detected as any write/delete of these attributes
# on a receiver other than ``self``.
SESSION_ATTRS = {"task", "tag", "lease_latest", "_rtags", "_handed",
                 "_base", "_apply_version"}

# -- REPRO-EXCEPT -----------------------------------------------------------
# Bare ``except:`` anywhere, and ``except Exception/BaseException`` whose
# body is only ``pass``. In protocol dispatch a swallowed error turns a bug
# into a silent hang (a reply never sent, a lease never requeued); handlers
# must name the exception and do something with it.
SWALLOW_NAMES = {"Exception", "BaseException"}


#: rule id -> one-line summary (docs/analysis.md carries the full catalog)
RULES = {
    "REPRO-TIME": "wall-clock read outside queue.py's LeaseClock classes",
    "REPRO-LAYER": "engine calls a QueueServer/DataServer consumer op "
                   "directly instead of via VolunteerSession/ServerEndpoint",
    "REPRO-SESSION": "VolunteerSession state mutated outside its methods",
    "REPRO-EXCEPT": "bare except / silently swallowed exception",
}


def _iter_with_classes(node: ast.AST, stack: Tuple[str, ...] = ()):
    """Yield ``(child, enclosing_class_names)`` for every descendant."""
    for child in ast.iter_child_nodes(node):
        cstack = stack + (child.name,) if isinstance(child, ast.ClassDef) \
            else stack
        yield child, cstack
        yield from _iter_with_classes(child, cstack)


def _receiver_name(expr: ast.AST):
    """Last name segment of a call receiver: ``self.qs`` -> "qs"."""
    if isinstance(expr, ast.Attribute):
        return expr.attr
    if isinstance(expr, ast.Name):
        return expr.id
    return None


def _check_time(tree: ast.AST, path: str, stem: str) -> List[Violation]:
    mod_aliases, fn_aliases = set(), {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "time":
                    mod_aliases.add(a.asname or a.name)
        elif isinstance(node, ast.ImportFrom) and node.module == "time":
            for a in node.names:
                if a.name in WALL_CLOCK_FNS:
                    fn_aliases[a.asname or a.name] = a.name
    out = []
    for node, classes in _iter_with_classes(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        called = None
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                and f.value.id in mod_aliases and f.attr in WALL_CLOCK_FNS:
            called = f.attr
        elif isinstance(f, ast.Name) and f.id in fn_aliases:
            called = fn_aliases[f.id]
        if called is None:
            continue
        if stem == CLOCK_HOME_STEM and \
                any(c.endswith(CLOCK_CLASS_SUFFIX) for c in classes):
            continue                 # a LeaseClock implementation itself
        out.append(Violation(
            "REPRO-TIME", path, node.lineno,
            f"time.{called}() outside queue.py's clock classes — all wall "
            f"time flows through a LeaseClock (WallClock/VirtualClock)"))
    return out


def _check_layer(tree: ast.AST, path: str, stem: str) -> List[Violation]:
    if stem not in ENGINE_STEMS:
        return []
    out = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        recv = _receiver_name(node.func.value)
        if node.func.attr in CONSUMER_OPS and recv in SERVER_ATTRS:
            out.append(Violation(
                "REPRO-LAYER", path, node.lineno,
                f"engine calls {recv}.{node.func.attr}() directly — route "
                f"consumer-protocol ops through VolunteerSession or "
                f"ServerEndpoint"))
    return out


def _check_session(tree: ast.AST, path: str, stem: str) -> List[Violation]:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AugAssign):
            targets = [node.target]
        elif isinstance(node, ast.Delete):
            targets = node.targets
        else:
            continue
        for t in targets:
            for sub in ast.walk(t):
                if not (isinstance(sub, ast.Attribute)
                        and sub.attr in SESSION_ATTRS):
                    continue
                base = sub.value
                if isinstance(base, ast.Name) and base.id == "self":
                    continue         # the session's own methods
                out.append(Violation(
                    "REPRO-SESSION", path, sub.lineno,
                    f"session state .{sub.attr} mutated from outside "
                    f"VolunteerSession — the session owns its protocol "
                    f"state; drive it through its methods"))
    return out


def _check_except(tree: ast.AST, path: str, stem: str) -> List[Violation]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if node.type is None:
            out.append(Violation(
                "REPRO-EXCEPT", path, node.lineno,
                "bare `except:` catches KeyboardInterrupt/SystemExit and "
                "hides protocol bugs — name the exception"))
            continue
        t = node.type
        elts = t.elts if isinstance(t, ast.Tuple) else [t]
        names = {e.id for e in elts if isinstance(e, ast.Name)}
        if names & SWALLOW_NAMES and len(node.body) == 1 \
                and isinstance(node.body[0], ast.Pass):
            out.append(Violation(
                "REPRO-EXCEPT", path, node.lineno,
                f"except {'/'.join(sorted(names & SWALLOW_NAMES))}: pass "
                f"swallows every error silently — handle it, log it, or "
                f"narrow the type"))
    return out


_CHECKS = (_check_time, _check_layer, _check_session, _check_except)


def check_file(path) -> Tuple[List[Violation], List[Violation]]:
    """Run every rule on one file. Returns ``(violations, stale_ignores)``
    after applying the ignore escape hatch."""
    p = pathlib.Path(path)
    source = p.read_text()
    tree = ast.parse(source, filename=str(p))
    raw: List[Violation] = []
    for check in _CHECKS:
        raw.extend(check(tree, str(p), p.stem))
    raw.sort(key=lambda v: (v.line, v.rule))
    return apply_ignores(raw, parse_ignores(source), str(p))


def check_paths(paths: Iterable) -> Tuple[List[Violation], List[Violation]]:
    violations: List[Violation] = []
    stale: List[Violation] = []
    for path in paths:
        vs, st = check_file(path)
        violations.extend(vs)
        stale.extend(st)
    return violations, stale
