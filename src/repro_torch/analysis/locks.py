"""Lock-order race detector (pass "locks") — the static half.

Extracts the lock-acquisition graph of the threaded core modules from their
ASTs and fails on cycles. Nodes are lock attributes assigned from a lock
factory (``threading.Lock()``/``RLock()`` or the gateway's ``_make_lock``
seam), named ``<module>.<attr>``; an edge ``a -> b`` means some code path
acquires ``b`` while holding ``a`` — from nested ``with`` statements, from
bare ``.acquire()`` calls, and from transitive intra-module call resolution:
a ``with self._lock:`` body calling a method that (through any bounded,
cycle-safe chain of same-module helpers, lock-free intermediates included)
takes another lock contributes the edge — a helper that takes no lock itself
cannot hide the locks past it. Any cycle is a potential deadlock: two
threads entering the cycle
from different ends can each hold what the other needs, and no test will
reliably catch the interleaving.

The default file set is gateway.py + queue.py + dataserver.py: the gateway
is the only threaded engine, and queue.py/dataserver.py are deliberately
lock-free (single-threaded under the dispatch lock) — if a lock ever
appears there, it joins this graph automatically.

The runtime half (``repro_torch.analysis.runtime``) replays this check against
ORDERS actually observed during the instrumented ``gateway --smoke`` legs:
``static_edges()`` is loaded by ``Analysis.instrument()`` so an observed
acquisition that inverts the static graph is flagged even if the opposing
static path never runs in that process.
"""
from __future__ import annotations

import ast
import importlib.util
import pathlib
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.base import Violation

LOCK_FACTORIES = {"Lock", "RLock", "_make_lock", "allocate_lock"}

#: core modules whose lock graph CI checks (see module docstring)
DEFAULT_MODULES = ("gateway", "queue", "dataserver")


def default_paths() -> List[pathlib.Path]:
    out = []
    for mod in DEFAULT_MODULES:
        spec = importlib.util.find_spec(f"repro_torch.core.{mod}")
        out.append(pathlib.Path(spec.origin))
    return out


def _call_name(func: ast.AST) -> Optional[str]:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _resolvable(func: ast.AST) -> bool:
    """True when a call may target a same-module function/method: a bare
    name ``f()`` or a ``self.f()``/``cls.f()`` method call. Calls through any
    other receiver (``qs.snapshot()``, ``self.qs.lease()``) are a foreign
    object's methods — resolving those by simple name would conflate e.g.
    ``QueueServer.snapshot`` with the gateway's own ``snapshot``."""
    if isinstance(func, ast.Name):
        return True
    if isinstance(func, ast.Attribute):
        return isinstance(func.value, ast.Name) and \
            func.value.id in ("self", "cls")
    return False


def _lock_attrs(tree: ast.AST) -> Set[str]:
    """Attribute/variable names assigned from a lock factory."""
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and _call_name(node.value.func) in LOCK_FACTORIES:
            for t in node.targets:
                if isinstance(t, ast.Attribute):
                    names.add(t.attr)
                elif isinstance(t, ast.Name):
                    names.add(t.id)
    return names


def _lock_of(expr: ast.AST, lockset: Set[str]) -> Optional[str]:
    """``self._lock`` / ``_lock`` -> the lock's attr name, if known."""
    if isinstance(expr, ast.Attribute) and expr.attr in lockset:
        return expr.attr
    if isinstance(expr, ast.Name) and expr.id in lockset:
        return expr.id
    return None


class _FnInfo:
    """Per-function facts: locks it acquires anywhere, direct nesting edges,
    calls made while holding locks (the edge sources), and ALL calls made
    anywhere in the body (the resolution graph — a lock-free helper in the
    middle of a call chain must not hide the locks past it)."""

    def __init__(self):
        self.acquires: Set[str] = set()
        self.edges: Set[Tuple[str, str]] = set()
        self.calls_while_held: List[Tuple[Tuple[str, ...], str]] = []
        self.calls: Set[str] = set()


_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)


def _scan(node: ast.AST, held: Tuple[str, ...], lockset: Set[str],
          qual, info: _FnInfo) -> None:
    """Walk one statement/expression threading the held-lock stack through
    nested ``with`` blocks. Bare ``.acquire()`` contributes edges and
    membership but not held-ness (no linear release tracking — ``with`` is
    the idiom the core uses; acquire/release pairs still register in the
    graph)."""
    if isinstance(node, _SCOPES):
        return                       # separate scope: scanned on its own
    if isinstance(node, (ast.With, ast.AsyncWith)):
        got = held
        for item in node.items:
            lk = _lock_of(item.context_expr, lockset)
            if lk is not None:
                name = qual(lk)
                for h in got:
                    info.edges.add((h, name))
                info.acquires.add(name)
                got = got + (name,)
            else:
                _scan(item.context_expr, got, lockset, qual, info)
        for st in node.body:
            _scan(st, got, lockset, qual, info)
        return
    if isinstance(node, ast.Call):
        nm = _call_name(node.func)
        if nm == "acquire" and isinstance(node.func, ast.Attribute):
            lk = _lock_of(node.func.value, lockset)
            if lk is not None:
                name = qual(lk)
                for h in held:
                    info.edges.add((h, name))
                info.acquires.add(name)
        elif nm is not None and nm != "release" and _resolvable(node.func):
            info.calls.add(nm)
            if held:
                info.calls_while_held.append((held, nm))
    for child in ast.iter_child_nodes(node):
        _scan(child, held, lockset, qual, info)


def _scan_file(path: pathlib.Path):
    """-> (lock names, edges, per-name _FnInfo map) for one module."""
    source = path.read_text()
    tree = ast.parse(source, filename=str(path))
    lockset = _lock_attrs(tree)
    stem = path.stem

    def qual(attr: str) -> str:
        return f"{stem}.{attr}"

    functions: Dict[str, _FnInfo] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            info = functions.setdefault(node.name, _FnInfo())
            for st in node.body:
                _scan(st, (), lockset, qual, info)
    # resolve calls made under a held lock: the callee's transitive acquires
    # (same module, matched by simple name) become edges from each held lock.
    # Resolution follows ALL calls — including ones made with no lock held —
    # so a lock-free helper between the holder and the acquirer cannot hide
    # the edge; it is cycle-safe (``seen``) and depth-bounded (recursion
    # deeper than any sane same-module helper chain stops contributing)
    _MAX_RESOLVE_DEPTH = 16

    def all_acquires(name: str, seen: frozenset) -> Set[str]:
        info = functions.get(name)
        if info is None or name in seen or len(seen) >= _MAX_RESOLVE_DEPTH:
            return set()
        acq = set(info.acquires)
        for callee in info.calls:
            acq |= all_acquires(callee, seen | {name})
        return acq

    edges: Set[Tuple[str, str]] = set()
    for info in functions.values():
        edges |= info.edges
        for held, callee in info.calls_while_held:
            for lk in all_acquires(callee, frozenset()):
                for h in held:
                    if h != lk:
                        edges.add((h, lk))
    locks = {qual(a) for a in lockset}
    return locks, edges


def lock_graph(paths: Iterable) -> Tuple[Set[str], Set[Tuple[str, str]]]:
    """Union of every file's (locks, edges)."""
    locks: Set[str] = set()
    edges: Set[Tuple[str, str]] = set()
    for path in paths:
        lk, ed = _scan_file(pathlib.Path(path))
        locks |= lk
        edges |= ed
    return locks, edges


def static_edges(paths: Iterable) -> Set[Tuple[str, str]]:
    """The acquisition-order edges alone (what the runtime monitor loads)."""
    return lock_graph(paths)[1]


def find_cycles(edges: Set[Tuple[str, str]]) -> List[List[str]]:
    graph = defaultdict(set)
    for a, b in edges:
        graph[a].add(b)
    cycles: List[List[str]] = []
    seen_sets: Set[frozenset] = set()
    done: Set[str] = set()

    def dfs(n: str, path: List[str], onpath: Set[str]) -> None:
        for m in sorted(graph[n]):
            if m in onpath:
                cyc = path[path.index(m):] + [m]
                key = frozenset(cyc)
                if key not in seen_sets:
                    seen_sets.add(key)
                    cycles.append(cyc)
            elif m not in done:
                dfs(m, path + [m], onpath | {m})
        done.add(n)

    for n in sorted(graph):
        if n not in done:
            dfs(n, [n], {n})
    return cycles


def check(paths: Iterable) -> List[Violation]:
    """One LOCK-ORDER violation per distinct cycle in the union graph."""
    paths = [pathlib.Path(p) for p in paths]
    _, edges = lock_graph(paths)
    out = []
    for cyc in find_cycles(edges):
        out.append(Violation(
            "LOCK-ORDER", str(paths[0]) if paths else "<locks>", 0,
            "lock-acquisition cycle " + " -> ".join(cyc) +
            " — two threads entering from different ends deadlock; pick one "
            "global order"))
    return out
