"""Shared plumbing for the repro_torch.analysis passes: the ``Violation`` record
and the ``# analysis: ignore[RULE-ID]`` escape hatch.

Every pass reports the same shape — (rule id, file, line, message) — so the
driver prints uniformly and CI fails on any of them. The ignore comment is
deliberately rule-scoped (no blanket ignores): it must name the exact rule
id, and strict mode additionally fails on ignores that no longer suppress
anything, so an escape cannot outlive the code it excused.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Tuple


@dataclass(frozen=True)
class Violation:
    rule: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclass(frozen=True)
class Ignore:
    """One ``# analysis: ignore[...]`` comment: the rules it names and the
    source lines it covers (its own line, plus the next line when the
    comment stands alone — for statements too long to carry it trailing)."""
    line: int
    rules: frozenset
    covers: Tuple[int, ...]


_IGNORE = re.compile(r"#\s*analysis:\s*ignore\[([A-Za-z0-9_,\- ]+)\]")


def parse_ignores(source: str) -> List[Ignore]:
    out = []
    for lineno, text in enumerate(source.splitlines(), start=1):
        m = _IGNORE.search(text)
        if m is None:
            continue
        rules = frozenset(x.strip() for x in m.group(1).split(",") if x.strip())
        covers = (lineno, lineno + 1) if text.lstrip().startswith("#") \
            else (lineno,)
        out.append(Ignore(lineno, rules, covers))
    return out


def apply_ignores(violations: List[Violation], ignores: List[Ignore],
                  path: str) -> Tuple[List[Violation], List[Violation]]:
    """Suppress violations covered by an ignore comment. Returns
    ``(kept, stale)`` where ``stale`` reports (as ANALYSIS-IGNORE
    violations) every ignore comment that suppressed nothing — strict mode
    fails on those, so dead escapes get cleaned up."""
    used = set()
    kept = []
    for v in violations:
        hit = next((ig for ig in ignores
                    if v.line in ig.covers and v.rule in ig.rules), None)
        if hit is None:
            kept.append(v)
        else:
            used.add(hit.line)
    stale = [Violation("ANALYSIS-IGNORE", path, ig.line,
                       f"ignore[{', '.join(sorted(ig.rules))}] suppresses "
                       f"nothing — remove it")
             for ig in ignores if ig.line not in used]
    return kept, stale
