"""Wire-schema exhaustiveness checker (pass "schema").

A wire type that exists but fails any one of these checks is a latent
protocol hole: a message that can't cross the wire, a request the server
silently drops, a task that vanishes across a crash, or a type the protocol
doc lies about by omission. Every dataclass in the ``@wire`` registry
(``protocol._WIRE_TYPES`` — protocol messages plus ``tasks.WIRE_TYPES``
bodies) must therefore be:

- **SCHEMA-ROUNDTRIP** — byte-round-trippable: a sample instance survives
  ``encode_message``/``decode_message`` unchanged.
- **SCHEMA-PARTITION** — classified in exactly one of REQUEST_TYPES,
  REPLY_TYPES, NOTIFICATION_TYPES, or tasks.WIRE_TYPES; an unclassified
  type is unreachable, a doubly-classified one is ambiguous to dispatch.
- **SCHEMA-DISPATCH** — reachable from ``ServerEndpoint``: every request
  type appears in an ``isinstance`` dispatch arm in protocol.py, and every
  reply/notification type is actually constructed there.
- **SCHEMA-SNAPSHOT** — durable where it claims to be: each task body
  published into a ``QueueServer`` survives snapshot -> encode -> decode ->
  restore with a byte-identical second snapshot.
- **SCHEMA-DOC** — listed (as a backticked name) in docs/protocol.md.
  ``scripts/check_docs.py`` delegates its wire-type check here so the two
  can't drift.
- **SCHEMA-MC** — modeled by the model checker: every REQUEST and
  NOTIFICATION type must map to an exploration action in
  ``repro_torch.analysis.mc.COVERED_MESSAGES``, so the protocol cannot grow a
  message the exhaustive search silently never exercises (the coverage test
  in tests/test_mc.py proves each mapping is real, not just declared).

Unlike the other passes this one imports the code under test — round-trip
and snapshot coverage are semantic claims AST inspection can't make.
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.analysis.base import Violation
from repro_torch.core import protocol, tasks
from repro_torch.core.queue import QueueServer

RULES = {
    "SCHEMA-ROUNDTRIP": "wire type does not survive encode/decode",
    "SCHEMA-PARTITION": "wire type not in exactly one protocol role",
    "SCHEMA-DISPATCH": "request not dispatched / reply never constructed",
    "SCHEMA-SNAPSHOT": "task body does not survive snapshot/restore",
    "SCHEMA-DOC": "wire type missing from docs/protocol.md",
    "SCHEMA-MC": "wire type not modeled by any model-checker action",
}

_PROTO = "protocol.py"


def registered_types() -> Dict[str, type]:
    """Name -> class for every ``@wire``-registered dataclass."""
    return dict(protocol._WIRE_TYPES)


def default_doc_path() -> pathlib.Path:
    return pathlib.Path(protocol.__file__).resolve().parents[3] \
        / "docs" / "protocol.md"


def sample(cls):
    """A representative instance: required fields filled by annotation
    (stringified under ``from __future__ import annotations``), defaults
    left alone. Payload-ish ``Any`` fields get None — the codec must carry
    that (simulated volunteers send exactly that shape)."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING or \
                f.default_factory is not dataclasses.MISSING:
            continue
        ann = str(f.type)
        if "bool" in ann:
            kwargs[f.name] = True
        elif "int" in ann:
            kwargs[f.name] = 1
        elif "float" in ann:
            kwargs[f.name] = 0.5
        elif "str" in ann:
            kwargs[f.name] = "x"
        elif "Dict" in ann or "dict" in ann:
            kwargs[f.name] = {}
        elif "List" in ann or "list" in ann:
            kwargs[f.name] = []
        elif "Tuple" in ann or "tuple" in ann:
            kwargs[f.name] = ()
        else:
            kwargs[f.name] = None
    return cls(**kwargs)


def check_roundtrip(types: Dict[str, type]) -> List[Violation]:
    out = []
    for name, cls in sorted(types.items()):
        try:
            inst = sample(cls)
            back = protocol.decode_message(protocol.encode_message(inst))
        except Exception as e:
            out.append(Violation(
                "SCHEMA-ROUNDTRIP", _PROTO, 0,
                f"{name} failed encode/decode: {e!r}"))
            continue
        if back != inst:
            out.append(Violation(
                "SCHEMA-ROUNDTRIP", _PROTO, 0,
                f"{name} round-trip changed the value: {inst!r} -> {back!r}"))
    return out


def check_partition(types: Dict[str, type]) -> List[Violation]:
    roles = (("request", set(protocol.REQUEST_TYPES)),
             ("reply", set(protocol.REPLY_TYPES)),
             ("notification", set(protocol.NOTIFICATION_TYPES)),
             ("task body", set(tasks.WIRE_TYPES)))
    out = []
    for name, cls in sorted(types.items()):
        hits = [role for role, members in roles if cls in members]
        if len(hits) != 1:
            what = "none of" if not hits else f"multiple ({', '.join(hits)})"
            out.append(Violation(
                "SCHEMA-PARTITION", _PROTO, 0,
                f"{name} is registered on the wire but classified in {what} "
                f"REQUEST/REPLY/NOTIFICATION/task-body roles — dispatch "
                f"cannot place it"))
    return out


def check_dispatch() -> List[Violation]:
    """Requests must appear in an ``isinstance(msg, X)`` arm; replies and
    notifications must be constructed somewhere in protocol.py."""
    tree = ast.parse(pathlib.Path(protocol.__file__).read_text())
    dispatched, constructed = set(), set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if isinstance(fn, ast.Name) and fn.id == "isinstance" \
                and len(node.args) == 2:
            arg = node.args[1]
            elts = arg.elts if isinstance(arg, ast.Tuple) else [arg]
            dispatched |= {e.id for e in elts if isinstance(e, ast.Name)}
        elif isinstance(fn, ast.Name):
            constructed.add(fn.id)
        elif isinstance(fn, ast.Attribute):
            constructed.add(fn.attr)
    out = []
    for cls in protocol.REQUEST_TYPES:
        if cls.__name__ not in dispatched:
            out.append(Violation(
                "SCHEMA-DISPATCH", _PROTO, 0,
                f"request {cls.__name__} has no isinstance arm in "
                f"ServerEndpoint dispatch — the server drops it silently"))
    for cls in protocol.REPLY_TYPES + protocol.NOTIFICATION_TYPES:
        if cls.__name__ not in constructed:
            out.append(Violation(
                "SCHEMA-DISPATCH", _PROTO, 0,
                f"reply/notification {cls.__name__} is never constructed in "
                f"protocol.py — dead wire type or dispatch hole"))
    return out


def check_snapshot(types: Optional[Iterable[type]] = None) -> List[Violation]:
    """Each task body must survive a full durable cycle: publish -> lease ->
    snapshot -> wire bytes -> restore -> identical second snapshot."""
    out = []
    for cls in (tasks.WIRE_TYPES if types is None else types):
        name = cls.__name__
        try:
            qs = QueueServer(default_timeout=5.0)
            qs.publish("q", sample(cls))
            qs.publish("q", sample(cls))
            qs.lease("q", "w0", 0.0)
            snap = qs.snapshot()
            blob = protocol.encode_message(snap)
            qs2 = QueueServer(default_timeout=5.0)
            qs2.restore(protocol.decode_message(blob))
            again = qs2.snapshot()
        except Exception as e:
            out.append(Violation(
                "SCHEMA-SNAPSHOT", _PROTO, 0,
                f"{name} broke the snapshot/restore cycle: {e!r}"))
            continue
        if again != snap:
            out.append(Violation(
                "SCHEMA-SNAPSHOT", _PROTO, 0,
                f"{name}: restored snapshot differs from the original — "
                f"this task body does not survive a server restart"))
    return out


def check_doc(doc_path=None,
              types: Optional[Dict[str, type]] = None) -> List[Violation]:
    doc_path = default_doc_path() if doc_path is None else \
        pathlib.Path(doc_path)
    types = registered_types() if types is None else types
    try:
        text = doc_path.read_text()
    except OSError as e:
        return [Violation("SCHEMA-DOC", str(doc_path), 0,
                          f"protocol doc unreadable: {e}")]
    out = []
    for name in sorted(types):
        if f"`{name}`" not in text:
            out.append(Violation(
                "SCHEMA-DOC", str(doc_path), 0,
                f"wire type {name} is not documented — add a `{name}` entry"))
    return out


def check_mc_coverage(
        covered: Optional[Dict[str, str]] = None) -> List[Violation]:
    """Every REQUEST/NOTIFICATION wire type must map to a model-checker
    action in ``repro_torch.analysis.mc.COVERED_MESSAGES`` — otherwise the
    protocol has grown a message the exhaustive search never exercises.
    Replies are excluded: they only exist as the return values of the
    requests that elicit them, so request coverage subsumes them. ``covered``
    overrides the shipped map (the fixture tests inject a partial one)."""
    if covered is None:
        from repro_torch.analysis.mc import COVERED_MESSAGES
        covered = COVERED_MESSAGES
    out = []
    for cls in (*protocol.REQUEST_TYPES, *protocol.NOTIFICATION_TYPES):
        name = cls.__name__
        if not str(covered.get(name, "") or "").strip():
            out.append(Violation(
                "SCHEMA-MC", _PROTO, 0,
                f"wire type {name} has no model-checker action mapping — "
                f"add it to repro_torch.analysis.mc.COVERED_MESSAGES and model "
                f"the action that sends it"))
    return out


def run(doc_path=None,
        extra_types: Tuple[type, ...] = ()) -> List[Violation]:
    """All six checks over the registry (plus ``extra_types``, which tests
    use to inject rogue types without touching the global registry)."""
    types = registered_types()
    for cls in extra_types:
        types[cls.__name__] = cls
    out: List[Violation] = []
    out.extend(check_roundtrip(types))
    out.extend(check_partition(types))
    out.extend(check_dispatch())
    out.extend(check_snapshot())
    out.extend(check_doc(doc_path, types))
    out.extend(check_mc_coverage())
    return out
