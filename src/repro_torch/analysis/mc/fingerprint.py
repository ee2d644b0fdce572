"""Canonical state fingerprints for visited-state dedup.

Two reductions happen here, both on top of the protocol's own durable
surface (``QueueServer.snapshot`` / ``DataServer.snapshot`` / session state
views), serialized through the wire codec (``repro_torch.checkpoint.serialize`` —
the same msgpack layer under ``encode_message``) and hashed:

- **Observational abstraction.** Pure accounting that cannot influence any
  future transition is stripped (requeue/wakeup tallies, byte counters), and
  lease deadlines are normalized to *time-to-expiry* (``deadline - now``) so
  states that differ only in absolute virtual time merge. Sound because the
  explorer checks every invariant on the CONCRETE state before dedup prunes
  it — abstraction only affects which successors get re-expanded, and two
  states equal under this fingerprint enable identical action sets with
  identical outcomes.

- **Symmetry reduction.** Volunteers with identical capabilities are
  interchangeable: volunteer ids are relabeled to canonical names
  (``c0, c1, ...``) ordered by each volunteer's full local signature (driver
  + session + fault-capability flags), then the rename is applied across the
  whole state — in-flight lease holders, waiter FIFOs, watch keys, pending
  notification targets, result ``worker`` stamps. Permuted-but-isomorphic
  fleets collapse to one fingerprint.

The canonical tree is hashed over its ``repr`` (deterministic for the plain
lists/strings/numbers the tree is normalized to, and an order of magnitude
faster than re-encoding through msgpack on every generated state); the claim
that the state SURVIVES the wire codec is checked separately and explicitly
by the ``snapshot-durability`` invariant, which round-trips the actual
snapshot through ``encode_message``/``decode_message``.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, Tuple

# accounting fields that cannot change any future transition
_QUEUE_DROP = ("requeued", "wakeups")

# sorted field-name tuples per dataclass type — the walk visits the same few
# types millions of times per exploration, so dataclasses.fields() and
# is_dataclass() are cached out of the hot path
_FIELDS: Dict[type, Tuple[str, ...]] = {}


def _plain(x: Any, rename: Dict[str, str]) -> Any:
    """Normalize to a canonical plain tree: dataclasses tagged by type with
    fields sorted, dicts sorted by key, tuples distinguished from lists,
    volunteer-id strings renamed."""
    t = x.__class__
    if t is str:
        return rename.get(x, x)
    if t is int or t is float or t is bool or x is None:
        return x
    if t is dict:
        return ["d", [[_plain(k, rename), _plain(v, rename)]
                      for k, v in sorted(x.items(), key=lambda kv: repr(kv[0]))]]
    if t is tuple:
        return ["t", [_plain(v, rename) for v in x]]
    if t is list:
        return ["l", [_plain(v, rename) for v in x]]
    if t is set or t is frozenset:
        return ["s", sorted((_plain(v, rename) for v in x), key=repr)]
    names = _FIELDS.get(t)
    if names is None:
        if not dataclasses.is_dataclass(x):
            return x
        names = _FIELDS[t] = tuple(sorted(
            f.name for f in dataclasses.fields(x)))
    return ["dc", t.__name__,
            [[n, _plain(getattr(x, n), rename)] for n in names]]


def _queue_abstract(qsnap: Dict[str, Any], now: float) -> Dict[str, Any]:
    out = {k: v for k, v in qsnap.items() if k not in _QUEUE_DROP}
    out["in_flight"] = [
        [tag, body, consumer, deadline - now]   # requeue count dropped
        for tag, body, consumer, deadline, _requeues in qsnap["in_flight"]]
    return out


def _volunteer_blob(world, vid: str, *, flags: bool) -> Dict[str, Any]:
    d = world.drivers[vid]
    blob = {
        "state": d.state, "blocked": d.blocked, "work": d.work,
        "mailbox": list(d.mailbox), "dropped": d.dropped,
        "session": world.sessions[vid].state_view(),
    }
    if flags:
        blob["can_crash"] = vid in world.cfg.crashable
        blob["can_leave"] = vid in world.cfg.leavable
    return blob


def _state_tree(world, *, symmetric: bool) -> Any:
    vids = list(world.vids)
    blobs = {v: _volunteer_blob(world, v, flags=symmetric) for v in vids}
    if symmetric and world.symmetry_possible():
        # order volunteers by their vid-blind local signature; ties keep the
        # original order (sound either way: the full renamed state is what
        # gets hashed, so a merge only ever unifies isomorphic states)
        blind = {v: "#v" for v in vids}
        sig = {v: repr(_plain(blobs[v], blind)) for v in vids}
        order = sorted(vids, key=lambda v: (sig[v], vids.index(v)))
        rename = {v: f"c{i}" for i, v in enumerate(order)}
    else:
        order, rename = vids, {}
    state = {
        "queues": {name: _queue_abstract(q.snapshot(), world.now)
                   for name, q in sorted(world.qs.queues.items())},
        "models": {k: v for k, v in world.ds.snapshot().items()
                   if k != "counters"},
        "waiters": world.qs.waiter_views(),
        "watches": list(world.endpoint.watch_view()),
        "volunteers": [blobs[v] for v in order],
        "pending": list(world.pending),
        "budget": [world.crashes, world.leaves, world.drops, world.dups,
                   # only meaningful when the config bounds expiries; folded
                   # to 0 otherwise so unbounded worlds keep merging states
                   # that differ only in how often they have already expired
                   world.expiries if world.cfg.max_expiries is not None
                   else 0],
    }
    # world-specific overlay (the gateway micro-world's ring/op-log state):
    # anything that can change a future transition must reach the hash, or
    # dedup could merge states with different failover futures
    extra = getattr(world, "extra_state", None)
    if extra is not None:
        state["extra"] = extra()
    return _plain(state, rename)


def canonical_state(world) -> Any:
    """The renamed, abstracted state tree (exposed for tests/debugging)."""
    return _state_tree(world, symmetric=True)


def _digest(tree: Any) -> bytes:
    return hashlib.blake2b(repr(tree).encode(), digest_size=16).digest()


def fingerprint(world) -> bytes:
    return _digest(_state_tree(world, symmetric=True))


def raw_fingerprint(world) -> bytes:
    """Fingerprint WITHOUT the symmetry rename — the explorer hashes both so
    it can report how many states symmetry actually merged."""
    return _digest(_state_tree(world, symmetric=False))
