"""The declarative invariant catalog the explorer checks at every state.

An ``Invariant`` is a name plus a predicate over the concrete ``MCWorld``.
The predicate returns ``None`` when the property holds, or a human-readable
violation message when it does not (returning ``False`` is also accepted and
converted to a generic message). Every *generated* state is covered: the
explorer schedules history-dependent invariants on every transition (before
fingerprint dedup can prune it) and state-based ones once per distinct
fingerprint — see ``explore._split`` — so the observational abstractions in
``fingerprint.py`` can never hide a violation.

Each invariant names the protocol guarantee it verifies; ``docs/protocol.md``
cross-references these from the state-machine sections they formalize.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Union

from repro_torch.core.queue import QueueServer
from repro_torch.core.tasks import INITIAL_QUEUE

Verdict = Union[None, bool, str]


@dataclass(frozen=True)
class Invariant:
    name: str
    predicate: Callable[["MCWorld"], Verdict]  # noqa: F821 - runtime duck type

    def check(self, world) -> Optional[str]:
        out = self.predicate(world)
        if out is None or out is True:
            return None
        return out if isinstance(out, str) else f"{self.name} violated"


def ticket_conservation(world) -> Verdict:
    """pending + in-flight + done == scheduled: the at-least-once queue never
    loses or invents a ticket, across expiry, nack, crash, and restore."""
    for name in sorted(world.qs.queues):
        q = world.qs.queues[name]
        try:
            q.check_invariants()
        except AssertionError as e:
            return f"queue structural invariant broke: {e}"
    iq = world.qs.queues[INITIAL_QUEUE]
    if iq.published != world.n_scheduled:
        return (f"task queue published {iq.published} != "
                f"{world.n_scheduled} scheduled")
    outstanding = iq.acked + iq.depth + iq.in_flight
    if outstanding != world.n_scheduled:
        return (f"ticket conservation broke: acked {iq.acked} + pending "
                f"{iq.depth} + in-flight {iq.in_flight} != "
                f"{world.n_scheduled} scheduled")
    return None


def admission_soundness(world) -> Verdict:
    """Every applied barrierless update satisfies the policy's declared
    bound: ``applied_at - computed_at <= s`` (the BoundedStaleness contract).
    Policies without a finite declared bound (LocalSteps) are exempt; barrier
    policies never take this path (a sync gradient is applied at exactly the
    version it was computed on, enforced by the reduce barrier itself)."""
    if world.policy.barrier:
        return None
    bound = getattr(world.policy, "staleness", None)
    if bound is None:
        return None
    for computed_at, applied_at in world.applied:
        if applied_at - computed_at > bound:
            return (f"update computed at v{computed_at} applied at "
                    f"v{applied_at}: staleness {applied_at - computed_at} "
                    f"exceeds the declared bound {bound}")
    return None


def single_commit_per_slot(world) -> Verdict:
    """Each model version slot is committed exactly once, gaplessly: the
    version sequence 1..latest with no duplicates (v0 is the initiator's).
    Duplicate reduce publishes must be absorbed by the DataServer, not
    double-committed."""
    versions = [v for v, _ in world.commit_meta]
    if len(versions) != len(set(versions)):
        dup = sorted(v for v in set(versions) if versions.count(v) > 1)
        return f"model version(s) {dup} committed more than once"
    expect = set(range(1, world.ds.latest_version + 1))
    if set(versions) != expect:
        return (f"commit log {sorted(versions)} does not match committed "
                f"versions 1..{world.ds.latest_version}")
    return None


def no_lost_wake(world) -> Verdict:
    """A parked volunteer always has SOMETHING that will wake it: an
    undelivered/delivered notification in flight, a live queue-waiter
    registration of the right kind, or a live version watch. Volunteers that
    had a notification deliberately dropped on them (injected fault budget)
    are exempt — recovering those is the lease-expiry/watchdog path, not the
    wake chain."""
    for vid in world.vids:
        d = world.drivers[vid]
        if d.state not in ("parked", "parked_idle"):
            continue
        if d.dropped:
            continue
        if d.mailbox or any(c == vid for c, _ in world.pending):
            continue
        if d.state == "parked_idle":
            q = world.qs.queues.get(INITIAL_QUEUE)
            if q is None or vid not in q.waiter_view()["any"]:
                return (f"{vid} parked idle with no live task-queue waiter, "
                        f"no pending wake")
            continue
        b = d.blocked
        if b is None:
            return f"{vid} parked with no recorded wait condition"
        if b.version is not None:
            if (vid, b.version) not in world.endpoint.watch_view():
                return (f"{vid} parked on version v{b.version} with no live "
                        f"watch, no pending wake")
        else:
            q = world.qs.queues.get(b.queue)
            names = q.waiter_view().get(b.kind, ()) if q is not None else ()
            if vid not in names:
                return (f"{vid} parked on {b.queue}/{b.kind} with no live "
                        f"waiter, no pending wake")
    return None


def snapshot_durability(world) -> Verdict:
    """The full server state survives snapshot -> wire bytes -> restore with
    an identical second snapshot — the gateway's crash-recovery contract,
    probed at this exact state."""
    from repro_torch.core.protocol import decode_message, encode_message
    snap = world.qs.snapshot()
    rebuilt = QueueServer(default_timeout=world.qs.default_timeout)
    rebuilt.restore(decode_message(encode_message(snap)), waiters_from={})
    snap2 = rebuilt.snapshot()
    if snap2 != snap:
        return "QueueServer snapshot did not survive a wire round-trip"
    return None


DEFAULT_INVARIANTS: List[Invariant] = [
    Invariant("ticket-conservation", ticket_conservation),
    Invariant("admission-soundness", admission_soundness),
    Invariant("single-commit-per-slot", single_commit_per_slot),
    Invariant("no-lost-wake", no_lost_wake),
    Invariant("snapshot-durability", snapshot_durability),
]

# deadlock-freedom is checked by the explorer itself (it needs the enabled
# action set), but it reports under this name so the catalog is uniform
DEADLOCK = "deadlock-freedom"


def check_all(world, invariants: List[Invariant]) -> Optional[tuple]:
    """First violated invariant as ``(name, message)``, else None."""
    for inv in invariants:
        msg = inv.check(world)
        if msg is not None:
            return (inv.name, msg)
    return None
