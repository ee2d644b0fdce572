"""Elastic control plane: gateway ring ownership + the durable op log.

Two pieces the multi-gateway deployment (``repro_torch.core.gateway --gid``) and
the chaos/model-checking tiers share:

- ``GatewayRing`` — consistent-hash ownership of queue names over K gateway
  processes, reusing the exact vnode hashing of ``ShardedQueueServer`` (PR 2)
  one level up: shards partition queues *inside* one process, the gateway
  ring partitions them *across* processes. A dead gateway's whole slice is
  adopted by ONE deterministic peer (``default_adopter`` = the smallest live
  gid), so failover never rehashes the survivors' slices.

- ``OpLog`` — incremental durability: ``snapshot()`` becomes a numbered BASE
  (full state, written atomically) plus append-only delta SEGMENTS of framed
  op records (``repro_torch.checkpoint.serialize.pack_record``: length + crc32,
  fsync per append). ``load()`` picks the newest complete base and replays
  every intact record after it; a torn tail — the writer was kill -9'd
  mid-append — ends replay cleanly instead of failing it. Writing a new base
  starts a new epoch and truncates everything older, which bounds disk to
  one base + the ops since.

The log layer is byte-agnostic: callers (the gateway's endpoint op sink, the
chaos journal) decide what an op record contains. ``durable_fingerprint``
is the shared equality observable for "replay reconstructed the same server":
per-queue snapshots with the session-coupled wake state (banked signals)
masked out — subscriptions are connection-bound and never logged, so a
replayed queue legitimately over-banks signals a live subscriber consumed;
waiters are already excluded from snapshots for the same reason.
"""
from __future__ import annotations

import bisect
import os
import re
from typing import Any, Dict, Iterable, List, Optional, Tuple

from repro_torch.checkpoint.serialize import (append_record, iter_records,
                                              read_bytes)
from repro_torch.checkpoint.serialize import atomic_write
from repro_torch.core.queue import _stable_hash

#: ring key routing every DataServer-backed op (model fetch/publish/watch,
#: update submission) to one gateway — the model owner
MODEL_KEY = "__model__"


class GatewayRing:
    """Consistent-hash ownership of routing keys over gateway ids.

    Each gid owns the vnode set ``gw-{gid}#0..vnodes-1`` — stable under
    membership events, exactly like ``ShardedQueueServer``'s ring. Death and
    adoption do NOT remove the dead gid's vnodes (that would scatter its
    slice over every survivor); instead ``adopt(dead, adopter)`` records a
    redirect, so the dead gateway's entire slice moves to exactly one peer —
    the unit of failover the op log can actually replay.
    """

    def __init__(self, gids: Iterable[int], *, vnodes: int = 32):
        self.gids: Tuple[int, ...] = tuple(sorted(set(gids)))
        if not self.gids:
            raise ValueError("ring needs at least one gateway")
        self.vnodes = vnodes
        self._dead: set = set()
        self._adopted: Dict[int, int] = {}       # dead gid -> adopter gid
        ring: List[Tuple[int, int]] = []
        for gid in self.gids:
            for r in range(vnodes):
                bisect.insort(ring, (_stable_hash(f"gw-{gid}#{r}"), gid))
        self._keys = [h for h, _ in ring]
        self._vals = [g for _, g in ring]

    # -- membership ---------------------------------------------------------
    def live(self) -> Tuple[int, ...]:
        return tuple(g for g in self.gids if g not in self._dead)

    def kill(self, gid: int) -> None:
        if gid not in self.gids:
            raise ValueError(f"unknown gateway {gid}")
        self._dead.add(gid)
        if not self.live():
            raise ValueError("cannot kill the last live gateway")

    def default_adopter(self, dead: int) -> int:
        """The deterministic failover choice every survivor agrees on
        without coordination: the smallest live gid."""
        live = [g for g in self.live() if g != dead]
        if not live:
            raise ValueError("no live gateway left to adopt")
        return min(live)

    def adopt(self, dead: int, adopter: Optional[int] = None) -> int:
        """Record that ``adopter`` now owns the dead gateway's slice.
        Returns the adopter gid. Idempotent for the same pair."""
        if dead not in self._dead:
            raise ValueError(f"gateway {dead} is not dead")
        adopter = self.default_adopter(dead) if adopter is None else adopter
        if adopter in self._dead:
            raise ValueError(f"adopter {adopter} is dead")
        prev = self._adopted.get(dead)
        if prev is not None and prev != adopter:
            raise ValueError(
                f"slice of {dead} already adopted by {prev}, not {adopter}")
        self._adopted[dead] = adopter
        return adopter

    def adoptions(self) -> Dict[int, int]:
        """Recorded ``dead gid -> adopter gid`` redirects (a copy)."""
        return dict(self._adopted)

    # -- routing ------------------------------------------------------------
    def base_owner(self, key: str) -> int:
        """Ring successor of ``key`` ignoring liveness — the original owner."""
        h = _stable_hash(key)
        i = bisect.bisect_right(self._keys, h) % len(self._keys)
        return self._vals[i]

    def serving(self, gid: int) -> int:
        """The live gateway currently serving ``gid``'s slice: itself while
        alive, else its (transitive) adopter. Raises ``LookupError`` in the
        failover window — dead and not yet adopted — during which requests
        must be held or retried."""
        seen = set()
        while gid in self._adopted:
            if gid in seen:
                raise RuntimeError(f"adoption cycle at gateway {gid}")
            seen.add(gid)
            gid = self._adopted[gid]
        if gid in self._dead:
            raise LookupError(
                f"slice owner {gid} is dead and not yet adopted")
        return gid

    def owner_of(self, key: str) -> int:
        """Current owner: the base owner, redirected through any adoptions."""
        return self.serving(self.base_owner(key))

    def owners(self, keys: Iterable[str]) -> Dict[str, int]:
        return {k: self.owner_of(k) for k in keys}


# ---------------------------------------------------------------------------
# op log: numbered base + append-only delta segments
# ---------------------------------------------------------------------------

_BASE_RE = re.compile(r"\.base\.(\d+)$")
_SEG_RE = re.compile(r"\.log\.(\d+)\.(\d+)$")


class OpLog:
    """Base + numbered delta segments under a filename prefix.

    Files:
      ``<prefix>.base.<epoch>``       — full state, atomic write
      ``<prefix>.log.<epoch>.<seg>``  — framed op records, appended + fsynced

    ``write_base`` starts epoch N+1 and truncates every older epoch; appends
    land in the current epoch's segment, rolling to a new segment every
    ``segment_ops`` records (bounded per-file size, and the property tests'
    crash-at-byte-k can only ever tear the LAST record of the last segment).
    A brand-new log starts at epoch 0 with no base: ``load`` then replays
    from empty state, so an op-log-only boot is well-defined too.
    """

    def __init__(self, prefix: str, *, segment_ops: int = 256,
                 fsync: bool = True):
        self.prefix = str(prefix)
        self.segment_ops = max(1, int(segment_ops))
        self.fsync = fsync
        self.epoch = 0
        self.seg = 0
        self._ops_in_seg = 0
        self.appended = 0                       # ops appended by THIS object
        d = os.path.dirname(self.prefix) or "."
        if os.path.isdir(d):
            epochs = self._epochs()
            if epochs:
                self.epoch = max(epochs)
            # resume the current epoch's segments whether or not a base
            # exists: epoch 0 (no base yet) has segments too, and a reopen
            # that restarted at segment 0 would append behind later
            # segments' records (the reference resumes only after a base)
            segs = self._segments(self.epoch)
            if segs:
                self.seg = max(segs)
                self._ops_in_seg = sum(
                    1 for _ in iter_records(
                        read_bytes(self._seg_path(self.epoch, self.seg))))

    # -- paths --------------------------------------------------------------
    def _base_path(self, epoch: int) -> str:
        return f"{self.prefix}.base.{epoch}"

    def _seg_path(self, epoch: int, seg: int) -> str:
        return f"{self.prefix}.log.{epoch}.{seg}"

    def _family(self) -> List[str]:
        d = os.path.dirname(self.prefix) or "."
        stem = os.path.basename(self.prefix)
        try:
            names = os.listdir(d)
        except OSError:
            return []
        return [os.path.join(d, n) for n in names if n.startswith(stem)]

    def _epochs(self) -> List[int]:
        out = []
        for p in self._family():
            m = _BASE_RE.search(p)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def _segments(self, epoch: int) -> List[int]:
        out = []
        for p in self._family():
            m = _SEG_RE.search(p)
            if m and int(m.group(1)) == epoch:
                out.append(int(m.group(2)))
        return sorted(out)

    @staticmethod
    def exists(prefix: str) -> bool:
        """Any op-log family files under this prefix? Only actual
        ``.base.<epoch>`` / ``.log.<epoch>.<seg>`` files count — a plain
        file AT the prefix path (e.g. a legacy full snapshot) is not a
        family member, so restore dispatch cannot mistake one for a log."""
        probe = OpLog.__new__(OpLog)
        probe.prefix = str(prefix)
        return any(_BASE_RE.search(p) or _SEG_RE.search(p)
                   for p in probe._family())

    # -- writing ------------------------------------------------------------
    def write_base(self, data: bytes) -> str:
        """Start a new epoch: write the full-state base atomically, reset the
        segment counter, and truncate every older epoch's files (they are
        subsumed: the base was encoded AFTER their last op)."""
        self.epoch += 1
        path = self._base_path(self.epoch)
        atomic_write(path, data)
        self.seg = 0
        self._ops_in_seg = 0
        self.truncate()
        return path

    def append(self, data: bytes) -> str:
        """Append one op record to the current epoch, rolling segments every
        ``segment_ops`` records. Durable (fsync) before returning unless the
        log was opened with ``fsync=False``."""
        if self._ops_in_seg >= self.segment_ops:
            self.seg += 1
            self._ops_in_seg = 0
        path = self._seg_path(self.epoch, self.seg)
        append_record(path, data, fsync=self.fsync)
        self._ops_in_seg += 1
        self.appended += 1
        return path

    def truncate(self) -> List[str]:
        """Delete every file from epochs older than the current one.
        Returns the removed paths (newest-base durability is unaffected)."""
        removed = []
        for p in self._family():
            m = _BASE_RE.search(p) or _SEG_RE.search(p)
            if m and int(m.group(1)) < self.epoch:
                try:
                    os.remove(p)
                    removed.append(p)
                except OSError:
                    pass                       # already gone: racing truncate
        return removed

    # -- reading ------------------------------------------------------------
    def load(self) -> Tuple[Optional[bytes], List[bytes]]:
        """(base bytes or None, op records after it, in append order).

        Picks the newest epoch that has a complete base (atomic writes mean a
        base either exists whole or not at all), then replays its segments in
        order, stopping at the first torn/corrupt record — by construction
        only the final append can be torn, so everything acknowledged before
        the crash is returned.
        """
        epochs = self._epochs()
        epoch = max(epochs) if epochs else self.epoch
        base = None
        if epochs:
            base = read_bytes(self._base_path(epoch))
        ops: List[bytes] = []
        for seg in self._segments(epoch):
            data = read_bytes(self._seg_path(epoch, seg))
            recs = list(iter_records(data))
            ops.extend(recs)
            # a record boundary that doesn't consume the file is a torn
            # tail — nothing after it was acknowledged as durable
            consumed = sum(len(r) + 8 for r in recs)
            if consumed < len(data):
                break
        return base, ops

    def op_count(self) -> int:
        """Total intact op records in the current epoch (reads the files —
        an observable for tests, not a hot path)."""
        return len(self.load()[1])


# ---------------------------------------------------------------------------
# shared replay-equality observable
# ---------------------------------------------------------------------------

def durable_queue_state(q) -> Dict[str, Any]:
    """One queue's snapshot with session-coupled wake state masked (banked
    signals; waiters are excluded from snapshots already)."""
    s = q.snapshot()
    s.pop("signal", None)
    s.pop("pub_signal", None)
    return s


def durable_fingerprint(qs) -> Dict[str, Any]:
    """Name -> durable queue state over a QueueServer/ShardedQueueServer —
    what an op-log replay must reconstruct exactly."""
    return {name: durable_queue_state(q)
            for name, q in sorted(qs.queues.items())}
