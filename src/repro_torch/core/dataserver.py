"""DataServer — the paper's Redis: a KV store holding data + the versioned model.

The model is stored under monotonically increasing versions. ``publish_model``
is the commit point of a reduce task; ``get_model(v)`` returns None until v is
committed, which is exactly the paper's "if the required version is not yet
available, the task waits" synchronization (solution 2 of §IV.F step 5: check
if a datum has been modified before starting).

``watch_version(v, callback)`` turns that wait into a push: the callback fires
the moment ``publish_model(v)`` lands (immediately if v is already committed),
so waiters never poll — the Redis-keyspace-notification analogue.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional


class DataServer:
    def __init__(self):
        self._kv: Dict[str, Any] = {}
        self._models: Dict[int, Any] = {}
        self._latest: int = -1
        self._watchers: Dict[int, List[Callable[[], None]]] = {}
        self.reads = 0
        self.writes = 0
        self.bytes_read = 0
        self.bytes_written = 0
        self.watch_fires = 0

    # -- CRUD -----------------------------------------------------------------
    def put(self, key: str, value: Any, nbytes: int = 0):
        self._kv[key] = value
        self.writes += 1
        self.bytes_written += nbytes

    def get(self, key: str, nbytes: int = 0):
        self.reads += 1
        self.bytes_read += nbytes
        return self._kv.get(key)

    def delete(self, key: str) -> bool:
        return self._kv.pop(key, None) is not None

    # -- versioned model --------------------------------------------------------
    def publish_model(self, version: int, blob: Any, nbytes: int = 0) -> bool:
        """Commit model version. Exactly-once: returns False if already present
        (a duplicate reduce execution after a requeue — the blob is discarded,
        keeping version publication idempotent)."""
        if version in self._models:
            return False
        assert version == self._latest + 1, (
            f"version gap: publishing {version}, latest {self._latest}")
        self._models[version] = blob
        self._latest = version
        self.writes += 1
        self.bytes_written += nbytes
        # versions commit in +1 order, so only exact-version watchers can exist
        for cb in self._watchers.pop(version, []):
            self.watch_fires += 1
            cb()
        return True

    def watch_version(self, version: int, callback: Callable[[], None]) -> None:
        """Fire ``callback`` once model ``version`` is committed — immediately
        if it already is, else at the ``publish_model(version)`` that lands it."""
        if self._latest >= version:
            self.watch_fires += 1
            callback()
            return
        self._watchers.setdefault(version, []).append(callback)

    def get_model(self, version: int, nbytes: int = 0) -> Optional[Any]:
        blob = self._models.get(version)
        if blob is not None:
            self.reads += 1
            self.bytes_read += nbytes
        return blob

    @property
    def latest_version(self) -> int:
        return self._latest

    def gc_models(self, keep_last: int = 2):
        """Drop stale versions (bounded memory, like Redis TTL). Pending
        ``watch_version`` registrations are untouched: a watch names a FUTURE
        commit, and GC only ever removes already-superseded blobs."""
        for v in sorted(self._models):
            if v <= self._latest - keep_last:
                del self._models[v]

    # -- durability ------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Serializable full state: the KV store, every LIVE model version
        (GC'd versions are gone and stay gone — restoring must not resurrect
        them), the latest-version cursor, and the accounting counters.
        Pending watchers are live callbacks and never serialize; see
        ``restore`` for how in-process watchers survive."""
        # lazily-published blobs (the real applier's LazyModelBlob)
        # solidify here: a checkpoint must hold values, not live thunks
        return {"kind": "DataServer",
                "kv": dict(self._kv),
                "models": [[v, b.materialize()
                            if hasattr(b, "materialize") else b]
                           for v, b in sorted(self._models.items())],
                "latest": self._latest,
                "reads": self.reads, "writes": self.writes,
                "bytes_read": self.bytes_read,
                "bytes_written": self.bytes_written,
                "watch_fires": self.watch_fires}

    def restore(self, state: Dict[str, Any]) -> None:
        """Replace this server's state with a snapshot, in place.

        Watchers registered on THIS object survive the restore (they are
        connection/session-bound callbacks, not state): any watch whose
        version the restored state has already committed fires immediately —
        the same guarantee ``watch_version`` makes for an already-published
        version — and watches on still-future versions stay pending. After a
        process crash there are no watchers to keep; reconnecting clients
        re-issue ``WatchVersion``."""
        if state.get("kind") != "DataServer":
            raise ValueError(f"not a DataServer snapshot: {state.get('kind')!r}")
        self._kv = dict(state["kv"])
        self._models = {v: blob for v, blob in state["models"]}
        self._latest = state["latest"]
        self.reads = state["reads"]
        self.writes = state["writes"]
        self.bytes_read = state["bytes_read"]
        self.bytes_written = state["bytes_written"]
        self.watch_fires = state["watch_fires"]
        for v in sorted(list(self._watchers)):
            if v <= self._latest:
                for cb in self._watchers.pop(v):
                    self.watch_fires += 1
                    cb()
