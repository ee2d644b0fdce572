"""Real server-side applier in PyTorch: the gateway-hosted half of the
DistML.js split (thin browser clients push contributions; the parameter
server owns the optimizer step).

Port of ``repro/core/applier.py``. The applier OWNS its hot model/optimizer
state and never re-reads it from the DataServer: within one server process
the blob stored for version v and the applier's state at version v are the
same values. Every update returns fresh tensors (nothing is written in
place), so a published blob never changes under a later drain.

Two modes:

* ``batch=False`` — the pre-batching baseline: tree-level ``apply_one`` /
  ``apply_delta`` per update (published blobs are the output trees).
* ``batch=True`` — the fast path: the flat carry runs a whole admitted drain
  in one ``apply_batch_flat`` call (the same elementwise kernels for every
  row), and every intermediate version is published as a ``LazyModelBlob``
  that splits its step's flat state into the leaves' shapes only if
  somebody actually fetches it (most intermediate versions are GC'd
  unseen).

Bit-exactness of the two modes — and of any drain split — is the contract
``tests/test_torch_applier.py`` enforces against the ``sequential_async`` /
``sequential_local`` references.
"""
from __future__ import annotations

from typing import Any, List, Optional

from repro_torch.core.protocol import ModelBlob, ServerApplier, wire_size
from repro_torch.core.tasks import GradResult


class LazyModelBlob:
    """A published model version materialized on first access.

    The batched applier publishes B intermediate versions per drain as
    ``apply_batch_flat``'s per-step outputs; ``materialize()`` splits its
    step's flat state into the leaves' shapes (views, no copy) exactly once,
    caching the tree. ``ServerEndpoint`` serves
    ``FetchModel`` with the materialized value and ``DataServer.snapshot``
    solidifies stored blobs, so laziness never crosses the wire or lands in
    a checkpoint."""

    __slots__ = ("_thunk", "_value")

    def __init__(self, thunk):
        self._thunk = thunk
        self._value = None

    def materialize(self):
        if self._thunk is not None:
            self._value = self._thunk()
            self._thunk = None
        return self._value


class RealApplier:
    """Backend state for a real PyTorch ``ServerApplier`` (see module docstring).

    Exposed as ``ServerApplier.backend`` by ``make_real_applier``; the
    gateway uses ``reseed`` after a snapshot restore to re-anchor the hot
    state on the restored latest blob."""

    def __init__(self, problem, *, batch: bool = True):
        self.problem = problem
        self.batch = bool(batch) and problem.supports_flat_apply
        self.version = 0
        self._nbytes: Optional[int] = None
        if self.batch:
            self._carry = problem.flat_carry(problem.params0,
                                             problem.opt_state0)
        else:
            self._params = problem.params0
            self._opt_state = problem.opt_state0

    # --------------------------------------------------------------- hooks
    def apply(self, blob, result, version: int):
        return self._advance([result], version)[0]

    def apply_batch(self, blob, results: List[Any],
                    base_version: int) -> List[Any]:
        return self._advance(results, base_version)

    def measure(self, blob) -> int:
        """Encoded size of a published blob as a ``ModelBlob`` reply would
        carry it. The serialized size is a pure function of array shapes and
        dtypes (raw buffer bytes + fixed headers), so one measurement covers
        every version of the same model."""
        if self._nbytes is None:
            mat = (blob.materialize() if isinstance(blob, LazyModelBlob)
                   else blob)
            self._nbytes = wire_size(ModelBlob(0, True, mat))
        return self._nbytes

    # --------------------------------------------------------------- state
    def reseed(self, blob, version: int) -> None:
        """Re-anchor the hot state on ``blob`` at ``version`` (snapshot
        restore: the DataServer's latest blob becomes the applier's truth)."""
        p, s = (blob.materialize() if isinstance(blob, LazyModelBlob)
                else blob)
        if self.batch:
            self._carry = self.problem.flat_carry(p, s)
        else:
            self._params, self._opt_state = p, s
        self.version = version

    def _advance(self, results: List[Any], base_version: int) -> List[Any]:
        """Apply a homogeneous admitted run (the endpoint segments drains by
        result type) and return the successive post-update blobs."""
        if base_version != self.version:
            raise ValueError(
                f"applier state is at version {self.version} but the "
                f"endpoint is applying onto {base_version} — the applier "
                f"must be the only writer of model versions")
        prob = self.problem
        blobs: List[Any] = []
        if not self.batch:
            p, s = self._params, self._opt_state
            for r in results:
                if isinstance(r, GradResult):
                    p, s = prob.apply_one(p, s, r.payload)
                else:
                    p, s = prob.apply_delta(p, s, r.payload, r.weight)
                blobs.append((p, s))
            self._params, self._opt_state = p, s
        elif isinstance(results[0], GradResult):
            rows = prob.pack_grad_rows([r.payload for r in results])
            self._carry, steps = prob.apply_batch_flat(self._carry, rows)
            for i in range(len(results)):
                blobs.append(LazyModelBlob(
                    lambda i=i: prob.unflatten_step(steps, i)))
        else:
            # LocalSteps deltas: weighted pytree adds, chained eagerly (the
            # delta path is model-transfer-bound, not dispatch-bound); the
            # repack below copies, so the published pytrees stay valid
            p, s = prob.unflatten_carry(self._carry)
            for r in results:
                p, s = prob.apply_delta(p, s, r.payload, r.weight)
                blobs.append((p, s))
            self._carry = prob.flat_carry(p, s)
        self.version += len(results)
        return blobs


def make_real_applier(problem, policy, *, batch: bool = True,
                      gc_keep: Optional[int] = None) -> ServerApplier:
    """A ``ServerApplier`` serving REAL PyTorch applies for ``problem``.

    The caller must have published ``(problem.params0, problem.opt_state0)``
    as model version 0 (``enqueue_problem(store_real_model=True)`` does), and
    the returned applier must be the only writer of later versions. The
    backend rides along as ``applier.backend`` (for ``reseed`` and tests)."""
    backend = RealApplier(problem, batch=batch)
    applier = ServerApplier(
        policy, backend.apply, gc_keep=gc_keep,
        measure=backend.measure,
        apply_batch=backend.apply_batch if backend.batch else None)
    applier.backend = backend
    return applier
