"""The port's batched server applier on the CPU: bit-exactness of the drained
fast path against the port's own sequential references, drain-edge
semantics, measured publish sizes, lazy blobs, the flat-carry methods, the
Simulator's dispatch cost, and the published models against the JAX
package's applier.

The contract is ``tests/test_applier.py``'s, in torch: ``submit_batch`` over
a ``make_real_applier`` lands on the SAME BITS as ``sequential_async`` /
chained ``apply_one`` for every drain split and both applier modes. Against
JAX the published models agree within the fp32 tolerance of
``tests/test_kernels.py::_tol`` (the two frameworks may round an update's
multiply-add differently).
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.paper_lstm import TrainParams as JTrainParams
from repro.core.aggregation import make_policy as j_make_policy
from repro.core.applier import make_real_applier as j_make_real_applier
from repro.core.dataserver import DataServer as JDataServer
from repro.core.mapreduce import TrainingProblem as JProblem
from repro.core.protocol import FetchModel as JFetchModel
from repro.core.protocol import ServerEndpoint as JServerEndpoint
from repro.core.protocol import SubmitUpdate as JSubmitUpdate
from repro.core.queue import QueueServer as JQueueServer
from repro.core.tasks import GradResult as JGradResult
from repro.core.tasks import INITIAL_QUEUE as J_INITIAL_QUEUE
from repro.data.text import synthetic_corpus as j_synthetic_corpus
from repro_torch import bridge, tree
from repro_torch.configs.paper_lstm import TrainParams
from repro_torch.core.aggregation import make_policy
from repro_torch.core.applier import (LazyModelBlob, RealApplier,
                                      make_real_applier)
from repro_torch.core.dataserver import DataServer
from repro_torch.core.mapreduce import (TrainingProblem, sequential_async,
                                        sequential_fullbatch,
                                        sequential_local)
from repro_torch.core.protocol import (FetchModel, ModelBlob, ServerEndpoint,
                                       SubmitUpdate, UpdateCommitted,
                                       UpdateRejected, wire_size)
from repro_torch.core.queue import QueueServer
from repro_torch.core.simulator import (CostModel, Simulator,
                                        SyntheticProblem, VolunteerSpec)
from repro_torch.core.tasks import DeltaResult, GradResult, INITIAL_QUEUE
from repro_torch.data.text import synthetic_corpus

N = 12  # updates per staged chain — enough for multi-segment drains
TP_ARGS = dict(batch_size=32, examples_per_epoch=256, num_epochs=1,
               sample_len=40, mini_batch_size=8,
               mini_batches_to_accumulate=4)
TOL = 2e-5  # tests/test_kernels.py::_tol, fp32


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny shapes: one intra-op thread is as fast, and it leaves the other
    cores to the timing-sensitive tests running beside these."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem():
    return TrainingProblem.paper_problem(corpus=synthetic_corpus(20_000),
                                         tp=TrainParams(**TP_ARGS), seed=0,
                                         d_model=8, device="cpu")


@pytest.fixture(scope="module")
def grads(problem):
    """g_i computed at params_i along the reference chain, as numpy (the
    wire-deserialized form the server actually sees)."""
    p, s = problem.params0, problem.opt_state0
    out = []
    for i in range(N):
        v, mb = problem.stream_slot(i)
        g, _ = problem.map_compute(p, v, mb)
        out.append(tree.map(lambda t: t.numpy(), g))
        p, s = problem.apply_one(p, s, g)
    return out


@pytest.fixture(scope="module")
def ref(problem):
    p, s, _ = sequential_async(problem, n_updates=N)
    return p, s


def bit_eq(a, b) -> bool:
    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(torch.as_tensor(x), torch.as_tensor(y))
        for x, y in zip(la, lb))


def fresh_endpoint(problem, *, batch, policy="staleness:2", gc_keep=None):
    qs, ds = QueueServer(), DataServer()
    qs.declare(INITIAL_QUEUE, timeout=float("inf"))
    ds.publish_model(0, (problem.params0, problem.opt_state0), nbytes=0)
    applier = make_real_applier(problem, make_policy(policy), batch=batch,
                                gc_keep=gc_keep)
    return ServerEndpoint(qs, ds, applier=applier), qs, ds, applier


def submit(endpoint, qs, results, *, split, submit_cls=SubmitUpdate,
           queue=INITIAL_QUEUE):
    """Drive ``results`` through ``submit_batch`` in drains of the given
    sizes, leasing a real ticket per message."""
    replies = []
    it = iter(results)
    for size in split:
        msgs = []
        for r in (next(it) for _ in range(size)):
            qs.publish(queue, "t")
            tag, _ = qs.lease(queue, "w", 0.0)
            msgs.append(submit_cls(queue, tag, r))
        replies.extend(endpoint.submit_batch(msgs))
    return replies


def grad_results(grads, cls=GradResult):
    return [cls(version=i, mb_index=0, payload=g, computed_at=i)
            for i, g in enumerate(grads)]


# ---------------------------------------------------------------------------
# bit-exactness matrix: drain splits x applier modes == sequential_async
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("split", [[1] * N, [4] * (N // 4), [N],
                                   [1, 2, 3, 6], [5, 7]],
                         ids=["ones", "fours", "whole", "ragged", "two"])
@pytest.mark.parametrize("batch", [False, True], ids=["plain", "batched"])
def test_drained_grads_bit_match_sequential(problem, grads, ref, split,
                                            batch):
    endpoint, qs, ds, ap = fresh_endpoint(problem, batch=batch)
    replies = submit(endpoint, qs, grad_results(grads), split=split)
    assert [r.version for r in replies] == list(range(1, N + 1))
    assert all(isinstance(r, UpdateCommitted) for r in replies)
    blob = endpoint.handle(FetchModel(N)).blob
    assert bit_eq(blob, ref)
    assert ap.applied == N and ap.rejected == 0
    if batch:
        assert ap.batches == sum(1 for s in split if s >= 2)
        assert ap.batched_updates == sum(s for s in split if s >= 2)
    else:
        assert ap.batches == 0 and ap.batched_updates == 0


def test_intermediate_versions_bit_match_sequential(problem, grads):
    """EVERY published version — not just the last — matches the reference
    prefix chain, whichever drain split produced it."""
    p, s = problem.params0, problem.opt_state0
    prefixes = []
    for g in grads[:6]:
        p, s = problem.apply_one(p, s, g)
        prefixes.append((p, s))
    endpoint, qs, ds, ap = fresh_endpoint(problem, batch=True)
    submit(endpoint, qs, grad_results(grads[:6]), split=[2, 4])
    for v in range(1, 7):
        assert bit_eq(endpoint.handle(FetchModel(v)).blob, prefixes[v - 1])


def test_delta_chain_bit_matches_sequential_local(problem):
    k, n_rounds = 4, 4
    refp, refs, _ = sequential_local(problem, k=k, n_updates=n_rounds)
    p, s = problem.params0, problem.opt_state0
    deltas = []
    for slot in range(n_rounds):
        d, _ = problem.local_compute(p, s, slot * k, k)
        deltas.append(tree.map(lambda t: t.numpy(), d))
        p, s = problem.apply_delta(p, s, d)
    results = [DeltaResult(slot=i, computed_at=i, payload=d)
               for i, d in enumerate(deltas)]
    for batch in (False, True):
        endpoint, qs, ds, ap = fresh_endpoint(problem, batch=batch)
        submit(endpoint, qs, results, split=[n_rounds])
        assert bit_eq(endpoint.handle(FetchModel(n_rounds)).blob,
                      (refp, refs))


def test_mixed_grad_delta_drain_segments(problem, grads):
    """A drain mixing result kinds splits into homogeneous segments; only
    the grad segment (>= 2 elements) rides the batched call, and the result
    bit-matches the fully sequential chain."""
    p, s = problem.params0, problem.opt_state0
    for g in grads[:3]:
        p, s = problem.apply_one(p, s, g)
    d, _ = problem.local_compute(p, s, 0, 2)
    p_ref, s_ref = problem.apply_delta(p, s, d)
    results = grad_results(grads[:3]) + [
        DeltaResult(slot=0, computed_at=3,
                    payload=tree.map(lambda t: t.numpy(), d))]
    endpoint, qs, ds, ap = fresh_endpoint(problem, batch=True)
    replies = submit(endpoint, qs, results, split=[4])
    assert all(isinstance(r, UpdateCommitted) for r in replies)
    assert bit_eq(endpoint.handle(FetchModel(4)).blob, (p_ref, s_ref))
    assert ap.batches == 1 and ap.batched_updates == 3  # grads only


# ---------------------------------------------------------------------------
# drain-edge semantics
# ---------------------------------------------------------------------------

def test_rejection_mid_drain_nacks_front_in_order(problem, grads):
    """Element i is admitted against the version it would have observed
    sequentially; a rejected element reports that version, its ticket goes
    back to the FRONT of the queue, and later elements still commit."""
    endpoint, qs, ds, ap = fresh_endpoint(problem, batch=True,
                                          policy="staleness:0")
    results = grad_results(grads[:4])
    results[0] = dataclasses.replace(results[0], computed_at=0)
    results[1] = dataclasses.replace(results[1], computed_at=0)
    results[2] = dataclasses.replace(results[2], computed_at=1)
    results[3] = dataclasses.replace(results[3], computed_at=2)
    replies = submit(endpoint, qs, results, split=[4])
    assert isinstance(replies[0], UpdateCommitted) and replies[0].version == 1
    assert isinstance(replies[1], UpdateRejected) and replies[1].latest == 1
    assert isinstance(replies[2], UpdateCommitted) and replies[2].version == 2
    assert isinstance(replies[3], UpdateCommitted) and replies[3].version == 3
    assert ap.applied == 3 and ap.rejected == 1
    qs.publish(INITIAL_QUEUE, "later")
    _, body = qs.lease(INITIAL_QUEUE, "w2", 0.0)
    assert body == "t"
    p, s = problem.params0, problem.opt_state0
    for g in (grads[0], grads[2], grads[3]):
        p, s = problem.apply_one(p, s, g)
    assert bit_eq(endpoint.handle(FetchModel(3)).blob, (p, s))


def test_all_rejected_drain_publishes_nothing(problem, grads):
    endpoint, qs, ds, ap = fresh_endpoint(problem, batch=True,
                                          policy="staleness:0")
    submit(endpoint, qs, grad_results(grads[:1]), split=[1])
    writes_before, latest_before = ds.writes, ds.latest_version
    stale = [dataclasses.replace(r, computed_at=0)
             for r in grad_results(grads[1:4])]
    replies = submit(endpoint, qs, stale, split=[3])
    assert all(isinstance(r, UpdateRejected) for r in replies)
    assert all(r.latest == 1 for r in replies)
    assert ds.writes == writes_before and ds.latest_version == latest_before
    assert ap.applied == 1 and ap.rejected == 3
    assert ap.batches == 0


def test_empty_drain_is_a_noop(problem):
    endpoint, qs, ds, ap = fresh_endpoint(problem, batch=True)
    writes_before = ds.writes
    assert endpoint.submit_batch([]) == []
    assert ds.writes == writes_before and ap.applied == 0


@pytest.mark.parametrize("gc_keep,split,survivors",
                         [(2, [6], [5, 6]), (3, [4, 4], [6, 7, 8])],
                         ids=["one-drain", "two-drains"])
def test_gc_keep_survivors(problem, grads, gc_keep, split, survivors):
    """gc runs ONCE at drain end; the surviving version set equals the
    sequential (gc-after-every-publish) endpoint's, and the kept blobs are
    fetchable and equal to the sequential chain's (a drain never publishes
    a buffer a later update rewrote in place)."""
    n = sum(split)
    chain, (p, s) = {}, (problem.params0, problem.opt_state0)
    for v, g in enumerate(grads[:n], start=1):
        p, s = problem.apply_one(p, s, g)
        chain[v] = (p, s)
    for batch, sp in ((False, [1] * n), (True, split)):
        endpoint, qs, ds, ap = fresh_endpoint(problem, batch=batch,
                                              gc_keep=gc_keep)
        submit(endpoint, qs, grad_results(grads[:n]), split=sp)
        assert sorted(ds._models) == survivors
        for v in survivors:
            assert bit_eq(endpoint.handle(FetchModel(v)).blob, chain[v])


# ---------------------------------------------------------------------------
# measured publish sizes
# ---------------------------------------------------------------------------

def test_model_nbytes_measured_matches_wire_encoding(problem, grads):
    sizes = []
    for batch in (False, True):
        endpoint, qs, ds, ap = fresh_endpoint(problem, batch=batch)
        assert ap.model_nbytes == 0
        bytes_before = ds.bytes_written
        submit(endpoint, qs, grad_results(grads[:4]), split=[4])
        blob = endpoint.handle(FetchModel(4)).blob
        expect = wire_size(ModelBlob(0, True, blob))
        assert ap.model_nbytes == expect > 0
        assert ds.bytes_written - bytes_before == 4 * expect
        sizes.append(ap.model_nbytes)
    assert sizes[0] == sizes[1]


# ---------------------------------------------------------------------------
# lazy blob materialization
# ---------------------------------------------------------------------------

def test_batched_publishes_are_lazy_and_fetch_materializes(problem, grads):
    endpoint, qs, ds, ap = fresh_endpoint(problem, batch=True)
    submit(endpoint, qs, grad_results(grads[:4]), split=[4])
    stored = [ds._models[v] for v in (2, 3)]
    assert all(isinstance(b, LazyModelBlob) for b in stored)
    reply = endpoint.handle(FetchModel(3))
    assert not isinstance(reply.blob, LazyModelBlob)
    p, _ = reply.blob
    assert all(isinstance(x, torch.Tensor) for x in tree.leaves(p))


def test_snapshot_solidifies_lazy_blobs(problem, grads):
    endpoint, qs, ds, ap = fresh_endpoint(problem, batch=True)
    submit(endpoint, qs, grad_results(grads[:3]), split=[3])
    snap = ds.snapshot()
    for _, blob in snap["models"]:
        assert not isinstance(blob, LazyModelBlob)
    ds2 = DataServer()
    ds2.restore(snap)
    assert ds2.latest_version == 3
    assert bit_eq(ds2.get_model(3), endpoint.handle(FetchModel(3)).blob)


def test_reseed_restores_applier_state(problem, grads, ref):
    """Snapshot-restore path: reseeding from the stored latest blob lets the
    applier continue the chain bit-exactly, in both modes."""
    for batch in (False, True):
        endpoint, qs, ds, ap = fresh_endpoint(problem, batch=batch)
        submit(endpoint, qs, grad_results(grads[:6]), split=[3, 3])
        backend2 = RealApplier(problem, batch=batch)
        backend2.reseed(ds.get_model(6), 6)
        blobs = backend2._advance(
            [GradResult(version=6 + i, mb_index=0, payload=g,
                        computed_at=6 + i)
             for i, g in enumerate(grads[6:])], 6)
        last = blobs[-1]
        last = last.materialize() if isinstance(last, LazyModelBlob) else last
        assert bit_eq(last, ref)


# ---------------------------------------------------------------------------
# the flat carry: no writes in place, packing, step unflatten
# ---------------------------------------------------------------------------

def test_apply_batch_matches_chained_apply_one(problem, grads):
    p, s = problem.params0, problem.opt_state0
    outs = problem.apply_batch(p, s, grads[:5])
    assert len(outs) == 5
    for i in range(5):
        p, s = problem.apply_one(p, s, grads[i])
        assert bit_eq(outs[i], (p, s))


def test_apply_one_and_delta_leave_their_inputs_untouched(problem, grads):
    """Nothing writes in place: the applier publishes what an update returns
    and keeps applying from it, so an update must never change its inputs
    or hand them back."""
    p0, s0 = tree.map(torch.clone, (problem.params0, problem.opt_state0))
    before = tree.map(torch.clone, (p0, s0))
    out = problem.apply_one(p0, s0, grads[0])
    assert bit_eq((p0, s0), before)
    assert not any(a is b for a, b in zip(tree.leaves(out),
                                          tree.leaves((p0, s0))))
    delta = tree.map(lambda a, b: a - b, out, (p0, s0))
    d_before = tree.map(torch.clone, delta)
    out_d = problem.apply_delta(p0, s0, delta, 0.5)
    assert bit_eq((p0, s0), before) and bit_eq(delta, d_before)
    assert not any(a is b for a, b in zip(tree.leaves(out_d),
                                          tree.leaves((p0, s0))))


def test_pack_grad_rows_matches_per_row_pack(problem, grads):
    rows = problem.pack_grad_rows(grads[:5])
    expect = torch.stack([problem.pack_grads(g) for g in grads[:5]])
    assert rows.shape == expect.shape == (5, problem.n_params)
    assert torch.equal(rows, expect)
    # tensor leaves pack to the same row as their numpy twins
    as_tensors = [tree.map(torch.from_numpy, g) for g in grads[:5]]
    assert torch.equal(problem.pack_grad_rows(as_tensors), rows)
    flat0 = np.concatenate([np.ravel(x) for x in tree.leaves(grads[0])])
    assert np.array_equal(rows[0].numpy(), flat0)


def test_unflatten_step_matches_carry_views(problem, grads):
    carry = problem.flat_carry(problem.params0, problem.opt_state0)
    rows = problem.pack_grad_rows(grads[:4])
    before = tree.map(torch.clone, carry)
    out, steps = problem.apply_batch_flat(carry, rows)
    assert bit_eq(carry, before)                  # the carry is never written
    assert len(steps) == 4 and out is steps[-1]
    for i in (0, 3):
        step = problem.unflatten_step(steps, i)
        assert bit_eq(step, problem.unflatten_carry(steps[i]))
        # views of the step's flat state, no copy
        assert all(x.untyped_storage().data_ptr() ==
                   steps[i][0].untyped_storage().data_ptr()
                   for x in tree.leaves(step[0]))


def test_batch_steps_never_alias_the_carry(problem, grads):
    """No step of a drain shares memory with the carry it started from, and
    a later drain from the returned carry never rewrites a published step."""
    carry = problem.flat_carry(problem.params0, problem.opt_state0)
    out, steps = problem.apply_batch_flat(
        carry, problem.pack_grad_rows(grads[:3]))
    carry_ptrs = {x.untyped_storage().data_ptr() for x in tree.leaves(carry)}
    assert not any(x.untyped_storage().data_ptr() in carry_ptrs
                   for x in tree.leaves(steps))
    published = tree.map(torch.clone, steps)
    problem.apply_batch_flat(out, problem.pack_grad_rows(grads[3:5]))
    assert bit_eq(steps, published)
    # an empty drain returns the carry itself and no steps
    same, none = problem.apply_batch_flat(
        out, torch.empty((0, problem.n_params)))
    assert same is out and none == []


def test_flat_carry_round_trips_and_copies(problem):
    before = tree.map(torch.clone, (problem.params0, problem.opt_state0))
    carry = problem.flat_carry(problem.params0, problem.opt_state0)
    assert bit_eq(problem.unflatten_carry(carry), before)
    carry[0].add_(1.0)                          # the carry owns its memory
    carry[2]["step"].add_(1)
    assert bit_eq((problem.params0, problem.opt_state0), before)


def test_supports_flat_apply_gates_batch_mode(problem):
    assert problem.supports_flat_apply
    assert make_real_applier(problem, make_policy("staleness:2"),
                             batch=True).backend.batch is True
    off = make_real_applier(problem, make_policy("staleness:2"), batch=False)
    assert off.backend.batch is False and off.apply_batch is None
    mixed = dataclasses.replace(
        problem, params0={**problem.params0,
                          "head": {k: v.double() for k, v in
                                   problem.params0["head"].items()}})
    assert not mixed.supports_flat_apply


def test_applier_refuses_version_skew(problem, grads):
    backend = RealApplier(problem, batch=True)
    with pytest.raises(ValueError, match="only writer"):
        backend._advance(grad_results(grads[:2]), 5)


def test_sequential_fullbatch_steps_like_apply_one(problem):
    """TFJS-Sequential-N: one optimizer step per batch of ``batch_size``
    examples; at bs = the version's batch it is one step a version."""
    p, s, losses = sequential_fullbatch(problem, n_versions=2)
    assert len(losses) == 2 and all(np.isfinite(losses))
    tp = problem.tp
    pp, ss = problem.params0, problem.opt_state0
    for v in range(2):
        e, b = problem.version_to_epoch_batch(v)
        batch = problem.data.make_batch(problem.data.starts(e, b,
                                                            tp.batch_size))
        _, g = problem.loss_and_grads(pp, batch)
        pp, ss = problem.apply_one(pp, ss, g)
    assert bit_eq((p, s), (pp, ss))
    _, _, small = sequential_fullbatch(problem, batch_size=8, n_versions=1)
    assert len(small) == tp.batch_size // 8


# ---------------------------------------------------------------------------
# simulator dispatch-cost pipeline (the port's Simulator)
# ---------------------------------------------------------------------------

def _sim(server_apply, dispatch_cost=0.0, k=3):
    problem = SyntheticProblem(n_versions=4, n_mb=6, model_bytes=1.0e6,
                               grad_bytes=1.0e5)
    specs = [VolunteerSpec(f"v{i}", speed=1.0 + 0.1 * i) for i in range(k)]
    return Simulator(problem, specs, cost=CostModel(dispatch_cost=dispatch_cost),
                     policy="staleness:2", server_apply=server_apply)


def test_zero_dispatch_cost_is_bit_identical():
    base = _sim(True).run()
    sim = _sim(True, dispatch_cost=0.0)
    again = sim.run()
    assert dataclasses.asdict(base) == dataclasses.asdict(again)
    assert sim.apply_dispatches == 0 and sim.batched_dispatch_credits == 0


def test_positive_dispatch_cost_pools_commits():
    sim = _sim(True, dispatch_cost=0.05, k=6)
    res = sim.run()
    assert res.final_version == 24
    assert sim.apply_dispatches > 0 and sim.batched_dispatch_credits > 0
    assert res.makespan > _sim(True, k=6).run().makespan


# ---------------------------------------------------------------------------
# against the JAX package's applier
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_pair():
    """The JAX problem and the port's problem on the JAX problem's
    params0/opt_state0, carried across with ``bridge``."""
    jprob = JProblem.paper_problem(corpus=j_synthetic_corpus(20_000),
                                   tp=JTrainParams(**TP_ARGS), seed=0,
                                   d_model=8)
    tprob = TrainingProblem.paper_problem(corpus=synthetic_corpus(20_000),
                                          tp=TrainParams(**TP_ARGS), seed=0,
                                          d_model=8, device="cpu")
    tprob = dataclasses.replace(
        tprob,
        params0=bridge.params_from_jax(
            jax.tree.map(np.asarray, jprob.params0), "cpu"),
        opt_state0=bridge.opt_state_from_jax(
            jax.tree.map(np.asarray, jprob.opt_state0), "cpu"))
    return jprob, tprob


def _seeded_grads(params, n, seed):
    """n gradient trees of the params' shapes, numpy, from one seed."""
    rng = np.random.RandomState(seed)
    return [tree.map(lambda p: (0.1 * rng.randn(*p.shape)).astype(np.float32),
                     params) for _ in range(n)]


def _jax_published(jprob, grads, split):
    qs, ds = JQueueServer(), JDataServer()
    qs.declare(J_INITIAL_QUEUE, timeout=float("inf"))
    ds.publish_model(0, (jprob.params0, jprob.opt_state0), nbytes=0)
    ap = j_make_real_applier(jprob, j_make_policy("staleness:2"))
    ep = JServerEndpoint(qs, ds, applier=ap)
    submit(ep, qs, grad_results(grads, JGradResult), split=split,
           submit_cls=JSubmitUpdate, queue=J_INITIAL_QUEUE)
    return [jax.tree.map(np.asarray, ep.handle(JFetchModel(v)).blob)
            for v in range(1, len(grads) + 1)]


@pytest.mark.parametrize("drain", [1, 4, 16])
def test_published_models_match_the_jax_applier(jax_pair, drain):
    jprob, tprob = jax_pair
    grads = _seeded_grads(jax.tree.map(np.asarray, jprob.params0), 16,
                          seed=drain)
    split = [drain] * (16 // drain)
    want = _jax_published(jprob, grads, split)
    endpoint, qs, ds, ap = fresh_endpoint(tprob, batch=True,
                                          policy="staleness:2")
    submit(endpoint, qs, grad_results(grads), split=split)
    assert ap.batches == (0 if drain == 1 else 16 // drain)
    for v in range(1, 17):
        got = bridge.to_numpy(endpoint.handle(FetchModel(v)).blob)
        jl, tl = tree.leaves(want[v - 1]), tree.leaves(got)
        assert len(jl) == len(tl)
        for a, b in zip(jl, tl):
            assert a.dtype == b.dtype and a.shape == b.shape
            if a.dtype == np.int32:
                np.testing.assert_array_equal(a, b)       # the step counter
            else:
                np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)
