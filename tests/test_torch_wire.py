"""The port's gradient wire on the CPU: the wire transport, its fault
injector, compressed gradients in messages, the byte codec against the JAX
package's, and the compute entries fed what the wire delivers.

A transport must not change the floats: over the wire the port's Coordinator
bit-matches its sequential references as it does in process
(``tests/test_invariance.py``, ``tests/test_aggregation.py`` for the JAX
package), and a TernGrad run over the wire equals the same run in process.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import serialize as jserialize
from repro.core import protocol as JP
from repro.core import transport as JT
from repro_torch import bridge, tree
from repro_torch.checkpoint import serialize
from repro_torch.configs.paper_lstm import TrainParams
from repro_torch.core import protocol as P
from repro_torch.core.coordinator import Coordinator
from repro_torch.core.dataserver import DataServer
from repro_torch.core.initiator import enqueue_problem
from repro_torch.core import aggregation
from repro_torch.core.mapreduce import (TrainingProblem,
                                        sequential_accumulated,
                                        sequential_async, sequential_local)
from repro_torch.core.queue import QueueServer
from repro_torch.core.tasks import GradResult, results_queue
from repro_torch.core.transport import (FaultSpec, FaultyTransport,
                                        InProcessTransport, Transport,
                                        WireTransport, make_transport)
from repro_torch.data import text as ttext
from repro_torch.optim import compression as TC

# tests/test_invariance.py's reduced schedule: 4 versions of 4 mini-batches
TP = TrainParams(batch_size=16, examples_per_epoch=64, num_epochs=1,
                 sample_len=20, mini_batch_size=4, mini_batches_to_accumulate=4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These shapes are tiny: one intra-op thread is as fast, and it leaves
    the other cores to the timing-sensitive tests running beside these."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem():
    return TrainingProblem.paper_problem(corpus=ttext.synthetic_corpus(6000),
                                         tp=TP, device="cpu")


@pytest.fixture(scope="module")
def sequential(problem):
    return sequential_accumulated(problem)


def _bitmatch(a, b) -> bool:
    """Same leaves, same dtypes, same bits (+0.0 and -0.0 differ)."""
    def bits(x):
        x = x.detach().cpu()
        return x.view(torch.int32) if x.dtype == torch.float32 else x
    return all(x.dtype == y.dtype and torch.equal(bits(x), bits(y))
               for x, y in zip(tree.leaves(a), tree.leaves(b), strict=True))


# ---------------------------------------------------------------------------
# (a) the Coordinator over the wire == its sequential references
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 3])
def test_wire_worker_count_invariance(problem, sequential, k):
    res = Coordinator(problem, n_workers=k, transport="wire").run()
    assert res.final_version == problem.n_versions
    assert _bitmatch((res.params, res.opt_state),
                     (sequential[0], sequential[1]))
    assert res.losses == sequential[2]
    # the result is back on the problem's device, as tensors
    assert all(isinstance(x, torch.Tensor) and x.device == problem.device
               for x in tree.leaves((res.params, res.opt_state)))


def test_wire_churn_invariance(problem, sequential):
    churn = [(5, "leave", "w0"), (9, "leave", "w1"), (12, "join", "w9"),
             (20, "join", "w10")]
    res = Coordinator(problem, n_workers=4, churn=churn,
                      transport="wire").run()
    assert _bitmatch((res.params, res.opt_state),
                     (sequential[0], sequential[1]))


@pytest.mark.parametrize("k", [1, 3])
def test_wire_async_matches_sequential_async(problem, k):
    ref_params, ref_state, _ = sequential_async(problem)
    res = Coordinator(problem, n_workers=k, policy="staleness:2",
                      transport="wire").run()
    assert res.final_version == 16          # 4 versions x 4 mini-batches
    assert _bitmatch((res.params, res.opt_state), (ref_params, ref_state))


def test_wire_local_matches_sequential_local(problem):
    """LocalSteps(k=4) over the wire: the policy-matrix cell the smoke
    below runs, bit-equal to ``sequential_local``."""
    ref_params, ref_state, _ = sequential_local(problem, k=4)
    res = Coordinator(problem, n_workers=3, policy="local:4",
                      transport="wire").run()
    assert res.final_version == 4            # 16 mini-batches in rounds of 4
    assert _bitmatch((res.params, res.opt_state), (ref_params, ref_state))


def test_aggregation_smoke_runs_every_policy_over_both_transports(capsys):
    """``python -m repro_torch.core.aggregation --smoke`` on the CPU: three
    policies x {inproc, wire}, each cell bit-equal to its reference, as
    ``repro/core/aggregation.py::main`` runs them."""
    aggregation.main(n_workers=3, device="cpu")
    rows = [line.split(",") for line in capsys.readouterr().out.splitlines()
            if line.startswith("aggregation_smoke,")]
    assert [(r[1], r[2]) for r in rows] == [
        (p, t) for p in ("sync", "staleness:2", "local:4")
        for t in ("inproc", "wire")]
    assert all(r[-1] == "True" and r[3] == r[4] for r in rows)


# ---------------------------------------------------------------------------
# (b) compressed gradients: the wire does not change a TernGrad run
# ---------------------------------------------------------------------------

def test_ternary_wire_equals_inproc_and_learns():
    """``tests/test_compression.py::test_training_converges_with_ternary_ef``
    on the port, over the wire and in process."""
    tp = TrainParams(batch_size=8, examples_per_epoch=64, num_epochs=2,
                     sample_len=16, mini_batch_size=4,
                     mini_batches_to_accumulate=2, learning_rate=0.05)
    prob = TrainingProblem.paper_problem(corpus=ttext.synthetic_corpus(4000),
                                         tp=tp, device="cpu")
    codec = TC.make_codec("ternary")
    wire = Coordinator(prob, n_workers=2, codec=codec, transport="wire").run()
    inproc = Coordinator(prob, n_workers=2, codec=codec).run()
    assert _bitmatch((wire.params, wire.opt_state),
                     (inproc.params, inproc.opt_state))
    assert wire.losses == inproc.losses
    h = len(wire.losses) // 2
    first, second = np.mean(wire.losses[:h]), np.mean(wire.losses[h:])
    assert second < first + 0.05, (first, second)
    dense = Coordinator(prob, n_workers=2).run()
    assert wire.final_version == dense.final_version
    n_maps = prob.n_versions * tp.mini_batches_to_accumulate
    _, per_map = TC.ternary_encode(prob.params0)
    assert wire.bytes_sent == n_maps * per_map + \
        prob.n_versions * prob.model_bytes
    assert dense.bytes_sent == n_maps * prob.grad_bytes + \
        prob.n_versions * prob.model_bytes


@pytest.mark.parametrize("codec", [None, "ternary"])
def test_wire_bytes_are_what_the_transport_moved(problem, codec):
    """``RunResult.wire_bytes`` is the wire transport's own count, both
    ways; in process nothing is measured. The codec round-trips on the
    volunteer, so every gradient crosses decoded, dense fp32, under either
    codec."""
    c = None if codec is None else TC.make_codec(codec)
    coord = Coordinator(problem, n_workers=2, codec=c, transport="wire")
    res = coord.run()
    assert res.wire_bytes == coord.port.bytes_sent + coord.port.bytes_received
    n_maps = problem.n_versions * TP.mini_batches_to_accumulate
    assert res.wire_bytes > n_maps * problem.grad_bytes
    assert Coordinator(problem, n_workers=2, codec=c).run().wire_bytes is None


def test_one_volunteer_codec_run_is_the_same_over_the_wire(problem):
    """One volunteer carries one error-feedback chain through every map;
    over the wire it is the same chain, bit for bit."""
    codec = TC.make_codec("ternary")
    a = Coordinator(problem, n_workers=1, codec=codec, transport="wire").run()
    b = Coordinator(problem, n_workers=1, codec=codec).run()
    assert _bitmatch((a.params, a.opt_state), (b.params, b.opt_state))


@pytest.mark.parametrize("name", ["topk", "ternary"])
def test_compressed_gradresult_roundtrips_encode_message(name):
    """``tests/test_compression.py::
    test_compressed_gradresult_roundtrips_encode_message`` on the port."""
    rng = np.random.RandomState(3)
    g = {"lstm": {"wx": torch.from_numpy(rng.randn(64, 32).astype(np.float32)),
                  "b": torch.from_numpy(rng.randn(32).astype(np.float32))},
         "head": torch.from_numpy(rng.randn(32, 8).astype(np.float32))}
    codec = TC.make_codec(name, fraction=0.05) if name == "topk" \
        else TC.make_codec(name)
    payload, nbytes = codec.encode(g)
    assert nbytes < TC.dense_bytes(g)
    msg = P.PublishResult(results_queue(1),
                          GradResult(1, 3, payload, nbytes, 0.5, "w0",
                                     computed_at=1))
    back = P.decode_message(P.encode_message(msg))
    r = back.result
    assert (r.version, r.mb_index, r.nbytes, r.computed_at) == (1, 3, nbytes, 1)
    assert _bitmatch(codec.decode(r.payload, device="cpu"),
                     codec.decode(payload))
    with pytest.raises(ValueError, match="device="):
        codec.decode(r.payload)        # numpy leaves need a device named


# ---------------------------------------------------------------------------
# (c) the transports themselves
# ---------------------------------------------------------------------------

def _endpoint(problem):
    qs, ds = QueueServer(), DataServer()
    enqueue_problem(problem, qs, ds, store_real_model=False)
    return P.ServerEndpoint(qs, ds)


def test_make_transport_and_wire_accounting(problem):
    ep = _endpoint(problem)
    assert isinstance(make_transport("inproc", ep), InProcessTransport)
    wt = make_transport("wire", ep)
    assert isinstance(wt, WireTransport) and wt.measures_bytes
    assert not InProcessTransport(ep).measures_bytes
    with pytest.raises(ValueError):
        make_transport("carrier-pigeon", ep)
    with pytest.raises(TypeError):
        make_transport(lambda e: object(), ep)
    g = {"w": torch.ones(100)}
    wt.call(P.PublishResult(results_queue(0),
                            GradResult(0, 0, g, 400, 0.0, "w0",
                                       computed_at=0)))
    moved = wt.take_bytes()
    assert moved == wt.bytes_sent + wt.bytes_received > 400
    assert wt.take_bytes() == 0
    assert ep.qs.depth(results_queue(0)) == 1


def test_faulty_transport_drops_version_ready(problem):
    """``tests/test_protocol.py::test_faulty_transport_drops_version_ready``
    on the port: drop_version_ready=1.0 suppresses watch fires entirely;
    requests pass through untouched."""
    ep = _endpoint(problem)
    seen = []
    ft = FaultyTransport(InProcessTransport(ep),
                         FaultSpec(drop_version_ready=1.0), seed=0)
    ft.set_deliver(lambda c, m: seen.append(m))
    ft.call(P.WatchVersion(0, "w0"))       # v0 committed -> fires immediately
    assert seen == []
    assert ft.faults["drop"] == 1
    ft.call(P.SubscribeQueue("initial", "w0"))
    assert ft.call(P.DepthReq("initial")).value > 0


class _Recorder:
    """Inner transport stub: records nothing, lets a test fire
    notifications into the wrapper's sink."""

    measures_bytes = False

    def set_deliver(self, deliver):
        self.fire = deliver

    def call(self, msg):
        return None

    def take_bytes(self):
        return 0.0


def _fault_trace(Faulty, Spec, wake, ready, seed):
    inner = _Recorder()
    ft = Faulty(inner, Spec(drop_wake=0.3, drop_version_ready=0.4,
                            duplicate=0.3, delay=0.2, max_faults=40),
                seed=seed, defer=lambda dt, fn: out.append(("deferred", dt)))
    out = []
    ft.set_deliver(lambda c, m: out.append((c, type(m).__name__)))
    for i in range(200):
        inner.fire(f"w{i % 3}", wake("initial") if i % 2 else ready(i))
    return out, dict(ft.faults)


def test_faulty_transport_replays_the_jax_schedule():
    """Decisions come from ``random.Random(seed)`` in delivery order, so one
    seed gives one schedule, and the port's schedule is the JAX package's."""
    port = _fault_trace(FaultyTransport, FaultSpec, P.Wake, P.VersionReady, 7)
    again = _fault_trace(FaultyTransport, FaultSpec, P.Wake, P.VersionReady,
                         7)
    jax_side = _fault_trace(JT.FaultyTransport, JT.FaultSpec, JP.Wake,
                            JP.VersionReady, 7)
    other = _fault_trace(FaultyTransport, FaultSpec, P.Wake, P.VersionReady,
                         8)
    assert port == again == jax_side
    assert port != other
    assert sum(port[1].values()) == 40     # max_faults reached


def test_coordinator_under_seeded_notification_faults(problem, sequential):
    """Duplicated and (without a timer) immediately delivered notifications
    wake volunteers spuriously; the model is unchanged and the schedule
    replays."""
    def run():
        holder = {}

        def factory(ep):
            holder["ft"] = FaultyTransport(
                WireTransport(ep), FaultSpec(duplicate=0.4, delay=0.2,
                                             max_faults=50), seed=7)
            return holder["ft"]
        res = Coordinator(problem, n_workers=3, transport=factory).run()
        return res, dict(holder["ft"].faults)

    (a, fa), (b, fb) = run(), run()
    assert fa == fb and fa["duplicate"] > 0
    assert _bitmatch((a.params, a.opt_state), (sequential[0], sequential[1]))
    assert _bitmatch((b.params, b.opt_state), (sequential[0], sequential[1]))


# ---------------------------------------------------------------------------
# (d) the byte codec: tensor leaves, and blobs across the two packages
# ---------------------------------------------------------------------------

def _tree_of(dtype, seed):
    rng = np.random.RandomState(seed)
    def make(*shape):
        if dtype == "float32":
            return np.asarray(rng.randn(*shape), np.float32)
        return np.asarray(rng.randint(0, 200, shape), dtype)
    return {"a": make(3, 4), "b": [make(5), (make(2, 2), make())],
            "n": 7, "s": "text"}


@pytest.mark.parametrize("dtype", ["float32", "int32", "uint8"])
def test_blobs_cross_between_packages(dtype):
    t = _tree_of(dtype, seed=len(dtype))
    arrays = lambda fn: jax.tree.map(  # noqa: E731
        lambda a: fn(a) if isinstance(a, np.ndarray) else a, t)
    tt = arrays(lambda a: torch.from_numpy(a.copy()))
    jt = arrays(jnp.asarray)
    for codec in (None, "zlib"):
        kw = {"compress": codec is not None, "codec": codec}
        from_port = jserialize.loads(serialize.dumps(tt, **kw))
        from_jax = serialize.loads(jserialize.dumps(jt, **kw))
        for got in (from_port, from_jax):
            assert got["n"] == 7 and got["s"] == "text"
            want = [a for a in jax.tree.leaves(t)
                    if isinstance(a, np.ndarray)]
            have = [b for b in jax.tree.leaves(got)
                    if not isinstance(b, (int, str))]
            assert len(want) == len(have) == 4
            for a, b in zip(want, have):
                assert isinstance(b, np.ndarray) and b.dtype == a.dtype
                np.testing.assert_array_equal(b, a)


def test_bfloat16_leaves_cross_between_packages():
    x = torch.from_numpy(np.random.RandomState(9).randn(4, 6)
                         .astype(np.float32)).bfloat16()
    port_back = serialize.loads(serialize.dumps({"x": x}))["x"]
    assert port_back.dtype == torch.bfloat16 and torch.equal(port_back, x)
    words = x.view(torch.int16).numpy()
    j = jserialize.loads(serialize.dumps({"x": x}))["x"]
    assert j.dtype.name == "bfloat16"
    np.testing.assert_array_equal(j.view(np.int16), words)
    back = serialize.loads(jserialize.dumps({"x": jnp.asarray(j)}))["x"]
    assert back.dtype == torch.bfloat16 and torch.equal(back, x)


def test_tensors_that_require_grad_encode():
    w = torch.randn(3, 3, requires_grad=True)
    y = (w * 2).sum(0)                      # a non-leaf in the graph
    back = serialize.loads(serialize.dumps({"w": w, "y": y}))
    np.testing.assert_array_equal(back["w"], w.detach().numpy())
    np.testing.assert_array_equal(back["y"], y.detach().numpy())
    strided = torch.arange(12, dtype=torch.float32).reshape(3, 4).t()
    np.testing.assert_array_equal(serialize.loads(serialize.dumps(strided)),
                                  strided.numpy())


# ---------------------------------------------------------------------------
# (e) the compute entries take what the wire delivers: numpy leaves
# ---------------------------------------------------------------------------

def test_compute_entries_take_numpy_leaves(problem):
    p0, s0 = problem.params0, problem.opt_state0
    np_p, np_s = bridge.to_numpy(p0), bridge.to_numpy(s0)

    g_t, l_t = problem.map_compute(p0, 1, 2)
    g_n, l_n = problem.map_compute(np_p, 1, 2)
    assert l_t == l_n and _bitmatch(g_t, g_n)

    grads = {0: g_t, 1: problem.map_compute(p0, 1, 3)[0]}
    np_grads = {k: bridge.to_numpy(v) for k, v in grads.items()}
    want = problem.reduce_compute(p0, s0, grads)
    got = problem.reduce_compute(np_p, np_s, np_grads)
    assert _bitmatch(got, want)
    assert got[1]["step"].dtype == torch.int32

    assert _bitmatch(problem.apply_one(np_p, np_s, np_grads[0]),
                     problem.apply_one(p0, s0, g_t))

    delta, loss = problem.local_compute(p0, s0, 0, 2)
    delta_n, loss_n = problem.local_compute(np_p, np_s, 0, 2)
    assert loss == loss_n and _bitmatch(delta, delta_n)
    got = problem.apply_delta(np_p, np_s, bridge.to_numpy(delta), 0.5)
    assert _bitmatch(got, problem.apply_delta(p0, s0, delta, 0.5))
    assert got[1]["step"].dtype == torch.int32


def test_to_device_keeps_dtypes():
    t = {"f": np.ones((2, 2), np.float32), "i": np.array(3, np.int32),
         "u": torch.arange(4, dtype=torch.uint8)}
    out = tree.to_device(t, "cpu")
    assert {k: v.dtype for k, v in out.items()} == {
        "f": torch.float32, "i": torch.int32, "u": torch.uint8}
    assert out["i"].shape == () and out["u"] is t["u"]
    out["f"][0, 0] = 5.0                    # a copy, not a view of the input
    assert t["f"][0, 0] == 1.0


def test_transport_base_class_contract():
    assert Transport().take_bytes() == 0.0
    with pytest.raises(NotImplementedError):
        Transport().call(None)
