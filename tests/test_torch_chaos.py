"""The port's chaos harness (``repro_torch.core.chaos``) against the
reference's.

Two parts:

- every case of ``tests/test_chaos.py`` run on the port: the metamorphic
  contract (a K-shard federation gives the IDENTICAL SimResult as one
  QueueServer under any chaos schedule, in event and poll mode, also over
  the wire with seeded notification faults), the census around a
  ``remove_shard``, lease-expiry and watchdog recovery of dropped wakes,
  and bit-identical replays;
- cross-package equality: ``run_chaos`` in both packages on the same
  schedules gives equal ``SimResult``s as plain data
  (``dataclasses.asdict``: timelines, counts, bytes, every float bit for
  bit) for the churn, reshard, mixed and snapshot schedules x seeds {0, 1}
  x {event, poll}, and one seed over the wire with a ``FaultSpec``; the
  chaos CLI's sweep runs under ``sync`` and ``staleness:2``.
"""
from __future__ import annotations

import dataclasses

import pytest

from repro.core import chaos as RC
from repro.core import transport as RT
from repro_torch.core import chaos as TC
from repro_torch.core import transport as TT
from repro_torch.core.chaos import (ChaosEvent, ChaosSchedule, ChaosSimulator,
                                    churn_schedule, federation_census,
                                    metamorphic_check, mixed_schedule,
                                    reshard_schedule, run_chaos, _smoke_cost,
                                    _smoke_problem, _smoke_specs)
from repro_torch.core.simulator import (CostModel, Simulator,
                                        SyntheticProblem, VolunteerSpec)
from repro_torch.core.transport import FaultSpec

SEEDS = range(5)

# the same workload/population/cost the CI smoke uses — imported, not copied
_problem, _specs, _cost = _smoke_problem, _smoke_specs, _smoke_cost

LEAVABLE = [s.vid for s in _specs() if s.vid.startswith("x")]

SCHEDULES = {
    "churn": lambda seed: churn_schedule(seed, leavable=LEAVABLE),
    "reshard": reshard_schedule,
    "mixed": lambda seed: mixed_schedule(seed, leavable=LEAVABLE),
}


# ---------------------------------------------------------------------------
# the metamorphic contract on the port: 5 seeds x 3 families x 2 modes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["event", "poll"])
@pytest.mark.parametrize("family", sorted(SCHEDULES))
@pytest.mark.parametrize("seed", SEEDS)
def test_sharded_simresult_bitmatches_single_server(seed, family, mode):
    schedule = SCHEDULES[family](seed)
    single, sharded = metamorphic_check(schedule, mode=mode, n_shards=3)
    assert single == sharded
    assert single.final_version == 5
    assert single.mode == mode


@pytest.mark.parametrize("mode", ["event", "poll"])
@pytest.mark.parametrize("seed", SEEDS)
def test_metamorphic_holds_with_live_expiries(seed, mode):
    """Leases expire mid-task, so migrations carry in-flight messages with
    pending deadlines."""
    schedule = mixed_schedule(seed, leavable=LEAVABLE)
    single, sharded = metamorphic_check(schedule, mode=mode, n_shards=4,
                                        visibility_timeout=0.6)
    assert single == sharded
    assert single.final_version == 5
    assert single.requeues > 0 and single.expire_scans > 0


def test_chaos_replay_is_bit_identical():
    schedule = mixed_schedule(3, leavable=LEAVABLE)
    a = run_chaos(_problem(), _specs(), schedule, mode="event", n_shards=3,
                  cost=_cost())
    b = run_chaos(_problem(), _specs(), schedule, mode="event", n_shards=3,
                  cost=_cost())
    assert a == b
    assert a.timeline == b.timeline and a.makespan == b.makespan


def test_scripted_schedule_joins_and_resharding():
    script = ChaosSchedule([
        ChaosEvent(1.0, "add_shard"),
        ChaosEvent(2.0, "join", vid="late", speed=2.5),
        ChaosEvent(3.0, "remove_shard", shard=0),
        ChaosEvent(4.0, "remove_shard", shard=1),
        ChaosEvent(5.0, "remove_shard", shard=0),   # down to a single shard
        ChaosEvent(6.0, "add_shard"),
        ChaosEvent(8.0, "leave", vid="x00"),
        ChaosEvent(9.0, "expire"),
    ], label="scripted")
    single, sharded = (
        run_chaos(_problem(), _specs(), script, mode="event", n_shards=k,
                  cost=_cost()) for k in (1, 3))
    assert single == sharded
    assert sum(single.tasks_by_worker.values()) == 5 * (6 + 1)
    assert single.tasks_by_worker.get("late", 0) > 0


def test_remove_shard_conservation_census():
    schedule = ChaosSchedule([ChaosEvent(2.0, "remove_shard", shard=1)])
    sim = ChaosSimulator(_problem(), _specs(), schedule=schedule,
                         mode="event", n_shards=4, cost=_cost(),
                         visibility_timeout=1e9)
    before = {}
    orig = sim._chaos

    def instrumented(ev):
        before.update(federation_census(sim.qs))
        n_shards_before = len(sim.qs.shards)
        orig(ev)
        assert len(sim.qs.shards) == n_shards_before - 1
        assert federation_census(sim.qs) == before
        assert sim.queues_migrated > 0

    sim._chaos = instrumented
    assert sim.run().final_version == 5
    assert before, "chaos event never fired"


# ---------------------------------------------------------------------------
# transport faults on the port
# ---------------------------------------------------------------------------

_FAULTS = dict(drop_version_ready=0.3, duplicate=0.2, delay=0.15,
               delay_dt=0.4, max_faults=2)


@pytest.mark.parametrize("family", sorted(SCHEDULES))
@pytest.mark.parametrize("seed", SEEDS)
def test_metamorphic_holds_over_wire_with_message_faults(seed, family):
    schedule = SCHEDULES[family](seed)
    single, sharded = metamorphic_check(schedule, mode="event", n_shards=3,
                                        transport="wire",
                                        faults=FaultSpec(**_FAULTS),
                                        fault_seed=seed,
                                        visibility_timeout=2.0)
    assert single == sharded
    assert single.final_version == 5
    assert single.wire_bytes > 0


def _cost_tight():
    return CostModel(flops_per_sec=2.0e9, latency=0.020, bandwidth=12.5e6,
                     poll_interval=0.200, cache_bytes=1e15)


def test_dropped_version_ready_recovered_by_lease_expiry():
    """The first VersionReady is dropped with the client watchdog off; the
    visibility timeout requeues the abandoned task to an idle volunteer."""
    problem = SyntheticProblem(n_versions=2, n_mb=2, model_bytes=1.0e6,
                               grad_bytes=2.0e5, map_flops=8.0e8,
                               reduce_flops=2.0e7)
    specs = [VolunteerSpec(f"v{i:02d}", speed=0.8 + 0.05 * i)
             for i in range(8)]
    sim = Simulator(problem, specs, cost=_cost_tight(), mode="event",
                    visibility_timeout=3.0, transport="wire",
                    faults=FaultSpec(drop_version_ready=1.0, max_faults=1),
                    watchdog=False)
    res = sim.run()
    assert sim.port.faults["drop"] == 1
    assert res.final_version == 2
    assert sim.expired >= 1
    assert res.requeues >= 1
    assert sum(res.tasks_by_worker.values()) >= 2 * 3
    ctl = Simulator(problem, specs, cost=_cost_tight(), mode="event",
                    visibility_timeout=3.0, transport="wire")
    ctl_res = ctl.run()
    assert ctl_res.final_version == 2
    assert ctl.expired == 0
    assert sum(ctl_res.tasks_by_worker.values()) == 2 * 3


def test_dropped_queue_wake_recovered_by_idle_watchdog():
    problem = SyntheticProblem(n_versions=3, n_mb=2, model_bytes=1.0e6,
                               grad_bytes=2.0e5, map_flops=8.0e8,
                               reduce_flops=2.0e7)
    specs = [VolunteerSpec(f"v{i:02d}", speed=0.9 + 0.05 * i)
             for i in range(12)]
    sim = Simulator(problem, specs, cost=_cost_tight(), mode="event",
                    visibility_timeout=1.5, transport="wire",
                    faults=FaultSpec(drop_wake=1.0, max_faults=1))
    res = sim.run()
    assert sim.port.faults["drop"] == 1
    assert res.final_version == 3
    assert sum(res.tasks_by_worker.values()) >= 3 * 3


def test_fault_injection_replays_bit_identically():
    schedule = mixed_schedule(2, leavable=LEAVABLE)
    runs = [run_chaos(_problem(), _specs(), schedule, mode="event",
                      n_shards=3, cost=_cost(), transport="wire",
                      faults=FaultSpec(**_FAULTS), fault_seed=11,
                      visibility_timeout=2.0) for _ in range(2)]
    assert runs[0] == runs[1]


def test_leave_of_lease_holder_requeues_and_run_completes():
    schedule = ChaosSchedule([ChaosEvent(0.7, "leave", vid="x00"),
                              ChaosEvent(0.8, "leave", vid="x01")])
    res = run_chaos(_problem(), _specs(), schedule, mode="event", n_shards=2,
                    cost=_cost())
    assert res.final_version == 5
    assert res.requeues >= 1
    assert sum(res.tasks_by_worker.values()) == 5 * 7


# ---------------------------------------------------------------------------
# cross-package equality: the same schedule, the same SimResult
# ---------------------------------------------------------------------------

def _schedule(pkg, family, seed):
    leavable = [s.vid for s in pkg._smoke_specs() if s.vid.startswith("x")]
    if family == "reshard":
        return pkg.reshard_schedule(seed)
    make = {"churn": pkg.churn_schedule, "mixed": pkg.mixed_schedule,
            "snapshot": pkg.snapshot_schedule}[family]
    return make(seed, leavable=leavable)


def _run(pkg, family, seed, **kw):
    schedule = _schedule(pkg, family, seed)
    res = pkg.run_chaos(pkg._smoke_problem(), pkg._smoke_specs(), schedule,
                        n_shards=3, cost=pkg._smoke_cost(), **kw)
    return dataclasses.asdict(schedule), dataclasses.asdict(res)


@pytest.mark.parametrize("mode", ["event", "poll"])
@pytest.mark.parametrize("family", ["churn", "reshard", "mixed", "snapshot"])
@pytest.mark.parametrize("seed", [0, 1])
def test_run_chaos_equals_reference(seed, family, mode):
    got_schedule, got = _run(TC, family, seed, mode=mode)
    want_schedule, want = _run(RC, family, seed, mode=mode)
    assert got_schedule == want_schedule
    assert got == want
    assert got["final_version"] == 5 and len(got["timeline"]) > 0


def test_run_chaos_over_the_wire_with_faults_equals_reference():
    runs = [_run(pkg, "mixed", 1, mode="event", transport="wire",
                 faults=tp.FaultSpec(**_FAULTS), fault_seed=1,
                 visibility_timeout=2.0)
            for pkg, tp in ((TC, TT), (RC, RT))]
    assert runs[0] == runs[1]
    assert runs[0][1]["wire_bytes"] > 0


@pytest.mark.parametrize("policy", ["sync", "staleness:2"])
def test_chaos_cli_sweep_passes(policy, capsys):
    TC.main(seeds=1, policy=policy)
    out = capsys.readouterr().out
    assert f"chaos runs under policy={policy}" in out
    assert out.count("chaos_smoke,") == 10       # 5 schedules x 2 modes
