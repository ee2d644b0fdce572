"""The port's virtual-time engines against the reference's: ``Simulator``
and ``traces`` are pure Python with the same arithmetic in both packages,
so the same schedule must give EQUAL results, field for field, exactly.
"""
from __future__ import annotations

import dataclasses

import pytest

from repro.core import simulator as jsim
from repro.core import traces as jtraces
from repro.core import transport as jtransport
from repro_torch.core import simulator as tsim
from repro_torch.core import traces as ttraces
from repro_torch.core import transport as ttransport

POLICIES = ["sync", "staleness:2", "local:3"]


def _run(mod, transport_mod, *, mode, policy, transport="inproc",
         faults=None, server_apply=False, dispatch_cost=0.0, specs=None,
         problem_kw=None, **sim_kw):
    problem = mod.SyntheticProblem(**(problem_kw or dict(
        n_versions=3, n_mb=5, model_bytes=2.0e5, grad_bytes=5.0e4,
        map_flops=5.0e8, reduce_flops=1.0e7)))
    if specs is None:
        specs = [mod.VolunteerSpec(f"v{i}", speed=0.6 + 0.3 * i,
                                   join_time=0.4 * i,
                                   leave_time=(30.0 if i == 1 else
                                               float("inf")))
                 for i in range(4)]
    else:
        specs = [mod.VolunteerSpec(**dataclasses.asdict(s)) for s in specs]
    spec = None if faults is None else transport_mod.FaultSpec(**faults)
    sim = mod.Simulator(problem, specs, mode=mode, policy=policy,
                        transport=transport, faults=spec, fault_seed=7,
                        server_apply=server_apply,
                        cost=mod.CostModel(dispatch_cost=dispatch_cost),
                        **sim_kw)
    return dataclasses.asdict(sim.run())


def _both(**kw):
    ref = _run(jsim, jtransport, **kw)
    port = _run(tsim, ttransport, **kw)
    return ref, port


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mode", ["event", "poll"])
def test_simresult_equals_reference(mode, policy):
    ref, port = _both(mode=mode, policy=policy)
    assert ref["final_version"] > 0 and ref["timeline"]
    assert port == ref


@pytest.mark.parametrize("policy", POLICIES)
def test_simresult_equals_reference_under_faults(policy):
    faults = dict(drop_wake=0.2, drop_version_ready=0.2, duplicate=0.1,
                  delay=0.1, delay_dt=0.3)
    ref, port = _both(mode="event", policy=policy, faults=faults,
                      visibility_timeout=5.0)
    assert port == ref
    if policy == "sync":                    # the faults were in force
        assert port != _run(tsim, ttransport, mode="event", policy=policy,
                            visibility_timeout=5.0)


@pytest.mark.parametrize("policy", POLICIES)
def test_simresult_equals_reference_over_the_wire(policy):
    ref, port = _both(mode="event", policy=policy, transport="wire")
    assert ref["wire_bytes"] > 0
    assert port == ref


def test_server_apply_with_dispatch_cost_equals_reference():
    ref, port = _both(mode="event", policy="staleness:2", server_apply=True,
                      dispatch_cost=0.05)
    assert port == ref


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_traces_equal_reference(seed):
    kw = dict(n_devices=120, horizon=2 * 3600.0, day=3600.0,
              session_median=120.0, seed=seed)
    jp, tp = jtraces.TraceParams(**kw), ttraces.TraceParams(**kw)
    js, ts = jtraces.generate_sessions(jp), ttraces.generate_sessions(tp)
    assert [dataclasses.asdict(s) for s in ts] == \
        [dataclasses.asdict(s) for s in js]
    assert dataclasses.asdict(ttraces.trace_stats(ts, tp)) == \
        dataclasses.asdict(jtraces.trace_stats(js, jp))


def test_simulator_on_a_trace_equals_reference():
    """A churning fleet from the trace generator, in the Simulator."""
    tp = ttraces.TraceParams(n_devices=40, horizon=1800.0, day=900.0,
                             session_median=60.0, seed=5)
    specs = ttraces.generate_sessions(tp)
    ref, port = _both(mode="event", policy="sync", specs=specs,
                      problem_kw=dict(n_versions=2, n_mb=6),
                      visibility_timeout=60.0)
    assert port == ref
