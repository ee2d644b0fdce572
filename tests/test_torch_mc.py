"""The port's model checker (``repro_torch.analysis.mc``) against the
reference's.

Two parts:

- every case of ``tests/test_mc.py`` run on the port: exhaustive clean
  exploration of the tiny sync world, the expiry budget, partial-order
  savings, the seeded historical bugs rediscovered and shrunk to 1-minimal
  counterexamples that replay bit for bit (also through
  ``repro_torch.core.chaos.replay_mc_trace`` from a JSON payload),
  capture/restore, symmetry, the invariant API, the 2-gateway world over
  the port's ``GatewayRing`` and the ``COVERED_MESSAGES`` ledger;
- cross-package equality: ``explore`` of the tiny sync world and of the
  gateway world reaches the same number of states and transitions, and the
  same set of fingerprints (``fingerprint.py`` keys on class names, so the
  two packages' fingerprints are comparable), and each seeded-bug fixture
  shrinks to the same action trace in both packages.

The seeded-bug fixtures of ``tests/fixtures/analysis/mc`` import the
reference; the port's runs load copies whose imports name ``repro_torch``
(``port_fixtures``). The slow explorations run once a module, each shared
by the port's case and the equality case.
"""
import importlib
import importlib.util
import json
import pathlib
import re
from unittest import mock

import pytest

import repro.analysis.mc as RMC
import repro_torch.analysis.mc as TMC
from repro.core import chaos as RC
from repro_torch.analysis.mc import (COVERED_MESSAGES, DEADLOCK,
                                     DEFAULT_INVARIANTS, GatewayMCConfig,
                                     Invariant, MCConfig, MCWorld, check_all,
                                     explore, fingerprint, replay,
                                     repro_payload, repro_script, shrink)
from repro_torch.core import chaos as TC
from repro_torch.core.chaos import replay_mc_trace

ROOT = pathlib.Path(__file__).resolve().parents[1]
MC_FIXTURES = ROOT / "tests" / "fixtures" / "analysis" / "mc"
SEEDED = ("stepaside_deadlock", "stale_admission", "gateway_fsync_drop")

# the explore modules (each package's ``mc.explore`` names the function)
REX = importlib.import_module("repro.analysis.mc.explore")
TEX = importlib.import_module("repro_torch.analysis.mc.explore")
# (mc package, explore module, chaos module) of each side
PKGS = {"port": (TMC, TEX, TC), "reference": (RMC, REX, RC)}


def port_copy(src: pathlib.Path, dst_dir: pathlib.Path) -> pathlib.Path:
    """``src`` written into ``dst_dir`` with its ``repro.`` imports naming
    ``repro_torch``."""
    dst = dst_dir / src.name
    dst.write_text(re.sub(r"\brepro\.(?=[A-Za-z_])", "repro_torch.",
                          src.read_text()))
    return dst


@pytest.fixture(scope="module")
def port_fixtures(tmp_path_factory):
    d = tmp_path_factory.mktemp("mc_fixtures")
    for name in SEEDED:
        port_copy(MC_FIXTURES / f"{name}.py", d)
    return d


def load_module(path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fixture_path(side, name, port_fixtures) -> pathlib.Path:
    return (port_fixtures if side == "port" else MC_FIXTURES) / f"{name}.py"


def explore_recorded(side, cfg, **kw):
    """``explore`` in ``side``'s package with every fingerprint it takes
    recorded: (report, the set of fingerprints, i.e. the visited states)."""
    _, ex, _ = PKGS[side]
    seen = set()
    real = ex.fingerprint

    def record(world):
        fp = real(world)
        seen.add(fp)
        return fp

    with mock.patch.object(ex, "fingerprint", record):
        report = ex.explore(cfg, **kw)
    return report, seen


def tiny(mc):
    return mc.MCConfig(policy="sync", n_volunteers=2, n_versions=1, n_mb=2,
                       visibility_timeout=10.0)


TINY = tiny(TMC)


@pytest.fixture(scope="module")
def tiny_runs():
    """The tiny sync world with one expiry allowed, explored to exhaustion
    in each package."""
    out = {}
    for side, (mc, _, _) in PKGS.items():
        cfg = mc.MCConfig.from_json({**tiny(mc).to_json(), "max_expiries": 1})
        out[side] = explore_recorded(side, cfg, max_states=50000,
                                     max_depth=60, max_seconds=300.0)
    return out


def gw(mc):
    return mc.GatewayMCConfig(policy="sync", n_volunteers=2, n_versions=1,
                              n_mb=2, visibility_timeout=10.0, n_gateways=2)


GW = gw(TMC)


@pytest.fixture(scope="module")
def gateway_runs():
    """The 2-gateway world to 4,000 states in each package (the state
    budget, not the clock, ends it), with the world kept."""
    out = {}
    for side, (mc, _, _) in PKGS.items():
        cfg = gw(mc)
        world = cfg.make_world()
        report, seen = explore_recorded(side, cfg, max_states=4000,
                                        max_depth=30, max_seconds=300.0,
                                        world=world)
        out[side] = (report, seen, world)
    return out


@pytest.fixture(scope="module")
def seeded_runs(port_fixtures):
    """Each seeded-bug fixture explored under its budget and its first
    violation shrunk, in each package: {name: {side: (fixture module,
    config, report, shrunk trace)}}."""
    out = {}
    for name in SEEDED:
        out[name] = {}
        for side, (mc, _, _) in PKGS.items():
            fx = load_module(fixture_path(side, name, port_fixtures))
            cfg = fx.configure()
            report = mc.explore(cfg, **fx.BUDGET)
            v = report.violations[0]
            out[name][side] = (fx, cfg, report,
                               mc.shrink(cfg, v.trace, v.invariant))
    return out


# ---------------------------------------------------------------------------
# exhaustive clean exploration
# ---------------------------------------------------------------------------

def test_tiny_sync_world_explores_exhaustively_clean(tiny_runs):
    report, _ = tiny_runs["port"]
    s = report.stats
    assert report.ok, report.violations
    assert not s.truncated, "tiny world must exhaust, not truncate"
    assert s.completes > 0
    assert s.dedup_hits > 0


def test_expiry_budget_gates_the_expire_fault():
    cfg = MCConfig.from_json({**TINY.to_json(), "max_expiries": 0})
    world = MCWorld(cfg)
    world.apply(("lease", "w0"))
    assert world.qs.next_deadline() is not None
    assert ("expire",) not in world.enabled_actions()
    unbounded = MCWorld(TINY)
    unbounded.apply(("lease", "w0"))
    assert ("expire",) in unbounded.enabled_actions()


def test_explore_reports_por_savings_with_faults():
    cfg = MCConfig(policy="sync", n_volunteers=2, n_versions=1, n_mb=2,
                   visibility_timeout=10.0, max_drops=1, max_dups=1)
    report = explore(cfg, max_states=1500, max_depth=30, max_seconds=60.0)
    assert report.ok, report.violations
    assert report.stats.reduction_factor > 1.0


# ---------------------------------------------------------------------------
# seeded historical bugs
# ---------------------------------------------------------------------------

def test_stepaside_deadlock_rediscovered_and_fix_is_clean(seeded_runs):
    _, cfg, report, _ = seeded_runs["stepaside_deadlock"]["port"]
    assert [v.invariant for v in report.violations] == [DEADLOCK]
    fixed = MCConfig.from_json({**cfg.to_json(), "allow_release": True})
    ok = explore(fixed, max_states=2500, max_depth=16, max_seconds=60.0)
    assert ok.violations == []


def test_stale_admission_rediscovered_and_honest_policy_is_clean(
        seeded_runs):
    _, cfg, report, _ = seeded_runs["stale_admission"]["port"]
    assert [v.invariant for v in report.violations] == ["admission-soundness"]
    assert "exceeds the declared bound 1" in report.violations[0].message
    honest = MCConfig.from_json(cfg.to_json())      # policy_object dropped
    ok = explore(honest, max_states=2500, max_depth=24, max_seconds=60.0)
    assert ok.violations == []


@pytest.mark.parametrize("name", SEEDED)
def test_shrunk_counterexample_replays_bit_deterministically(
        name, seeded_runs, port_fixtures):
    _, cfg, report, small = seeded_runs[name]["port"]
    v = report.violations[0]
    assert 0 < len(small) <= len(v.trace)
    for i in range(len(small)):                     # 1-minimal
        assert replay(cfg, small[:i] + small[i + 1:]).invariant != \
            v.invariant, i
    r1 = replay(cfg, small)
    r2 = replay(cfg, small)
    assert r1.invariant == v.invariant
    assert (r1.step, r1.final_fingerprint) == (r2.step, r2.final_fingerprint)
    payload = repro_payload(cfg, small, v.invariant, v.message,
                            fixture=str(port_fixtures / f"{name}.py"))
    payload = json.loads(json.dumps(payload))
    r3 = replay_mc_trace(payload)
    assert r3.invariant == v.invariant
    assert r3.final_fingerprint == r1.final_fingerprint
    script = repro_script(payload)
    assert "replay_mc_trace" in script and v.invariant in script
    assert "from repro_torch.core.chaos import replay_mc_trace" in script


@pytest.mark.parametrize("name", SEEDED)
def test_seeded_bug_shrinks_to_the_reference_trace(name, seeded_runs):
    runs = seeded_runs[name]
    (_, _, rep_t, small_t), (_, _, rep_r, small_r) = (runs["port"],
                                                      runs["reference"])
    assert [(v.invariant, v.message, v.trace) for v in rep_t.violations] == \
        [(v.invariant, v.message, v.trace) for v in rep_r.violations]
    assert small_t == small_r
    assert (rep_t.stats.states, rep_t.stats.transitions) == \
        (rep_r.stats.states, rep_r.stats.transitions)


# ---------------------------------------------------------------------------
# capture/restore and fingerprints
# ---------------------------------------------------------------------------

def test_capture_restore_roundtrips_fingerprint():
    world = MCWorld(TINY)
    world.apply(("lease", "w0"))
    world.apply(("advance", "w0"))
    cap = world.capture()
    fp = fingerprint(world)
    world.apply(("lease", "w1"))
    world.apply(("expire",))
    assert fingerprint(world) != fp
    world.restore(cap)
    assert fingerprint(world) == fp
    assert check_all(world, DEFAULT_INVARIANTS) is None


def test_symmetric_volunteers_merge_under_relabeling():
    w1 = MCWorld(TINY)
    w2 = MCWorld(TINY)
    w1.apply(("lease", "w0"))
    w2.apply(("lease", "w1"))
    assert TINY.crashable == () and TINY.leavable == ()
    assert fingerprint(w1) == fingerprint(w2)


def test_asymmetric_volunteers_do_not_merge():
    cfg = MCConfig(policy="sync", n_volunteers=2, n_versions=1, n_mb=2,
                   visibility_timeout=10.0, crashable=("w0",), max_crashes=1)
    w1 = MCWorld(cfg)
    w2 = MCWorld(cfg)
    assert not w1.symmetry_possible()
    w1.apply(("lease", "w0"))
    w2.apply(("lease", "w1"))
    assert fingerprint(w1) != fingerprint(w2)


def test_fingerprints_equal_the_reference_along_a_trace():
    worlds = [mc.MCWorld(tiny(mc)) for mc in (TMC, RMC)]
    for action in (None, ("lease", "w0"), ("advance", "w0"),
                   ("lease", "w1"), ("expire",)):
        for w in worlds:
            if action is not None:
                w.apply(action)
        assert TMC.fingerprint(worlds[0]) == RMC.fingerprint(worlds[1])
        assert TMC.canonical_state(worlds[0]) == \
            RMC.canonical_state(worlds[1])
        assert worlds[0].enabled_actions() == worlds[1].enabled_actions()


# ---------------------------------------------------------------------------
# invariant API
# ---------------------------------------------------------------------------

def test_invariant_api_verdict_forms():
    good = Invariant("ok", lambda w: None)
    also_good = Invariant("ok2", lambda w: True)
    bad_msg = Invariant("bad", lambda w: "broke")
    bad_bool = Invariant("bad2", lambda w: False)
    world = MCWorld(TINY)
    assert good.check(world) is None and also_good.check(world) is None
    assert bad_msg.check(world) == "broke"
    assert bad_bool.check(world) == "bad2 violated"
    assert check_all(world, [good, bad_msg]) == ("bad", "broke")
    assert check_all(world, DEFAULT_INVARIANTS) is None


def test_custom_invariant_violation_carries_trace():
    inv = Invariant("no-compute", lambda w: not any(
        d.state == "computing" for d in w.drivers.values()))
    report = explore(TINY, invariants=[inv], max_states=500, max_depth=10,
                     max_seconds=60.0)
    assert report.violations and report.violations[0].invariant == "no-compute"
    trace = report.violations[0].trace
    assert replay(TINY, trace, invariants=[inv]).invariant == "no-compute"


# ---------------------------------------------------------------------------
# the gateway micro-world over the port's GatewayRing
# ---------------------------------------------------------------------------

def test_gateway_world_roundtrips_through_config_json():
    cfg = GatewayMCConfig.from_json(GW.to_json())
    assert isinstance(cfg, GatewayMCConfig) and cfg == GW
    assert isinstance(MCConfig.from_json(GW.to_json()), GatewayMCConfig)


def test_gateway_world_explores_clean_and_actually_forwards(gateway_runs):
    report, _, world = gateway_runs["port"]
    assert report.ok, report.violations
    assert report.stats.completes > 0
    assert world.gw_forwards > 0
    assert {"Forward", "ForwardNotify"} <= world.sent_types


def test_gateway_crash_opens_window_then_peer_adopts_slice():
    cfg = GatewayMCConfig.from_json(
        {**GW.to_json(), "gw_crashable": [0], "max_gw_crashes": 1})
    world = cfg.make_world()
    world.apply(("lease", "w1"))        # forwarded: w1 is homed on gw1
    assert world.gw_forwards == 1
    world.apply(("gw_crash", 0))
    assert world.enabled_actions() == [("gw_adopt", 0)]
    world.apply(("gw_adopt", 0))
    assert world.ring.owner_of("__model__") == 1
    assert world.gw_owned[1] == [0, 1] and world.gw_owned[0] == []
    assert any(a[0] in ("lease", "advance") for a in world.enabled_actions())


def test_gateway_capture_restore_roundtrips_mid_window():
    cfg = GatewayMCConfig.from_json(
        {**GW.to_json(), "gw_crashable": [0], "max_gw_crashes": 1})
    world = cfg.make_world()
    world.apply(("lease", "w1"))
    world.apply(("gw_crash", 0))
    cap = world.capture()
    fp = fingerprint(world)
    world.apply(("gw_adopt", 0))
    assert fingerprint(world) != fp
    world.restore(cap)
    assert fingerprint(world) == fp
    assert world.gw_window == [0]
    world.apply(("gw_adopt", 0))


def test_single_owner_invariant_rejects_a_doubly_served_slice():
    from repro_torch.analysis.mc.gateway_world import single_owner_per_slice
    world = GW.make_world()
    assert single_owner_per_slice(world) is None
    world.gw_owned[1] = [0, 1]
    msg = single_owner_per_slice(world)
    assert msg is not None and "served by 2 gateways" in msg


def test_gateway_fsync_drop_rediscovered_and_fsync_is_clean(seeded_runs):
    _, cfg, report, _ = seeded_runs["gateway_fsync_drop"]["port"]
    assert [v.invariant for v in report.violations] == ["no-lost-forward"]
    assert "never made durable" in report.violations[0].message
    fixed = MCConfig.from_json({**cfg.to_json(), "oplog_fsync": True})
    assert isinstance(fixed, GatewayMCConfig)
    ok = explore(fixed, max_states=4000, max_depth=12, max_seconds=60.0)
    assert ok.violations == []


def test_gateway_rules_are_registered_for_ci():
    from repro_torch.analysis.mc import RULES
    from repro_torch.analysis.mc.check import _RULE_BY_INVARIANT
    assert {"MC-OWNER", "MC-FORWARD"} <= set(RULES)
    assert _RULE_BY_INVARIANT["single-owner-per-slice"] == "MC-OWNER"
    assert _RULE_BY_INVARIANT["no-lost-forward"] == "MC-FORWARD"


# ---------------------------------------------------------------------------
# cross-package equality of the explorations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", ["tiny", "gateway"])
def test_exploration_equals_the_reference(world, tiny_runs, gateway_runs):
    runs = tiny_runs if world == "tiny" else gateway_runs
    (rep_t, seen_t), (rep_r, seen_r) = (runs["port"][:2],
                                        runs["reference"][:2])
    st, sr = rep_t.stats, rep_r.stats
    assert st.states > 100 and len(seen_t) == st.states
    assert (st.states, st.transitions, st.dedup_hits, st.symmetry_hits,
            st.por_skipped, st.max_depth, st.completes, st.stranded,
            st.fleet_exhausted, st.truncated) == \
        (sr.states, sr.transitions, sr.dedup_hits, sr.symmetry_hits,
         sr.por_skipped, sr.max_depth, sr.completes, sr.stranded,
         sr.fleet_exhausted, sr.truncated)
    assert seen_t == seen_r
    assert rep_t.ok and rep_r.ok
    if world == "gateway":
        wt, wr = runs["port"][2], runs["reference"][2]
        assert (wt.gw_forwards, wt.sent_types) == (wr.gw_forwards,
                                                   wr.sent_types)


# ---------------------------------------------------------------------------
# wire coverage: COVERED_MESSAGES is honest
# ---------------------------------------------------------------------------

def test_covered_messages_ledger_is_honest():
    """Every wire type COVERED_MESSAGES claims must be sent while the
    shipped worlds (and a server-apply world) are explored."""
    from repro_torch.analysis.mc import default_config
    sent = set()
    worlds = [default_config("sync"), default_config("staleness:1"),
              default_config("local:2"),
              MCConfig(policy="sync", n_volunteers=2, n_versions=2, n_mb=1,
                       visibility_timeout=10.0),
              MCConfig(policy="staleness:1", n_volunteers=2, n_versions=2,
                       n_mb=2, visibility_timeout=10.0, server_apply=True,
                       gc_keep=2),
              GW]
    for cfg in worlds:
        world = cfg.make_world()
        explore(cfg, max_states=1500, max_depth=40, max_seconds=15.0,
                first_violation=False, world=world)
        sent |= world.sent_types
    missing = set(COVERED_MESSAGES) - sent
    assert not missing, f"claimed covered but never sent: {sorted(missing)}"
    assert COVERED_MESSAGES == RMC.COVERED_MESSAGES


def test_schema_mc_coverage_cross_check_is_clean_on_tree():
    from repro_torch.analysis.schema import check_mc_coverage
    assert check_mc_coverage() == []

