"""The port's static passes (``repro_torch.analysis``: ``rules``, ``locks``,
``schema`` and the driver ``python -m repro_torch.analysis``) and its
runtime lock monitor, against the reference's.

Two parts:

- every case of ``tests/test_analysis.py`` run on the port's tree
  (``src/repro_torch/core``): each rule fires on its seeded fixture of
  ``tests/fixtures/analysis`` and stays silent on the port's core, the
  lock-inversion fixtures are caught statically and at run time, the
  schema checks, the mc pass's seeded bugs, and the CLI contract
  (``--strict`` exits 0 on the port's core and 1 on each violation
  fixture; one case runs the CLI as a process, the others call its
  ``main``);
- cross-package equality: ``rules``, ``locks`` and ``schema`` report the
  same (rule, line) pairs on the same fixtures in both packages, and both
  packages' lock graphs of their own cores agree.

``Analysis.instrument()`` loads the static lock graph of the port's core
(a non-empty set of edges), as the reference's does of its own.
"""
import json
import os
import pathlib
import re
import subprocess
import sys
import threading
from collections import deque
from dataclasses import dataclass
from typing import Any

import pytest

from repro.analysis import locks as RL
from repro.analysis import rules as RR
from repro.analysis import schema as RS
from repro_torch.analysis import locks, rules, schema
from repro_torch.analysis.__main__ import main as cli_main
from repro_torch.analysis.runtime import Analysis
from repro_torch.core import gateway
from test_torch_mc import load_module, port_copy

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures" / "analysis"
CORE = ROOT / "src" / "repro_torch" / "core"
RULE_FIXTURES = {"wallclock.py": "REPRO-TIME", "simulator.py": "REPRO-LAYER",
                 "session_mutation.py": "REPRO-SESSION",
                 "swallow.py": "REPRO-EXCEPT"}


def _pairs(violations):
    return [(v.rule, v.line) for v in violations]


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fixture,rule,n_min", [
    ("wallclock.py", "REPRO-TIME", 4),
    ("simulator.py", "REPRO-LAYER", 3),
    ("session_mutation.py", "REPRO-SESSION", 4),
    ("swallow.py", "REPRO-EXCEPT", 2),
])
def test_rule_fires_on_fixture(fixture, rule, n_min):
    violations, stale = rules.check_file(FIXTURES / fixture)
    assert len([v for v in violations if v.rule == rule]) >= n_min, violations
    assert {v.rule for v in violations} == {rule}
    assert stale == []


def test_rules_clean_on_core_tree():
    violations, stale = rules.check_paths(sorted(CORE.glob("*.py")))
    assert violations == [], "\n".join(map(str, violations))
    assert stale == [], "\n".join(map(str, stale))


def test_fixture_negative_space_not_flagged():
    violations, _ = rules.check_file(FIXTURES / "simulator.py")
    assert not any(v.line >= 20 for v in violations), violations


def test_ignore_escape_hatch_and_strict_staleness(tmp_path):
    clean, stale = rules.check_file(FIXTURES / "ignored.py")
    assert clean == [] and stale == []
    p = tmp_path / "stale.py"
    p.write_text("x = 1  # analysis: ignore[REPRO-TIME]\n")
    clean, stale = rules.check_file(p)
    assert clean == []
    assert [v.rule for v in stale] == ["ANALYSIS-IGNORE"]


def test_ignore_is_rule_scoped(tmp_path):
    p = tmp_path / "wrong.py"
    p.write_text("import time\n"
                 "t = time.monotonic()  # analysis: ignore[REPRO-LAYER]\n")
    clean, stale = rules.check_file(p)
    assert [v.rule for v in clean] == ["REPRO-TIME"]
    assert [v.rule for v in stale] == ["ANALYSIS-IGNORE"]


@pytest.mark.parametrize("fixture", sorted(RULE_FIXTURES) + ["ignored.py"])
def test_rules_report_the_reference_pairs(fixture):
    got, got_stale = rules.check_file(FIXTURES / fixture)
    want, want_stale = RR.check_file(FIXTURES / fixture)
    assert _pairs(got) == _pairs(want)
    assert _pairs(got_stale) == _pairs(want_stale)
    assert [v.message for v in got] == [v.message for v in want]
    if fixture in RULE_FIXTURES:
        assert got


def test_core_trees_carry_the_reference_ignores():
    """The port's core carries no ``# analysis: ignore[...]`` that the
    reference's lacks."""
    def ignores(core):
        return sorted(m.group(0) for p in core.glob("*.py")
                      for m in re.finditer(r"# analysis: ignore\[[^\]]*\]",
                                           p.read_text()))
    port = ignores(CORE)
    ref = ignores(ROOT / "src" / "repro" / "core")
    assert all(port.count(x) <= ref.count(x) for x in set(port))


# ---------------------------------------------------------------------------
# locks: static half
# ---------------------------------------------------------------------------

def test_static_cycle_found_in_inversion_fixture():
    vs = locks.check([FIXTURES / "lock_inversion.py"])
    assert len(vs) == 1 and vs[0].rule == "LOCK-ORDER"
    assert "lock_inversion._a" in vs[0].message
    assert "lock_inversion._b" in vs[0].message


def test_static_graph_clean_on_core():
    assert all(p.parent == CORE for p in locks.default_paths())
    assert locks.check(locks.default_paths()) == []


def test_static_graph_sees_gateway_locks():
    lks, edges = locks.lock_graph(locks.default_paths())
    assert {"gateway._lock", "gateway._snap_lock"} <= lks
    assert ("gateway._lock", "gateway._snap_lock") not in edges, edges
    assert ("gateway._snap_lock", "gateway._lock") in edges, edges


def test_static_cycle_found_through_lock_free_intermediate():
    vs = locks.check([FIXTURES / "lock_depth2.py"])
    assert [v.rule for v in vs] == ["LOCK-ORDER"]
    assert "lock_depth2._a" in vs[0].message
    assert "lock_depth2._b" in vs[0].message


def test_foreign_receiver_calls_do_not_resolve(tmp_path):
    p = tmp_path / "foreign.py"
    p.write_text(
        "import threading\n"
        "class S:\n"
        "    def __init__(self, other):\n"
        "        self._a = threading.Lock()\n"
        "        self._b = threading.Lock()\n"
        "        self.other = other\n"
        "    def snapshot(self):\n"
        "        with self._b:\n"
        "            pass\n"
        "    def outer(self):\n"
        "        with self._a:\n"
        "            self.other.snapshot()\n")
    _, edges = locks.lock_graph([p])
    assert ("foreign._a", "foreign._b") not in edges


def test_transitive_edges_via_same_module_calls(tmp_path):
    p = tmp_path / "nested.py"
    p.write_text(
        "import threading\n"
        "class S:\n"
        "    def __init__(self):\n"
        "        self._a = threading.Lock()\n"
        "        self._b = threading.Lock()\n"
        "    def inner(self):\n"
        "        with self._b:\n"
        "            pass\n"
        "    def outer(self):\n"
        "        with self._a:\n"
        "            self.inner()\n")
    _, edges = locks.lock_graph([p])
    assert ("nested._a", "nested._b") in edges


@pytest.mark.parametrize("fixture", ["lock_inversion.py", "lock_depth2.py"])
def test_locks_report_the_reference_pairs(fixture):
    got = locks.check([FIXTURES / fixture])
    want = RL.check([FIXTURES / fixture])
    assert got and _pairs(got) == _pairs(want)
    assert [v.message for v in got] == [v.message for v in want]
    assert locks.lock_graph([FIXTURES / fixture]) == \
        RL.lock_graph([FIXTURES / fixture])


def test_lock_graphs_of_the_cores_agree():
    """Each package's static graph of its own core: the same locks and the
    same edges (the port's control plane nests its locks as the
    reference's does)."""
    got = locks.lock_graph(locks.default_paths())
    want = RL.lock_graph(RL.default_paths())
    assert got == want and got[1]


# ---------------------------------------------------------------------------
# locks: runtime half
# ---------------------------------------------------------------------------

def test_runtime_catches_inversion_in_fixture_class():
    fx = load_module(FIXTURES / "lock_inversion.py")
    mon = Analysis()
    inv = fx.Inverted()
    inv._a = mon.make_lock("fx._a")
    inv._b = mon.make_lock("fx._b")
    inv.forward()
    assert mon.violations == []
    inv.backward()
    assert [v.rule for v in mon.violations] == ["LOCK-ORDER"]
    with open(os.devnull, "w") as sink:
        assert mon.report(stream=sink) == 1


def test_runtime_catches_inversion_against_static_graph():
    static = locks.static_edges([FIXTURES / "lock_inversion.py"])
    assert ("lock_inversion._a", "lock_inversion._b") in static
    mon = Analysis(static_edges=static)
    a = mon.make_lock("lock_inversion._a")
    b = mon.make_lock("lock_inversion._b")
    with b:
        with a:
            pass
    assert [v.rule for v in mon.violations] == ["LOCK-ORDER"]
    assert "static graph" in mon.violations[0].message


def test_runtime_self_deadlock_fails_fast():
    mon = Analysis()
    lk = mon.make_lock("l")
    lk.acquire()
    with pytest.raises(RuntimeError):
        lk.acquire()
    assert [v.rule for v in mon.violations] == ["LOCK-SELF"]


def test_blocking_under_guard_lock_flagged():
    mon = Analysis()
    guard = mon.make_lock("gateway._lock", guard=True)
    plain = mon.make_lock("gateway._snap_lock")
    with plain:
        mon.note_blocking("snapshot-fsync")
    assert mon.violations == []
    with guard:
        mon.note_blocking("socket-recv")
    assert [v.rule for v in mon.violations] == ["LOCK-BLOCK"]


def test_parked_holder_invariant():
    mon = Analysis()
    mon.note_park("v", holding=False, timed=False)
    mon.note_park("v", holding=True, timed=True)
    assert mon.violations == []
    mon.note_park("v", holding=True, timed=False)
    assert [v.rule for v in mon.violations] == ["PARKED-HOLDER"]


def test_gateway_wait_reports_parked_holder(monkeypatch):
    mon = Analysis()
    monkeypatch.setattr(gateway, "_monitor", lambda: mon)

    class UntimedTransport:
        timed_waits = False

        def wait_notification(self, timeout=None):
            return object()

    assert gateway._wait(UntimedTransport(), deque(), 0.5, holding=True)
    assert [v.rule for v in mon.violations] == ["PARKED-HOLDER"]
    mon2 = Analysis()
    monkeypatch.setattr(gateway, "_monitor", lambda: mon2)

    class TimedTransport(UntimedTransport):
        timed_waits = True

    assert gateway._wait(TimedTransport(), deque(), 0.5, holding=True)
    assert mon2.violations == []


def test_monitored_locks_work_across_threads():
    mon = Analysis()
    lk = mon.make_lock("shared")
    hits = []

    def worker():
        for _ in range(200):
            with lk:
                hits.append(1)

    ts = [threading.Thread(target=worker) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert len(hits) == 800 and mon.violations == []


def test_instrument_singleton_loads_static_graph():
    """The monitor the gateway installs under ``ANALYSIS_INSTRUMENT=1``
    holds the static graph of the port's core: not empty, and with the
    one legal nesting of the gateway's locks."""
    Analysis.reset()
    try:
        mon = Analysis.instrument()
        assert mon is Analysis.instrument()
        assert isinstance(mon._static, set) and mon._static
        assert ("gateway._snap_lock", "gateway._lock") in mon._static
        assert mon._static == locks.static_edges(locks.default_paths())
    finally:
        Analysis.reset()


# ---------------------------------------------------------------------------
# schema
# ---------------------------------------------------------------------------

def test_schema_clean_on_tree():
    vs = schema.run()
    assert vs == [], "\n".join(map(str, vs))


def test_schema_doc_check_fires_on_incomplete_doc():
    vs = schema.check_doc(FIXTURES / "protocol_missing.md")
    assert vs and all(v.rule == "SCHEMA-DOC" for v in vs)
    named = " ".join(v.message for v in vs)
    assert "LeaseReq" in named and "MapTask" in named
    assert "Hello " not in named


def test_schema_doc_check_reports_the_reference_pairs():
    got = schema.check_doc(FIXTURES / "protocol_missing.md")
    want = RS.check_doc(FIXTURES / "protocol_missing.md")
    assert got and _pairs(got) == _pairs(want)
    assert [v.message for v in got] == [v.message for v in want]
    assert sorted(schema.registered_types()) == \
        sorted(RS.registered_types())


def test_rogue_type_fails_roundtrip_and_partition():
    @dataclass(frozen=True)
    class Rogue:
        payload: Any

    vs = schema.run(extra_types=(Rogue,))
    fired = {v.rule for v in vs if "Rogue" in v.message}
    assert fired == {"SCHEMA-ROUNDTRIP", "SCHEMA-PARTITION", "SCHEMA-DOC"}
    want = RS.run(extra_types=(Rogue,))
    assert sorted(_pairs(vs)) == sorted(_pairs(want))


def test_schema_samples_construct_every_registered_type():
    for name, cls in schema.registered_types().items():
        inst = schema.sample(cls)
        assert type(inst).__name__ == name


def test_schema_mc_coverage_fires_on_partial_ledger(tmp_path):
    fx = load_module(port_copy(FIXTURES / "mc_partial_coverage.py", tmp_path))
    vs = schema.check_mc_coverage(fx.COVERED)
    assert all(v.rule == "SCHEMA-MC" for v in vs)
    assert sorted(m for v in vs for m in fx.MISSING if m in v.message) == \
        sorted(fx.MISSING)
    assert len(vs) == len(fx.MISSING)
    ref = load_module(FIXTURES / "mc_partial_coverage.py")
    assert _pairs(vs) == _pairs(RS.check_mc_coverage(ref.COVERED))


# ---------------------------------------------------------------------------
# the mc pass: seeded historical bugs rediscovered with replayable repros
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fixture,rule,invariant", [
    ("mc/stepaside_deadlock.py", "MC-DEADLOCK", "deadlock-freedom"),
    ("mc/stale_admission.py", "MC-ADMIT", "admission-soundness"),
])
def test_mc_rediscovers_seeded_bug_with_replayable_repro(fixture, rule,
                                                         invariant, tmp_path):
    from repro_torch.analysis.mc import replay_payload, run_mc
    path = str(port_copy(FIXTURES / fixture, tmp_path))
    vs = run_mc(fixture=path, max_states=30000, max_depth=24,
                max_seconds=30.0)
    assert vs, "seeded bug not rediscovered"
    assert vs[0].rule == rule
    assert "minimized" in vs[0].message
    payload = json.loads(vs[0].message[vs[0].message.index('{"'):])
    assert replay_payload(payload).invariant == invariant


# ---------------------------------------------------------------------------
# the CLI contract
# ---------------------------------------------------------------------------

def test_cli_strict_clean_on_shipped_tree():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                          "--strict"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "repro_torch.analysis [locks+rules+schema]: clean" in res.stdout


@pytest.mark.parametrize("argv", [
    ("--only", "rules", "--paths", "tests/fixtures/analysis/wallclock.py"),
    ("--only", "rules", "--paths", "tests/fixtures/analysis/simulator.py"),
    ("--only", "rules", "--paths",
     "tests/fixtures/analysis/session_mutation.py"),
    ("--only", "rules", "--paths", "tests/fixtures/analysis/swallow.py"),
    ("--only", "locks", "--paths",
     "tests/fixtures/analysis/lock_inversion.py"),
    ("--only", "schema", "--doc",
     "tests/fixtures/analysis/protocol_missing.md"),
    ("--mc", "--mc-fixture", "mc/stale_admission.py", "--mc-depth", "24"),
])
def test_cli_nonzero_on_each_violation_fixture(argv, tmp_path, monkeypatch,
                                               capsys):
    monkeypatch.chdir(ROOT)
    if "--mc-fixture" in argv:
        i = argv.index("--mc-fixture") + 1
        fixture = port_copy(FIXTURES / argv[i], tmp_path)
        argv = argv[:i] + (str(fixture),) + argv[i + 1:]
    assert cli_main(list(argv)) == 1
    assert "violation" in capsys.readouterr().out


def test_cli_ignored_fixture_clean_even_strict(monkeypatch, capsys):
    monkeypatch.chdir(ROOT)
    assert cli_main(["--strict", "--only", "rules", "--paths",
                     "tests/fixtures/analysis/ignored.py"]) == 0
    assert "clean" in capsys.readouterr().out
