"""repro_torch.analysis.mc — explicit-state model checking of the volunteer
protocol.

Drives N real ``VolunteerSession`` objects against a real ``ServerEndpoint``
(no mocks — the shipped ``protocol.py`` is the model) through every enabled
interleaving of protocol moves, notification fates (deliver/drop/duplicate),
lease expiry, heartbeat/release races, crash/rejoin, and clean departure —
checking a declarative invariant catalog at every reached state, with
canonical-fingerprint dedup, symmetry + partial-order reduction, and
counterexample shrinking to runnable repro scripts.

Entry points: ``explore(MCConfig(...))`` for one world, ``run_mc`` for the
CI pass (``python -m repro_torch.analysis --strict --mc``), ``replay``/``shrink``
for counterexample work. See docs/analysis.md ("Model checking").
"""
from repro_torch.analysis.mc.check import (DEFAULT_POLICIES, RULES, check_config,
                                     default_config, run_mc)
from repro_torch.analysis.mc.explore import MCReport, MCStats, explore
from repro_torch.analysis.mc.fingerprint import canonical_state, fingerprint
from repro_torch.analysis.mc.gateway_world import GatewayMCConfig, GatewayMCWorld
from repro_torch.analysis.mc.invariants import (DEADLOCK, DEFAULT_INVARIANTS,
                                          Invariant, check_all)
from repro_torch.analysis.mc.shrink import (Replay, load_payload_config, replay,
                                      replay_payload, repro_payload,
                                      repro_script, shrink)
from repro_torch.analysis.mc.world import MCConfig, MCWorld

# Every REQUEST/NOTIFICATION wire type -> the model-checker action(s) that
# exercise it. ``analysis.schema.check_mc_coverage`` (rule SCHEMA-MC) fails
# --strict when a @wire type is missing here, so the model cannot silently
# under-model a growing protocol; the coverage test in tests/test_mc.py
# proves each entry is actually sent during exploration, so an entry cannot
# be an empty promise either.
COVERED_MESSAGES = {
    # requests
    "Hello": "world construction / rejoin (connection registration)",
    "LeaseReq": "lease action; reduce-barrier drain inside advance",
    "Ack": "finish action (map/reduce/commit acks); stale-duplicate ack",
    "Nack": "release action; incomplete-barrier putback; stale-update nack",
    "ExtendLease": "heartbeat action",
    "PublishResult": "finish action (sync map publishes its gradient)",
    "FetchModel": "advance action (map/barrierless model fetch)",
    "PublishModel": "finish action (reduce / commit_update publish)",
    "GcModels": "finish action with gc_keep configured",
    "WatchVersion": "advance -> Blocked(version) park; restore re-watch",
    "SubscribeQueue": "advance -> Blocked(queue) park; idle park; restore",
    "KickQueue": "rejoin action (abort passes on a consumed wake)",
    "DropConsumer": "rejoin action (requeue the dead incarnation's leases)",
    "DepthReq": "advance action (reduce barrier probe)",
    "DrainedReq": "lease action (NoTask -> retirement check)",
    "LatestReq": "advance/finish admission reads",
    "SubmitUpdate": "finish action under server_apply",
    "Bye": "leave action (clean departure)",
    "ExpireAll": "expire action (the lease sweep is a logged wire op)",
    "Forward": "gateway world: remotely-homed op routed to its slice owner",
    "ForwardNotify": "gateway world: wake crossing back to its origin",
    # notifications
    "Wake": "deliver/drop/dup fates + wake action",
    "VersionReady": "deliver/drop/dup fates + wake action",
}

__all__ = [
    "COVERED_MESSAGES", "DEADLOCK", "DEFAULT_INVARIANTS", "DEFAULT_POLICIES",
    "GatewayMCConfig", "GatewayMCWorld",
    "Invariant", "MCConfig", "MCReport", "MCStats", "MCWorld", "RULES",
    "Replay", "canonical_state", "check_all", "check_config",
    "default_config", "explore", "fingerprint", "load_payload_config",
    "replay", "replay_payload", "repro_payload", "repro_script", "run_mc",
    "shrink",
]
