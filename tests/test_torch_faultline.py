"""Twins of ``tests/test_faultline.py`` on the port's faultline, and its
parity with the reference's.

- The reference file's 21 non-slow tests (scenario policy determinism,
  ``FaultPlane`` link semantics, checker verdicts, and the two seeded
  chaos runs on a live 4-node committee of port engines), with the same
  inputs and assertions; the n = 8 storm stays ``slow``, as there.
- Parity: ``Schedule.trace()`` byte-identical between the packages for
  the six committed scenarios of ``benchmark/scenarios/`` (read as data,
  by path) and ``chaos_scenario`` seeds 3, 7, 11 and 991, each compiled on
  4, 8 and 20 names; one seeded ``FaultPlane`` in each package returning
  the same ``filter_send``/``filter_recv`` decisions over a fixed list of
  frames; the checker's verdicts equal on the reference tests' commit
  streams.
- The silent leader's proposal tag, a literal in ``runtime.py``, equals
  the port's ``consensus.messages.TAG_PROPOSE``.

Ports 23200-23299.
The committee runs use the port's ``CpuBackend()``.
"""

import json
import time
from pathlib import Path

import pytest

import hotstuff_tpu.faultline as j_faultline
import hotstuff_tpu_torch.crypto as t_crypto
import hotstuff_tpu_torch.faultline as t_faultline
from hotstuff_tpu.faultline import checker as j_checker
from hotstuff_tpu_torch.consensus import cert_arena
from hotstuff_tpu_torch.consensus.messages import TAG_PROPOSE, encode_propose, encode_vote
from hotstuff_tpu_torch.faultline import (
    CommitRecord,
    FaultPlane,
    Scenario,
    chaos_scenario,
    check,
    hooks,
)
from hotstuff_tpu_torch.faultline import checker as t_checker
from hotstuff_tpu_torch.faultline import policy as t_policy
from hotstuff_tpu_torch.faultline import runtime as fl_runtime

from .common import async_test

BASE = 23200
SCENARIOS = Path(__file__).resolve().parents[1] / "benchmark" / "scenarios"


@pytest.fixture(autouse=True)
def port_backend(monkeypatch):
    monkeypatch.setattr(t_crypto, "_BACKEND", None)
    t_crypto.set_backend(t_crypto.CpuBackend())
    cert_arena.reset()
    yield
    cert_arena.reset()


NODES = ["n000", "n001", "n002", "n003"]
ADDRS = {("127.0.0.1", 40000 + i): NODES[i] for i in range(4)}
ADDR = {name: addr for addr, name in ADDRS.items()}


# ---------------------------------------------------------------------------
# policy: seed determinism + serialization
# ---------------------------------------------------------------------------


def test_same_seed_identical_schedule():
    a = chaos_scenario(1234, duration_s=20).compile(NODES)
    b = chaos_scenario(1234, duration_s=20).compile(NODES)
    assert a.trace() == b.trace()


def test_different_seed_different_schedule():
    a = chaos_scenario(1234, duration_s=20).compile(NODES)
    b = chaos_scenario(1235, duration_s=20).compile(NODES)
    assert a.trace() != b.trace()


def test_scenario_json_roundtrip_preserves_schedule():
    s = chaos_scenario(7, duration_s=12)
    restored = Scenario.from_json(s.to_json())
    assert restored.compile(NODES).trace() == s.compile(NODES).trace()


def test_chaos_crash_and_restart_pair_same_node():
    for seed in range(20):
        schedule = chaos_scenario(seed, duration_s=20).compile(NODES)
        crashes = [e for e in schedule.events if e.kind == "crash"]
        restarts = [e for e in schedule.events if e.kind == "restart"]
        assert {e.params["node"] for e in crashes} == {
            e.params["node"] for e in restarts
        }
        assert not schedule.crashed_forever()


def test_heal_time_covers_interval_faults():
    s = Scenario(
        name="t", seed=0, duration_s=10,
        events=[
            {"kind": "partition", "at": 2.0, "until": 6.0},
            {"kind": "crash", "node": 0, "at": 1.0},
            {"kind": "restart", "node": 0, "at": 7.5},
        ],
    )
    schedule = s.compile(NODES)
    assert schedule.last_heal_time() == 7.5
    assert schedule.crashed_forever() == set()


# ---------------------------------------------------------------------------
# runtime: link filter semantics
# ---------------------------------------------------------------------------


def _armed_plane(events, elapsed: float = 100.0) -> FaultPlane:
    """A plane whose virtual clock already sits ``elapsed`` seconds in —
    every event with at <= elapsed is active."""
    schedule = Scenario(
        name="unit", seed=9, duration_s=1e6, events=events
    ).compile(NODES)
    plane = FaultPlane(schedule, ADDRS)
    plane.start(time.monotonic() - elapsed)
    return plane


def _as(node: str):
    return hooks.NODE.set(node)


def test_partition_drops_cross_group_only():
    plane = _armed_plane(
        [{"kind": "partition", "groups": [[0, 1], [2, 3]], "at": 0.0}]
    )
    token = _as("n000")
    try:
        assert plane.filter_send(ADDR["n002"], b"\x01x") == ("drop", 0.0, 0)
        assert plane.filter_send(ADDR["n001"], b"\x01x") is None
    finally:
        hooks.NODE.reset(token)
    assert plane.counts["send_drops"] == 1


def test_unknown_sender_and_peer_unaffected():
    plane = _armed_plane(
        [{"kind": "partition", "groups": [[0, 1], [2, 3]], "at": 0.0}]
    )
    # No node identity (e.g. a benchmark client): never filtered.
    assert plane.filter_send(ADDR["n002"], b"x") is None
    token = _as("n000")
    try:  # an address outside the committee map: never filtered
        assert plane.filter_send(("127.0.0.1", 55555), b"x") is None
    finally:
        hooks.NODE.reset(token)


def test_silent_leader_suppresses_only_proposals():
    plane = _armed_plane(
        [{"kind": "byzantine", "node": 0, "behavior": "silent_leader", "at": 0.0}]
    )
    token = _as("n000")
    try:
        # TAG_PROPOSE = 0 is the first payload byte of proposal frames.
        assert plane.filter_send(ADDR["n001"], b"\x00rest") == ("drop", 0.0, 0)
        assert plane.filter_send(ADDR["n001"], b"\x01vote") is None
        # Framed variant (length prefix skipped via payload_off).
        assert plane.filter_send(
            ADDR["n001"], b"\x00\x00\x00\x04\x00abc", payload_off=4
        ) == ("drop", 0.0, 0)
    finally:
        hooks.NODE.reset(token)
    token = _as("n001")  # other nodes' proposals flow
    try:
        assert plane.filter_send(ADDR["n002"], b"\x00rest") is None
    finally:
        hooks.NODE.reset(token)
    assert plane.counts["proposals_suppressed"] == 2


def test_link_drop_decisions_replay_with_seed():
    events = [{"kind": "link", "src": 0, "dst": "*", "at": 0.0, "drop": 0.5}]

    def decisions():
        plane = _armed_plane(events)
        token = _as("n000")
        try:
            return [
                plane.filter_send(ADDR["n002"], b"\x01x") is None
                for _ in range(200)
            ]
        finally:
            hooks.NODE.reset(token)

    first, second = decisions(), decisions()
    assert first == second  # same seed => same per-message coin flips
    assert any(first) and not all(first)  # p=0.5 actually drops and passes


def test_link_delay_and_duplicate():
    plane = _armed_plane(
        [
            {
                "kind": "link", "src": 0, "dst": 2, "at": 0.0,
                "delay_ms": [5, 10], "duplicate": 1.0,
            }
        ]
    )
    token = _as("n000")
    try:
        action, delay, copies = plane.filter_send(ADDR["n002"], b"\x01x")
    finally:
        hooks.NODE.reset(token)
    assert action == "deliver"
    assert 0.005 <= delay <= 0.010
    assert copies == 2
    assert plane.counts["delays"] == 1 and plane.counts["duplicates"] == 1


def test_recv_side_rule_applies_at_receiver():
    plane = _armed_plane(
        [
            {
                "kind": "link", "src": "*", "dst": 2, "at": 0.0,
                "drop": 1.0, "side": "recv",
            }
        ]
    )
    assert plane.filter_recv(ADDR["n002"]) == ("drop", 0.0)
    assert plane.filter_recv(ADDR["n001"]) is None
    token = _as("n000")  # send side ignores recv rules
    try:
        assert plane.filter_send(ADDR["n002"], b"\x01x") is None
    finally:
        hooks.NODE.reset(token)


def test_heal_restores_clean_links():
    plane = _armed_plane(
        [{"kind": "partition", "groups": [[0, 1], [2, 3]], "at": 0.0,
          "until": 50.0}],
        elapsed=60.0,  # past the heal
    )
    token = _as("n000")
    try:
        assert plane.filter_send(ADDR["n002"], b"\x01x") is None
    finally:
        hooks.NODE.reset(token)
    phases = [(a["kind"], a["phase"]) for a in plane.applied]
    assert phases == [("partition", "inject"), ("partition", "heal")]


def test_injected_event_log_replays_identically():
    """Satellite: the injected-fault EVENT LOG (``FaultPlane.applied``:
    what fired, in which phase, against whom, at which scheduled time)
    is byte-identical across two runs of the same seed. Both transport
    planes consume this one plane object, so log determinism here is
    plane determinism everywhere the schedule is concerned; the
    per-frame coin-flip replays are covered per plane by
    ``test_link_drop_decisions_replay_with_seed`` (asyncio) and
    ``test_native_fault_drop_pattern_replays_with_seed`` (native)."""
    import json

    scenario = chaos_scenario(77, duration_s=20, crashes=2, partitions=2,
                              byzantine=1, links=2)

    def one_run():
        plane = FaultPlane(scenario.compile(NODES), ADDRS)
        plane.start(time.monotonic() - 1e6)  # whole schedule elapsed
        actions = plane.poll_actions()
        return json.dumps(plane.applied, sort_keys=True), actions

    (log_a, actions_a), (log_b, actions_b) = one_run(), one_run()
    assert log_a == log_b
    assert actions_a == actions_b
    assert json.loads(log_a)  # the storm is not empty


def test_supervised_actions_surface_in_order():
    plane = _armed_plane(
        [
            {"kind": "crash", "node": 1, "at": 1.0},
            {"kind": "restart", "node": 1, "at": 2.0},
            {"kind": "byzantine", "node": 2, "behavior": "stale_vote_flood",
             "at": 3.0, "until": 4.0},
        ]
    )
    actions = plane.poll_actions()
    assert [a["action"] for a in actions] == [
        "crash", "restart", "byzantine_on", "byzantine_off"
    ]


# ---------------------------------------------------------------------------
# checker
# ---------------------------------------------------------------------------


def _schedule(events=None, duration=10.0):
    return Scenario(
        name="chk", seed=3, duration_s=duration, events=events or []
    ).compile(NODES)


def test_checker_flags_conflicting_commits():
    schedule = _schedule()
    commits = {
        "n000": [CommitRecord(5, b"a" * 32, 1.0)],
        "n001": [CommitRecord(5, b"b" * 32, 1.0)],
    }
    verdict = check(schedule, commits, min_recovery_commits=0)
    assert not verdict["safety"]["ok"]
    assert verdict["safety"]["violations"][0]["type"] == "conflicting_commit"


def test_checker_flags_intra_node_conflict():
    schedule = _schedule()
    commits = {
        "n000": [CommitRecord(5, b"a" * 32, 1.0), CommitRecord(5, b"c" * 32, 2.0)]
    }
    verdict = check(schedule, commits, min_recovery_commits=0)
    assert not verdict["safety"]["ok"]
    assert verdict["safety"]["violations"][0]["type"] == "intra_node_conflict"


def test_checker_tolerates_crash_recovery_replay():
    """Commit progress persists lazily (with the vote state), so a node
    restarted between a commit and its next vote REPLAYS recent commits.
    Identical-digest repeats — in any order — are legitimate
    at-least-once delivery, not a safety violation."""
    schedule = _schedule()
    stream = [
        CommitRecord(4, b"d" * 32, 1.0),
        CommitRecord(5, b"a" * 32, 1.1),
        # crash + restart: rounds 4..5 re-delivered with the same digests
        CommitRecord(4, b"d" * 32, 2.0),
        CommitRecord(5, b"a" * 32, 2.1),
        CommitRecord(6, b"b" * 32, 2.2),
    ]
    commits = {n: list(stream) for n in NODES}
    verdict = check(schedule, commits, min_recovery_commits=0)
    assert verdict["safety"]["ok"], verdict["safety"]


def test_checker_liveness_requires_post_heal_growth():
    schedule = _schedule(
        [{"kind": "partition", "at": 1.0, "until": 5.0}]
    )
    pre = [CommitRecord(r, bytes([r]) * 32, 0.5) for r in range(1, 4)]
    post = [CommitRecord(r, bytes([r]) * 32, 6.0 + r) for r in range(4, 8)]
    commits = {n: pre + post for n in NODES}
    ok = check(schedule, commits, min_recovery_commits=3)
    assert ok["liveness"]["recovered"]
    stalled = {n: list(pre) for n in NODES}
    bad = check(schedule, stalled, min_recovery_commits=3)
    assert not bad["liveness"]["recovered"]
    assert bad["liveness"]["laggards"] == NODES


def test_checker_excludes_byzantine_and_dead_nodes():
    schedule = _schedule(
        [
            {"kind": "crash", "node": 0, "at": 1.0},  # never restarted
            {"kind": "byzantine", "node": 1, "behavior": "equivocate",
             "at": 1.0, "until": 2.0},
        ]
    )
    good = [CommitRecord(r, bytes([r]) * 32, 3.0 + r) for r in range(1, 6)]
    commits = {"n002": list(good), "n003": list(good)}
    verdict = check(schedule, commits, min_recovery_commits=3)
    assert verdict["safety"]["ok"]
    assert verdict["liveness"]["recovered"]
    assert set(verdict["liveness"]["post_heal_commits"]) == {"n002", "n003"}


# ---------------------------------------------------------------------------
# end to end: seeded crash + partition + heal on a live committee
# ---------------------------------------------------------------------------


@async_test(timeout=150)
async def test_chaos_smoke_crash_partition_heal():
    """The canonical chaos smoke: a 4-node committee survives a
    supervised crash/restart and a 2-2 partition with healing; the
    checker must report safety=ok and liveness=recovered, and the
    injection counters must show the faults actually fired."""
    from hotstuff_tpu_torch.faultline import run_scenario

    scenario = Scenario(
        name="smoke-4", seed=20260804, duration_s=6.0,
        events=[
            {"kind": "crash", "node": 1, "at": 0.5},
            {"kind": "restart", "node": 1, "at": 2.0},
            {"kind": "partition", "at": 3.0, "until": 4.5},
        ],
    )
    result = await run_scenario(
        scenario, 4, base_port=BASE, timeout_delay=500,
        recovery_timeout_s=60.0,
    )
    verdict = result["verdict"]
    assert verdict["safety"]["ok"], verdict["safety"]
    assert verdict["liveness"]["recovered"], verdict["liveness"]
    counts = verdict["injections"]["counts"]
    assert counts["events_applied"] == 4
    assert counts["send_drops"] > 0  # the partition really cut links
    # Replay contract: recompiling the same scenario yields the identical
    # fault schedule byte for byte.
    assert result["trace"] == scenario.compile(
        [f"n{i:03d}" for i in range(4)]
    ).trace()
    # The plane uninstalled cleanly (no leakage into later tests).
    assert hooks.plane is None
    assert fl_runtime.uninstall() is None


@async_test(timeout=150)
async def test_minority_partition_halts_then_recovers():
    """Satellite: cut the committee into TWO MINORITY groups (2+2 of 4 —
    neither side holds 2f+1 = 3), at a fixed seed. Safety demands the
    commit stream goes silent for the partition's duration (no quorum
    anywhere ⇒ no QC ⇒ no commit); liveness demands commit progress
    resumes within k timeout periods of the heal."""
    from hotstuff_tpu_torch.faultline import run_scenario

    cut_at, heal_at = 2.0, 4.0
    scenario = Scenario(
        name="minority-split", seed=424242, duration_s=5.0,
        events=[
            {"kind": "partition", "groups": [[0, 1], [2, 3]],
             "at": cut_at, "until": heal_at},
        ],
    )
    timeout_delay_ms = 500
    result = await run_scenario(
        scenario, 4, base_port=BASE + 80, timeout_delay=timeout_delay_ms,
        recovery_timeout_s=60.0,
    )
    verdict = result["verdict"]
    assert verdict["safety"]["ok"], verdict["safety"]
    # No commits during the cut: allow a 1 s drain for blocks already
    # QC'd in flight when the partition lands, then demand silence. A
    # healthy committee here commits many times per second, so a quorum
    # that somehow survived the cut would certainly show up.
    silent_from = cut_at + 1.0
    during = [
        (name, round_, t)
        for name, recs in result["commit_streams"].items()
        for round_, t in recs
        if silent_from < t < heal_at
    ]
    assert during == [], f"commits flowed inside a minority-only split: {during}"
    # Progress DID happen before the cut and resumed after the heal.
    for name, recs in result["commit_streams"].items():
        assert any(t < cut_at for _, t in recs), f"{name} never committed pre-cut"
    assert verdict["liveness"]["recovered"], verdict["liveness"]
    # Recovery within k timeout periods of the heal (k = 40 is generous
    # for a loaded CI box; the regression this guards was a TOTAL stall).
    k = 40
    recovery_s = verdict["liveness"]["recovery_s"]
    assert recovery_s is not None
    assert recovery_s <= k * (timeout_delay_ms / 1e3), verdict["liveness"]
    # The partition really cut links both ways.
    assert verdict["injections"]["counts"]["send_drops"] > 0


@pytest.mark.slow
@async_test(timeout=240)
async def test_chaos_byzantine_storm_n8():
    """Heavier seeded storm: 8 nodes, crash + partition + byzantine
    actor + lossy links, all drawn from one seed. Safety must hold under
    active adversarial traffic and liveness must recover post-heal."""
    from hotstuff_tpu_torch.faultline import run_scenario

    scenario = chaos_scenario(
        991, duration_s=10.0, crashes=1, partitions=1, byzantine=1, links=1
    )
    result = await run_scenario(
        scenario, 8, base_port=BASE + 40, timeout_delay=1_000,
        recovery_timeout_s=90.0,
    )
    verdict = result["verdict"]
    assert verdict["safety"]["ok"], verdict["safety"]
    assert verdict["liveness"]["recovered"], verdict["liveness"]
    assert verdict["injections"]["counts"]["events_applied"] >= 6


# ---------------------------------------------------------------------------
# parity with the reference's faultline
# ---------------------------------------------------------------------------


def _names(n: int) -> list[str]:
    return [f"n{i:03d}" for i in range(n)]


SCENARIO_FILES = sorted(p.name for p in SCENARIOS.glob("*.json"))


def test_the_six_committed_scenarios_are_read():
    assert SCENARIO_FILES == [
        "crash.json", "delay-reorder.json", "partition.json", "rejoin.json",
        "storm-n20.json", "worker-crash.json",
    ]


@pytest.mark.parametrize("n", [4, 8, 20])
@pytest.mark.parametrize("filename", SCENARIO_FILES)
def test_scenario_file_trace_byte_identical_to_reference(filename, n):
    path = str(SCENARIOS / filename)
    ours = Scenario.load(path)
    theirs = j_faultline.Scenario.load(path)
    assert ours.to_json() == theirs.to_json()
    trace = ours.compile(_names(n)).trace()
    assert trace == theirs.compile(_names(n)).trace()
    # And through a JSON round trip of either package's scenario.
    assert Scenario.from_json(theirs.to_json()).compile(_names(n)).trace() == trace


@pytest.mark.parametrize("n", [4, 8, 20])
@pytest.mark.parametrize("seed", [3, 7, 11, 991])
def test_chaos_seed_trace_byte_identical_to_reference(seed, n):
    ours, theirs = chaos_scenario(seed), j_faultline.chaos_scenario(seed)
    assert ours.to_json() == theirs.to_json()
    assert ours.compile(_names(n)).trace() == theirs.compile(_names(n)).trace()


def test_link_rng_draws_equal_the_reference():
    for src, dst in (("n000", "n002"), ("*", "n003"), ("n019", "*")):
        ours, theirs = t_policy.link_rng(991, src, dst), j_faultline.link_rng(991, src, dst)
        assert [ours.random() for _ in range(64)] == [theirs.random() for _ in range(64)]
    assert t_policy.SEEDED_BEHAVIORS == j_faultline.policy.SEEDED_BEHAVIORS
    assert t_policy.BYZANTINE_BEHAVIORS == j_faultline.BYZANTINE_BEHAVIORS


PLANE_EVENTS = [
    {"kind": "partition", "groups": [[0], [1, 2, 3]], "at": 0.0, "until": 1e5},
    {"kind": "link", "src": 1, "dst": "*", "at": 0.0, "drop": 0.3,
     "delay_ms": [5, 40], "duplicate": 0.2, "reorder": 0.2},
    {"kind": "link", "src": "*", "dst": 2, "at": 0.0, "drop": 0.25,
     "delay_ms": [1, 3], "side": "recv"},
    {"kind": "byzantine", "node": 3, "behavior": "silent_leader", "at": 0.0},
]


def _decisions(faultline_pkg):
    """One seeded plane of ``faultline_pkg`` over a fixed frame list: every
    sender in turn, to every peer, a proposal and a vote frame (framed and
    unframed), then every listener's receive filter."""
    schedule = faultline_pkg.Scenario(
        name="parity", seed=4242, duration_s=1e6, events=PLANE_EVENTS
    ).compile(NODES)
    plane = faultline_pkg.FaultPlane(schedule, ADDRS)
    plane.start(time.monotonic() - 100.0)
    out = []
    for _ in range(25):
        for src in NODES:
            token = faultline_pkg.hooks.NODE.set(src)
            try:
                for dst in NODES:
                    for frame, off in ((b"\x00prop", 0), (b"\x01vote", 0),
                                       (b"\x00\x00\x00\x05\x00prop", 4)):
                        out.append(plane.filter_send(ADDR[dst], frame, payload_off=off))
            finally:
                faultline_pkg.hooks.NODE.reset(token)
        for dst in NODES:
            out.append(plane.filter_recv(ADDR[dst]))
    return out, plane.counts, plane.applied


def test_seeded_plane_decisions_equal_the_reference():
    ours, theirs = _decisions(t_faultline), _decisions(j_faultline)
    assert ours[0] == theirs[0]
    assert ours[1] == theirs[1] and ours[2] == theirs[2]
    kinds = {None if d is None else d[0] for d in ours[0]}
    assert kinds == {None, "drop", "deliver"}  # every fate was drawn


def _commit_cases():
    """The commit streams of the reference checker tests, in plain tuples."""
    stream = [(4, b"d" * 32, 1.0), (5, b"a" * 32, 1.1), (4, b"d" * 32, 2.0),
              (5, b"a" * 32, 2.1), (6, b"b" * 32, 2.2)]
    pre = [(r, bytes([r]) * 32, 0.5) for r in range(1, 4)]
    post = [(r, bytes([r]) * 32, 6.0 + r) for r in range(4, 8)]
    good = [(r, bytes([r]) * 32, 3.0 + r) for r in range(1, 6)]
    partition = [{"kind": "partition", "at": 1.0, "until": 5.0}]
    dead = [{"kind": "crash", "node": 0, "at": 1.0},
            {"kind": "byzantine", "node": 1, "behavior": "equivocate", "at": 1.0, "until": 2.0}]
    return [
        ([], {"n000": [(5, b"a" * 32, 1.0)], "n001": [(5, b"b" * 32, 1.0)]}, 0),
        ([], {"n000": [(5, b"a" * 32, 1.0), (5, b"c" * 32, 2.0)]}, 0),
        ([], {n: stream for n in NODES}, 0),
        (partition, {n: pre + post for n in NODES}, 3),
        (partition, {n: pre for n in NODES}, 3),
        (dead, {"n002": good, "n003": good}, 3),
    ]


@pytest.mark.parametrize("case", range(6))
def test_checker_verdict_equals_the_reference(case):
    events, streams, k = _commit_cases()[case]
    verdicts = []
    for pkg, checker in ((j_faultline, j_checker), (t_faultline, t_checker)):
        scen = pkg.Scenario(name="chk", seed=3, duration_s=10.0, events=events)
        commits = {n: [checker.CommitRecord(*r) for r in recs] for n, recs in streams.items()}
        verdicts.append(checker.check(scen.compile(NODES), commits, min_recovery_commits=k))
    assert json.dumps(verdicts[0], sort_keys=True) == json.dumps(verdicts[1], sort_keys=True)
    assert t_checker.VERDICT_SCHEMA == j_checker.VERDICT_SCHEMA


def test_frontier_availability_verdict_equals_the_reference():
    cases = [
        ({(1, b"a"), (2, b"b")}, {b"a": {"n0", "n1"}, b"b": {"n0", "n1", "n2"}}, {}),
        ({(5, b"x")}, {b"x": {"n0"}}, {"n1": 7}),
        ({(5, b"x")}, {b"x": {"n0"}}, {"n1": 4}),
    ]
    for committed, resolvers, floors in cases:
        got = [checker.check_frontier_availability(
            policy.Schedule(scenario="t", seed=0, nodes=["n0", "n1", "n2", "n3"]),
            committed, resolvers, floors)
            for checker, policy in ((j_checker, j_faultline.policy), (t_checker, t_policy))]
        assert got[0] == got[1]


def test_silent_leader_tag_is_the_ports_proposal_tag():
    """``runtime._TAG_PROPOSE`` is a literal so that the runtime imports no
    consensus code; it must stay the first payload byte of the port's
    proposals, v1 and v2, and of no vote."""
    from hotstuff_tpu_torch.consensus.messages import QC, Block, SeatTable, Vote
    from hotstuff_tpu_torch.consensus.config import Authority, Committee
    from hotstuff_tpu_torch.crypto import generate_keypair, sha512_digest

    assert fl_runtime._TAG_PROPOSE == TAG_PROPOSE == 0
    keys = [generate_keypair(seed=bytes([i]) * 32)[:2] for i in range(4)]
    committee = Committee({pk: Authority(1, ("127.0.0.1", 1 + i)) for i, (pk, _) in enumerate(keys)})
    pk, sk = keys[0]
    block = Block.new_from_key(QC.genesis(), None, pk, 1, [sha512_digest(b"p")], sk)
    for seats in (None, SeatTable.for_committee(committee)):
        assert encode_propose(block, seats)[0] == fl_runtime._TAG_PROPOSE
    vote = Vote.new_from_key(block.digest(), 1, pk, sk)
    assert encode_vote(vote)[0] != fl_runtime._TAG_PROPOSE


def test_card_scenarios_bind_below_the_hosts_ephemeral_range():
    """``chip_smoke.py``'s phase 15 and the faultline card test bind below
    the H100 host's ephemeral range (16000-65535), each run on ports of its
    own, clear of each other and of the ranges taken before them (phases
    9-14, the bench, the other card tests, phase 9's profiled run)."""
    import ast

    from . import test_torch_faultline_card as card

    tree = ast.parse((Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text())
    consts = {}
    for node in tree.body:  # NAME = value, and A, B = a, b
        if isinstance(node, ast.Assign):
            target = node.targets[0]
            pairs = (zip(target.elts, node.value.elts) if isinstance(target, ast.Tuple)
                     else [(target, node.value)])
            for t, v in pairs:
                if isinstance(t, ast.Name) and t.id in (
                        "FAULT_RUNS", "STORM_RUN", "CONVEYOR_N", "CONVEYOR_WORKERS",
                        "QUIET_PORTS", "WITHHOLD_PORTS"):
                    consts[t.id] = ast.literal_eval(v)
    runs = [range(base, base + n) for _, n, base, _ in consts["FAULT_RUNS"] + (consts["STORM_RUN"],)]
    runs.append(range(consts["QUIET_PORTS"], consts["QUIET_PORTS"] + 4))
    n, w = consts["CONVEYOR_N"], consts["CONVEYOR_WORKERS"]
    runs.append(range(consts["WITHHOLD_PORTS"], consts["WITHHOLD_PORTS"] + (3 + 2 * w) * n))
    runs.append(range(card.BASE, card.BASE + 4))
    taken = [range(10000, 10748), range(10800, 10900)]
    for i, ports in enumerate(runs):
        assert max(ports) < 16000
        assert not any(set(ports) & set(r) for r in taken), ports
        assert not any(set(ports) & set(other) for other in runs[i + 1:]), ports
