"""Faultline scenarios on live committees of each package, on the CPU.

- The smoke scenario of ``tests/test_faultline.py::
  test_chaos_smoke_crash_partition_heal`` (crash, restart, 2-2 partition)
  and its two-minority-group split, each run through the reference's
  ``run_scenario`` on four reference engines and through the port's on
  four port engines: both verdicts safe and recovered, the faults fired,
  and the two replay traces equal. The two packages keep separate
  ``faultline.hooks.plane`` globals, so no mixed committee runs under one
  plane: each package's committee runs under its own.
- A crashed port engine sends nothing from its crash to its restart, even
  with frames held back by a delay rule when it crashes (the port's
  senders close with their owners and drop what the filter holds back),
  and sends again after the restart.
- Twins of ``tests/test_reputation_grind.py``'s non-slow tests on the
  port's ``ReputationLeaderElector``; its seed sweep stays ``slow``.

Both packages on ``cpu`` keys and backends. Ports 23300-23499.
"""

import asyncio
import time

import pytest

import hotstuff_tpu.crypto as j_crypto
import hotstuff_tpu.faultline as j_faultline
import hotstuff_tpu_torch.crypto as t_crypto
import hotstuff_tpu_torch.faultline as t_faultline
from hotstuff_tpu_torch.consensus import cert_arena
from hotstuff_tpu_torch.consensus.leader import ReputationLeaderElector, RRLeaderElector
from hotstuff_tpu_torch.faultline import Scenario, hooks
from hotstuff_tpu_torch.faultline.harness import ScenarioRun

from .common import async_test
from .test_torch_statesync import chain, consensus_committee

BASE = 23300
PKG = {"reference": j_faultline, "port": t_faultline}


@pytest.fixture(autouse=True)
def backends(monkeypatch):
    monkeypatch.setattr(t_crypto, "_BACKEND", None)
    monkeypatch.setattr(j_crypto, "_BACKEND", None)
    t_crypto.set_backend(t_crypto.CpuBackend())
    j_crypto.set_backend("cpu")
    cert_arena.reset()
    yield
    cert_arena.reset()


def _names(n: int) -> list[str]:
    return [f"n{i:03d}" for i in range(n)]


SMOKE = {
    "name": "smoke-4", "seed": 20260804, "duration_s": 6.0,
    "events": [
        {"kind": "crash", "node": 1, "at": 0.5},
        {"kind": "restart", "node": 1, "at": 2.0},
        {"kind": "partition", "at": 3.0, "until": 4.5},
    ],
}
SPLIT = {
    "name": "minority-split", "seed": 424242, "duration_s": 5.0,
    "events": [
        {"kind": "partition", "groups": [[0, 1], [2, 3]], "at": 2.0, "until": 4.0},
    ],
}


@pytest.mark.parametrize("case, spec, events, base", [
    ("smoke", SMOKE, 4, BASE),
    ("minority-split", SPLIT, 2, BASE + 20),
], ids=["smoke", "minority-split"])
@async_test(timeout=150)
async def test_scenario_on_each_packages_committee(case, spec, events, base):
    results = {}
    for offset, (label, pkg) in enumerate(PKG.items()):
        scenario = pkg.Scenario(**spec)
        results[label] = await pkg.run_scenario(
            scenario, 4, base_port=base + 10 * offset, timeout_delay=500,
            recovery_timeout_s=60.0,
        )
        assert pkg.hooks.plane is None  # uninstalled after the run
    for label, result in results.items():
        verdict = result["verdict"]
        assert verdict["safety"]["ok"], (label, verdict["safety"])
        assert verdict["liveness"]["recovered"], (label, verdict["liveness"])
        counts = verdict["injections"]["counts"]
        assert counts["events_applied"] == events, (label, counts)
        assert counts["send_drops"] > 0, (label, counts)
        assert result["trace"] == Scenario(**spec).compile(_names(4)).trace()
    assert results["port"]["trace"] == results["reference"]["trace"]
    assert (results["port"]["verdict"]["injections"]["applied"]
            == results["reference"]["verdict"]["injections"]["applied"])


@async_test(timeout=120)
async def test_crashed_engine_sends_nothing_until_its_restart(monkeypatch):
    """Every write of a port sender is stamped with the writing engine's
    faultline identity (a sender's connection task carries its engine's
    context). None of n001's may fall between its crash and its restart,
    though a delay rule on its links holds frames back when it crashes."""
    writes: list[tuple[str | None, float]] = []
    real_open = asyncio.open_connection

    async def spying_open(*args, **kwargs):
        reader, writer = await real_open(*args, **kwargs)
        real_write = writer.write

        def write(data):
            writes.append((hooks.current_node(), time.monotonic()))
            real_write(data)

        writer.write = write
        return reader, writer

    monkeypatch.setattr(asyncio, "open_connection", spying_open)
    scenario = Scenario(
        name="crash-quiet", seed=77, duration_s=5.0,
        events=[
            {"kind": "link", "src": 1, "dst": "*", "at": 0.0, "until": 5.0,
             "delay_ms": [100, 300], "duplicate": 0.5},
            {"kind": "crash", "node": 1, "at": 1.5},
            {"kind": "restart", "node": 1, "at": 3.0},
        ],
    )
    run = ScenarioRun(scenario, 4, base_port=BASE + 40, timeout_delay=500,
                      recovery_timeout_s=60.0)
    marks = {}
    crash, restart = run._crash_engine, run._restart_engine

    async def crash_engine(eng):
        await crash(eng)
        marks["crash"] = time.monotonic()

    async def restart_engine(eng, wipe=False):
        marks["restart"] = time.monotonic()
        await restart(eng, wipe)

    run._crash_engine, run._restart_engine = crash_engine, restart_engine
    result = await run.execute()
    verdict = result["verdict"]
    assert verdict["safety"]["ok"] and verdict["liveness"]["recovered"], verdict
    # The byzantine actors' round source reads each engine's Core through
    # ``Consensus.core`` (the reference digs it out of a coroutine frame).
    assert all(e.core() is e.consensus.core for e in run.engines)
    assert run._honest_round() > 1
    assert verdict["injections"]["counts"]["delays"] > 0
    n001 = [t for node, t in writes if node == "n001"]
    assert any(t < marks["crash"] for t in n001)  # it sent before its crash
    assert any(t > marks["restart"] for t in n001)  # and after its restart
    quiet = [t - marks["crash"] for t in n001 if marks["crash"] < t < marks["restart"]]
    assert quiet == [], f"the crashed engine wrote {len(quiet)} frames: {quiet[:5]}"


# -- twins of tests/test_reputation_grind.py -----------------------------------


def _divergent_electors():
    """Two electors over the SAME chain but with one node lagging two
    commits — the exact transient the commit-batching skew produces."""
    committee = consensus_committee(BASE + 60)
    blocks = chain(12)
    ahead = ReputationLeaderElector(committee)
    behind = ReputationLeaderElector(committee)
    for blk in blocks:
        ahead.update(blk)
    for blk in blocks[:-2]:
        behind.update(blk)
    return committee, ahead, behind, blocks


def test_divergent_windows_disagree_without_tc_fallback():
    _, ahead, behind, blocks = _divergent_electors()
    start = blocks[-1].round + ReputationLeaderElector.LAG
    picks = [
        (ahead.get_leader(r), behind.get_leader(r))
        for r in range(start - 3, start + 6)
    ]
    assert any(a != b for a, b in picks), (
        "fixture no longer produces divergent elections; rebuild it "
        "with a different lag"
    )


def test_tc_entered_round_elects_round_robin_on_every_node():
    committee, ahead, behind, blocks = _divergent_electors()
    rr = RRLeaderElector(committee)
    start = blocks[-1].round + ReputationLeaderElector.LAG
    for r in range(start - 3, start + 6):
        ahead.note_round_entry(r, via_tc=True)
        behind.note_round_entry(r, via_tc=True)
        assert ahead.get_leader(r) == behind.get_leader(r) == rr.get_leader(r)
    far = start + 100
    ahead.note_round_entry(far, via_tc=False)
    assert far not in ahead._tc_set


def test_tc_memory_is_bounded():
    committee = consensus_committee(BASE + 60)
    rep = ReputationLeaderElector(committee)
    for r in range(10_000):
        rep.note_round_entry(r, via_tc=True)
    assert len(rep._tc_set) <= ReputationLeaderElector.TC_MEMORY
    assert len(rep._tc_rounds) <= ReputationLeaderElector.TC_MEMORY
    assert 9_999 in rep._tc_set and 0 not in rep._tc_set


def test_rr_elector_accepts_round_entry_feed():
    committee = consensus_committee(BASE + 60)
    rr = RRLeaderElector(committee)
    rr.note_round_entry(7, via_tc=True)  # must be a no-op, not an error
    assert rr.get_leader(7) == committee.sorted_keys()[7 % 4]


@async_test(timeout=150)
async def test_reputation_committee_survives_grind_scenario():
    """A silent leader plus a partition straggler on a live committee of
    port engines under the reputation elector: safe and recovered."""
    scenario = Scenario(
        name="reputation-grind", seed=413, duration_s=8.0,
        events=[
            {"kind": "partition", "groups": [[3], [0, 1, 2]],
             "at": 1.0, "until": 4.0},
            {"kind": "byzantine", "node": 0, "behavior": "silent_leader",
             "at": 3.5, "until": 6.0},
        ],
    )
    result = await t_faultline.run_scenario(
        scenario, 4, base_port=BASE + 80, timeout_delay=500,
        leader_elector="reputation", recovery_timeout_s=60.0,
    )
    verdict = result["verdict"]
    assert verdict["safety"]["ok"], verdict["safety"]
    assert verdict["liveness"]["recovered"], verdict["liveness"]


@pytest.mark.slow
@async_test(timeout=300)
async def test_reputation_grind_seed_sweep():
    """Chaos seeds 11 and 12 on a reputation committee of port engines."""
    for i, seed in enumerate((11, 12)):
        scenario = t_faultline.chaos_scenario(
            seed, duration_s=8.0, crashes=1, partitions=1, byzantine=1,
            links=1,
        )
        result = await t_faultline.run_scenario(
            scenario, 4, base_port=BASE + 100 + i * 8, timeout_delay=500,
            leader_elector="reputation", recovery_timeout_s=60.0,
        )
        verdict = result["verdict"]
        assert verdict["safety"]["ok"], (seed, verdict["safety"])
        assert verdict["liveness"]["recovered"], (seed, verdict["liveness"])
