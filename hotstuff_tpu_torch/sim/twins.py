"""Twins-style systematic Byzantine-scenario generation.

Port copy of ``hotstuff_tpu/sim/twins.py``, whole.

The Twins insight (Bano et al., "Twins: BFT Systems Made Robust"): most
Byzantine behaviors worth testing are EQUIVALENT to running two copies
of a correct validator with the same identity ("twins") and letting the
network schedule decide which copy each honest node hears — equivocation
falls out of duplicate identity + partitioning, with no hand-written
attack code.

Mapping onto this codebase:

- a twin pair is two :class:`~hotstuff_tpu_torch.sim.machine.CoreStateMachine`
  instances sharing one committee seat (same keypair, same address,
  SEPARATE stores — so each signs whatever its own partition shows it,
  which is exactly how a real equivocator splits the committee);
- the Twins round-by-round partition schedule is approximated by
  virtual-time partition windows over node INSTANCES (the sim's
  schedules are time-indexed, not round-indexed; with default link
  latency a window of W seconds covers ~10·W rounds, and the generator
  enumerates window phases so leader/partition alignments vary);
- leader rotation comes from the deterministic round-robin elector
  cycling every seat through leadership inside each window — OR, with
  the per-round API below, from the paper's explicit controls:
  ``SimWorld(leader_schedule=...)`` pins exactly who leads each round
  (a :class:`~hotstuff_tpu_torch.consensus.leader.ScheduledLeaderElector`
  shared by every instance) and ``SimWorld(round_partitions=...)``
  decides per-message connectivity by the SENDER's current round, so a
  partition arrangement holds for protocol rounds rather than wall
  windows. ``twin_proposal_salt`` makes a twin pair's same-round blocks
  differ by digest (payloads are salted per instance), which is what
  lets two sides of a split certify CONFLICTING blocks instead of
  accidentally agreeing on identical empty ones.

The per-round controls make the Twins paper's boundary executable:
``dual_commit_config(pairs=2)`` scripts two twinned seats at n=4 —
faults strictly beyond the f=1 tolerance — into a split where BOTH
sides hold a full quorum of distinct seats, each side chains its own
QCs over salted twin proposals, and two honest nodes commit conflicting
blocks (the checker's safety verdict flags it). The same script with
``pairs=1`` (faults within tolerance) leaves one side short of quorum:
safety provably holds. ``tests/test_sim_twins.py`` pins both sides of
that boundary.

Every time-windowed scenario (``enumerate_twins`` / ``twins_scenario``)
heals before the end, so the checker judges BOTH properties: safety
across the whole run (the twin pair is the byzantine fault — honest
nodes must never commit conflicting blocks no matter which twin they
heard) and post-heal liveness.

``enumerate_twins`` is exhaustive over (twin seat × partition
arrangement × window phase) below the cap; ``twins_scenario`` draws one
configuration from a seed for sweep-style sampling.
"""

from __future__ import annotations

import itertools

from hotstuff_tpu_torch.faultline.policy import Scenario, _seed_stream

from .world import SimWorld, _node_name

__all__ = [
    "TWIN_SUFFIX",
    "dual_commit_config",
    "enumerate_twins",
    "run_twins",
    "twins_round_scenario",
    "twins_scenario",
]

TWIN_SUFFIX = "+twin"


def _twin_name(base: str) -> str:
    return base + TWIN_SUFFIX


def _partition_arrangements(names: list[str], twin: str) -> list[list[list[str]]]:
    """All 2-way splits of the instance set where the twin pair is
    separated (one copy per side) — the arrangements that can actually
    produce equivocation — and each side can make progress at least when
    joined by the twin (size >= quorum - 1 honest members)."""
    twin_a, twin_b = twin, _twin_name(twin)
    honest = [n for n in names if n not in (twin_a, twin_b)]
    n_seats = len(honest) + 1  # committee size (the twin pair is one seat)
    quorum = 2 * ((n_seats - 1) // 3) + 1
    arrangements = []
    for r in range(1, len(honest)):
        for side in itertools.combinations(honest, r):
            group_a = sorted([twin_a, *side])
            group_b = sorted([twin_b, *(n for n in honest if n not in side)])
            # Keep splits where at least one side can quorum (with its
            # twin copy counted for the shared seat) — those are the
            # dangerous ones: commits can happen while the committee is
            # split, so safety genuinely rests on quorum intersection.
            if max(len(group_a), len(group_b)) >= quorum:
                arrangements.append([group_a, group_b])
    return arrangements


def enumerate_twins(
    n: int = 4,
    *,
    duration_s: float = 8.0,
    windows: int = 2,
    phases: int = 2,
    limit: int | None = None,
):
    """Yield ``(scenario, twins_map)`` pairs systematically covering
    (twin seat) x (partition arrangement) x (window phase). ``windows``
    partition windows tile the middle of the run; ``phases`` shifts the
    tiling so window edges land at different protocol rounds."""
    names = [_node_name(i) for i in range(n)]
    count = 0
    lo, hi = 0.15 * duration_s, 0.75 * duration_s
    for twin in names:
        instances = sorted([*names, _twin_name(twin)])
        for arrangement in _partition_arrangements(instances, twin):
            for phase in range(phases):
                span = (hi - lo) / windows
                offset = span * phase / phases
                events = []
                for w in range(windows):
                    at = lo + w * span + offset
                    until = min(at + span * 0.8, 0.85 * duration_s)
                    # Alternate which side the odd windows isolate by
                    # reversing group order (groups are symmetric for
                    # the partition filter; alternating is for trace
                    # readability only).
                    groups = arrangement if w % 2 == 0 else arrangement[::-1]
                    events.append(
                        {
                            "kind": "partition",
                            "groups": groups,
                            "at": round(at, 3),
                            "until": round(until, 3),
                        }
                    )
                scenario = Scenario(
                    name=f"twins-{twin}-a{len(arrangement[0])}-p{phase}",
                    seed=count,
                    duration_s=duration_s,
                    events=events,
                )
                yield scenario, {_twin_name(twin): twin}
                count += 1
                if limit is not None and count >= limit:
                    return


def twins_scenario(seed: int, n: int = 4, *, duration_s: float = 8.0):
    """One seed-drawn Twins configuration: ``(scenario, twins_map)``."""
    rng = _seed_stream(seed, "twins")
    names = [_node_name(i) for i in range(n)]
    twin = rng.choice(names)
    instances = sorted([*names, _twin_name(twin)])
    arrangements = _partition_arrangements(instances, twin)
    arrangement = rng.choice(arrangements)
    windows = rng.choice((1, 2, 3))
    lo, hi = 0.15 * duration_s, 0.75 * duration_s
    span = (hi - lo) / windows
    events = []
    for w in range(windows):
        at = lo + w * span + rng.uniform(0.0, 0.3) * span
        until = min(at + rng.uniform(0.5, 0.9) * span, 0.85 * duration_s)
        events.append(
            {
                "kind": "partition",
                "groups": arrangement,
                "at": round(at, 3),
                "until": round(until, 3),
            }
        )
    scenario = Scenario(
        name=f"twins-seed{seed}", seed=seed, duration_s=duration_s, events=events
    )
    return scenario, {_twin_name(twin): twin}


def dual_commit_config(n: int = 4, *, pairs: int = 2, rounds: int = 60):
    """The Twins tolerance boundary as an executable config: returns
    ``(scenario, twins_map, sim_kwargs)`` for :func:`run_twins`.

    With ``pairs=2`` at ``n=4`` (two twinned seats — faults strictly
    beyond the f=1 tolerance) the script separates the copies into two
    sides that EACH hold a quorum of distinct seats::

        side A: n000,  n001,  n002        side B: n000', n001', n003

    Every scripted round pins a twinned seat as leader, so both of its
    copies believe they lead and propose to their own side; the
    per-instance proposal salt makes those same-round blocks conflict
    by digest, each side certifies and 2-chains its own blocks, and the
    two honest observers (n002, n003) commit CONFLICTING blocks — the
    checker's safety verdict must flag it.

    With ``pairs=1`` (within tolerance) side B is one distinct seat
    short of quorum: it can never certify anything, so safety provably
    holds no matter the schedule — the unreachable side of the
    boundary, pinned by the same test that pins the violation.
    """
    if n != 4:
        raise ValueError("the scripted boundary is a committee-of-4 story")
    if pairs not in (1, 2):
        raise ValueError("pairs must be 1 (safe) or 2 (violating)")
    names = [_node_name(i) for i in range(n)]
    twinned = names[:pairs]
    twins_map = {_twin_name(b): b for b in twinned}
    side_a = sorted(names[:3])
    side_b = sorted([_twin_name(b) for b in twinned] + names[3:])
    # Leaders alternate over the twinned seats only: every scripted
    # round both sides have a copy of the leader, so neither waits on
    # rotation reaching an absent seat.
    leader_schedule = {r: twinned[r % len(twinned)] for r in range(rounds)}
    round_partitions = {r: [side_a, side_b] for r in range(rounds)}
    scenario = Scenario(
        name=f"twins-dual-commit-p{pairs}",
        seed=0,
        duration_s=8.0,
        events=[],
    )
    sim_kwargs = {
        "leader_schedule": leader_schedule,
        "round_partitions": round_partitions,
        "twin_proposal_salt": True,
    }
    return scenario, twins_map, sim_kwargs


def twins_round_scenario(
    seed: int,
    n: int = 4,
    *,
    rounds: int = 40,
    duration_s: float = 8.0,
):
    """One seed-drawn PER-ROUND Twins configuration — the paper's actual
    adversary space: each scripted round independently draws a leader
    (any seat) and a partition arrangement separating the twin pair.
    Returns ``(scenario, twins_map, sim_kwargs)``; rounds beyond the
    scripted range are fully connected with round-robin leaders. Safety
    is judged across the whole run regardless; post-heal liveness is
    only meaningful for runs that exhaust the scripted range in time —
    a schedule whose drawn leaders keep landing on the minority side
    grinds at timeout pace and may end mid-script, which the checker
    reports as ``recovered: false`` rather than a safety problem."""
    rng = _seed_stream(seed, "twins-rounds")
    names = [_node_name(i) for i in range(n)]
    twin = rng.choice(names)
    instances = sorted([*names, _twin_name(twin)])
    arrangements = _partition_arrangements(instances, twin)
    leader_schedule: dict[int, str] = {}
    round_partitions: dict[int, list] = {}
    for r in range(rounds):
        leader_schedule[r] = rng.choice(names)
        # ~1 round in 4 left fully connected: progress interleaves with
        # splits, which is where stale-QC / fork-choice bugs live.
        if rng.random() < 0.75:
            round_partitions[r] = rng.choice(arrangements)
    scenario = Scenario(
        name=f"twins-rounds-seed{seed}",
        seed=seed,
        duration_s=duration_s,
        events=[],
    )
    sim_kwargs = {
        "leader_schedule": leader_schedule,
        "round_partitions": round_partitions,
        "twin_proposal_salt": True,
    }
    return scenario, {_twin_name(twin): twin}, sim_kwargs


def run_twins(scenario: Scenario, twins_map: dict[str, str], n: int = 4, **kwargs):
    """Execute one Twins scenario on the sim plane. The verdict's
    ``safety`` section is the point: honest nodes must agree on every
    committed round even though the twinned seat signed on both sides of
    every partition."""
    return SimWorld(scenario, n, twins=twins_map, **kwargs).run()
