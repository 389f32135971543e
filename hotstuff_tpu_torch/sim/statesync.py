"""Lazarus simulation model: seeded replica join/truncate schedules.

Port copy of ``hotstuff_tpu/sim/statesync.py``, whole. One difference in
its entry point: the reference's default crypto backend is ``cpu``, the
port's ``cuda``, under which the sim plane cannot run (its verifications
leave the loop); so ``main`` requires ``HOTSTUFF_CRYPTO_BACKEND`` to name a
``cpu`` backend, exits with a usage error when it is unset or names
``cuda``, installs it and prints it on its first line.

The sim-first half of the state-sync subsystem (see
``docs/statesync.md``): every seed is a full replica-lifecycle schedule
— one victim crashes early, the committee keeps committing (and, with
retention armed, SNAPSHOTS + TRUNCATES its logs past the victim's last
known round), then the victim comes back — half the seeds with a wiped
store (cold join), half with its stale one (warm lag below the quorum's
truncation horizon). Some seeds add link impairment during catch-up to
stress the retry/rotation path. The schedule executes on the sans-io
plane (:mod:`hotstuff_tpu_torch.sim.world`) in virtual time through the real
:class:`~hotstuff_tpu_torch.faultline.runtime.FaultPlane`, with the Lazarus
machinery live: ``retention_rounds > 0`` arms the Compactor on every
node and ``statesync_active=True`` arms the anti-entropy probe loop.

Each run is judged by three machine-checked invariants:

- **safety** / **liveness** — the standard faultline checker verdict;
  cross-node agreement doubles as the rejoin-prefix check (a recovered
  victim's commit stream is compared round-by-round against the
  quorum's — a snapshot install that adopted a wrong chain shows up as
  a ``conflicting_commit``);
- **frontier availability** — post-run, every committed ``(round,
  digest)`` must still be servable at f+1 honest live nodes, where a
  node serves a block either from its store or by covering it with its
  snapshot floor (:func:`~hotstuff_tpu_torch.faultline.checker.
  check_frontier_availability`). Truncation may bound disk, never
  recoverability.

Sweep CLI (the CI leg; artifact schema ``statesync-sweep-v1``)::

    HOTSTUFF_CRYPTO_BACKEND=cpu python -m hotstuff_tpu_torch.sim.statesync \
        --seeds 0:200 --gate --out results/statesync-sweep.json
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

from hotstuff_tpu_torch import crypto
from hotstuff_tpu_torch.consensus.statesync import SNAPSHOT_KEY, peek_frontier
from hotstuff_tpu_torch.faultline.checker import check_frontier_availability
from hotstuff_tpu_torch.faultline.policy import Scenario, _seed_stream

from .world import SimWorld

__all__ = [
    "rejoin_scenario",
    "run_rejoin",
    "probe_frontier_availability",
    "SCHEMA",
]

SCHEMA = "statesync-sweep-v1"


def rejoin_scenario(seed: int, duration_s: float = 12.0) -> Scenario:
    """One seeded replica-lifecycle schedule. All free choices (victim,
    crash/rejoin instants, wipe-or-stale, whether catch-up happens under
    link noise) are drawn from streams keyed only by ``seed``, so the
    schedule — like every faultline scenario — replays byte-identically.
    """
    rng = _seed_stream(seed, "lazarus")
    victim = rng.randrange(1 << 16)  # compile maps modulo committee size
    t_crash = round(rng.uniform(0.8, 0.2 * duration_s), 3)
    # Rejoin late enough that (at the sim's ~10 rounds/virtual-second
    # pacing) the survivors' compaction hysteresis has fired at least
    # once and the victim is below every peer's truncation horizon.
    t_rejoin = round(rng.uniform(0.55 * duration_s, 0.75 * duration_s), 3)
    restart: dict = {"kind": "restart", "node": victim, "at": t_rejoin}
    if rng.random() < 0.5:
        restart["wipe"] = True  # cold join: empty store
    events = [
        {"kind": "crash", "node": victim, "at": t_crash},
        restart,
    ]
    if rng.random() < 0.3:
        # Impaired catch-up: drop/delay a seeded link while the victim
        # is syncing, exercising retry + per-peer rotation.
        at = round(rng.uniform(t_rejoin, 0.85 * duration_s), 3)
        events.append(
            {
                "kind": "link",
                "src": "?",
                "dst": "*",
                "at": at,
                "until": round(min(at + 0.1 * duration_s, 0.9 * duration_s), 3),
                "drop": round(rng.uniform(0.05, 0.25), 3),
                "delay_ms": [5.0, round(rng.uniform(20.0, 60.0), 1)],
            }
        )
    return Scenario(
        name=f"rejoin-{seed}",
        seed=seed,
        duration_s=duration_s,
        events=events,
    )


def probe_frontier_availability(world: SimWorld) -> dict:
    """Post-run audit over the sim stores (mirrors the real harness's
    ``_probe_frontier_availability``): collect every committed
    ``(round, digest)``, each live node's resolvable set and snapshot
    floor, and hand them to the checker invariant."""
    committed: set = set()
    for recs in world.commits.values():
        for rec in recs:
            committed.add((rec.round, rec.digest))
    resolvers: dict = {}
    floors: dict[str, int] = {}
    for slot in world.slots:
        if slot.crashed or slot.engine is None:
            continue
        snap = slot.engine.get_meta(SNAPSHOT_KEY)
        if snap is not None:
            floors[slot.name] = peek_frontier(snap)[0]
        for _round, digest in committed:
            if slot.engine.get(digest) is not None:
                resolvers.setdefault(digest, set()).add(slot.name)
    return check_frontier_availability(
        world.schedule, committed, resolvers, floors
    )


def _rejoin_metrics(world: SimWorld) -> dict:
    """Per-run recovery numbers for the sweep artifact: how long after
    the rejoin the victim's first commit landed, and where its committed
    round ended relative to the quorum's."""
    restarts = [e for e in world.schedule.events if e.kind == "restart"]
    if not restarts:
        return {}
    ev = restarts[-1]
    victim = ev.params["node"]
    post = [rec for rec in world.commits.get(victim, ()) if rec.t > ev.at]
    victim_max = max(
        (rec.round for rec in world.commits.get(victim, ())), default=0
    )
    quorum_max = max(
        (
            rec.round
            for name, recs in world.commits.items()
            if name != victim
            for rec in recs
        ),
        default=0,
    )
    floor = None
    slot = world._by_name.get(victim)
    if slot is not None and slot.engine is not None:
        snap = slot.engine.get_meta(SNAPSHOT_KEY)
        if snap is not None:
            floor = peek_frontier(snap)[0]
    return {
        "victim": victim,
        "wipe": bool(ev.params.get("wipe")),
        "rejoin_t": ev.at,
        "first_commit_after_s": round(post[0].t - ev.at, 3) if post else None,
        "post_rejoin_commits": len(post),
        "victim_max_round": victim_max,
        "quorum_max_round": quorum_max,
        "victim_snapshot_round": floor,
    }


def run_rejoin(
    seed: int,
    n: int = 4,
    *,
    duration_s: float = 12.0,
    retention_rounds: int = 16,
    sync_retry_delay: int = 1_000,
    **world_kwargs,
) -> dict:
    """Execute one seeded rejoin schedule with the Lazarus machinery
    armed; returns the harness-shaped result with the verdict extended
    by ``frontier_availability`` and a ``rejoin`` metrics section."""
    scenario = rejoin_scenario(seed, duration_s=duration_s)
    world = SimWorld(
        scenario,
        n,
        retention_rounds=retention_rounds,
        statesync_active=True,
        sync_retry_delay=sync_retry_delay,
        **world_kwargs,
    )
    result = world.run()
    result["verdict"]["frontier_availability"] = probe_frontier_availability(
        world
    )
    result["rejoin"] = _rejoin_metrics(world)
    return result


def _violation(verdict: dict) -> str | None:
    if not verdict["safety"]["ok"]:
        return "safety"
    if not verdict["liveness"]["recovered"]:
        return "liveness"
    fa = verdict.get("frontier_availability")
    if fa is not None and not fa["ok"]:
        return "frontier_availability"
    return None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", default="0:200",
                   help="seed range lo:hi (half-open) for rejoin schedules")
    p.add_argument("--nodes", type=int, default=4)
    p.add_argument("--duration", type=float, default=12.0,
                   help="virtual seconds per schedule")
    p.add_argument("--retention", type=int, default=16,
                   help="snapshot/truncate retention depth in rounds")
    p.add_argument("--timeout-delay", type=int, default=1_000, help="ms")
    p.add_argument("--sync-retry-delay", type=int, default=1_000,
                   help="ms; also the statesync probe cadence")
    p.add_argument("--link-delay", default="25:75",
                   help="per-hop latency draw lo:hi in ms")
    p.add_argument("--out", default=None, help="summary JSON path")
    p.add_argument("--gate", action="store_true",
                   help="exit non-zero on any checker violation")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)

    if not args.verbose:
        for name in ("consensus", "network", "faultline", "sim"):
            logging.getLogger(name).setLevel(logging.ERROR)

    lo, hi = (int(x) for x in args.seeds.split(":"))
    dlo, dhi = (float(x) for x in args.link_delay.split(":"))
    # The sim plane verifies inline: a backend whose name holds "cuda"
    # sends every verification to the bridge's pool, which the sim cannot
    # run (see the module docstring). The caller names the CPU.
    backend = os.environ.get("HOTSTUFF_CRYPTO_BACKEND")
    if backend is None or "cuda" in backend:
        p.error(f"HOTSTUFF_CRYPTO_BACKEND is {backend!r}: the sim plane verifies inline "
                "and runs only under a cpu backend; set HOTSTUFF_CRYPTO_BACKEND=cpu")
    crypto.set_backend(backend)
    print(f"statesync-sweep: crypto backend {backend}")

    runs = []
    failures = []
    t0 = time.perf_counter()
    events_total = 0
    cold = warm = 0
    recoveries = []
    for seed in range(lo, hi):
        result = run_rejoin(
            seed,
            args.nodes,
            duration_s=args.duration,
            retention_rounds=args.retention,
            sync_retry_delay=args.sync_retry_delay,
            timeout_delay=args.timeout_delay,
            link_delay_ms=(dlo, dhi),
        )
        verdict = result["verdict"]
        violation = _violation(verdict)
        rejoin = result["rejoin"]
        events_total += result["events"]
        if rejoin.get("wipe"):
            cold += 1
        else:
            warm += 1
        if rejoin.get("first_commit_after_s") is not None:
            recoveries.append(rejoin["first_commit_after_s"])
        runs.append(
            {
                "seed": seed,
                "violation": violation,
                "rejoin": rejoin,
                "commits": verdict["commits"],
                "recovery_s": verdict["liveness"]["recovery_s"],
                "floors": verdict["frontier_availability"]["floors"],
            }
        )
        if violation is not None:
            failures.append(
                {"seed": seed, "violation": violation, "rejoin": rejoin}
            )
            print(f"  VIOLATION {violation}: rejoin-{seed} "
                  f"(wipe={rejoin.get('wipe')})")

    wall = time.perf_counter() - t0
    n_runs = len(runs)
    summary = {
        "schema": SCHEMA,
        "config": {
            "seeds": [lo, hi],
            "nodes": args.nodes,
            "duration_s": args.duration,
            "retention_rounds": args.retention,
            "timeout_delay_ms": args.timeout_delay,
            "sync_retry_delay_ms": args.sync_retry_delay,
            "link_delay_ms": [dlo, dhi],
        },
        "totals": {
            "runs": n_runs,
            "cold_joins": cold,
            "warm_rejoins": warm,
            "ok": n_runs - len(failures),
            "violations": len(failures),
            "events_simulated": events_total,
            "wall_s": round(wall, 3),
            "schedules_per_min": round(n_runs / wall * 60.0, 1)
            if wall > 0
            else 0.0,
            "rejoin_first_commit_s": {
                "min": min(recoveries) if recoveries else None,
                "max": max(recoveries) if recoveries else None,
                "mean": round(sum(recoveries) / len(recoveries), 3)
                if recoveries
                else None,
            },
        },
        "failures": failures,
        "runs": runs,
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2, sort_keys=True)
            f.write("\n")
    print(
        f"statesync-sweep: {n_runs} schedules ({cold} cold / {warm} warm) "
        f"in {wall:.1f}s; {len(failures)} violations"
    )
    if args.gate and failures:
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
