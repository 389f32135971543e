"""Seeded fault-schedule sweep on the deterministic simulation plane.

The search the asyncio planes cannot afford: every seed is a full
chaos schedule (crash/restart, partition, link impairment, byzantine
behavior) executed in virtual time on the sans-io core
(``hotstuff_tpu_torch/sim``), checker-gated, at >=1,000 seeds per minute at
N=4 on one CPU core. Any safety/liveness violation is shrunk to a
minimal pinned reproducer (``hotstuff_tpu_torch/sim/shrink``) and written as
a replayable artifact.

Usage:
    python -m hotstuff_tpu_torch.benchmark.sim_sweep --seeds 0:1000     # search
    python -m hotstuff_tpu_torch.benchmark.sim_sweep --seeds 0:500 --twins 24 --gate
    python -m hotstuff_tpu_torch.benchmark.sim_sweep --seeds 0:50 --jitter 3
    python -m hotstuff_tpu_torch.benchmark.sim_sweep --inject-wedge     # shrink demo

``--gate`` exits non-zero on any genuine violation (the CI contract).
``--inject-wedge`` adds a deliberately wedged schedule (two permanent
crashes at N=4) to validate the violation->shrink->artifact pipeline
end to end; its expected violation never trips the gate.

Port copy of the reference's ``benchmark/sim_sweep.py``, over the port's
``sim`` and ``faultline.policy``. Its flags, printed line, summary schema
and reproducer files are the reference's. What differs: ``main`` runs the
sweep under the ``cpu`` backend, set for this process and put back after
it. The sim verifies inline and fails under a ``cuda``-named backend (no
running event loop) as the reference's does under ``tpu``; the reference
reaches ``cpu`` through its default backend, the port's default is
``cuda``. Neither package has a device path on the sim plane, so this is
not a fallback. ``--artifacts`` still defaults to ``results``: pass a
directory of your own.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time

from hotstuff_tpu_torch import crypto
from hotstuff_tpu_torch.benchmark.hostinfo import host_meta
from hotstuff_tpu_torch.faultline.policy import Scenario, chaos_scenario
from hotstuff_tpu_torch.sim import SimWorld
from hotstuff_tpu_torch.sim.shrink import shrink, sim_failure_probe, write_reproducer
from hotstuff_tpu_torch.sim.twins import enumerate_twins

SCHEMA = "sim-sweep-v1"

#: the injected-violation demo: two permanent crashes wedge an N=4
#: committee below quorum; the trailing link fault extends the
#: checker's heal horizon past the crashes so the liveness window
#: actually judges the wedged tail (see docs/faultline.md).
WEDGE = {
    "name": "injected-wedge",
    "seed": 3,
    "duration_s": 8.0,
    "events": [
        {"kind": "link", "src": "?", "dst": "*", "at": 1.0, "until": 3.0,
         "drop": 0.2, "delay_ms": [5.0, 40.0]},
        {"kind": "partition", "at": 2.0, "until": 4.0},
        {"kind": "crash", "node": 1, "at": 2.5},
        {"kind": "byzantine", "node": 0, "behavior": "stale_vote_flood",
         "at": 3.0, "until": 5.0},
        {"kind": "crash", "node": 2, "at": 3.5},
        {"kind": "link", "src": "*", "dst": "?", "at": 4.0, "until": 5.5,
         "drop": 0.1, "delay_ms": [1.0, 10.0]},
    ],
}


def _violation(verdict: dict) -> str | None:
    if not verdict["safety"]["ok"]:
        return "safety"
    if not verdict["liveness"]["recovered"]:
        return "liveness"
    return None


def _run_one(scenario, n, world_kwargs, twins=None):
    world = SimWorld(scenario, n, twins=twins, **world_kwargs)
    result = world.run()
    return result


def main(argv=None) -> int:
    """The sweep under the ``cpu`` backend; the backend before it is put
    back after it."""
    saved = crypto._BACKEND
    crypto.set_backend("cpu")
    try:
        return _sweep(argv)
    finally:
        crypto.set_backend(saved)


def _sweep(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", default="0:200",
                   help="seed range lo:hi (half-open) for chaos schedules")
    p.add_argument("--nodes", type=int, default=4)
    p.add_argument("--duration", type=float, default=8.0,
                   help="virtual seconds per schedule")
    p.add_argument("--timeout-delay", type=int, default=1_000, help="ms")
    p.add_argument("--elector", default="",
                   help="leader elector ('' = round-robin, or 'reputation')")
    p.add_argument("--link-delay", default="25:75",
                   help="per-hop latency draw lo:hi in ms")
    p.add_argument("--jitter", type=int, default=1,
                   help="interleavings per seed (re-drawn link latencies)")
    p.add_argument("--twins", type=int, default=0,
                   help="also run this many systematic Twins scenarios")
    p.add_argument("--inject-wedge", action="store_true",
                   help="add the known-wedged demo schedule (expected "
                        "violation; exercises shrink+artifact)")
    p.add_argument("--no-shrink", action="store_true")
    p.add_argument("--max-shrink", type=int, default=5,
                   help="shrink at most this many distinct failures")
    p.add_argument("--artifacts", default="results",
                   help="directory for shrunk reproducer artifacts")
    p.add_argument("--out", default=None, help="summary JSON path")
    p.add_argument("--gate", action="store_true",
                   help="exit non-zero on any genuine violation")
    p.add_argument("--verbose", action="store_true",
                   help="keep per-round protocol warnings (timeouts, "
                        "rejected byzantine traffic) on stderr")
    args = p.parse_args(argv)

    if not args.verbose:
        # Chaos schedules make the cores warn constantly (timeouts,
        # rejected byzantine frames) — per-event noise at sweep rates.
        for name in ("consensus", "network", "faultline", "sim"):
            logging.getLogger(name).setLevel(logging.ERROR)

    lo, hi = (int(x) for x in args.seeds.split(":"))
    dlo, dhi = (float(x) for x in args.link_delay.split(":"))
    world_kwargs = dict(
        timeout_delay=args.timeout_delay,
        leader_elector=args.elector,
        link_delay_ms=(dlo, dhi),
    )

    runs = []
    failures = []
    injected_failures = []
    t0 = time.perf_counter()
    events_total = 0

    def record(scenario, n, result, *, twins=None, jitter=0, injected=False):
        nonlocal events_total
        verdict = result["verdict"]
        violation = _violation(verdict)
        events_total += result["events"]
        runs.append(
            {
                "name": scenario.name,
                "seed": scenario.seed,
                "jitter": jitter,
                "twins": bool(twins),
                "violation": violation,
                "commits": verdict["commits"],
                "recovery_s": verdict["liveness"]["recovery_s"],
            }
        )
        if violation is None:
            return
        entry = {
            "name": scenario.name,
            "seed": scenario.seed,
            "jitter": jitter,
            "violation": violation,
            "injected": injected,
            "artifact": None,
        }
        (injected_failures if injected else failures).append(entry)
        budget = args.max_shrink - len(
            [f for f in failures + injected_failures if f["artifact"]]
        )
        if args.no_shrink or budget <= 0:
            return
        probe_kwargs = dict(world_kwargs)
        probe_kwargs["jitter"] = jitter
        if twins:
            # Shrink under the same twin topology.
            def probe(sc, _tw=twins, _kw=probe_kwargs):
                v = SimWorld(sc, n, twins=_tw, **_kw).run()["verdict"]
                return _violation(v), v
        else:
            probe = sim_failure_probe(n, **probe_kwargs)
        res = shrink(scenario, probe)
        entry["artifact"] = write_reproducer(
            args.artifacts,
            res.scenario,
            n,
            res.verdict,
            trace=result["trace"],
            world={**probe_kwargs, "twins": twins or {}},
            steps=res.steps,
            tag="sim-shrunk",
        )
        entry["shrink_runs"] = res.runs
        entry["shrunk_events"] = len(res.scenario.events)
        print(
            f"  shrunk {scenario.name}: {len(scenario.events)} -> "
            f"{len(res.scenario.events)} events ({res.runs} probe runs) "
            f"-> {entry['artifact']}"
        )

    for seed in range(lo, hi):
        scenario = chaos_scenario(seed, duration_s=args.duration)
        for jitter in range(args.jitter):
            kwargs = dict(world_kwargs)
            kwargs["jitter"] = jitter
            result = _run_one(scenario, args.nodes, kwargs)
            record(scenario, args.nodes, result, jitter=jitter)

    twins_runs = 0
    for scenario, twins_map in enumerate_twins(
        args.nodes, duration_s=args.duration, limit=args.twins or None
    ):
        if args.twins <= 0:
            break
        result = _run_one(scenario, args.nodes, world_kwargs, twins=twins_map)
        record(scenario, args.nodes, result, twins=twins_map)
        twins_runs += 1

    if args.inject_wedge:
        scenario = Scenario.from_json({**WEDGE, "schema": None})
        result = _run_one(scenario, args.nodes, world_kwargs)
        record(scenario, args.nodes, result, injected=True)

    wall = time.perf_counter() - t0
    n_runs = len(runs)
    per_min = n_runs / wall * 60.0 if wall > 0 else 0.0
    summary = {
        "schema": SCHEMA,
        "host": host_meta(),
        "config": {
            "seeds": [lo, hi],
            "nodes": args.nodes,
            "duration_s": args.duration,
            "timeout_delay_ms": args.timeout_delay,
            "leader_elector": args.elector or "round-robin",
            "link_delay_ms": [dlo, dhi],
            "jitter": args.jitter,
            "twins": args.twins,
            "inject_wedge": args.inject_wedge,
        },
        "totals": {
            "runs": n_runs,
            "chaos_seeds": hi - lo,
            "twins_runs": twins_runs,
            "ok": sum(1 for r in runs if r["violation"] is None),
            "violations": len(failures),
            "injected_violations": len(injected_failures),
            "events_simulated": events_total,
            "wall_s": round(wall, 3),
            "schedules_per_min": round(per_min, 1),
        },
        "failures": failures,
        "injected": injected_failures,
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2, sort_keys=True)
            f.write("\n")
    print(
        f"sim-sweep: {n_runs} schedules ({twins_runs} twins) in {wall:.1f}s "
        f"= {per_min:.0f}/min; {len(failures)} violations"
        + (f", {len(injected_failures)} injected" if args.inject_wedge else "")
    )
    if failures:
        for f_ in failures:
            print(f"  VIOLATION {f_['violation']}: {f_['name']} "
                  f"seed={f_['seed']} jitter={f_['jitter']} "
                  f"artifact={f_['artifact']}")
    if args.gate and failures:
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
