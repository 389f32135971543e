"""Watchtower smoke + overhead gate (the live-detection sibling of
``benchmark/profile_smoke.py``).

Runs the one-process committee bench twice per repeat — telemetry
streaming in BOTH legs (that budget is already paid and gated by
``telemetry_smoke``), watchtower DETACHED vs ATTACHED (a
:class:`hotstuff_tpu_torch.benchmark.watchtower.DirectoryWatch` tail-following the stream
and scoring every peer while the committee runs) — and gates:

1. the attached leg actually ingested the stream (records > 0) and
   scored rounds (frontier advanced);
2. **zero alerts on the fault-free run** — the detectors' false-positive
   gate at the exact config the soaks run with;
3. measured overhead within ``--budget`` (default 1%): min-over-repeats
   with alternating order, the same noise-robust estimator the other
   smoke lanes use. Each leg runs in a FRESH subprocess (the native
   transport accumulates process-wide state; see profile_smoke).

Exit 0 on pass, 1 on ingest/alert failure, 2 on budget failure.

    python -m hotstuff_tpu_torch.benchmark.watchtower_smoke --nodes 10 --rounds 20

Port copy of the reference's ``benchmark/watchtower_smoke.py``: the same
flags, legs (each in a fresh ``python -m
hotstuff_tpu_torch.benchmark.watchtower_smoke --one-shot`` process, run
from the repository's root), ingest and zero-alert checks, overhead
arithmetic, summary line and exit codes, over the port's
``committee_scale``, ``watchtower`` and telemetry. The legs verify under
``HOTSTUFF_CRYPTO_BACKEND``, whose default here is ``cuda``: without a
card the parent raises before it starts a leg and prints no summary.
``main`` takes ``argv``; there is no ``sys.path`` edit. On the H100 host
pass a ``--base-port`` below 16000 (each leg takes ``2 * --nodes`` ports).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import subprocess
import sys
import tempfile


from hotstuff_tpu_torch.benchmark.hostinfo import host_meta
from hotstuff_tpu_torch.utils.device import resolve_backend_card

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def _run_once(
    n: int,
    rounds: int,
    base_port: int,
    with_watch: bool,
    snap_path: str,
):
    from hotstuff_tpu_torch.benchmark.committee_scale import run_committee
    from hotstuff_tpu_torch.benchmark.watchtower import DirectoryWatch
    from hotstuff_tpu_torch import telemetry

    telemetry.reset_for_tests()
    telemetry.enable()
    watch = None
    if with_watch:
        watch = DirectoryWatch(
            os.path.dirname(os.path.abspath(snap_path)),
            pattern=os.path.basename(snap_path),
            alerts_path=snap_path + ".alerts.jsonl",
        )
        watch.start()
    try:
        per_round, _ = asyncio.run(
            run_committee(
                n, rounds, base_port, timeout_delay=30_000,
                telemetry_path=snap_path,
            )
        )
    finally:
        if watch is not None:
            watch.stop()
        telemetry.disable()
    result = {"per_round": per_round, "alerts": 0, "records": 0, "rounds": 0}
    if watch is not None:
        board = watch.scoreboard()
        result.update(
            alerts=len(watch.alerts()),
            records=watch.stats()["records"],
            rounds=board["rounds"],
            frontier=board["frontier"],
        )
    return result


def _spawn_once(
    n: int, rounds: int, base_port: int, with_watch: bool, snap_path: str
):
    """One measurement leg in a fresh subprocess (see profile_smoke for
    why in-process repeats bias the estimator)."""
    cmd = [
        sys.executable, "-m", "hotstuff_tpu_torch.benchmark.watchtower_smoke", "--one-shot",
        "--nodes", str(n), "--rounds", str(rounds),
        "--base-port", str(base_port), "--snap", snap_path,
    ]
    if with_watch:
        cmd.append("--watch-on")
    proc = subprocess.run(
        cmd, capture_output=True, text=True,
        cwd=REPO_ROOT,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"one-shot leg failed (rc={proc.returncode}):\n{proc.stderr[-2000:]}"
        )
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--nodes", type=int, default=10)
    p.add_argument("--rounds", type=int, default=20)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument(
        "--budget",
        type=float,
        default=float(os.environ.get("HOTSTUFF_WATCHTOWER_BUDGET", "0.01")),
        help="max allowed relative overhead (default 0.01 = 1%%)",
    )
    p.add_argument("--base-port", type=int, default=20500)
    p.add_argument("--output", help="file to append the result summary to")
    # Internal: one measurement leg (see _spawn_once).
    p.add_argument("--one-shot", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--watch-on", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--snap", help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    os.environ.setdefault("HOTSTUFF_TELEMETRY_INTERVAL", "1")
    os.environ.setdefault("HOTSTUFF_CRYPTO_WORKERS", "32")

    if args.one_shot:
        print(
            json.dumps(
                _run_once(
                    args.nodes, args.rounds, args.base_port,
                    args.watch_on, args.snap,
                )
            )
        )
        return

    resolve_backend_card()
    snap_dir = tempfile.mkdtemp(prefix="hotstuff_watchtower_smoke_")
    off_times: list[float] = []
    on_times: list[float] = []
    total_alerts = 0
    total_records = 0
    scored_rounds = 0
    port = args.base_port

    # Discarded warm-up (one-time costs must not land on either side).
    _spawn_once(
        args.nodes, max(2, args.rounds // 4), port, False,
        os.path.join(snap_dir, "telemetry-warmup.jsonl"),
    )
    port += 2 * args.nodes

    for rep in range(args.repeats):
        order = (False, True) if rep % 2 == 0 else (True, False)
        for with_watch in order:
            snap_path = os.path.join(
                snap_dir,
                f"telemetry-{'on' if with_watch else 'off'}-{rep}.jsonl",
            )
            result = _spawn_once(
                args.nodes, args.rounds, port, with_watch, snap_path
            )
            port += 2 * args.nodes
            if with_watch:
                on_times.append(result["per_round"])
                total_alerts += result["alerts"]
                total_records += result["records"]
                scored_rounds += result["rounds"]
            else:
                off_times.append(result["per_round"])

    problems: list[str] = []
    if total_records == 0:
        problems.append("attached watchtower ingested zero stream records")
    if scored_rounds == 0:
        problems.append("attached watchtower scored zero rounds")
    if total_alerts:
        problems.append(
            f"{total_alerts} alert(s) fired on fault-free runs — "
            "false positives"
        )

    best_off = min(off_times)
    best_on = min(on_times)
    overhead = (best_on - best_off) / best_off

    result = {
        "metric": f"watchtower_overhead_n{args.nodes}",
        "host": host_meta(),
        "off_ms_per_round": round(best_off * 1e3, 2),
        "on_ms_per_round": round(best_on * 1e3, 2),
        "overhead": round(overhead, 4),
        "budget": args.budget,
        "alerts": total_alerts,
        "records": total_records,
        "scored_rounds": scored_rounds,
        "problems": problems,
    }
    print(json.dumps(result))

    if args.output:
        os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
        with open(args.output, "a") as f:
            f.write(json.dumps(result) + "\n")

    if problems:
        print(f"FAIL: {problems}", file=sys.stderr)
        sys.exit(1)
    if overhead > args.budget:
        print(
            f"FAIL: watchtower overhead {overhead:.2%} exceeds the "
            f"{args.budget:.2%} budget",
            file=sys.stderr,
        )
        sys.exit(2)
    print(
        f"PASS: watchtower overhead {overhead:+.2%} within "
        f"{args.budget:.2%}; {total_records} record(s) ingested, "
        f"{scored_rounds} round(s) scored, 0 alerts"
    )


if __name__ == "__main__":
    main()
