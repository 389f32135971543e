"""Telemetry smoke + overhead gate.

Runs the one-process committee bench (``benchmark.committee_scale``'s
protocol mode) twice per repeat — telemetry OFF and telemetry ON
(counters + round-trace spans + a 1 s snapshot emitter + per-stage
profiling) — and:

1. validates every emitted snapshot line against the schema
   (``hotstuff_tpu.telemetry.validate_snapshot``) and checks the
   per-stage profile is present and parses back through
   ``benchmark.logs.read_telemetry_stream``;
2. gates the measured overhead: min-over-repeats per-round time with
   telemetry on must be within ``--budget`` (default 1%) of off.
   Min-of-N with alternating order is the noise-robust estimator on a
   shared CI core; a genuine regression shifts the minimum, scheduler
   noise does not.

Exit code 0 on pass, 1 on schema failure, 2 on budget failure.

    python -m hotstuff_tpu_torch.benchmark.telemetry_smoke --nodes 10 --rounds 15
    python -m hotstuff_tpu_torch.benchmark.telemetry_smoke --nodes 100 --rounds 20 \
        --output results/telemetry-overhead-100.txt

Port copy of the reference's ``benchmark/telemetry_smoke.py``: the same
flags, legs (a discarded warm-up, then telemetry off and on in alternating
order), schema and counter checks, overhead arithmetic (min over repeats),
summary line and exit codes, over the port's ``committee_scale``,
``logs`` and telemetry. The committees verify under
``HOTSTUFF_CRYPTO_BACKEND``, whose default here is ``cuda``: without a
card the script raises before the first committee and prints no summary.
``main`` takes ``argv``; there is no ``sys.path`` edit. On the H100 host
pass a ``--base-port`` below 16000 (each leg takes ``2 * --nodes`` ports).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import tempfile


from hotstuff_tpu_torch.benchmark.hostinfo import host_meta
from hotstuff_tpu_torch.utils.device import resolve_backend_card


def _run_once(
    n: int, rounds: int, base_port: int, with_telemetry: bool, snap_path: str | None
):
    from hotstuff_tpu_torch import telemetry
    from hotstuff_tpu_torch.benchmark.committee_scale import run_committee

    if with_telemetry:
        telemetry.reset_for_tests()
        telemetry.enable()
    else:
        telemetry.disable()
    try:
        per_round, stage = asyncio.run(
            run_committee(
                n,
                rounds,
                base_port,
                timeout_delay=30_000,
                profile=with_telemetry,
                telemetry_path=snap_path if with_telemetry else None,
            )
        )
    finally:
        telemetry.disable()
    return per_round, stage


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--nodes", type=int, default=10)
    p.add_argument("--rounds", type=int, default=15)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument(
        "--budget",
        type=float,
        default=float(os.environ.get("HOTSTUFF_TELEMETRY_BUDGET", "0.01")),
        help="max allowed relative overhead (default 0.01 = 1%%)",
    )
    p.add_argument("--base-port", type=int, default=18000)
    p.add_argument("--output", help="file to append the result summary to")
    args = p.parse_args(argv)
    resolve_backend_card()

    os.environ.setdefault("HOTSTUFF_TELEMETRY_INTERVAL", "1")

    from hotstuff_tpu_torch.benchmark.logs import read_telemetry_stream

    snap_dir = tempfile.mkdtemp(prefix="hotstuff_telemetry_smoke_")
    off_times: list[float] = []
    on_times: list[float] = []
    last_stage = None
    port = args.base_port

    # Discarded warm-up: first-run one-time costs (native lib load, key
    # interning, backend init) must not land on either side of the gate.
    _run_once(args.nodes, max(2, args.rounds // 4), port, False, None)
    port += 2 * args.nodes

    for rep in range(args.repeats):
        order = (False, True) if rep % 2 == 0 else (True, False)
        for with_telemetry in order:
            snap_path = os.path.join(snap_dir, f"telemetry-run{rep}.jsonl")
            per_round, stage = _run_once(
                args.nodes, args.rounds, port, with_telemetry, snap_path
            )
            port += 2 * args.nodes
            if with_telemetry:
                on_times.append(per_round)
                last_stage = stage
            else:
                off_times.append(per_round)

    # -- snapshot schema gate -----------------------------------------------
    problems: list[str] = []
    streams = 0
    for fn in sorted(os.listdir(snap_dir)):
        path = os.path.join(snap_dir, fn)
        try:
            snaps = read_telemetry_stream(path)  # raises on schema violation
        except Exception as e:  # noqa: BLE001
            problems.append(f"{fn}: {e}")
            continue
        streams += 1
        final = snaps[-1]
        for expected in (
            "consensus.rounds_advanced",
            "consensus.qcs_formed",
            "consensus.votes_received",
        ):
            if expected not in final["counters"]:
                problems.append(f"{fn}: missing counter {expected}")
    if streams == 0:
        problems.append("no telemetry streams were emitted")
    if not last_stage:
        problems.append("per-stage profile missing from telemetry registry")

    # -- overhead gate ------------------------------------------------------
    best_off = min(off_times)
    best_on = min(on_times)
    overhead = (best_on - best_off) / best_off

    result = {
        "metric": f"telemetry_overhead_n{args.nodes}",
        "host": host_meta(),
        "off_ms_per_round": round(best_off * 1e3, 2),
        "on_ms_per_round": round(best_on * 1e3, 2),
        "overhead": round(overhead, 4),
        "budget": args.budget,
        "snapshot_streams": streams,
        "schema_problems": problems,
        "stages": {
            k: [ns, calls] for k, (ns, calls) in (last_stage or {}).items()
        },
    }
    print(json.dumps(result))

    if args.output:
        os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
        with open(args.output, "a") as f:
            f.write(json.dumps(result) + "\n")
            if last_stage:
                f.write(
                    f"per-stage handler cost (all {args.nodes} engines, "
                    f"{args.rounds} measured rounds, telemetry registry):\n"
                )
                f.write(f"  {'stage':<10} {'calls/round':>12} {'us/round':>12}\n")
                for kind, (ns, calls) in sorted(
                    last_stage.items(), key=lambda kv: -kv[1][0]
                ):
                    f.write(
                        f"  {kind:<10} {calls / args.rounds:>12.1f} "
                        f"{ns / 1e3 / args.rounds:>12.1f}\n"
                    )

    if problems:
        print(f"FAIL: schema problems: {problems}", file=sys.stderr)
        sys.exit(1)
    if overhead > args.budget:
        print(
            f"FAIL: telemetry overhead {overhead:.2%} exceeds the "
            f"{args.budget:.2%} budget",
            file=sys.stderr,
        )
        sys.exit(2)
    print(
        f"PASS: telemetry overhead {overhead:+.2%} within {args.budget:.2%}; "
        f"{streams} snapshot stream(s) schema-valid"
    )


if __name__ == "__main__":
    main()
