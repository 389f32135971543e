"""CLI entry for the local benchmark (the ``fab local`` equivalent,
reference ``benchmark/fabfile.py:11-38``): boots N nodes + clients on
localhost and prints the SUMMARY block.

Port copy of the reference's ``benchmark/run_local.py``, over the port's
``LocalBench``. Its flags and printed lines are the reference's, with
``cuda`` in place of ``tpu`` in ``--crypto-backend``'s values, and that
flag defaults to ``cuda`` where the reference's defaults to ``cpu``: a run
that does not name ``cpu`` verifies on the card and exits non-zero without
one. ``main`` takes ``argv``. Nothing is left out. On the H100 host pass a
``--base-port`` below 16000.

    python -m hotstuff_tpu_torch.benchmark.run_local --nodes 4 --rate 1000 \
        --duration 20 --base-port 14300
"""

from __future__ import annotations

import argparse
import os
import sys

from hotstuff_tpu_torch.benchmark.local import LocalBench


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Run a local hotstuff_tpu benchmark.")
    p.add_argument("--nodes", type=int, default=4)
    p.add_argument("--rate", type=int, default=1_000, help="total input rate tx/s")
    p.add_argument("--tx-size", type=int, default=512, help="transaction bytes")
    p.add_argument("--duration", type=int, default=20, help="benchmark seconds")
    p.add_argument("--faults", type=int, default=0, help="crash-faulted nodes")
    p.add_argument("--timeout", type=int, default=1_000, help="consensus timeout ms")
    p.add_argument("--batch-size", type=int, default=15_000, help="mempool batch B")
    p.add_argument("--max-batch-delay", type=int, default=10, help="ms")
    p.add_argument("--base-port", type=int, default=9000)
    p.add_argument("--work-dir", default=".bench")
    p.add_argument(
        "--workers", type=int, default=0,
        help="Conveyor worker shards per node (0 = legacy mempool only); "
        "clients switch to the sharded bundle load generator",
    )
    p.add_argument(
        "--crypto-backend",
        default="cuda",
        choices=["cpu", "cuda", "cpu-batched", "cuda-batched"],
    )
    p.add_argument(
        "--telemetry",
        action="store_true",
        help="nodes stream JSON-lines telemetry snapshots next to their "
        "logs; prints the telemetry-derived SUMMARY alongside the regex one",
    )
    p.add_argument(
        "--chaos",
        metavar="SCENARIO",
        help="faultline scenario: a JSON file, or chaos:<seed> for a "
        "seeded generated storm. Crash/restart events kill and relaunch "
        "real node processes; partition/link/byzantine events run inside "
        "each node via its env-armed fault plane. Prints the checker "
        "verdict and exits nonzero on a safety violation or liveness "
        "stall.",
    )
    args = p.parse_args(argv)

    chaos_path = args.chaos
    if chaos_path and chaos_path.startswith("chaos:"):
        from hotstuff_tpu_torch.faultline import chaos_scenario

        scenario = chaos_scenario(
            int(chaos_path.split(":", 1)[1]), duration_s=float(args.duration)
        )
        # NOT inside work_dir: LocalBench.run() wipes that tree before
        # loading the scenario.
        chaos_path = os.path.abspath(args.work_dir).rstrip("/") + "-scenario.json"
        scenario.save(chaos_path)

    bench = LocalBench(
        nodes=args.nodes,
        rate=args.rate,
        tx_size=args.tx_size,
        duration=args.duration,
        faults=args.faults,
        base_port=args.base_port,
        timeout_delay=args.timeout,
        batch_size=args.batch_size,
        max_batch_delay=args.max_batch_delay,
        work_dir=args.work_dir,
        crypto_backend=args.crypto_backend,
        telemetry=args.telemetry,
        chaos=chaos_path,
        workers=args.workers,
    )
    parser = bench.run()
    print(parser.result())
    if args.telemetry or chaos_path:
        from hotstuff_tpu_torch.benchmark.logs import TelemetryParser

        print(
            TelemetryParser.process(
                os.path.join(os.path.abspath(args.work_dir), "logs"),
                tx_size=args.tx_size,
            ).result()
        )
    if bench.chaos_verdict is not None:
        import json

        v = bench.chaos_verdict
        avail = v.get("availability")
        print(
            f"chaos verdict: safety="
            f"{'ok' if v['safety']['ok'] else 'VIOLATED'} liveness="
            f"{'recovered' if v['liveness']['recovered'] else 'STALLED'}"
            + (
                f" availability={'ok' if avail['ok'] else 'VIOLATED'}"
                f" ({avail['checked']} digests @ f+1={avail['required_holders']})"
                if avail is not None
                else ""
            )
            + f" commits={v['commits']}"
        )
        out = os.path.join(os.path.abspath(args.work_dir), "chaos-verdict.json")
        with open(out, "w") as f:
            json.dump(v, f, indent=2, sort_keys=True)
        print(f"verdict written to {out}")
        if not (
            v["safety"]["ok"]
            and v["liveness"]["recovered"]
            and v.get("availability", {}).get("ok", True)
        ):
            sys.exit(1)


if __name__ == "__main__":
    main()
