"""Open-loop fleet bench: the front door under connection-scale load.

Boots the sharded-ingest local bench (real node processes, worker
shards) but replaces the per-node saturating loader with the client's
``--fleet`` mode: many concurrent connections per client, Poisson
(exponential-gap) arrivals of small bundles, optional square-wave burst
windows and connection churn. Because arrivals never wait for
back-pressure, overload shows up where it should: shed notifications,
worker ingress watermarks, and the p99.9 e2e tail — the three numbers a
closed-loop sweep structurally cannot measure.

The artifact (``results/fleet-*.json``) records, per run: committed e2e
TPS, mean/p99/p99.9 e2e latency, total sheds, connection churns, and
the max ``mempool.worker.ingress_depth`` watermark observed across
every node's telemetry stream (host class stamped via
``benchmark.hostinfo``).

    python -m hotstuff_tpu_torch.benchmark.fleet_bench --nodes 4 --workers 2 --rate 20000 \
        --fleet 256 --bundle-txs 8 --duration 30 --output results
    python -m hotstuff_tpu_torch.benchmark.fleet_bench --nodes 4 --workers 1 --rate 10000 \
        --fleet 512 --burst-every 10 --burst-len 2 --burst-x 4 --churn 0.5

Port copy of the reference's ``benchmark/fleet_bench.py``, over the port's
``LocalBench``, client (``--fleet`` mode) and ``read_telemetry_stream``.
Its flags, printed lines, schema and artifact name are the reference's.
What differs: the nodes verify under ``HOTSTUFF_CRYPTO_BACKEND``, whose
default here is ``cuda``, where the reference runs ``LocalBench``'s default
``cpu`` (without a card the run raises before it starts a process and
prints no result);
``main`` takes ``argv``; there is no ``sys.path`` edit. On the H100 host
pass a ``--base-port`` below 16000.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import time

from hotstuff_tpu_torch.benchmark.hostinfo import host_meta
from hotstuff_tpu_torch.benchmark.local import BenchError, LocalBench
from hotstuff_tpu_torch.benchmark.logs import ParseError, read_telemetry_stream

FLEET_SCHEMA = "hotstuff-fleet-v1"


def _churn_total(logs_dir: str) -> int:
    total = 0
    for fn in sorted(glob.glob(os.path.join(logs_dir, "client-*.log"))):
        with open(fn) as f:
            matches = re.findall(r"Connection churns: (\d+)", f.read())
        if matches:
            total += int(matches[-1])
    return total


def _ingress_watermark(logs_dir: str) -> int:
    """Max ``mempool.worker.ingress_depth`` gauge across all snapshots of
    all node streams — the high-water mark the fleet actually reached."""
    peak = 0
    for fn in sorted(glob.glob(os.path.join(logs_dir, "telemetry-*.jsonl"))):
        try:
            stream = read_telemetry_stream(fn)
        except ParseError:
            continue
        for snap in stream:
            for name, value in snap.get("gauges", {}).items():
                if name.endswith("ingress_depth"):
                    peak = max(peak, int(value))
    return peak


def run_fleet(args: argparse.Namespace) -> dict:
    per_client_fleet = max(args.fleet // args.nodes, 1)
    extra = [
        "--fleet", str(per_client_fleet),
        "--bundle-txs", str(args.bundle_txs),
    ]
    if args.burst_every > 0:
        extra += [
            "--burst-every", str(args.burst_every),
            "--burst-len", str(args.burst_len),
            "--burst-x", str(args.burst_x),
        ]
    if args.churn > 0:
        extra += ["--churn", str(args.churn)]
    bench = LocalBench(
        nodes=args.nodes,
        rate=args.rate,
        tx_size=args.tx_size,
        duration=args.duration,
        base_port=args.base_port,
        timeout_delay=args.timeout,
        batch_size=args.batch_size,
        max_batch_delay=args.max_batch_delay,
        work_dir=args.work_dir,
        workers=args.workers,
        telemetry=True,
        client_extra=extra,
        crypto_backend=os.environ.get("HOTSTUFF_CRYPTO_BACKEND", "cuda"),
    )
    parser = bench.run()
    e2e_tps, e2e_bps, dur = parser._end_to_end_throughput()
    logs_dir = os.path.join(os.path.abspath(args.work_dir), "logs")
    return {
        "e2e_tps": round(e2e_tps),
        "e2e_bps": round(e2e_bps),
        "e2e_latency_ms": round(parser._end_to_end_latency() * 1e3),
        "e2e_latency_p99_ms": round(parser.e2e_latency_tail(0.99) * 1e3),
        "e2e_latency_p999_ms": round(parser.e2e_latency_tail(0.999) * 1e3),
        "consensus_latency_ms": round(parser._consensus_latency() * 1e3),
        "duration_s": round(dur, 1),
        "shed": parser.sheds,
        "churns": _churn_total(logs_dir),
        "ingress_depth_peak": _ingress_watermark(logs_dir),
        "rate_misses": parser.misses,
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--nodes", type=int, default=4)
    p.add_argument("--workers", type=int, default=1)
    p.add_argument("--rate", type=int, default=10_000, help="total tx/s")
    p.add_argument("--tx-size", type=int, default=512)
    p.add_argument("--duration", type=int, default=30)
    p.add_argument("--timeout", type=int, default=2_000)
    p.add_argument("--batch-size", type=int, default=250_000)
    p.add_argument("--max-batch-delay", type=int, default=50, help="ms")
    p.add_argument("--base-port", type=int, default=13000)
    p.add_argument("--work-dir", default=".fleet-bench")
    p.add_argument(
        "--fleet", type=int, default=256,
        help="total concurrent connections across all clients",
    )
    p.add_argument(
        "--bundle-txs", type=int, default=8,
        help="transactions per bundle (arrival granularity)",
    )
    p.add_argument("--burst-every", type=float, default=0.0)
    p.add_argument("--burst-len", type=float, default=0.0)
    p.add_argument("--burst-x", type=float, default=1.0)
    p.add_argument(
        "--churn", type=float, default=0.0,
        help="per-client: redial one connection every N seconds",
    )
    p.add_argument("--output", help="directory for the fleet artifact")
    args = p.parse_args(argv)
    if args.workers < 1:
        p.error("--workers must be >= 1 (fleet mode targets worker shards)")

    try:
        results = run_fleet(args)
    except (BenchError, ParseError) as e:
        print(f"fleet bench failed: {e}")
        sys.exit(1)
    report = {
        "schema": FLEET_SCHEMA,
        "ts": time.time(),
        "host": host_meta(),
        "config": {
            "nodes": args.nodes,
            "workers": args.workers,
            "rate": args.rate,
            "tx_size": args.tx_size,
            "duration_s": args.duration,
            "fleet": args.fleet,
            "bundle_txs": args.bundle_txs,
            "burst_every_s": args.burst_every,
            "burst_len_s": args.burst_len,
            "burst_x": args.burst_x,
            "churn_s": args.churn,
        },
        "results": results,
    }
    print(json.dumps(report, indent=2, sort_keys=True))
    if args.output:
        os.makedirs(args.output, exist_ok=True)
        path = os.path.join(
            args.output,
            f"fleet-n{args.nodes}-w{args.workers}-c{args.fleet}-"
            f"{args.tx_size}B.json",
        )
        with open(path, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"artifact written to {path}")


if __name__ == "__main__":
    main()
