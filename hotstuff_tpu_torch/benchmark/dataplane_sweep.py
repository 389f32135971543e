"""Conveyor rate/latency sweep: the data plane's committed throughput
curve, and the noise-aware gate the CI smoke compares against.

Sweeps the sharded-ingest local bench (real node processes, worker
shards, bundle-mode clients) across offered rates and records, per
point: committed end-to-end TPS/BPS/latency, consensus TPS/latency, and
the clients' shed counts (the back-pressure contract made visible — at
overload the curve should PLATEAU with rising shed counts, not
collapse). The artifact (``results/dataplane-sweep-*.json``) is the
throughput claim the README cites.

Gate mode (``--gate``): the fresh peak e2e TPS must stay within
``tolerance`` of the best committed sweep artifact (min-over-noise
semantics borrowed from ``benchmark/regress.py``: CI shares cores, the
gate catches silent multiples, not drift). ``--min-tps`` adds an
absolute floor. Exit 0 green / 1 regression.

    python -m hotstuff_tpu_torch.benchmark.dataplane_sweep --nodes 4 --workers 2 \
        --rates 10000,20000,40000,80000 --duration 20 --output results
    HOTSTUFF_REGRESS_TOLERANCE=0.5 python -m hotstuff_tpu_torch.benchmark.dataplane_sweep \
        --nodes 4 --workers 1 --rates 20000 --duration 15 --gate

Port copy of the reference's ``benchmark/dataplane_sweep.py``, over the
port's ``LocalBench`` and ``dtrace_assemble``. Its flags, printed lines,
schema and artifact names are the reference's. What differs:

- the nodes verify under ``HOTSTUFF_CRYPTO_BACKEND``, whose default here
  is ``cuda``, where the reference runs ``LocalBench``'s default ``cpu``.
  Without a card the run raises before it starts a process and prints no
  result;
- ``REPO_ROOT`` is three directories above this file, so that ``--gate``
  reads the repository's ``results/dataplane-sweep-*.json`` as the
  reference's does;
- ``main`` takes ``argv``; there is no ``sys.path`` edit.

On the H100 host pass a ``--base-port`` below 16000.
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
from hotstuff_tpu_torch.benchmark.logs import ParseError

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
SWEEP_SCHEMA = "hotstuff-dataplane-sweep-v1"


def _shed_total(logs_dir: str) -> int:
    """Final shed count across clients (the counter is cumulative, so
    the last 'Shed notifications: N' line per client is the total)."""
    total = 0
    for fn in sorted(glob.glob(os.path.join(logs_dir, "client-*.log"))):
        with open(fn) as f:
            matches = re.findall(r"Shed notifications: (\d+)", f.read())
        if matches:
            total += int(matches[-1])
    return total


#: per-point cap on per-batch lifeline rows kept in the artifact (the
#: aggregate edge stats always cover every batch; only the raw rows trim).
DTRACE_BATCH_CAP = 200


def run_point(
    rate: int,
    *,
    nodes: int,
    workers: int,
    tx_size: int,
    duration: int,
    base_port: int,
    work_dir: str,
    batch_size: int,
    max_batch_delay: int,
    timeout: int,
    dtrace: bool = False,
    client_extra: list[str] | None = None,
) -> dict:
    bench = LocalBench(
        nodes=nodes,
        rate=rate,
        tx_size=tx_size,
        duration=duration,
        base_port=base_port,
        timeout_delay=timeout,
        batch_size=batch_size,
        max_batch_delay=max_batch_delay,
        work_dir=work_dir,
        workers=workers,
        telemetry=dtrace,
        client_extra=client_extra,
        crypto_backend=os.environ.get("HOTSTUFF_CRYPTO_BACKEND", "cuda"),
    )
    parser = bench.run()
    e2e_tps, e2e_bps, dur = parser._end_to_end_throughput()
    c_tps, c_bps, _ = parser._consensus_throughput()
    logs_dir = os.path.join(os.path.abspath(work_dir), "logs")
    row = {
        "rate": rate,
        "e2e_tps": round(e2e_tps),
        "e2e_bps": round(e2e_bps),
        "e2e_latency_ms": round(parser._end_to_end_latency() * 1e3),
        "consensus_tps": round(c_tps),
        "consensus_latency_ms": round(parser._consensus_latency() * 1e3),
        "duration_s": round(dur, 1),
        "shed": _shed_total(logs_dir),
        "rate_misses": parser.misses,
    }
    if dtrace:
        # Per-batch edge attribution assembled from this point's streams
        # (joined to round traces and the clients' sampled submit lines).
        from hotstuff_tpu_torch.benchmark.dtrace_assemble import assemble

        streams = sorted(
            glob.glob(os.path.join(logs_dir, "telemetry-*.jsonl"))
        )
        try:
            report = assemble(
                streams,
                client_paths=sorted(
                    glob.glob(os.path.join(logs_dir, "client-*.log"))
                ),
            )
            if len(report["per_batch"]) > DTRACE_BATCH_CAP:
                report["per_batch"] = report["per_batch"][:DTRACE_BATCH_CAP]
                report["per_batch_truncated"] = True
            row["dtrace"] = report
        except Exception as e:  # noqa: BLE001 — attribution is advisory
            row["dtrace"] = {"error": str(e)}
    return row


def best_committed_tps(results_dir: str) -> dict | None:
    """Best peak e2e TPS across committed sweep artifacts."""
    best = None
    for fn in sorted(
        glob.glob(os.path.join(results_dir, "dataplane-sweep-*.json"))
    ):
        try:
            with open(fn) as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        peak = data.get("peak", {}).get("e2e_tps")
        if peak is None:
            continue
        if best is None or peak > best["e2e_tps"]:
            best = {"e2e_tps": peak, "source": os.path.basename(fn)}
    return best


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--nodes", type=int, default=4)
    p.add_argument("--workers", type=int, default=1)
    p.add_argument(
        "--rates", default="10000,20000,40000",
        help="comma-separated offered rates (total tx/s)",
    )
    p.add_argument("--tx-size", type=int, default=512)
    p.add_argument("--duration", type=int, default=20)
    p.add_argument("--timeout", type=int, default=2_000)
    p.add_argument("--batch-size", type=int, default=250_000)
    p.add_argument("--max-batch-delay", type=int, default=50, help="ms")
    p.add_argument("--base-port", type=int, default=11000)
    p.add_argument("--work-dir", default=".dataplane-bench")
    p.add_argument("--output", help="directory for the sweep artifact")
    p.add_argument(
        "--client-extra", default="",
        help="extra args appended to every client command line, e.g. "
        "'--coalesce-bytes 8192 --coalesce-ms 5' to enable small-bundle "
        "write coalescing",
    )
    p.add_argument(
        "--dtrace", action="store_true",
        help="stream telemetry from every node and attach the assembled "
        "per-batch lifeline attribution (seven-edge) to each point; also "
        "writes a dataplane-dtrace-*.json artifact under --output",
    )
    p.add_argument(
        "--gate", action="store_true",
        help="compare the peak against the committed baseline artifact",
    )
    p.add_argument(
        "--min-tps", type=float, default=None,
        help="absolute floor for the fresh peak e2e TPS",
    )
    p.add_argument(
        "--tolerance",
        type=float,
        default=float(os.environ.get("HOTSTUFF_REGRESS_TOLERANCE", "0.5")),
        help="allowed relative shortfall vs the committed peak",
    )
    args = p.parse_args(argv)

    rates = [int(r) for r in args.rates.split(",") if r]
    rows = []
    port = args.base_port
    for rate in rates:
        print(f"--- sweep point: {rate:,} tx/s offered ---", flush=True)
        try:
            row = run_point(
                rate,
                nodes=args.nodes,
                workers=args.workers,
                tx_size=args.tx_size,
                duration=args.duration,
                base_port=port,
                work_dir=args.work_dir,
                batch_size=args.batch_size,
                max_batch_delay=args.max_batch_delay,
                timeout=args.timeout,
                dtrace=args.dtrace,
                client_extra=args.client_extra.split() or None,
            )
        except (BenchError, ParseError) as e:
            row = {"rate": rate, "error": str(e)}
        rows.append(row)
        # Per-point console line stays one line: the lifeline report (if
        # any) is summarized to its cost-center ranking here and kept in
        # full in the report/artifact.
        preview = {k: v for k, v in row.items() if k != "dtrace"}
        if isinstance(row.get("dtrace"), dict):
            preview["dtrace_top"] = row["dtrace"].get(
                "top_cost_centers", row["dtrace"].get("error")
            )
        print(json.dumps(preview), flush=True)
        # Fresh port block per point: TIME_WAIT sockets from the last
        # point must not collide with the next committee.
        port += 20 * args.nodes * (args.workers + 3)

    good = [r for r in rows if "error" not in r]
    peak = max(good, key=lambda r: r["e2e_tps"], default=None)
    report = {
        "schema": SWEEP_SCHEMA,
        "ts": time.time(),
        "host": host_meta(),
        "config": {
            "nodes": args.nodes,
            "workers": args.workers,
            "tx_size": args.tx_size,
            "duration_s": args.duration,
            "batch_size": args.batch_size,
            "max_batch_delay_ms": args.max_batch_delay,
            "client_extra": args.client_extra or None,
        },
        "rows": rows,
        "peak": peak,
    }

    ok = True
    if args.gate:
        gate: dict = {"tolerance": args.tolerance}
        fresh = peak["e2e_tps"] if peak else 0
        baseline = best_committed_tps(os.path.join(REPO_ROOT, "results"))
        gate["fresh_peak_tps"] = fresh
        if args.min_tps is not None:
            gate["min_tps"] = args.min_tps
            ok = ok and fresh >= args.min_tps
        if baseline is not None:
            # A run cannot commit more than it offered: the floor is set
            # by the committed peak OR this sweep's highest offered rate,
            # whichever is lower — so a cheap CI point (one mid rate)
            # still gates against silent multiples without demanding the
            # committed box's full curve.
            reachable = min(baseline["e2e_tps"], max(rates))
            floor = reachable * (1 - args.tolerance)
            gate.update(
                baseline=baseline["e2e_tps"],
                baseline_source=baseline["source"],
                reachable=reachable,
                floor=round(floor),
            )
            ok = ok and fresh >= floor
        else:
            gate["status"] = "no-baseline"
        gate["ok"] = ok
        report["gate"] = gate

    print(
        json.dumps(
            {
                **report,
                "rows": [
                    {k: v for k, v in r.items() if k != "dtrace"}
                    for r in report["rows"]
                ],
                "peak": (
                    {k: v for k, v in peak.items() if k != "dtrace"}
                    if peak
                    else None
                ),
            },
            indent=2,
            sort_keys=True,
        )
    )
    if args.output:
        os.makedirs(args.output, exist_ok=True)
        path = os.path.join(
            args.output,
            f"dataplane-sweep-n{args.nodes}-w{args.workers}-"
            f"{args.tx_size}B.json",
        )
        with open(path, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"artifact written to {path}")
        if args.dtrace and peak and isinstance(peak.get("dtrace"), dict):
            # The lifeline attribution stands alone too: the per-batch
            # edge breakdown at the sweep's peak point, the artifact the
            # latency profile doc cites.
            dpath = os.path.join(
                args.output,
                f"dataplane-dtrace-n{args.nodes}-w{args.workers}-"
                f"{args.tx_size}B.json",
            )
            with open(dpath, "w") as f:
                json.dump(
                    {
                        "config": report["config"],
                        "host": report["host"],
                        "rate": peak["rate"],
                        "lifeline": peak["dtrace"],
                    },
                    f, indent=2, sort_keys=True,
                )
                f.write("\n")
            print(f"lifeline artifact written to {dpath}")
    if args.gate:
        print(f"dataplane gate: {'GREEN' if ok else 'RED'}")
        if not ok:
            sys.exit(1)


if __name__ == "__main__":
    main()
