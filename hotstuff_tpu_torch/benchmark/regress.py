"""Perf-regression gate: fresh telemetry-derived measurements vs the
committed baseline corpus, with noise-aware thresholds.

Two checks, each min-over-repeats (the CI-stable estimator — scheduler
noise inflates individual runs, a real regression shifts the minimum):

- **protocol**: one-process committee round rate at ``--nodes`` under
  the CURRENT backend/transport selection, compared against the best
  committed ``results/committee-protocol-*.txt`` row with the same
  (committee, backend, transport) key. The run streams telemetry and the
  artifact records the registry-derived context (rounds advanced, QCs
  formed, votes batched) alongside the wall number, so a regression
  comes with its first diagnostic attached.
- **crypto**: CPU batch-verify µs/sig at ``--sigs`` (the committed
  bench shape: RLC + MSM through the native engine), compared against the
  best committed ``cpu_batch_us``.

A check fails when ``fresh_min > baseline_min * (1 + tolerance)``.
``--tolerance`` defaults to 0.5: the committed corpus was measured on an
idle box, CI shares cores — the gate catches the silent 2× rots, not 5%
drift. Exit 0 green / 1 regression / 2 usage error.

    python -m benchmark.regress --output results
    HOTSTUFF_CRYPTO_BACKEND=cuda-batched python -m hotstuff_tpu_torch.benchmark.regress \
        --base-port 14200 --output results
    HOTSTUFF_NET=native HOTSTUFF_CRYPTO_BACKEND=cpu-batched \
        python -m hotstuff_tpu_torch.benchmark.regress --nodes 100 --tolerance 0.35

Port copy of the reference's ``benchmark/regress.py``: the same flags,
checks, schema (``hotstuff-regress-v1``), artifact (``regress-gate.json``),
printed lines and exit codes, over the port's ``committee_scale``,
``dataplane_sweep`` and telemetry. What differs:

- the protocol check runs under ``HOTSTUFF_CRYPTO_BACKEND``, whose default
  here is ``cuda``: without a card it raises before a committee starts and
  prints no report. Its baselines are the committed
  ``results/committee-protocol-*.txt`` rows as in the reference, and the
  port's own rows taken on the H100 (``committee-protocol-cuda-batched-40.txt``,
  backend ``cuda+superbatch``) sit beside them, since the reference host's
  rows match no ``cuda`` backend;
- the crypto check times the CPU batch verify through the port's bench
  (``bench_torch.make_batch`` and ``bench_cpu_batch``; run from the
  repository's root, as the reference runs from its) and reads its baseline only from the port's committed
  bench lines, ``results/bench-torch-*.json`` (each ``bench_torch.py``'s
  JSON line as the card's host printed it), not from the reference host's
  ``BENCH_r0*.json``;
- ``REPO_ROOT`` is three directories above this file; ``main`` takes
  ``argv``; there is no ``sys.path`` edit.

On the H100 host pass a ``--base-port`` below 16000 (each repeat takes
``2 * --nodes`` ports); ``--dataplane`` binds from base + 5,000 and
``--dataplane-parity`` from base + 7,000 and + 8,000, so with them pass a
base below 8,000.
"""

from __future__ import annotations

import argparse
import asyncio
import glob
import json
import os
import re
import sys
import time

from hotstuff_tpu_torch.benchmark.hostinfo import host_meta

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

REGRESS_SCHEMA = "hotstuff-regress-v1"

_PROTOCOL_LINE = re.compile(
    r"committee=(\d+) .*mode=protocol.*backend=(\S+?)"
    r"(?: transport=(\w+))?: ([\d.]+) ms/round"
)


def load_protocol_baselines(results_dir: str) -> list[dict]:
    """Every committed protocol row: {nodes, backend, transport, ms}."""
    rows: list[dict] = []
    for fn in sorted(
        glob.glob(os.path.join(results_dir, "committee-protocol-*.txt"))
    ):
        with open(fn) as f:
            for line in f:
                m = _PROTOCOL_LINE.search(line)
                if m:
                    rows.append(
                        {
                            "nodes": int(m.group(1)),
                            "backend": m.group(2),
                            "transport": m.group(3),  # None on old rows
                            "ms_per_round": float(m.group(4)),
                            "source": os.path.basename(fn),
                        }
                    )
    return rows


def best_protocol_baseline(
    rows: list[dict], nodes: int, backend: str, transport: str
) -> dict | None:
    """Best committed row for this config. Rows predating the transport
    tag match any transport (they were measured before the tag existed —
    better a loose baseline than none)."""
    matches = [
        r
        for r in rows
        if r["nodes"] == nodes
        and r["backend"] == backend
        and r["transport"] in (transport, None)
    ]
    exact = [r for r in matches if r["transport"] == transport]
    pool = exact or matches
    return min(pool, key=lambda r: r["ms_per_round"]) if pool else None


def load_crypto_baseline(repo_root: str) -> dict | None:
    """Best committed CPU batch µs/sig across the port's bench lines,
    ``results/bench-torch-*.json``."""
    best = None
    for fn in sorted(
        glob.glob(os.path.join(repo_root, "results", "bench-torch-*.json"))
    ):
        try:
            with open(fn) as f:
                parsed = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        us = parsed.get("cpu_batch_us") if isinstance(parsed, dict) else None
        if us is None:
            continue
        if best is None or us < best["cpu_batch_us"]:
            best = {"cpu_batch_us": us, "source": os.path.basename(fn)}
    return best


def measure_protocol(
    nodes: int, rounds: int, repeats: int, base_port: int, pyprof: bool = False
):
    """(min ms/round, telemetry context) for the current stack. With
    ``pyprof`` the sampling profiler runs across the repeats and the
    context gains the top self-time functions — a regression artifact
    then carries its own first function-level diagnosis."""
    from hotstuff_tpu_torch import telemetry
    from hotstuff_tpu_torch.benchmark.committee_scale import run_committee
    from hotstuff_tpu_torch.telemetry import profiler as pyprof_mod

    telemetry.enable()
    registry = telemetry.get_registry()
    profiler = None
    if pyprof:
        profiler = pyprof_mod.SamplingProfiler()
        profiler.start(mode="auto")
    best = float("inf")
    port = base_port
    before = registry.snapshot()["counters"]
    try:
        for _ in range(repeats):
            per_round, _ = asyncio.run(
                run_committee(nodes, rounds, port, timeout_delay=30_000)
            )
            best = min(best, per_round)
            port += 2 * nodes
    finally:
        if profiler is not None:
            profiler.stop()
    deltas = telemetry.diff_counters(before, registry.snapshot()["counters"])
    context = {
        k: v
        for k, v in deltas.items()
        if k in (
            "consensus.rounds_advanced",
            "consensus.qcs_formed",
            "consensus.votes_received",
            "consensus.blocks_committed",
            "consensus.span.evicted_rounds",
        )
    }
    if profiler is not None:
        self_c, _cum, _ = profiler.self_cum()
        total = sum(self_c.values()) or 1
        context["profile_top"] = [
            {"fn": fn, "self_share": round(n / total, 4)}
            for fn, n in self_c.most_common(10)
        ]
        context["profile_samples"] = profiler.samples
    return best * 1e3, context


def measure_crypto(sigs: int, repeats: int) -> float:
    """Min µs/sig of the CPU batch verify at the committed bench shape."""
    import bench_torch as headline_bench

    msgs, pubs, sigs_ = headline_bench.make_batch(sigs)
    best = float("inf")
    for _ in range(repeats):
        best = min(best, headline_bench.bench_cpu_batch(msgs, pubs, sigs_))
    return best / sigs * 1e6


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--nodes", type=int, default=40)
    p.add_argument("--rounds", type=int, default=12)
    p.add_argument("--repeats", type=int, default=2)
    p.add_argument("--sigs", type=int, default=1343)
    p.add_argument(
        "--tolerance",
        type=float,
        default=float(os.environ.get("HOTSTUFF_REGRESS_TOLERANCE", "0.5")),
        help="allowed relative slowdown vs baseline (0.5 = +50%%)",
    )
    p.add_argument("--base-port", type=int, default=25000)
    p.add_argument("--skip-protocol", action="store_true")
    p.add_argument("--skip-crypto", action="store_true")
    p.add_argument(
        "--dataplane", type=int, default=0, metavar="RATE",
        help="also gate the Conveyor sharded-ingest e2e TPS at this "
        "offered rate (tx/s) against the committed dataplane sweep "
        "artifact (offered-rate-aware floor)",
    )
    p.add_argument("--dataplane-workers", type=int, default=1)
    p.add_argument("--dataplane-duration", type=int, default=15)
    p.add_argument(
        "--dataplane-parity", type=int, default=0, metavar="RATE",
        help="paired small-frame legs at this offered rate: one asyncio, "
        "one native (subprocesses inherit HOTSTUFF_NET per leg); fails "
        "when native e2e TPS drops below asyncio's minus the tolerance",
    )
    p.add_argument(
        "--parity-size", type=int, default=1024,
        help="tx size (B) for the --dataplane-parity legs",
    )
    p.add_argument(
        "--pyprof", action="store_true",
        help="sample the protocol measurement and attach the top "
        "self-time functions to the artifact (a red gate then names "
        "its own suspects)",
    )
    p.add_argument("--output", help="directory for the JSON artifact")
    args = p.parse_args(argv)

    if (
        args.skip_protocol
        and args.skip_crypto
        and not args.dataplane
        and not args.dataplane_parity
    ):
        print("nothing to check", file=sys.stderr)
        sys.exit(2)

    checks: list[dict] = []

    if not args.skip_protocol:
        os.environ.setdefault("HOTSTUFF_CRYPTO_WORKERS", "32")
        from hotstuff_tpu_torch import network as _network
        from hotstuff_tpu_torch.crypto import get_backend

        backend = get_backend().name  # under cuda, raises without a card
        transport = (
            "native" if "Native" in _network.Receiver.__name__ else "asyncio"
        )
        rows = load_protocol_baselines(os.path.join(REPO_ROOT, "results"))
        baseline = best_protocol_baseline(rows, args.nodes, backend, transport)
        fresh_ms, context = measure_protocol(
            args.nodes, args.rounds, args.repeats, args.base_port,
            pyprof=args.pyprof,
        )
        check = {
            "metric": f"protocol_ms_per_round_n{args.nodes}",
            "backend": backend,
            "transport": transport,
            "fresh": round(fresh_ms, 1),
            "telemetry": context,
        }
        if baseline is None:
            check.update(status="no-baseline", ok=True)
        else:
            limit = baseline["ms_per_round"] * (1 + args.tolerance)
            check.update(
                status="compared",
                baseline=baseline["ms_per_round"],
                baseline_source=baseline["source"],
                limit=round(limit, 1),
                ratio=round(fresh_ms / baseline["ms_per_round"], 3),
                ok=fresh_ms <= limit,
            )
        checks.append(check)

    if not args.skip_crypto:
        baseline = load_crypto_baseline(REPO_ROOT)
        fresh_us = measure_crypto(args.sigs, max(2, args.repeats))
        check = {
            "metric": f"crypto_cpu_batch_us_per_sig_{args.sigs}sigs",
            "fresh": round(fresh_us, 2),
        }
        if baseline is None:
            check.update(status="no-baseline", ok=True)
        else:
            limit = baseline["cpu_batch_us"] * (1 + args.tolerance)
            check.update(
                status="compared",
                baseline=baseline["cpu_batch_us"],
                baseline_source=baseline["source"],
                limit=round(limit, 2),
                ratio=round(fresh_us / baseline["cpu_batch_us"], 3),
                ok=fresh_us <= limit,
            )
        checks.append(check)

    if args.dataplane:
        from hotstuff_tpu_torch.benchmark.dataplane_sweep import best_committed_tps, run_point

        row = run_point(
            args.dataplane,
            nodes=4,
            workers=args.dataplane_workers,
            tx_size=512,
            duration=args.dataplane_duration,
            base_port=args.base_port + 5_000,
            work_dir=".regress-dataplane",
            batch_size=250_000,
            max_batch_delay=50,
            timeout=5_000,
        )
        check = {
            "metric": f"dataplane_e2e_tps_{args.dataplane}offered",
            "fresh": row["e2e_tps"],
            "e2e_latency_ms": row["e2e_latency_ms"],
            "shed": row["shed"],
        }
        baseline = best_committed_tps(os.path.join(REPO_ROOT, "results"))
        if baseline is None:
            check.update(status="no-baseline", ok=True)
        else:
            # A run cannot commit more than it offered: floor against
            # min(committed peak, offered rate).
            reachable = min(baseline["e2e_tps"], args.dataplane)
            floor = reachable * (1 - args.tolerance)
            check.update(
                status="compared",
                baseline=baseline["e2e_tps"],
                baseline_source=baseline["source"],
                floor=round(floor),
                ratio=round(row["e2e_tps"] / reachable, 3),
                ok=row["e2e_tps"] >= floor,
            )
        checks.append(check)

    if args.dataplane_parity:
        from hotstuff_tpu_torch.benchmark.dataplane_sweep import run_point

        # Same offered load through both transports, back to back on the
        # same host. The bench subprocesses read HOTSTUFF_NET from the
        # inherited environment, so each leg swaps the whole plane —
        # receiver, senders, and worker ingress — not just the parent.
        legs: dict[str, dict] = {}
        for i, plane in enumerate(("asyncio", "native")):
            saved = os.environ.get("HOTSTUFF_NET")
            os.environ["HOTSTUFF_NET"] = plane
            try:
                legs[plane] = run_point(
                    args.dataplane_parity,
                    nodes=4,
                    workers=args.dataplane_workers,
                    tx_size=args.parity_size,
                    duration=args.dataplane_duration,
                    base_port=args.base_port + 7_000 + i * 1_000,
                    work_dir=f".regress-parity-{plane}",
                    batch_size=250_000,
                    max_batch_delay=50,
                    timeout=5_000,
                )
            finally:
                if saved is None:
                    os.environ.pop("HOTSTUFF_NET", None)
                else:
                    os.environ["HOTSTUFF_NET"] = saved
        floor = legs["asyncio"]["e2e_tps"] * (1 - args.tolerance)
        checks.append(
            {
                "metric": (
                    f"dataplane_parity_tps_{args.parity_size}B"
                    f"_{args.dataplane_parity}offered"
                ),
                "status": "compared",
                "fresh": legs["native"]["e2e_tps"],
                "baseline": legs["asyncio"]["e2e_tps"],
                "baseline_source": "paired asyncio leg (same run)",
                "floor": round(floor),
                "ratio": round(
                    legs["native"]["e2e_tps"]
                    / max(legs["asyncio"]["e2e_tps"], 1),
                    3,
                ),
                "native_latency_ms": legs["native"]["e2e_latency_ms"],
                "asyncio_latency_ms": legs["asyncio"]["e2e_latency_ms"],
                "ok": legs["native"]["e2e_tps"] >= floor,
            }
        )

    ok = all(c["ok"] for c in checks)
    report = {
        "schema": REGRESS_SCHEMA,
        "ok": ok,
        "host": host_meta(),
        "tolerance": args.tolerance,
        "ts": time.time(),
        "checks": checks,
    }
    print(json.dumps(report, indent=2, sort_keys=True))
    if args.output:
        os.makedirs(args.output, exist_ok=True)
        path = os.path.join(args.output, "regress-gate.json")
        with open(path, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"artifact written to {path}")
    print(f"regression gate: {'GREEN' if ok else 'RED'}")
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
