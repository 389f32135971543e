"""SLO-gated soak harness: sustained load under faultline chaos, judged
by machine verdicts instead of eyeballed summaries.

Drives the multi-process local bench (real node processes + load
clients) for ``--duration`` seconds with a seeded faultline chaos
scenario armed and telemetry streaming per node, then judges THREE ways
and passes only if all agree:

1. the faultline **invariant checker** (safety: no conflicting commits;
   liveness: post-heal commit growth) — correctness under chaos;
2. the **SLO engine** over every node's snapshot stream in sliding
   windows (p99 commit latency, ms/round, mempool queue depth,
   timeout/view-change rate) — sustained service quality, with a bounded
   tolerated fraction of degraded windows while faults are open;
3. the **regex log parse** (tracebacks in any log fail the run).

The verdict (one JSON artifact) is the machine contract ROADMAP item 3
asks for: long runs gated on telemetry SLOs. Thresholds and the chaos
seed are CLI knobs so CI smokes (60 s) and overnight soaks share this
entry point.

    python -m hotstuff_tpu_torch.benchmark.soak --nodes 4 --rate 500 --duration 60 \
        --chaos-seed 7 --output results

Port copy of the reference's ``benchmark/soak.py``, over the port's
``LocalBench``, stream readers, ``DirectoryWatch``, SLO engine and
watchtower (``--watch-config preset:tuned-n4`` reads the port's copy of
the preset). Its flags, printed lines, schema and artifact names are the
reference's. What differs: the nodes verify under ``HOTSTUFF_CRYPTO_BACKEND``,
whose default here is ``cuda``, where the reference runs ``LocalBench``'s
default ``cpu`` (without a card the run raises before it starts a process
and prints no verdict);
``main`` takes ``argv``; there is no ``sys.path`` edit. On the H100 host
pass a ``--base-port`` below 16000.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from hotstuff_tpu_torch.benchmark.hostinfo import host_meta
from hotstuff_tpu_torch.benchmark.local import LocalBench
from hotstuff_tpu_torch.benchmark.logs import (
    ParseError,
    TelemetryParser,
    read_telemetry_stream,
)
from hotstuff_tpu_torch.benchmark.watchtower import DirectoryWatch
from hotstuff_tpu_torch.telemetry import slo as slo_mod
from hotstuff_tpu_torch.telemetry.watchtower import AlertCapture, WatchtowerConfig

SOAK_SCHEMA = "hotstuff-soak-verdict-v1"


def run_soak(args) -> dict:
    work_dir = os.path.abspath(args.work_dir)
    if args.pyprof:
        # Child node processes arm the all-thread sampling profiler and
        # their hotstuff-profile-v1 records ride the telemetry streams
        # (joined below into the verdict's attribution section).
        os.environ["HOTSTUFF_PYPROF"] = "1"
    chaos_path = None
    if getattr(args, "chaos_scenario", None):
        chaos_path = os.path.abspath(args.chaos_scenario)
    elif args.chaos_seed is not None:
        from hotstuff_tpu_torch.faultline import chaos_scenario

        scenario = chaos_scenario(
            args.chaos_seed, duration_s=float(args.duration)
        )
        # NOT inside work_dir: LocalBench.run() wipes that tree.
        chaos_path = work_dir.rstrip("/") + "-soak-scenario.json"
        scenario.save(chaos_path)

    bench = LocalBench(
        nodes=args.nodes,
        rate=args.rate,
        tx_size=args.tx_size,
        duration=args.duration,
        base_port=args.base_port,
        timeout_delay=args.timeout,
        work_dir=args.work_dir,
        telemetry=True,
        chaos=chaos_path,
        workers=args.workers,
        retention_rounds=args.retention_rounds,
        crypto_backend=os.environ.get("HOTSTUFF_CRYPTO_BACKEND", "cuda"),
    )
    logs_dir = os.path.join(work_dir, "logs")

    # Live watchtower: tail every node's stream WHILE the soak runs, so
    # an SLO breach mid-run carries a named suspect in the verdict and
    # the capture evidence is written at the moment of detection, not at
    # teardown. (bench.run() wipes work_dir first; the watch's rescan
    # picks the fresh streams up as the nodes create them.)
    watch = None
    if not args.no_watch:
        capture = AlertCapture(
            os.path.join(work_dir, "captures"),
            profile_s=0.0,  # nodes are other processes: evidence-only
        )
        watch_cfg = None
        if args.watch_config:
            if args.watch_config.startswith("preset:"):
                watch_cfg = WatchtowerConfig.preset(
                    args.watch_config.split(":", 1)[1]
                )
            else:
                # Accept both a bare config dict and a committed preset
                # document ({"schema": ..., "config": {...}, ...}).
                doc = json.load(open(args.watch_config))
                watch_cfg = WatchtowerConfig.from_dict(
                    doc.get("config", doc) if isinstance(doc, dict) else doc
                )
        watch = DirectoryWatch(
            logs_dir,
            config=watch_cfg,
            on_alert=capture,
            alerts_path=os.path.join(logs_dir, "watchtower-alerts.jsonl"),
        )
        capture.watchtower = watch.watch
        watch.start()

    parse_error = None
    summary = None
    try:
        parser = bench.run()
        summary = parser.result()
    except ParseError as e:
        parse_error = str(e)
    finally:
        if watch is not None:
            watch.stop()
    streams: dict[str, list[dict]] = {}
    skipped = 0
    for fn in sorted(glob.glob(os.path.join(logs_dir, "telemetry-*.jsonl"))):
        stream = read_telemetry_stream(fn)
        skipped += stream.skipped
        streams[os.path.basename(fn)] = list(stream)

    specs = (
        slo_mod.load_specs(args.slo_spec)
        if args.slo_spec
        else slo_mod.default_slos(
            p99_commit_latency_ms=args.p99_commit_ms,
            ms_per_round=args.ms_per_round,
            mempool_queue_depth=args.queue_depth,
            timeouts_per_round=args.timeouts_per_round,
            allow_violation_fraction=args.allow_violation_fraction,
        )
        + (
            # Conveyor gate set: bounded worker store depth (the
            # back-pressure contract) and zero commit-path resolution
            # timeouts (the availability contract). Streams without the
            # worker metrics skip these, so the flag is always safe.
            slo_mod.dataplane_slos(
                allow_violation_fraction=args.allow_violation_fraction
            )
            if args.workers
            else []
        )
        + slo_mod.memory_slos(
            # The unbounded-growth gate (ROADMAP item 4): RSS and store
            # disk must grow slower than the bound in every window. The
            # resource gauges come from each node's resource collector;
            # streams without them skip these specs. With retention
            # armed, the bounded-store contract additionally caps the
            # ABSOLUTE store size (compaction must plateau it).
            rss_growth_bytes_per_s=args.rss_growth_mb_s * 1024 * 1024,
            store_growth_bytes_per_s=args.store_growth_mb_s * 1024 * 1024,
            store_bytes_max=(
                args.store_max_mb * 1024 * 1024
                if args.store_max_mb is not None
                else None
            ),
            allow_violation_fraction=args.allow_violation_fraction,
        )
    )
    slo_verdict = slo_mod.evaluate_streams(
        streams, specs, window_s=args.window
    )

    chaos_ok = True
    if bench.chaos_verdict is not None:
        chaos_ok = (
            bench.chaos_verdict["safety"]["ok"]
            and bench.chaos_verdict["liveness"]["recovered"]
            # Conveyor availability invariant (present when workers > 0):
            # every committed digest resolvable at f+1 honest stores.
            and bench.chaos_verdict.get("availability", {}).get("ok", True)
        )

    # Resource + commit trajectory per node (first → last snapshot): the
    # human-readable face of what the memory-growth SLOs judged, plus
    # each node's commit height so a laggard that commits nothing in the
    # tail is visible in the verdict itself — the chaos3 finding took
    # diffing flight records to see; now it is one row here.
    resources: dict[str, dict] = {}
    commit_heights: dict[str, dict] = {}
    for name, snaps in streams.items():
        if not snaps:
            continue
        first, last_snap = snaps[0], snaps[-1]
        row = {}
        for gauge_name, label in (
            ("resource.rss_bytes", "rss_bytes"),
            ("resource.store_bytes", "store_bytes"),
            ("resource.open_fds", "open_fds"),
        ):
            a = first.get("gauges", {}).get(gauge_name)
            b = last_snap.get("gauges", {}).get(gauge_name)
            if b is not None:
                row[label] = {"first": a, "last": b}
        h_first = first.get("gauges", {}).get("consensus.last_committed_round")
        h_last = last_snap.get("gauges", {}).get(
            "consensus.last_committed_round"
        )
        if h_last is not None:
            heights = {"first": h_first, "last": h_last}
            row["commit_height"] = heights
            commit_heights[name] = dict(heights)
        if row:
            resources[name] = row
    frontier = max(
        (h["last"] for h in commit_heights.values()), default=None
    )
    commit_section = None
    if commit_heights:
        for h in commit_heights.values():
            h["lag"] = frontier - h["last"]
            h["advanced"] = (h["last"] - (h["first"] or 0)) > 0
        commit_section = {
            "frontier": frontier,
            "nodes": commit_heights,
            "laggards": sorted(
                name
                for name, h in commit_heights.items()
                if not h["advanced"] or h["lag"] >= 8
            ),
        }

    # Per-batch lifeline attribution from the nodes' dtrace records
    # (only present under --dtrace; absence is not an error). The soak
    # keeps just the aggregate face — edge stats, cost centers, and the
    # incomplete-lifeline census (a batch stuck mid-pipeline during
    # chaos is exactly what this section is for).
    dtrace_attr = None
    if args.dtrace:
        try:
            from hotstuff_tpu_torch.benchmark.dtrace_assemble import assemble

            report = assemble(
                sorted(glob.glob(os.path.join(logs_dir, "telemetry-*.jsonl")))
            )
            dtrace_attr = {
                "batches": report["batches"],
                "complete": report["complete"],
                "incomplete_by_stage_reached": report[
                    "incomplete_by_stage_reached"
                ],
                "total_ms": report["total_ms"],
                "edges": report["edges"],
                "top_cost_centers": report["top_cost_centers"],
                "slowest_batches": report["slowest_batches"][:3],
            }
        except Exception as e:  # noqa: BLE001 — attribution is advisory
            dtrace_attr = {"error": str(e)}

    # Function-level attribution from the nodes' profile records (only
    # present under --pyprof; absence is not an error).
    profile_attr = None
    if args.pyprof:
        try:
            from hotstuff_tpu_torch.benchmark.profile_assemble import attribute

            report = attribute(
                sorted(glob.glob(os.path.join(logs_dir, "telemetry-*.jsonl")))
            )
            profile_attr = {
                "samples": report["sampler"]["samples"],
                "gil_delay_ms": report["sampler"]["gil_delay_ms"],
                "ctypes": report["ctypes"],
                "edges": {
                    e: {
                        "samples": v["samples"],
                        "top_functions": v["top_functions"][:3],
                    }
                    for e, v in report["edges"].items()
                },
            }
        except Exception as e:  # noqa: BLE001 — attribution is advisory
            profile_attr = {"error": str(e)}

    telemetry_summary = None
    try:
        tele = TelemetryParser.process(logs_dir, tx_size=args.tx_size)
        tps, bps, duration = tele.consensus_throughput()
        telemetry_summary = {
            "consensus_tps": round(tps),
            "consensus_bps": round(bps),
            "consensus_latency_ms": round(tele.consensus_latency_ms()),
            "measured_window_s": round(duration, 1),
            "skipped_stream_lines": tele.skipped_lines,
        }
    except ParseError:
        pass

    # Watchtower verdict section: what the ONLINE plane concluded while
    # the run was still going — every alert (with its accused peers and
    # capture paths) plus the per-peer scoreboard, so an SLO breach has
    # a named suspect without any post-hoc assembly.
    alerts_section = None
    if watch is not None:
        alerts = watch.alerts()
        alerts_section = {
            "count": len(alerts),
            "alerts": alerts,
            "suspects": sorted(
                {p for a in alerts for p in a["accused"]}
            ),
            "scoreboard": watch.scoreboard(),
            "streams": watch.stats(),
        }

    ok = slo_verdict["ok"] and chaos_ok and parse_error is None
    return {
        "schema": SOAK_SCHEMA,
        "ok": ok,
        "host": host_meta(),
        "config": {
            "nodes": args.nodes,
            "rate": args.rate,
            "tx_size": args.tx_size,
            "duration_s": args.duration,
            "chaos_seed": args.chaos_seed,
            "chaos_scenario": getattr(args, "chaos_scenario", None),
            "workers": args.workers,
            "retention_rounds": args.retention_rounds,
            "store_max_mb": args.store_max_mb,
            "slo_window_s": args.window,
        },
        "slo": slo_verdict,
        "chaos": bench.chaos_verdict,
        "telemetry": telemetry_summary,
        "resources": resources,
        "commit": commit_section,
        "alerts": alerts_section,
        "profile": profile_attr,
        "dtrace": dtrace_attr,
        "parse_error": parse_error,
        "skipped_stream_lines": skipped,
        "summary": summary,
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--nodes", type=int, default=4)
    p.add_argument("--rate", type=int, default=500, help="total input tx/s")
    p.add_argument("--tx-size", type=int, default=512)
    p.add_argument("--duration", type=int, default=60, help="soak seconds")
    p.add_argument(
        "--hours", type=float, default=None,
        help="convenience: soak length in hours (overrides --duration); "
        "the ROADMAP 3c long-soak artifacts use --hours 1",
    )
    p.add_argument("--timeout", type=int, default=1_000, help="consensus ms")
    p.add_argument("--base-port", type=int, default=9400)
    p.add_argument("--work-dir", default=".soak")
    p.add_argument(
        "--chaos-seed", type=int, default=None,
        help="arm a seeded faultline chaos storm for the whole run",
    )
    p.add_argument(
        "--chaos-scenario", default=None,
        help="explicit faultline scenario JSON (overrides --chaos-seed); "
        "e.g. benchmark/scenarios/worker-crash.json",
    )
    p.add_argument(
        "--workers", type=int, default=0,
        help="Conveyor worker shards per node; adds the dataplane SLO "
        "set and the availability invariant to the verdict",
    )
    p.add_argument(
        "--window", type=float, default=15.0, help="SLO sliding window (s)"
    )
    p.add_argument("--slo-spec", help="JSON SLO spec file (overrides knobs)")
    p.add_argument("--p99-commit-ms", type=float, default=5_000.0)
    p.add_argument("--ms-per-round", type=float, default=2_000.0)
    p.add_argument("--queue-depth", type=float, default=50_000.0)
    p.add_argument("--timeouts-per-round", type=float, default=1.0)
    p.add_argument(
        "--rss-growth-mb-s", type=float, default=8.0,
        help="memory-growth SLO: max RSS growth (MiB/s) per window",
    )
    p.add_argument(
        "--store-growth-mb-s", type=float, default=32.0,
        help="memory-growth SLO: max on-disk store growth (MiB/s)",
    )
    p.add_argument(
        "--retention-rounds", type=int, default=0,
        help="Lazarus: arm snapshot/truncate log compaction in every "
        "node at this retention depth (rounds; 0 = unbounded store)",
    )
    p.add_argument(
        "--store-max-mb", type=float, default=None,
        help="absolute on-disk store cap per node (gauge_max SLO on "
        "resource.store_bytes); defaults to 512 MiB when "
        "--retention-rounds is armed, off otherwise",
    )
    p.add_argument(
        "--dtrace", action="store_true",
        help="join the per-batch lifeline attribution (edge stats, cost "
        "centers, stuck-batch census) into the verdict",
    )
    p.add_argument(
        "--pyprof", action="store_true",
        help="arm the sampling profiler in every node process and join "
        "the function-level attribution into the verdict",
    )
    p.add_argument(
        "--no-watch", action="store_true",
        help="disable the live watchtower (alerts section absent)",
    )
    p.add_argument(
        "--watch-config",
        help="WatchtowerConfig for the live tower: a JSON file (bare "
        "config or committed preset document) or preset:<name> "
        "(e.g. preset:tuned-n4, Oracle's sweep-tuned preset)",
    )
    p.add_argument(
        "--allow-violation-fraction", type=float, default=0.34,
        help="tolerated fraction of degraded windows per SLO (chaos "
        "scenarios legitimately stall while a partition is open)",
    )
    p.add_argument("--output", help="directory for the verdict artifact")
    args = p.parse_args(argv)
    if args.hours is not None:
        args.duration = int(args.hours * 3600)
    if args.store_max_mb is None and args.retention_rounds > 0:
        # Bounded-store contract: a retention-armed soak gates on an
        # absolute store cap by default (compaction must plateau it).
        args.store_max_mb = 512.0

    verdict = run_soak(args)
    print(json.dumps({k: v for k, v in verdict.items() if k != "summary"},
                     indent=2, sort_keys=True))
    if verdict["summary"]:
        print(verdict["summary"])
    if args.output:
        os.makedirs(args.output, exist_ok=True)
        if getattr(args, "chaos_scenario", None):
            tag = os.path.splitext(os.path.basename(args.chaos_scenario))[0]
        elif args.chaos_seed is not None:
            tag = f"chaos{args.chaos_seed}"
        else:
            tag = "clean"
        if args.workers:
            tag = f"w{args.workers}-{tag}"
        if args.retention_rounds:
            tag = f"r{args.retention_rounds}-{tag}"
        path = os.path.join(
            args.output,
            f"soak-slo-n{args.nodes}-{args.duration}s-{tag}.json",
        )
        with open(path, "w") as f:
            json.dump(verdict, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"verdict written to {path}")
    print(f"soak verdict: {'PASS' if verdict['ok'] else 'FAIL'}")
    if not verdict["ok"]:
        sys.exit(1)


if __name__ == "__main__":
    main()
