"""Port copy of the reference's ``benchmark/profile_assemble.py``, whole
(``attribute``, ``_human``, the aggregation, the speedscope export), over
the port's ``hostinfo``, ``logs`` and ``trace_assemble``. Nothing is left
out.

Function-level attribution: join sampling-profiler records onto the
cross-node trace edges.

``benchmark/trace_assemble.py`` answers "which EDGE of the round eats
the milliseconds" (ingress, vote_wire, qc_to_commit, ...);
``telemetry/profiler.py`` records folded stacks tagged with the stage
active when each sample was taken — and the stages are NAMED AFTER the
trace edges, so the join is a group-by: for every edge, the top-k
functions by self (leaf) samples inside it, with sample counts converted
to estimated milliseconds via the sampling interval. The report answers
"which decode path, which ctypes call" for each edge.

Also emits speedscope-format flamegraphs (one sampled profile per
stage, https://www.speedscope.app) so the full stacks stay explorable,
and surfaces the sampler's boundary accounts: per-``hs_net_*``/
``hs_ed25519_*`` ctypes call counts + wall time, and the GIL-delay
proxy.

    python -m hotstuff_tpu_torch.benchmark.profile_assemble .bench/logs --committee 200 \
        --output results/profile-attribution-200.json \
        --speedscope results/profile-200.speedscope.json
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from collections import Counter, defaultdict

from hotstuff_tpu_torch.benchmark.hostinfo import host_meta
from hotstuff_tpu_torch.benchmark.logs import ParseError, read_stream_records
from hotstuff_tpu_torch.benchmark.trace_assemble import EDGES, assemble

ATTRIBUTION_SCHEMA = "hotstuff-profile-attribution-v1"


def load_profiles(
    paths: list[str], skipped_streams: list[str] | None = None
) -> list[dict]:
    """All ``hotstuff-profile-v1`` records across streams; unusable
    streams are skipped with a warning (same contract as the trace
    assembler — partial attribution beats none)."""
    records: list[dict] = []
    for path in paths:
        try:
            records.extend(read_stream_records(path).profiles)
        except (ParseError, OSError) as e:
            print(f"WARN: skipping stream {path}: {e}", file=sys.stderr)
            if skipped_streams is not None:
                skipped_streams.append(os.path.basename(path))
    return records


def aggregate(records: list[dict]) -> tuple[dict[str, Counter], dict]:
    """(per-stage folded-stack counters, sampler meta). Stage counters
    sum across records/nodes; meta keeps the session totals the report
    surfaces (samples, interval, GIL delay, ctypes accounts — cumulative
    per record, so the LAST record per (node, pid) wins)."""
    stages: dict[str, Counter] = defaultdict(Counter)
    last: dict[tuple, dict] = {}
    interval_ms = None
    for rec in records:
        interval_ms = rec.get("interval_ms", interval_ms)
        for stage_name, folded, count in rec.get("stacks", []):
            stages[stage_name][folded] += count
        key = (rec.get("node", ""), rec.get("pid", 0))
        if key not in last or rec.get("seq", 0) >= last[key].get("seq", 0):
            last[key] = rec
    samples = sum(r.get("samples", 0) for r in last.values())
    gil_delay_ns = sum(r.get("gil_delay_ns", 0) for r in last.values())
    truncated = sum(r.get("truncated", 0) for r in last.values())
    ctypes_totals: dict[str, list[int]] = defaultdict(lambda: [0, 0])
    for rec in last.values():
        for name, (calls, ns) in (rec.get("ctypes") or {}).items():
            ctypes_totals[name][0] += calls
            ctypes_totals[name][1] += ns
    meta = {
        "interval_ms": interval_ms,
        "samples": samples,
        "truncated": truncated,
        "gil_delay_ms": round(gil_delay_ns / 1e6, 3),
        "sessions": len(last),
        "ctypes": {
            name: {
                "calls": calls,
                "ms": round(ns / 1e6, 3),
                "us_per_call": round(ns / 1e3 / calls, 3) if calls else None,
            }
            for name, (calls, ns) in sorted(
                ctypes_totals.items(), key=lambda kv: -kv[1][1]
            )
        },
    }
    return dict(stages), meta


def top_functions(
    stacks: Counter, interval_ms: float | None, k: int
) -> list[dict]:
    """Top-k by self (leaf) samples inside one stage, with cumulative
    (anywhere-on-stack) counts alongside."""
    self_c: Counter[str] = Counter()
    cum_c: Counter[str] = Counter()
    total = 0
    for folded, count in stacks.items():
        frames = folded.split(";")
        self_c[frames[-1]] += count
        total += count
        for name in set(frames):
            cum_c[name] += count
    out = []
    for fn, n in self_c.most_common(k):
        entry = {
            "fn": fn,
            "self_samples": n,
            "self_share": round(n / total, 4) if total else 0.0,
            "cum_samples": cum_c[fn],
        }
        if interval_ms:
            entry["self_ms_est"] = round(n * interval_ms, 1)
        out.append(entry)
    return out


def attribute(
    paths: list[str], *, top_k: int = 10, align: bool = True
) -> dict:
    """The joined report: trace edge attribution (ms) + per-edge top
    functions (samples/estimated ms) + sampler/boundary accounts."""
    skipped: list[str] = []
    trace_report = assemble(paths, align=align)
    stages, meta = aggregate(load_profiles(paths, skipped_streams=skipped))
    interval_ms = meta["interval_ms"]
    total_samples = sum(sum(c.values()) for c in stages.values())

    edges: dict[str, dict] = {}
    for edge in EDGES:
        stacks = stages.get(edge, Counter())
        n = sum(stacks.values())
        trace_edge = trace_report["edges"].get(edge)
        edges[edge] = {
            "trace_mean_ms": trace_edge["mean_ms"] if trace_edge else None,
            "trace_p90_ms": trace_edge["p90_ms"] if trace_edge else None,
            "samples": n,
            "sample_share": (
                round(n / total_samples, 4) if total_samples else 0.0
            ),
            "thread_ms_est": round(n * interval_ms, 1) if interval_ms else None,
            "top_functions": top_functions(stacks, interval_ms, top_k),
        }
    other = {}
    for stage_name in sorted(set(stages) - set(EDGES)):
        stacks = stages[stage_name]
        n = sum(stacks.values())
        other[stage_name or "(untagged)"] = {
            "samples": n,
            "sample_share": (
                round(n / total_samples, 4) if total_samples else 0.0
            ),
            "top_functions": top_functions(stacks, interval_ms, top_k),
        }
    return {
        "schema": ATTRIBUTION_SCHEMA,
        "host": host_meta(),
        "streams": trace_report["streams"],
        "skipped_streams": sorted(
            set(skipped) | set(trace_report["skipped_streams"])
        ),
        "rounds": trace_report["rounds"],
        "round_total_ms": trace_report["total_ms"],
        "top_cost_centers": trace_report["top_cost_centers"],
        "sampler": {k: v for k, v in meta.items() if k != "ctypes"},
        "ctypes": meta["ctypes"],
        "edges": edges,
        "other_stages": other,
    }


# -- speedscope export -------------------------------------------------------


def to_speedscope(
    stages: dict[str, Counter], interval_ms: float | None, name: str
) -> dict:
    """Speedscope file: one *sampled* profile per stage over a shared
    frame table (https://www.speedscope.app/file-format-schema.json).
    Weights are milliseconds (samples x interval)."""
    frame_index: dict[str, int] = {}
    frames: list[dict] = []

    def idx(fn: str) -> int:
        i = frame_index.get(fn)
        if i is None:
            i = frame_index[fn] = len(frames)
            frames.append({"name": fn})
        return i

    weight = interval_ms or 1.0
    profiles = []
    for stage_name in sorted(stages, key=lambda s: -sum(stages[s].values())):
        stacks = stages[stage_name]
        samples = []
        weights = []
        total = 0.0
        for folded, count in sorted(stacks.items()):
            samples.append([idx(fn) for fn in folded.split(";")])
            w = count * weight
            weights.append(w)
            total += w
        profiles.append(
            {
                "type": "sampled",
                "name": stage_name or "(untagged)",
                "unit": "milliseconds",
                "startValue": 0,
                "endValue": round(total, 3),
                "samples": samples,
                "weights": weights,
            }
        )
    return {
        "$schema": "https://www.speedscope.app/file-format-schema.json",
        "name": name,
        "exporter": "hotstuff_tpu profile_assemble",
        "shared": {"frames": frames},
        "profiles": profiles,
    }


def _human(report: dict, top: int = 3) -> str:
    lines = [
        f"{report['rounds']} rounds, {report['sampler']['samples']} samples "
        f"@ {report['sampler']['interval_ms']} ms, "
        f"GIL delay {report['sampler']['gil_delay_ms']} ms"
        + (
            f", {len(report['skipped_streams'])} stream(s) skipped"
            if report["skipped_streams"]
            else ""
        ),
        f"{'edge':<14} {'trace ms':>9} {'thr ms':>9}  top functions by self time",
    ]
    for edge, e in sorted(
        report["edges"].items(), key=lambda kv: -(kv[1]["samples"])
    ):
        tops = ", ".join(
            f"{f['fn'].rsplit(':', 1)[-1]} {f['self_share']:.0%}"
            for f in e["top_functions"][:top]
        )
        lines.append(
            f"{edge:<14} {e['trace_mean_ms'] if e['trace_mean_ms'] is not None else '-':>9} "
            f"{e['thread_ms_est'] if e['thread_ms_est'] is not None else '-':>9}  {tops}"
        )
    if report["ctypes"]:
        worst = next(iter(report["ctypes"].items()))
        lines.append(
            f"ctypes boundary: {len(report['ctypes'])} entry points; "
            f"heaviest {worst[0]} ({worst[1]['calls']} calls, "
            f"{worst[1]['ms']} ms)"
        )
    return "\n".join(lines)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument(
        "paths", nargs="+",
        help="telemetry stream files, or directories containing "
        "telemetry-*.jsonl",
    )
    p.add_argument("--committee", type=int, help="committee size (recorded)")
    p.add_argument("--top", type=int, default=10, help="functions per edge")
    p.add_argument("--no-align", action="store_true")
    p.add_argument("--output", help="write the JSON attribution report here")
    p.add_argument(
        "--speedscope", metavar="PATH",
        help="also write a speedscope flamegraph file (one profile per stage)",
    )
    args = p.parse_args()

    paths: list[str] = []
    for path in args.paths:
        if os.path.isdir(path):
            paths.extend(
                sorted(glob.glob(os.path.join(path, "telemetry-*.jsonl")))
            )
        else:
            paths.append(path)
    if not paths:
        print("no telemetry streams found", file=sys.stderr)
        sys.exit(2)

    report = attribute(paths, top_k=args.top, align=not args.no_align)
    if args.committee is not None:
        report["committee"] = args.committee
    print(_human(report))
    if args.output:
        os.makedirs(
            os.path.dirname(os.path.abspath(args.output)), exist_ok=True
        )
        with open(args.output, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"attribution report written to {args.output}")
    if args.speedscope:
        stages, meta = aggregate(load_profiles(paths))
        scope = to_speedscope(
            stages, meta["interval_ms"],
            os.path.basename(args.speedscope),
        )
        os.makedirs(
            os.path.dirname(os.path.abspath(args.speedscope)), exist_ok=True
        )
        with open(args.speedscope, "w") as f:
            json.dump(scope, f)
            f.write("\n")
        print(f"speedscope profile written to {args.speedscope}")
    if not report["sampler"]["samples"]:
        print("no profile records were found in the streams", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
