"""Lifeline assembly: merge every node's ``hotstuff-dtrace-v1`` batch
lifecycle events (plus the round traces they join onto) into one causal
timeline per committed batch, and attribute milliseconds to each edge of
the data-plane path the consensus-round trace cannot see.

Input: telemetry streams (``telemetry-*.jsonl``) carrying interleaved
``hotstuff-dtrace-v1`` and ``hotstuff-trace-v1`` records. The lifecycle
stages a batch leaves behind (see ``hotstuff_tpu_torch/telemetry/dtrace.py``):
``ingress`` → ``seal`` → ``disseminate`` → ``ack``* → ``cert`` →
``enqueue`` → ``proposed`` → ``committed`` → ``resolved``.

Per committed batch the assembler computes the seven-edge attribution:

- ``ingress_wait``: earliest contributing bundle arrival → seal
- ``seal``:        seal → dissemination handoff (encode+hash+store+sign)
- ``disseminate``: handoff → FIRST peer ack verified (wire + peer store)
- ``ack_fanin``:   first ack → 2f+1 stake (the straggler wait)
- ``queue_wait``:  proposer enqueue → drained into a block
- ``ordering``:    proposed → first commit anywhere (joined to the
  round trace: the ``r<round>`` detail keys the round's own
  propose→vote→QC→commit breakdown onto the batch)
- ``resolve``:     first commit → commit-path bytes materialized

A batch that died mid-pipeline (sealed but never certified, committed
but never resolved) is reported with its reached stage and the OPEN
edge named — partial lifelines are the diagnostic, not an error.

Clock model: each record's wall anchor maps its monotonic timestamps
onto the shared timeline; ``--align`` additionally applies the round
trace's causality-estimated per-node offsets (a replica cannot receive
a proposal before its leader sent it) to the dtrace events of the same
nodes — multi-process engine-group streams merge the same way.

    python -m hotstuff_tpu_torch.benchmark.dtrace_assemble .dataplane-bench/logs \
        --clients .dataplane-bench/logs --output results/dtrace.json

Port copy of the reference's ``benchmark/dtrace_assemble.py``, whole, over
the port's ``logs.read_stream_records`` and ``trace_assemble``. Only the
imports differ (no ``sys.path`` edit). It reads streams and touches no
device.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from collections import defaultdict
from statistics import median

from hotstuff_tpu_torch.benchmark.hostinfo import host_meta
from hotstuff_tpu_torch.benchmark.logs import ParseError, _to_posix, read_stream_records
from hotstuff_tpu_torch.benchmark.trace_assemble import (
    _pct,
    assemble_rounds,
    estimate_offsets,
    load_events,
)

REPORT_SCHEMA = "hotstuff-dtrace-lifeline-v1"

#: the seven per-batch lifecycle edges, in causal order.
EDGES = (
    "ingress_wait", "seal", "disseminate", "ack_fanin", "queue_wait",
    "ordering", "resolve",
)

#: (edge, its opening stage, its closing stage) — an edge is OPEN when
#: the opening stage was observed but the closing one never arrived.
_EDGE_STAGES = (
    ("ingress_wait", "ingress", "seal"),
    ("seal", "seal", "disseminate"),
    ("disseminate", "disseminate", "first_ack"),
    ("ack_fanin", "first_ack", "cert"),
    ("queue_wait", "enqueue", "proposed"),
    ("ordering", "proposed", "committed"),
    ("resolve", "committed", "resolved"),
)


def load_dtrace_events(
    paths: list[str], skipped_streams: list[str] | None = None
) -> list[dict]:
    """All batch-lifecycle events across streams with wall-mapped times
    (same skip semantics as ``trace_assemble.load_events``: a stream
    that cannot contribute is warned about and recorded, not fatal)."""
    events: list[dict] = []
    for path in paths:
        try:
            records = read_stream_records(path)
        except (ParseError, OSError) as e:
            print(f"WARN: skipping stream {path}: {e}", file=sys.stderr)
            if skipped_streams is not None:
                skipped_streams.append(os.path.basename(path))
            continue
        bad_anchor = False
        for rec in records.dtraces:
            anchor = rec.get("anchor") or {}
            if not all(
                isinstance(anchor.get(k), (int, float)) for k in ("mono", "wall")
            ):
                bad_anchor = True
                continue
            off = anchor["wall"] - anchor["mono"]
            for ev in rec["events"]:
                seq, node, batch, stage, t = ev[:5]
                events.append(
                    {
                        "seq": seq,
                        "node": node,
                        "batch": batch,
                        "stage": stage,
                        "t": t + off,
                        "detail": ev[5] if len(ev) > 5 else None,
                        "stream": path,
                    }
                )
        if bad_anchor:
            print(
                f"WARN: {path}: dtrace record(s) without a wall-clock "
                "anchor skipped (cannot place on the shared timeline)",
                file=sys.stderr,
            )
            if skipped_streams is not None:
                skipped_streams.append(os.path.basename(path))
    events.sort(key=lambda e: (e["stream"], e["node"], e["seq"]))
    return events


def load_client_sends(paths: list[str]) -> dict[int, float]:
    """sample id -> earliest wall send time, from the clients' "Sending
    sample transaction N" measurement lines (the regex contract)."""
    from re import findall

    sends: dict[int, float] = {}
    for path in paths:
        try:
            with open(path) as f:
                log_text = f.read()
        except OSError:
            continue
        for ts, s in findall(
            r"\[(.*Z) .* sample transaction (\d+)", log_text
        ):
            t = _to_posix(ts)
            sid = int(s)
            if sid not in sends or t < sends[sid]:
                sends[sid] = t
    return sends


def _parse_round(detail) -> int | None:
    if isinstance(detail, str) and detail.startswith("r"):
        try:
            return int(detail[1:])
        except ValueError:
            return None
    return None


def _seal_samples(detail) -> list[int]:
    """Sample ids from a seal detail ``w0|8tx|4096B|s42,43``."""
    if not isinstance(detail, str):
        return []
    for part in detail.split("|"):
        if part.startswith("s") and part[1:].replace(",", "").isdigit():
            return [int(x) for x in part[1:].split(",") if x]
    return []


def assemble_batches(
    events: list[dict],
    offsets: dict[str, float] | None = None,
    round_edges: dict[int, dict] | None = None,
    client_sends: dict[int, float] | None = None,
) -> list[dict]:
    """Per batch: merged timeline, seven-edge attribution, round join."""
    offsets = offsets or {}
    round_edges = round_edges or {}

    def t_of(e):
        return e["t"] + offsets.get(e["node"], 0.0)

    by_batch: dict[str, dict[str, list[dict]]] = defaultdict(
        lambda: defaultdict(list)
    )
    for e in events:
        by_batch[e["batch"]][e["stage"]].append(e)

    batches: list[dict] = []
    for label in sorted(by_batch):
        stages = by_batch[label]
        marks: dict[str, float] = {}
        # Single-producer stages: the sealing worker's own marks.
        for st in ("ingress", "seal", "disseminate", "cert"):
            if stages.get(st):
                marks[st] = min(t_of(e) for e in stages[st])
        acks = sorted(t_of(e) for e in stages.get("ack", []))
        if acks:
            marks["first_ack"] = acks[0]
        proposed_evs = stages.get("proposed", [])
        proposer = None
        round_ = None
        if proposed_evs:
            first_prop = min(proposed_evs, key=t_of)
            marks["proposed"] = t_of(first_prop)
            proposer = first_prop["node"]
            round_ = _parse_round(first_prop["detail"])
        # queue_wait wants the enqueue on the PROPOSING node (that is
        # the queue the digest waited in); fall back to the earliest.
        enq = stages.get("enqueue", [])
        if enq:
            own = [e for e in enq if proposer is None or e["node"] == proposer]
            marks["enqueue"] = min(t_of(e) for e in (own or enq))
        commits = sorted(t_of(e) for e in stages.get("committed", []))
        if commits:
            marks["committed"] = commits[0]
            if round_ is None:
                round_ = _parse_round(
                    min(stages["committed"], key=t_of)["detail"]
                )
        resolves = sorted(t_of(e) for e in stages.get("resolved", []))
        if resolves:
            marks["resolved"] = resolves[0]

        edges: dict[str, float | None] = dict.fromkeys(EDGES)
        open_edges: list[str] = []
        last_stage = None
        for edge, lo, hi in _EDGE_STAGES:
            a, b = marks.get(lo), marks.get(hi)
            if a is not None:
                last_stage = lo
            if a is not None and b is not None:
                edges[edge] = max(0.0, b - a)
            elif a is not None and b is None:
                open_edges.append(edge)
        if marks.get("resolved") is not None:
            last_stage = "resolved"
        elif marks.get("committed") is not None:
            last_stage = "committed"

        t_first = min(marks.values(), default=None)
        t_last = max(marks.values(), default=None)
        if t_first is None:
            continue
        total = t_last - t_first
        attributed = sum(v for v in edges.values() if v is not None)
        row = {
            "batch": label,
            "round": round_,
            "stage_reached": last_stage,
            "total_ms": round(total * 1e3, 3),
            "unattributed_ms": round(max(0.0, total - attributed) * 1e3, 3),
            "edges_ms": {
                k: (None if v is None else round(v * 1e3, 3))
                for k, v in edges.items()
            },
            "open_edges": open_edges,
            "acks": len(acks),
            "commit_nodes": len(commits),
        }
        # Round-trace join: the batch's ordering edge decomposed through
        # the round's own critical path (propose wire, verify, vote
        # fan-in, qc→commit) when that round assembled.
        if round_ is not None and round_ in round_edges:
            row["round_edges_ms"] = round_edges[round_]
        # Client join: earliest sampled client send → worker ingress
        # (only sampled txs carry ids; absence is not an open edge).
        if client_sends and stages.get("seal"):
            sids = _seal_samples(min(stages["seal"], key=t_of)["detail"])
            sent = min(
                (client_sends[s] for s in sids if s in client_sends),
                default=None,
            )
            anchor_t = marks.get("ingress", marks.get("seal"))
            if sent is not None and anchor_t is not None:
                row["client_submit_ms"] = round(
                    max(0.0, anchor_t - sent) * 1e3, 3
                )
        batches.append(row)
    return batches


def summarize(batches: list[dict], top: int = 5) -> dict:
    """Aggregate edge attribution + cost-center ranking + top-k slowest
    COMPLETE batches + a census of where incomplete lifelines stopped."""
    per_edge: dict[str, list[float]] = defaultdict(list)
    complete = [b for b in batches if not b["open_edges"]]
    for b in batches:
        for edge, v in b["edges_ms"].items():
            if v is not None:
                per_edge[edge].append(v)
    edge_summary = {}
    for edge, values in per_edge.items():
        vs = sorted(values)
        edge_summary[edge] = {
            "n": len(vs),
            "mean_ms": round(sum(vs) / len(vs), 3),
            "median_ms": round(median(vs), 3),
            "p90_ms": round(_pct(vs, 0.9), 3),
            "max_ms": round(vs[-1], 3),
        }
    cost_centers = sorted(
        (
            {"edge": e, "mean_ms": s["mean_ms"]}
            for e, s in edge_summary.items()
        ),
        key=lambda c: -c["mean_ms"],
    )
    totals = sorted(b["total_ms"] for b in complete)
    mean_total = sum(totals) / len(totals) if totals else 0.0
    for c in cost_centers:
        c["share"] = round(c["mean_ms"] / mean_total, 4) if mean_total else 0.0
    stage_census: dict[str, int] = defaultdict(int)
    for b in batches:
        if b["open_edges"]:
            stage_census[b["stage_reached"] or "none"] += 1
    slowest = sorted(complete, key=lambda b: -b["total_ms"])[:top]
    return {
        "batches": len(batches),
        "complete": len(complete),
        "incomplete_by_stage_reached": dict(sorted(stage_census.items())),
        "total_ms": {
            "mean": round(mean_total, 3),
            "median": round(median(totals), 3) if totals else None,
            "p90": round(_pct(totals, 0.9), 3) if totals else None,
            "max": round(totals[-1], 3) if totals else None,
        },
        "edges": edge_summary,
        "cost_centers": cost_centers,
        "top_cost_centers": [c["edge"] for c in cost_centers[:3]],
        "slowest_batches": slowest,
    }


def assemble(
    paths: list[str],
    *,
    align: bool = True,
    top: int = 5,
    client_paths: list[str] | None = None,
) -> dict:
    skipped: list[str] = []
    devents = load_dtrace_events(paths, skipped_streams=skipped)
    # The round traces ride the same streams: they give the per-node
    # clock offsets (causality anchored on propose_send) AND the ordering
    # edge's internal breakdown for the round join.
    revents = load_events(paths)
    offsets = estimate_offsets(revents) if align else {}
    rounds = assemble_rounds(revents, offsets)
    round_edges = {rd["round"]: rd["edges_ms"] for rd in rounds}
    client_sends = (
        load_client_sends(client_paths) if client_paths else None
    )
    batches = assemble_batches(
        devents, offsets, round_edges=round_edges, client_sends=client_sends
    )
    report = {
        "schema": REPORT_SCHEMA,
        "host": host_meta(),
        "streams": [os.path.basename(p) for p in paths],
        "events": len(devents),
        "round_trace_rounds": len(rounds),
        "skipped_streams": sorted(set(skipped)),
        "clock_offsets_s": {
            n: round(o, 6) for n, o in sorted(offsets.items())
        },
        **summarize(batches, top=top),
        "per_batch": batches,
    }
    if client_sends is not None:
        joined = [
            b["client_submit_ms"]
            for b in batches
            if "client_submit_ms" in b
        ]
        report["client_submit_ms"] = (
            {
                "n": len(joined),
                "median_ms": round(median(joined), 3),
                "max_ms": round(max(joined), 3),
            }
            if joined
            else {"n": 0}
        )
    return report


def _human(report: dict) -> str:
    lines = [
        f"assembled {report['batches']} batch lifelines "
        f"({report['complete']} complete) from {report['events']} events "
        f"across {len(report['streams'])} stream(s); "
        f"{report['round_trace_rounds']} round traces joined"
        + (
            f" ({len(report['skipped_streams'])} stream(s) skipped)"
            if report.get("skipped_streams")
            else ""
        ),
    ]
    if report["incomplete_by_stage_reached"]:
        lines.append(
            "incomplete lifelines stopped at: "
            + ", ".join(
                f"{st}={n}"
                for st, n in report["incomplete_by_stage_reached"].items()
            )
        )
    if report["total_ms"]["mean"] is not None and report["complete"]:
        lines.append(
            f"batch e2e (ingress→resolved): mean {report['total_ms']['mean']} ms, "
            f"p90 {report['total_ms']['p90']} ms, max {report['total_ms']['max']} ms"
        )
    lines.append(
        f"{'edge':<14} {'mean ms':>9} {'p90 ms':>9} {'max ms':>9} {'share':>7}"
    )
    shares = {c["edge"]: c["share"] for c in report["cost_centers"]}
    for edge, s in sorted(
        report["edges"].items(), key=lambda kv: -kv[1]["mean_ms"]
    ):
        lines.append(
            f"{edge:<14} {s['mean_ms']:>9} {s['p90_ms']:>9} {s['max_ms']:>9} "
            f"{shares.get(edge, 0):>6.1%}"
        )
    lines.append(
        "top cost centers: " + ", ".join(report["top_cost_centers"])
    )
    return "\n".join(lines)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument(
        "paths", nargs="+",
        help="telemetry stream files, or directories containing "
        "telemetry-*.jsonl",
    )
    p.add_argument("--top", type=int, default=5, help="slowest batches kept")
    p.add_argument(
        "--clients", nargs="*", default=None,
        help="client log files or directories (joins the sampled client "
        "submit timestamps as an extra leading edge)",
    )
    p.add_argument(
        "--no-align", action="store_true",
        help="skip causality-based clock-offset estimation",
    )
    p.add_argument("--output", help="write the JSON report here")
    args = p.parse_args()

    paths: list[str] = []
    for path in args.paths:
        if os.path.isdir(path):
            paths.extend(sorted(glob.glob(os.path.join(path, "telemetry-*.jsonl"))))
        else:
            paths.append(path)
    if not paths:
        print("no telemetry streams found", file=sys.stderr)
        sys.exit(2)
    client_paths: list[str] | None = None
    if args.clients is not None:
        client_paths = []
        for path in args.clients:
            if os.path.isdir(path):
                client_paths.extend(
                    sorted(glob.glob(os.path.join(path, "client-*.log")))
                )
            else:
                client_paths.append(path)

    report = assemble(
        paths, align=not args.no_align, top=args.top,
        client_paths=client_paths,
    )
    print(_human(report))
    if args.output:
        os.makedirs(
            os.path.dirname(os.path.abspath(args.output)), exist_ok=True
        )
        with open(args.output, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"report written to {args.output}")
    if not report["batches"]:
        print("no batch lifelines were assembled", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
