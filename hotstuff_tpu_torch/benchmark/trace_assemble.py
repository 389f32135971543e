"""Port copy of the reference's ``benchmark/trace_assemble.py``, whole
(``EDGES``, ``assemble``, ``load_events``, the CLI), over the port's
``hostinfo`` and ``logs``. Nothing is left out.

Cross-node round-trace assembly: merge every node's telemetry trace
stream into one causal timeline per committed block and attribute
milliseconds to each edge of the propose→vote→QC→commit path.

Input: the ``hotstuff-trace-v1`` lines interleaved in telemetry streams
(``telemetry-*.jsonl``) — per-node protocol events ``(seq, node, round,
stage, t_mono)`` with a wall-clock anchor per emitting process. The
stages a round leaves behind:

- ``propose_send`` (leader): proposal broadcast — t=0 of the timeline
- ``propose`` (every node): proposal seen (wire + receiver decode +
  core queue wait behind it)
- ``verified`` (every node): certificates verified (the crypto edge)
- ``vote_send`` (every node): vote created and dispatched
- ``first_vote`` / ``qc`` (the round's collector — the NEXT leader):
  fan-in window endpoints
- ``commit`` (every node): 2-chain commit of the round's block

Per committed round the assembler computes the **critical path**
``propose_send → first_vote → qc → commit`` and sub-attributes its first
leg through the fastest replica's marks, plus per-node distributions
(median/p90/max) for the fan-out edges — which is exactly the
decomposition that separates serde/queueing (``ingress``) from the
crypto plane (``verify``) from vote fan-in (``fanin``) at committee
scale.

Clock model: events are monotonic timestamps mapped to wall time via
each stream's anchor (``wall = anchor.wall + (t - anchor.mono)``). For
multi-host runs with skewed wall clocks, ``--align`` (default on)
estimates a per-node offset from causality — a replica cannot receive a
proposal before its leader sent it — and shifts each node by the
smallest offset restoring non-negative wire times.

    python -m hotstuff_tpu_torch.benchmark.trace_assemble .bench/logs --committee 100 \
        --output results/trace-critical-path-100.json
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
from hotstuff_tpu_torch.benchmark.logs import ParseError, read_stream_records

REPORT_SCHEMA = "hotstuff-trace-critical-path-v1"

# The cross-node edges, in causal order. "ingress" is wire + receiver
# decode + core queue; "verify" the certificate verification; "vote" the
# vote make/persist/dispatch; "vote_wire" dispatch to first arrival at
# the collector; "fanin" first vote to assembled QC (the 2f+1 straggler
# wait); "qc_to_commit" certificate to 2-chain commit (two follow-on
# rounds by construction).
EDGES = ("ingress", "verify", "vote", "vote_wire", "fanin", "qc_to_commit")


def load_events(
    paths: list[str], skipped_streams: list[str] | None = None
) -> list[dict]:
    """All trace events across streams as dicts with wall-mapped times.
    Events are re-sorted by (node, seq): a stream's lines can land
    interleaved/out of order when processes share a file.

    A stream that cannot contribute — unreadable/corrupt, or trace
    records missing the wall-clock **anchor** that maps their monotonic
    timestamps onto the shared timeline — is skipped with a warning and
    recorded in ``skipped_streams`` (when a list is given) instead of
    aborting the whole assembly or vanishing silently: one crashed
    node's stream must not cost the other N-1 nodes' timeline, but the
    report has to say the attribution is partial."""
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
        for rec in records.traces:
            anchor = rec.get("anchor") or {}
            if not all(
                isinstance(anchor.get(k), (int, float)) for k in ("mono", "wall")
            ):
                bad_anchor = True
                continue
            off = anchor["wall"] - anchor["mono"]
            for ev in rec["events"]:
                # Events are 5-tuples, or 6 with a detail payload (vote
                # author/digest, commit height — the watchtower's fields);
                # edge attribution only needs the first five.
                seq, node, round_, stage, t = ev[:5]
                events.append(
                    {
                        "seq": seq,
                        "node": node,
                        "round": round_,
                        "stage": stage,
                        "t": t + off,
                        "stream": path,
                    }
                )
        if bad_anchor:
            print(
                f"WARN: {path}: trace record(s) without a wall-clock "
                "anchor skipped (cannot place on the shared timeline)",
                file=sys.stderr,
            )
            if skipped_streams is not None:
                skipped_streams.append(os.path.basename(path))
    events.sort(key=lambda e: (e["stream"], e["node"], e["seq"]))
    return events


def estimate_offsets(events: list[dict]) -> dict[str, float]:
    """Per-node clock offsets restoring send→receive causality.

    For every round with a ``propose_send``, each node's ``propose``
    must not precede it. A node whose earliest observed wire delta is
    negative gets shifted forward by exactly that amount — the minimal
    correction, assuming near-zero minimum network delay. Leaders anchor
    the timeline; nodes that never receive relative to a known send
    keep offset 0."""
    sends: dict[int, float] = {}
    for e in events:
        if e["stage"] == "propose_send":
            r = e["round"]
            if r not in sends or e["t"] < sends[r]:
                sends[r] = e["t"]
    offsets: dict[str, float] = defaultdict(float)
    worst: dict[str, float] = {}
    for e in events:
        if e["stage"] != "propose" or e["round"] not in sends:
            continue
        delta = e["t"] - sends[e["round"]]
        node = e["node"]
        if node not in worst or delta < worst[node]:
            worst[node] = delta
    for node, delta in worst.items():
        if delta < 0:
            offsets[node] = -delta
    return dict(offsets)


def _pct(sorted_values: list[float], q: float) -> float:
    if not sorted_values:
        return 0.0
    idx = min(len(sorted_values) - 1, int(round(q * (len(sorted_values) - 1))))
    return sorted_values[idx]


def _stats_ms(values: list[float]) -> dict:
    vs = sorted(values)
    return {
        "n": len(vs),
        "median_ms": round(median(vs) * 1e3, 3) if vs else None,
        "p90_ms": round(_pct(vs, 0.9) * 1e3, 3) if vs else None,
        "max_ms": round(vs[-1] * 1e3, 3) if vs else None,
    }


def assemble_rounds(
    events: list[dict], offsets: dict[str, float] | None = None
) -> list[dict]:
    """Per committed round: the merged timeline and edge attribution."""
    offsets = offsets or {}

    def t_of(e):
        return e["t"] + offsets.get(e["node"], 0.0)

    by_round: dict[int, dict[str, list[dict]]] = defaultdict(
        lambda: defaultdict(list)
    )
    for e in events:
        by_round[e["round"]][e["stage"]].append(e)

    rounds: list[dict] = []
    for r in sorted(by_round):
        stages = by_round[r]
        if not stages.get("commit"):
            continue  # only committed blocks get a full timeline
        commits = sorted(t_of(e) for e in stages["commit"])
        send = min(
            (t_of(e) for e in stages.get("propose_send", [])), default=None
        )
        recvs = {e["node"]: t_of(e) for e in stages.get("propose", [])}
        if send is None:
            # Leader's stream missing: fall back to the earliest sighting
            # (the leader's own loopback propose is within µs of its
            # broadcast in-process).
            send = min(recvs.values(), default=None)
        if send is None:
            continue
        verifieds = {e["node"]: t_of(e) for e in stages.get("verified", [])}
        vote_sends = {e["node"]: t_of(e) for e in stages.get("vote_send", [])}
        first_vote = min(
            (t_of(e) for e in stages.get("first_vote", [])), default=None
        )
        qc = min((t_of(e) for e in stages.get("qc", [])), default=None)
        first_commit = commits[0]

        ingress = [max(0.0, t - send) for t in recvs.values()]
        verify = [
            max(0.0, verifieds[n] - recvs[n]) for n in verifieds if n in recvs
        ]
        vote = [
            max(0.0, vote_sends[n] - verifieds[n])
            for n in vote_sends
            if n in verifieds
        ]

        # Critical-path legs (they sum to total by construction when all
        # marks exist): send→first_vote decomposed through the fastest
        # voter, then the fan-in window, then qc→commit.
        edges: dict[str, float | None] = dict.fromkeys(EDGES)
        if first_vote is not None and vote_sends:
            fastest_vote_send = min(vote_sends.values())
            edges["vote_wire"] = max(0.0, first_vote - fastest_vote_send)
            # Sub-attribute through the fastest FULLY-marked replica (the
            # leader votes via loopback and carries no receive/verify
            # marks, so it would otherwise always win and void these
            # edges). The table is attribution along representative fast
            # paths, not an exact decomposition — "unattributed" absorbs
            # the difference against the true total.
            full = [
                n for n in vote_sends if n in recvs and n in verifieds
            ]
            if full:
                fast_voter = min(full, key=vote_sends.get)
                edges["ingress"] = max(0.0, recvs[fast_voter] - send)
                edges["verify"] = max(
                    0.0, verifieds[fast_voter] - recvs[fast_voter]
                )
                edges["vote"] = max(
                    0.0, vote_sends[fast_voter] - verifieds[fast_voter]
                )
        if first_vote is not None and qc is not None:
            edges["fanin"] = max(0.0, qc - first_vote)
        if qc is not None:
            edges["qc_to_commit"] = max(0.0, first_commit - qc)

        total = first_commit - send
        attributed = sum(v for v in edges.values() if v is not None)
        rounds.append(
            {
                "round": r,
                "total_ms": round(total * 1e3, 3),
                "unattributed_ms": round(max(0.0, total - attributed) * 1e3, 3),
                "edges_ms": {
                    k: (None if v is None else round(v * 1e3, 3))
                    for k, v in edges.items()
                },
                "fanout": {
                    "ingress": _stats_ms(ingress),
                    "verify": _stats_ms(verify),
                    "vote": _stats_ms(vote),
                },
                "nodes_observed": len(recvs),
                "commit_spread_ms": round((commits[-1] - commits[0]) * 1e3, 3),
            }
        )
    return rounds


def summarize(rounds: list[dict], top: int = 5) -> dict:
    """Aggregate edge attribution + top-k slowest rounds + ranked cost
    centers (the committed "what eats the time" answer)."""
    per_edge: dict[str, list[float]] = defaultdict(list)
    for rd in rounds:
        for edge, v in rd["edges_ms"].items():
            if v is not None:
                per_edge[edge].append(v)
        per_edge["unattributed"].append(rd["unattributed_ms"])
    totals = sorted(rd["total_ms"] for rd in rounds)
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
    mean_total = sum(totals) / len(totals) if totals else 0.0
    for c in cost_centers:
        c["share"] = round(c["mean_ms"] / mean_total, 4) if mean_total else 0.0
    slowest = sorted(rounds, key=lambda rd: -rd["total_ms"])[:top]
    return {
        "rounds": len(rounds),
        "total_ms": {
            "mean": round(mean_total, 3),
            "median": round(median(totals), 3) if totals else None,
            "p90": round(_pct(totals, 0.9), 3) if totals else None,
            "max": round(totals[-1], 3) if totals else None,
        },
        "edges": edge_summary,
        "cost_centers": cost_centers,
        "top_cost_centers": [c["edge"] for c in cost_centers[:3]],
        "slowest_rounds": slowest,
    }


def assemble(
    paths: list[str], *, align: bool = True, top: int = 5
) -> dict:
    skipped: list[str] = []
    events = load_events(paths, skipped_streams=skipped)
    offsets = estimate_offsets(events) if align else {}
    rounds = assemble_rounds(events, offsets)
    report = {
        "schema": REPORT_SCHEMA,
        "host": host_meta(),
        "streams": [os.path.basename(p) for p in paths],
        "events": len(events),
        "skipped_streams": sorted(set(skipped)),
        "clock_offsets_s": {
            n: round(o, 6) for n, o in sorted(offsets.items())
        },
        **summarize(rounds, top=top),
        "per_round": rounds,
    }
    return report


def _human(report: dict) -> str:
    lines = [
        f"assembled {report['rounds']} committed rounds from "
        f"{report['events']} events across {len(report['streams'])} stream(s)"
        + (
            f" ({len(report['skipped_streams'])} skipped: no usable anchor)"
            if report.get("skipped_streams")
            else ""
        ),
        f"round total: mean {report['total_ms']['mean']} ms, "
        f"p90 {report['total_ms']['p90']} ms, max {report['total_ms']['max']} ms",
        f"{'edge':<14} {'mean ms':>9} {'p90 ms':>9} {'max ms':>9} {'share':>7}",
    ]
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
    p.add_argument("--top", type=int, default=5, help="slowest rounds kept")
    p.add_argument("--committee", type=int, help="committee size (recorded)")
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

    report = assemble(paths, align=not args.no_align, top=args.top)
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
        print(f"report written to {args.output}")
    if not report["rounds"]:
        print("no committed rounds were assembled", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
