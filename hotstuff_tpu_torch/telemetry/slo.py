"""SLO engine: declarative service-level objectives evaluated over
telemetry snapshot streams, emitting machine verdicts.

An :class:`SloSpec` names a metric, an evaluation ``kind``, and a
threshold; :func:`evaluate` slides a time window over a node's snapshot
stream (cumulative counters/histograms → reset-aware window deltas) and
judges every window, so a long soak is gated on "p99 commit latency
stayed under X in every 30 s window", not on one end-of-run average that
a mid-run stall would vanish into. The verdict is plain JSON data —
benchmark harnesses and CI lanes gate on ``verdict["ok"]`` without
parsing human text (the same contract as faultline's checker).

Kinds:

- ``quantile``: histogram metric; the window's q-quantile (linear
  interpolation inside the bucket) must stay ≤ ``max``. Windows with no
  observations are skipped (no data ≠ violation — a rate SLO owns
  progress).
- ``ms_per_count``: ``window_ms / counter delta`` ≤ ``max`` (ms/round
  from ``consensus.rounds_advanced``). A window with zero delta is a
  stall: worst = +inf, violated.
- ``rate``: counter delta per second ≥ ``min`` and/or ≤ ``max``.
- ``ratio``: counter delta ÷ another counter delta (``per``) ≤ ``max``
  (timeouts per round). Zero denominator skips the window.
- ``gauge_max``: the gauge's value in every snapshot of the window ≤
  ``max`` (mempool queue depth).
- ``gauge_growth``: the gauge's per-second growth across the window,
  ``(after - before) / window_s`` ≤ ``max`` (RSS / store-size growth —
  the unbounded-growth failure mode long soaks exist to catch). Windows
  where the gauge is absent at either end are skipped; negative growth
  (GC, compaction) always passes a max bound.

Counter resets (node restart mid-stream) make a cumulative value go
DOWN; a reset-aware delta treats that as "counted from zero again" and
uses the after-value, so a crash/restart chaos run doesn't produce
negative rates or bogus violations.

``allow_violation_fraction`` (per spec) tolerates a bounded fraction of
bad windows — chaos soaks legitimately degrade while a partition is
open; the SLO bounds how much of the run may be degraded, rather than
flipping on the first bad window.

Port copy of ``hotstuff_tpu/telemetry/slo.py``; only comments differ.
"""

from __future__ import annotations

import json
import math

SLO_VERDICT_SCHEMA = "hotstuff-slo-verdict-v1"


class SloSpec:
    """One declarative objective. See module docstring for kinds."""

    __slots__ = (
        "name", "kind", "metric", "q", "per", "max", "min",
        "allow_violation_fraction",
    )

    def __init__(
        self,
        name: str,
        kind: str,
        metric: str,
        *,
        q: float | None = None,
        per: str | None = None,
        max: float | None = None,  # noqa: A002 — spec field name
        min: float | None = None,  # noqa: A002
        allow_violation_fraction: float = 0.0,
    ) -> None:
        if kind not in (
            "quantile", "ms_per_count", "rate", "ratio", "gauge_max",
            "gauge_growth",
        ):
            raise ValueError(f"unknown SLO kind {kind!r}")
        if kind == "quantile" and not (q and 0.0 < q < 1.0):
            raise ValueError(f"quantile SLO {name!r} needs 0 < q < 1")
        if kind == "ratio" and not per:
            raise ValueError(f"ratio SLO {name!r} needs a 'per' counter")
        if max is None and min is None:
            raise ValueError(f"SLO {name!r} needs a max and/or min threshold")
        self.name = name
        self.kind = kind
        self.metric = metric
        self.q = q
        self.per = per
        self.max = max
        self.min = min
        self.allow_violation_fraction = allow_violation_fraction

    @classmethod
    def from_dict(cls, d: dict) -> "SloSpec":
        return cls(
            d["name"], d["kind"], d["metric"],
            q=d.get("q"), per=d.get("per"), max=d.get("max"), min=d.get("min"),
            allow_violation_fraction=d.get("allow_violation_fraction", 0.0),
        )

    def to_dict(self) -> dict:
        d = {"name": self.name, "kind": self.kind, "metric": self.metric}
        for k in ("q", "per", "max", "min"):
            v = getattr(self, k)
            if v is not None:
                d[k] = v
        if self.allow_violation_fraction:
            d["allow_violation_fraction"] = self.allow_violation_fraction
        return d


def load_specs(path: str) -> list[SloSpec]:
    """Read a JSON file: a list of spec objects (see ``SloSpec``)."""
    with open(path) as f:
        return [SloSpec.from_dict(d) for d in json.load(f)]


def default_slos(
    *,
    p99_commit_latency_ms: float = 5_000.0,
    ms_per_round: float = 2_000.0,
    mempool_queue_depth: float = 50_000.0,
    timeouts_per_round: float = 0.5,
    allow_violation_fraction: float = 0.0,
) -> list[SloSpec]:
    """The roadmap's gate set: p99 commit latency, round rate, mempool
    queue depth, timeout/view-change rate. Thresholds are per-deployment
    knobs, not universal truths — callers override per harness."""
    return [
        SloSpec(
            "p99_commit_latency_ms", "quantile",
            "consensus.commit_latency_ms", q=0.99, max=p99_commit_latency_ms,
            allow_violation_fraction=allow_violation_fraction,
        ),
        SloSpec(
            "ms_per_round", "ms_per_count",
            "consensus.rounds_advanced", max=ms_per_round,
            allow_violation_fraction=allow_violation_fraction,
        ),
        SloSpec(
            "mempool_queue_depth", "gauge_max",
            "mempool.tx_queue_depth", max=mempool_queue_depth,
            allow_violation_fraction=allow_violation_fraction,
        ),
        SloSpec(
            "timeouts_per_round", "ratio",
            "consensus.timeouts_fired", per="consensus.rounds_advanced",
            max=timeouts_per_round,
            allow_violation_fraction=allow_violation_fraction,
        ),
    ]


def dataplane_slos(
    *,
    worker_store_depth: float = 512.0,
    digest_queue_growth_per_s: float = 50.0,
    allow_violation_fraction: float = 0.0,
) -> list[SloSpec]:
    """The Conveyor data-plane gate set. Streams without the worker
    metrics (data plane off) skip these specs entirely.

    - ``worker_store_depth`` — sealed-but-uncommitted batches per node
      must stay bounded (the watermark should gate sealing well before
      this trips; a breach means back-pressure is broken, the
      queue-collapse failure mode this plane exists to prevent);
    - ``resolver_unresolved`` — the commit path must NEVER time out
      resolving a certified digest to its batch (max 0 per second: one
      occurrence is an availability violation, not degradation);
    - ``digest_queue_growth_per_s`` — the proposer's certified-digest
      queue must not GROW faster than the bound in any window (ordering
      starving behind ingest). Growth, not depth: a deep
      queue that drains as fast as it fills is healthy pipelining; the
      watchtower's ``digest_queue_starvation`` detector judges the same
      gauge online.
    """
    return [
        SloSpec(
            "worker_store_depth", "gauge_max",
            "mempool.worker.store_depth", max=worker_store_depth,
            allow_violation_fraction=allow_violation_fraction,
        ),
        SloSpec(
            "resolver_unresolved", "rate",
            "mempool.resolver.unresolved", max=0.0,
            allow_violation_fraction=0.0,
        ),
        SloSpec(
            "digest_queue_growth_per_s", "gauge_growth",
            "consensus.proposer.digest_queue_depth",
            max=digest_queue_growth_per_s,
            allow_violation_fraction=allow_violation_fraction,
        ),
    ]


def memory_slos(
    *,
    rss_growth_bytes_per_s: float = 8 * 1024 * 1024,
    store_growth_bytes_per_s: float = 32 * 1024 * 1024,
    store_bytes_max: float | None = None,
    allow_violation_fraction: float = 0.0,
) -> list[SloSpec]:
    """The memory-growth gate (the unbounded-growth failure mode): RSS and on-disk store size must grow slower than a bound in
    every window. The gauges come from ``telemetry/resources.py``
    (``resource.rss_bytes`` / ``resource.store_bytes``); streams without
    them (resource collector not installed) skip these specs. Store
    growth is workload-proportional — the default bound is a ceiling on
    runaway WAL/MetaLog growth, not a tight fit; soaks tune it to their
    input rate.

    ``store_bytes_max`` (None = off) adds an ABSOLUTE cap on on-disk
    store size — the gate retention-armed soaks use: with
    snapshot/truncate compaction live, store size must plateau at the
    retention depth's working set, so a cap is meaningful regardless of
    run length. Without compaction store size is unbounded by design and
    only the growth-rate bound applies."""
    specs = [
        SloSpec(
            "rss_growth_bytes_per_s", "gauge_growth",
            "resource.rss_bytes", max=rss_growth_bytes_per_s,
            allow_violation_fraction=allow_violation_fraction,
        ),
        SloSpec(
            "store_growth_bytes_per_s", "gauge_growth",
            "resource.store_bytes", max=store_growth_bytes_per_s,
            allow_violation_fraction=allow_violation_fraction,
        ),
    ]
    if store_bytes_max is not None:
        specs.append(
            SloSpec(
                "store_bytes_max", "gauge_max",
                "resource.store_bytes", max=store_bytes_max,
                allow_violation_fraction=allow_violation_fraction,
            )
        )
    return specs


# -- window arithmetic -------------------------------------------------------


_ZERO = {"counters": {}, "histograms": {}, "gauges": {}, "ts": None}


def counter_delta(before: dict | None, after: dict, name: str) -> int:
    """Reset-aware cumulative-counter delta over a window."""
    a = after.get("counters", {}).get(name, 0)
    b = (before or _ZERO).get("counters", {}).get(name, 0)
    return a if a < b else a - b  # a < b: the counter reset mid-window


def histogram_delta(before: dict | None, after: dict, name: str) -> dict | None:
    """Window delta of a cumulative histogram (per-bucket subtraction);
    falls back to the after-histogram on a mid-window reset. None when
    the metric is absent."""
    ha = after.get("histograms", {}).get(name)
    if ha is None:
        return None
    hb = (before or _ZERO).get("histograms", {}).get(name)
    if hb is None or list(hb.get("le", [])) != list(ha["le"]):
        return ha
    counts = [a - b for a, b in zip(ha["counts"], hb["counts"])]
    if any(c < 0 for c in counts):  # reset: count from zero again
        return ha
    return {
        "le": ha["le"],
        "counts": counts,
        "sum": ha["sum"] - hb["sum"],
        "count": ha["count"] - hb["count"],
    }


def histogram_quantile(hist: dict, q: float) -> float | None:
    """q-quantile from bucket counts, linearly interpolated inside the
    bucket (Prometheus ``histogram_quantile`` semantics; the overflow
    bucket resolves to its lower edge — a known-conservative answer).
    None when the histogram is empty."""
    le, counts = list(hist["le"]), list(hist["counts"])
    total = sum(counts)
    if total <= 0:
        return None
    rank = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        if c <= 0:
            continue
        if cum + c >= rank:
            if i >= len(le):  # overflow bucket: unbounded above
                return le[-1] if le else math.inf
            lo = le[i - 1] if i > 0 else 0.0
            return lo + (le[i] - lo) * ((rank - cum) / c)
        cum += c
    return le[-1] if le else math.inf


def windows(snapshots: list[dict], window_s: float) -> list[tuple[dict | None, dict]]:
    """Sliding (before, after) snapshot pairs ~``window_s`` apart.

    Every snapshot past the first ends one window whose start is the
    latest snapshot at least ``window_s`` older (clamped to the stream
    head for the warm-up prefix). A single-snapshot stream yields one
    cumulative-from-zero window ``(None, snap)`` — counters are
    cumulative, so zero-state is a valid "before". An empty stream
    yields no windows."""
    if not snapshots:
        return []
    if len(snapshots) == 1:
        return [(None, snapshots[0])]
    out: list[tuple[dict | None, dict]] = []
    for i in range(1, len(snapshots)):
        end = snapshots[i]
        start_idx = 0
        for j in range(i - 1, -1, -1):
            if end["ts"] - snapshots[j]["ts"] >= window_s:
                start_idx = j
                break
        out.append((snapshots[start_idx], end))
    return out


# -- evaluation --------------------------------------------------------------


def _window_seconds(before: dict | None, after: dict) -> float:
    if before is None or before.get("ts") is None:
        return 0.0
    return max(0.0, after["ts"] - before["ts"])


def _counter_present(before: dict | None, after: dict, name: str) -> bool:
    """A counter that never appeared in the window is 'plane absent'
    (e.g. no mempool in a consensus-only bench) — no data, not a stall."""
    return name in after.get("counters", {}) or (
        before is not None and name in before.get("counters", {})
    )


def _eval_window(spec: SloSpec, before: dict | None, after: dict):
    """The spec's observed value over one window, or None (no data)."""
    if spec.kind == "quantile":
        hist = histogram_delta(before, after, spec.metric)
        if hist is None:
            return None
        return histogram_quantile(hist, spec.q)
    if spec.kind == "ms_per_count":
        secs = _window_seconds(before, after)
        if secs <= 0.0 or not _counter_present(before, after, spec.metric):
            return None
        delta = counter_delta(before, after, spec.metric)
        return math.inf if delta <= 0 else secs * 1e3 / delta
    if spec.kind == "rate":
        secs = _window_seconds(before, after)
        if secs <= 0.0 or not _counter_present(before, after, spec.metric):
            return None
        return counter_delta(before, after, spec.metric) / secs
    if spec.kind == "ratio":
        num = counter_delta(before, after, spec.metric)
        den = counter_delta(before, after, spec.per)
        return None if den <= 0 else num / den
    if spec.kind == "gauge_growth":
        secs = _window_seconds(before, after)
        if secs <= 0.0 or before is None:
            return None
        a = after.get("gauges", {}).get(spec.metric)
        b = before.get("gauges", {}).get(spec.metric)
        if a is None or b is None:
            return None
        return (a - b) / secs
    # gauge_max: worst value across the window's endpoints.
    values = [
        s.get("gauges", {}).get(spec.metric)
        for s in (before, after)
        if s is not None
    ]
    values = [v for v in values if v is not None]
    return max(values) if values else None


def _violates(spec: SloSpec, value: float) -> bool:
    if spec.max is not None and value > spec.max:
        return True
    return spec.min is not None and value < spec.min


def evaluate(
    snapshots: list[dict],
    specs: list[SloSpec],
    *,
    window_s: float = 30.0,
    source: str = "",
) -> dict:
    """Judge one snapshot stream against ``specs``; returns the verdict.

    ``ok`` is True only when every spec's violated-window fraction stays
    within its allowance AND the stream carried at least one window —
    an empty stream cannot certify anything, so it fails closed
    (``ok: False, reason: "no snapshots"``); specs whose metric never
    appeared report ``windows: 0`` and don't fail the verdict (absence
    of a plane ≠ violation — e.g. no mempool in a consensus-only bench).
    """
    snaps = sorted(snapshots, key=lambda s: (s.get("ts", 0), s.get("seq", 0)))
    wins = windows(snaps, window_s)
    results = []
    ok = True
    for spec in specs:
        evaluated = 0
        violated = 0
        worst = None
        worst_t = None
        for before, after in wins:
            value = _eval_window(spec, before, after)
            if value is None:
                continue
            evaluated += 1
            bad = _violates(spec, value)
            if bad:
                violated += 1
            # "worst" is the most-violating direction: max for max-bound
            # specs, min for min-bound ones.
            key = value if spec.max is not None else -value
            if worst is None or key > (worst if spec.max is not None else -worst):
                worst = value
                worst_t = after.get("ts")
        frac = (violated / evaluated) if evaluated else 0.0
        spec_ok = frac <= spec.allow_violation_fraction
        if evaluated and not spec_ok:
            ok = False
        results.append(
            {
                "spec": spec.to_dict(),
                "ok": spec_ok,
                "windows": evaluated,
                "violated_windows": violated,
                "violated_fraction": round(frac, 4),
                "worst": (
                    None if worst is None
                    else ("inf" if math.isinf(worst) else round(worst, 3))
                ),
                "worst_at": worst_t,
            }
        )
    verdict = {
        "schema": SLO_VERDICT_SCHEMA,
        "source": source,
        "window_s": window_s,
        "snapshots": len(snaps),
        "ok": ok and bool(wins),
        "slos": results,
    }
    if not wins:
        verdict["reason"] = "no snapshots"
    return verdict


def evaluate_streams(
    streams: dict[str, list[dict]],
    specs: list[SloSpec],
    *,
    window_s: float = 30.0,
) -> dict:
    """Per-stream (per-node) evaluation + one aggregate verdict: every
    node must individually meet its SLOs — a cluster average hides a
    wedged straggler."""
    per_node = {
        name: evaluate(snaps, specs, window_s=window_s, source=name)
        for name, snaps in sorted(streams.items())
    }
    return {
        "schema": SLO_VERDICT_SCHEMA,
        "window_s": window_s,
        "ok": bool(per_node) and all(v["ok"] for v in per_node.values()),
        "nodes": per_node,
    }
