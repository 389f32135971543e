"""JSON-lines snapshot emitter + snapshot schema validation.

One snapshot is one line: a self-describing JSON object carrying the
whole registry state (cumulative counters, current gauges, merged
histograms). Cumulative-not-delta means a reader needs only the LAST
line of a stream — a crashed node's stream is still fully usable up to
its final interval, and intermediate lines give time series for free.

When a :class:`~.trace.TraceBuffer` is attached, each emit additionally
appends one ``hotstuff-trace-v1`` line carrying the protocol trace
events recorded since the previous emit (delta, not cumulative — events
are large and append-only), interleaved with the snapshots in the same
stream. ``benchmark/logs.py`` separates the two schemas when reading.

Unclean shutdown: :func:`arm_shutdown_flush` registers SIGTERM and
``atexit`` hooks that write the ``final: true`` snapshot (and trace
tail, and optionally a flight record) even when the process never
reaches its graceful ``shutdown()`` — the local bench's teardown and
faultline's crash/restart harness both kill nodes, and without this the
last interval of every stream was lost.

``benchmark/logs.py`` consumes these streams (``TelemetryParser``)
alongside its regex path; the CI smoke lane validates them with
``validate_snapshot``.

Port copy of ``hotstuff_tpu/telemetry/emitter.py``.
"""

from __future__ import annotations

import asyncio
import atexit
import json
import logging
import os
import signal
import time

from . import profiler as pyprof
from .dtrace import build_dtrace_record
from .trace import build_trace_record, dump_flight_record

log = logging.getLogger("telemetry")

SCHEMA = "hotstuff-telemetry-v1"
META_SCHEMA = "hotstuff-meta-v1"
DEFAULT_INTERVAL_S = 5.0


def build_meta_record(
    node: str = "",
    interval_s: float | None = None,
    anchor: dict | None = None,
) -> dict:
    """The stream's self-description: every emitter writes one of these
    as its FIRST record so a consumer (the watchtower, the validate CLI,
    a human with ``head -1``) knows what it is looking at without
    guessing from content — which schemas may appear, which node wrote
    it, the wall-clock anchor that places the stream's monotonic trace
    timestamps on a shared timeline, and the writer pid (restarts of the
    same node produce a new meta record mid-stream: a visible epoch
    boundary, not a silent counter reset)."""
    from .dtrace import DTRACE_SCHEMA
    from .profiler import PROFILE_SCHEMA
    from .trace import TRACE_SCHEMA
    from .watchtower import ALERT_SCHEMA

    return {
        "schema": META_SCHEMA,
        "schemas": [
            SCHEMA, TRACE_SCHEMA, DTRACE_SCHEMA, PROFILE_SCHEMA,
            ALERT_SCHEMA,
        ],
        "node": node,
        "pid": os.getpid(),
        "ts": time.time(),
        "anchor": anchor
        or {"mono": time.perf_counter(), "wall": time.time()},
        "interval_s": interval_s,
    }


def validate_meta_record(obj) -> list[str]:
    """Schema check mirroring ``validate_snapshot``; returns problems."""
    problems: list[str] = []
    if not isinstance(obj, dict):
        return [f"meta record is {type(obj).__name__}, not an object"]
    if obj.get("schema") != META_SCHEMA:
        problems.append(
            f"schema is {obj.get('schema')!r}, want {META_SCHEMA!r}"
        )
    if not isinstance(obj.get("schemas"), list) or not all(
        isinstance(s, str) for s in obj.get("schemas") or []
    ):
        problems.append("schemas missing or not a list of strings")
    for key, types in (("node", str), ("pid", int), ("ts", (int, float))):
        if not isinstance(obj.get(key), types):
            problems.append(f"field {key!r} missing or mistyped")
    anchor = obj.get("anchor")
    if not isinstance(anchor, dict) or not all(
        isinstance(anchor.get(k), (int, float)) for k in ("mono", "wall")
    ):
        problems.append("anchor missing mono/wall")
    return problems


def build_snapshot(registry, node: str = "", seq: int = 0, final: bool = False) -> dict:
    snap = registry.snapshot()
    return {
        "schema": SCHEMA,
        "node": node,
        "pid": os.getpid(),
        "seq": seq,
        "ts": time.time(),
        "final": final,
        "counters": snap["counters"],
        "gauges": snap["gauges"],
        "histograms": snap["histograms"],
    }


def validate_snapshot(obj) -> list[str]:
    """Schema check for one parsed snapshot line; returns a list of
    problems (empty == valid). Deliberately dependency-free — the CI
    smoke lane and tests share it."""
    problems: list[str] = []
    if not isinstance(obj, dict):
        return [f"snapshot is {type(obj).__name__}, not an object"]
    if obj.get("schema") != SCHEMA:
        problems.append(f"schema is {obj.get('schema')!r}, want {SCHEMA!r}")
    for key, types in (
        ("node", str), ("pid", int), ("seq", int),
        ("ts", (int, float)), ("final", bool),
        ("counters", dict), ("gauges", dict), ("histograms", dict),
    ):
        if not isinstance(obj.get(key), types):
            problems.append(f"field {key!r} missing or mistyped")
    for name, v in (obj.get("counters") or {}).items():
        if not isinstance(v, int) or v < 0:
            problems.append(f"counter {name!r} not a non-negative int")
    for name, v in (obj.get("gauges") or {}).items():
        if not isinstance(v, (int, float)):
            problems.append(f"gauge {name!r} not a number")
    for name, h in (obj.get("histograms") or {}).items():
        if not isinstance(h, dict):
            problems.append(f"histogram {name!r} not an object")
            continue
        le, counts = h.get("le"), h.get("counts")
        if not isinstance(le, list) or not isinstance(counts, list):
            problems.append(f"histogram {name!r} missing le/counts")
            continue
        if len(counts) != len(le) + 1:
            problems.append(f"histogram {name!r}: {len(counts)} counts "
                            f"for {len(le)} edges (want edges+1)")
        if list(le) != sorted(le):
            problems.append(f"histogram {name!r}: edges not sorted")
        if not isinstance(h.get("count"), int) or not isinstance(
            h.get("sum"), (int, float)
        ):
            problems.append(f"histogram {name!r} missing count/sum")
        elif sum(counts) != h["count"]:
            problems.append(
                f"histogram {name!r}: bucket counts sum to {sum(counts)}, "
                f"count says {h['count']}"
            )
    return problems


class TelemetryEmitter:
    """Appends one snapshot line to ``path`` every ``interval_s`` and a
    ``final`` one at shutdown. Each write is a single buffered
    write+flush of a complete line, so concurrent emitters appending to
    the same file (in-process testbeds) interleave at line granularity.
    With ``trace`` attached, each emit also appends a trace line carrying
    the protocol events recorded since the previous emit."""

    def __init__(
        self,
        registry,
        path: str,
        node: str = "",
        interval_s: float = DEFAULT_INTERVAL_S,
        trace=None,
        dtrace=None,
        profiler=None,
    ) -> None:
        self.registry = registry
        self.path = path
        self.node = node
        self.interval_s = max(float(interval_s), 0.05)
        self.trace = trace  # TraceBuffer or None
        self.dtrace = dtrace  # batch-lifecycle TraceBuffer or None
        # SamplingProfiler, or None to follow the process-active session
        # lazily (nodes arm the profiler from the environment after the
        # emitter exists; a fixed None would silently drop its records).
        self.profiler = profiler
        self._trace_seq = 0  # last trace event seq already streamed
        self._dtrace_seq = 0  # last dtrace event seq already streamed
        self._seq = 0
        self._final_done = False
        self._meta_done = False
        self._task: asyncio.Task | None = None
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)

    def emit(self, final: bool = False) -> dict:
        if final:
            if self._final_done:
                # Already flushed (signal handler / atexit raced the
                # graceful shutdown): final state is on disk, don't
                # duplicate it.
                return {}
            self._final_done = True
        snapshot = build_snapshot(
            self.registry, node=self.node, seq=self._seq, final=final
        )
        self._seq += 1
        lines = []
        if not self._meta_done:
            # Stream self-description rides as the first record this
            # emitter contributes (per WRITER, not per file: in-process
            # testbeds append several emitters to one file, and a node
            # restart appends a fresh meta record — the epoch boundary).
            self._meta_done = True
            anchor = self.trace.anchor() if self.trace is not None else None
            lines.append(
                json.dumps(
                    build_meta_record(
                        node=self.node,
                        interval_s=self.interval_s,
                        anchor=anchor,
                    ),
                    separators=(",", ":"),
                )
            )
        lines.append(json.dumps(snapshot, separators=(",", ":")))
        if self.trace is not None:
            events = self.trace.events_since(self._trace_seq)
            if events:
                self._trace_seq = events[-1][0]
                record = build_trace_record(self.trace, events, node=self.node)
                lines.append(json.dumps(record, separators=(",", ":")))
        if self.dtrace is not None:
            # Batch-lifecycle events ride the same stream as their own
            # delta line (same contract as the round trace above).
            events = self.dtrace.events_since(self._dtrace_seq)
            if events:
                self._dtrace_seq = events[-1][0]
                record = build_dtrace_record(
                    self.dtrace, events, node=self.node
                )
                lines.append(json.dumps(record, separators=(",", ":")))
        prof = self.profiler if self.profiler is not None else pyprof.active()
        if prof is not None:
            # Folded stacks sampled since the previous emit ride the same
            # stream as one ``hotstuff-profile-v1`` line (delta, like
            # trace events; the sampler keeps nothing after the drain).
            profile = prof.drain_record(node=self.node)
            if profile is not None:
                lines.append(json.dumps(profile, separators=(",", ":")))
        try:
            with open(self.path, "a") as f:
                f.write("\n".join(lines) + "\n")
        except OSError as e:  # telemetry must never kill the node
            log.error("cannot write telemetry snapshot to %s: %s", self.path, e)
        return snapshot

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.interval_s)
            self.emit()

    def spawn(self) -> "TelemetryEmitter":
        self._task = asyncio.create_task(self._run(), name="telemetry_emitter")
        return self

    async def shutdown(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
        self.emit(final=True)


def arm_shutdown_flush(
    emitter: TelemetryEmitter, flight_path: str | None = None
) -> None:
    """Guarantee the ``final: true`` snapshot survives unclean teardown.

    Registers an ``atexit`` hook and chains a SIGTERM handler: both flush
    the final snapshot (idempotent — ``emit(final=True)`` runs at most
    once per emitter) and, when ``flight_path`` is given, dump the flight
    record. The SIGTERM handler then restores the previous disposition
    and re-raises the signal so the process still dies with the expected
    status — this instrumentation observes shutdown, it doesn't veto it.
    SIGKILL remains unsurvivable by design; benches that want the final
    interval send SIGTERM first (``benchmark/local.py`` does).
    """

    def _flush(reason: str) -> None:
        try:
            emitter.emit(final=True)
            if flight_path is not None and emitter.trace is not None:
                dump_flight_record(
                    flight_path, reason, emitter.trace, emitter.registry
                )
        except Exception as e:  # noqa: BLE001 — shutdown paths never raise
            log.error("telemetry shutdown flush failed: %s", e)

    atexit.register(_flush, "atexit")

    try:
        previous = signal.getsignal(signal.SIGTERM)

        def _on_sigterm(signum, frame):
            _flush("sigterm")
            if callable(previous):
                previous(signum, frame)
            else:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                signal.raise_signal(signal.SIGTERM)

        signal.signal(signal.SIGTERM, _on_sigterm)
    except (ValueError, OSError):
        # Not the main thread (in-process testbeds spawn emitters from
        # worker contexts): the atexit hook still covers interpreter exit.
        pass
