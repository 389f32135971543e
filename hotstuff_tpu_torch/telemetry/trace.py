"""Causal trace plane: per-round protocol events and the flight recorder.

Where the registry answers "how much" (counters, histograms), this module
answers "in what order, on which node": every traced protocol mark —
leader proposal broadcast, replica receive/verify/vote, collector vote
fan-in, QC formation, commit — lands as one event tuple in a process-wide
bounded ring (:class:`TraceBuffer`). Two consumers read the ring:

- the :class:`~.emitter.TelemetryEmitter` drains *new* events into
  ``hotstuff-trace-v1`` JSON lines interleaved with snapshots, which
  ``benchmark/trace_assemble.py`` merges across nodes into per-block
  causal timelines with critical-path attribution;
- the **flight recorder** (:func:`dump_flight_record`) dumps the *whole*
  ring — the last ``capacity`` protocol events — plus a registry snapshot
  when something goes wrong (faultline checker failure, node crash,
  SIGTERM), turning "safety violated, good luck" into a postmortem.

Event timestamps are ``time.perf_counter()`` (monotonic); each buffer
carries a wall-clock **anchor** captured at construction so cross-process
consumers can map monotonic times onto one wall timeline:
``wall = anchor.wall + (t - anchor.mono)``. Recording costs one lock
acquire + deque append per event and only happens when telemetry is
enabled, so the disabled hot path pays nothing.

Port copy of ``hotstuff_tpu/telemetry/trace.py``, unchanged.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from bisect import bisect_right
from collections import deque

log = logging.getLogger("telemetry")

TRACE_SCHEMA = "hotstuff-trace-v1"
FLIGHT_SCHEMA = "hotstuff-flightrec-v1"

#: default ring capacity; override with HOTSTUFF_FLIGHT_CAPACITY.
DEFAULT_CAPACITY = 65_536


def _env_capacity() -> int:
    try:
        return max(256, int(os.environ.get("HOTSTUFF_FLIGHT_CAPACITY", "")))
    except ValueError:
        return DEFAULT_CAPACITY


class TraceBuffer:
    """Bounded ring of ``(seq, node, round, stage, t_mono[, detail])``
    events.

    ``seq`` is a process-wide monotonically increasing id: the emitter
    remembers the last seq it streamed and fetches only newer events
    (:meth:`events_since`), while the flight recorder copies the whole
    ring (:meth:`snapshot_events`) — the two consumers never contend over
    a destructive drain. Eviction (ring overflow) is counted, never
    silent.

    ``detail`` is an optional short string payload carrying the
    per-event fields the streaming analyzers need beyond (node, round,
    stage): a ``vote_rx`` event's ``"<author>|<block digest>"``, a
    ``propose`` event's ``"<author>|<digest>"``, a ``commit`` event's
    ``"h<last_committed_round>"``. Events without a detail stay
    5-tuples, so pre-existing streams and consumers are unaffected.
    """

    __slots__ = (
        "_events", "_lock", "_seq", "evicted",
        "anchor_mono", "anchor_wall", "capacity",
    )

    def __init__(self, capacity: int | None = None) -> None:
        self.capacity = capacity or _env_capacity()
        self._events: deque[tuple] = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self.evicted = 0
        self.anchor_mono = time.perf_counter()
        self.anchor_wall = time.time()

    def record(
        self,
        node: str,
        round_: int,
        stage: str,
        t: float | None = None,
        detail: str | None = None,
    ) -> None:
        if t is None:
            t = time.perf_counter()
        with self._lock:
            if len(self._events) == self.capacity:
                self.evicted += 1
            self._seq += 1
            if detail is None:
                self._events.append((self._seq, node, round_, stage, t))
            else:
                self._events.append(
                    (self._seq, node, round_, stage, t, detail)
                )

    def last_seq(self) -> int:
        return self._seq

    def events_since(self, seq: int) -> list[tuple]:
        """Events with seq strictly greater than ``seq`` (oldest first)."""
        with self._lock:
            events = list(self._events)
        if not events or events[-1][0] <= seq:
            return []
        # Events are seq-sorted; binary-search the cut instead of scanning.
        idx = bisect_right([e[0] for e in events], seq)
        return events[idx:]

    def snapshot_events(self) -> list[tuple]:
        with self._lock:
            return list(self._events)

    def anchor(self) -> dict:
        return {"mono": self.anchor_mono, "wall": self.anchor_wall}

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._seq = 0
            self.evicted = 0
            self.anchor_mono = time.perf_counter()
            self.anchor_wall = time.time()


def build_trace_record(
    buffer: TraceBuffer, events: list[tuple], node: str = ""
) -> dict:
    """One ``hotstuff-trace-v1`` stream line carrying ``events``."""
    return {
        "schema": TRACE_SCHEMA,
        "node": node,
        "pid": os.getpid(),
        "anchor": buffer.anchor(),
        "evicted": buffer.evicted,
        "events": [list(e) for e in events],
    }


def validate_trace_record(obj) -> list[str]:
    """Schema check mirroring ``validate_snapshot``; returns problems."""
    problems: list[str] = []
    if not isinstance(obj, dict):
        return [f"trace record is {type(obj).__name__}, not an object"]
    if obj.get("schema") != TRACE_SCHEMA:
        problems.append(f"schema is {obj.get('schema')!r}, want {TRACE_SCHEMA!r}")
    anchor = obj.get("anchor")
    if not isinstance(anchor, dict) or not all(
        isinstance(anchor.get(k), (int, float)) for k in ("mono", "wall")
    ):
        problems.append("anchor missing mono/wall")
    events = obj.get("events")
    if not isinstance(events, list):
        problems.append("events missing or not a list")
        return problems
    for i, ev in enumerate(events):
        if (
            not isinstance(ev, (list, tuple))
            or len(ev) not in (5, 6)
            or not isinstance(ev[0], int)
            or not isinstance(ev[1], str)
            or not isinstance(ev[2], int)
            or not isinstance(ev[3], str)
            or not isinstance(ev[4], (int, float))
            or (len(ev) == 6 and not isinstance(ev[5], str))
        ):
            problems.append(f"event {i} malformed: {ev!r}")
            break
    return problems


def dump_flight_record(
    path: str,
    reason: str,
    buffer: TraceBuffer,
    registry=None,
    extra: dict | None = None,
) -> str | None:
    """Write the flight record — the ring's recent protocol events plus a
    registry snapshot — to ``path``. Returns the path, or None when the
    write failed (the recorder must never take the process down with it:
    it runs from crash paths and signal handlers)."""
    record = {
        "schema": FLIGHT_SCHEMA,
        "reason": reason,
        "ts": time.time(),
        "pid": os.getpid(),
        "anchor": buffer.anchor(),
        "evicted": buffer.evicted,
        "events": [list(e) for e in buffer.snapshot_events()],
    }
    if registry is not None:
        try:
            record["snapshot"] = registry.snapshot()
        except Exception as e:  # noqa: BLE001 — postmortem must not raise
            record["snapshot_error"] = str(e)
    if extra:
        record.update(extra)
    try:
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            json.dump(record, f)
            f.write("\n")
    except OSError as e:
        log.error("cannot write flight record to %s: %s", path, e)
        return None
    log.warning("flight record (%s) dumped to %s", reason, path)
    return path
