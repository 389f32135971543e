"""Oracle's sim→stream bridge: render a Simulant run into the exact
JSON-lines telemetry streams the real emitters write.

Port copy of ``hotstuff_tpu/sim/streams.py``, whole: the rendered lines
are the reference's byte for byte, and the port's ``Watchtower`` scores
them.

The real observability pipeline is ``RoundTrace`` marks → ``TraceBuffer``
→ ``TelemetryEmitter`` writing ``hotstuff-meta-v1`` / snapshot /
``hotstuff-trace-v1`` lines per node, which ``Watchtower`` tails. This
module substitutes only the clock and the writer: a ``StreamRecorder``
splices a virtual-clock ``SimRoundTrace`` into every spawned
``CoreStateMachine`` (the same duck-typed mark surface ``Core`` already
calls), collects per-instance writer *epochs* (one per spawn — a restart
opens a new epoch with a new synthetic pid, exactly the mid-stream meta
boundary a real process restart produces), and renders them into stream
lines that are **byte-deterministic** in ``(scenario, seed, jitter)``.

Bridge conventions (the parts a real emitter derives from the host):

- ``anchor`` is ``{"mono": 0.0, "wall": 0.0}`` — the virtual clock IS
  both timelines, so every timestamp in the rendered streams is in
  virtual seconds and alert ``ts`` values compare directly against the
  fault schedule's virtual incident times (no ``FaultPlane.started_wall``
  needed).
- ``pid`` is synthetic and deterministic: ``40000 + 100*slot_index +
  incarnation``. Distinct per epoch, stable across runs.
- A crash drops the unflushed tail of the victim's stream (everything
  after the last emit boundary), the same loss a SIGKILL inflicts on a
  real buffered writer. A clean scenario end flushes everything behind a
  ``final: true`` snapshot.

``Watchtower.feed`` replays the merged timeline in milliseconds; the
reference's ``benchmark/detector_sweep.py`` (not ported) is the
labeled-incident scoring loop built on top.
"""

from __future__ import annotations

import json
import os
from collections import OrderedDict

from hotstuff_tpu_torch.telemetry.dtrace import DTRACE_SCHEMA
from hotstuff_tpu_torch.telemetry.emitter import META_SCHEMA, SCHEMA
from hotstuff_tpu_torch.telemetry.profiler import PROFILE_SCHEMA
from hotstuff_tpu_torch.telemetry.trace import TRACE_SCHEMA
from hotstuff_tpu_torch.telemetry.watchtower import ALERT_SCHEMA, Watchtower

__all__ = [
    "SimRoundTrace",
    "StreamRecorder",
    "replay_watchtower",
]

# Deterministic stand-in for os.getpid(): per-slot, bumped per
# incarnation so a restart is a visible pid change in the meta record.
SIM_PID_BASE = 40000

# Mirrors telemetry.spans first-mark-wins slots.
_PROPOSE, _VOTE, _QC = 0, 1, 2


class SimRoundTrace:
    """``RoundTrace`` duck-type on the virtual clock.

    Emits the same stage names with the same first-mark-wins semantics
    (``propose`` / ``first_vote`` / ``qc`` emit once per round) and the
    same commit-driven GC, but stamps ``clock.now`` instead of
    ``time.perf_counter()`` and appends events to the recorder's current
    epoch instead of a ``TraceBuffer``. Author labels inside
    ``"<author>|<digest>"`` details arrive as ``repr(PublicKey)`` from
    the core; they are translated to committee seat names here so the
    rendered streams (and every alert accusing from them) speak
    ``n000``-style names end to end.
    """

    __slots__ = ("node", "_clock", "_events", "_alias", "_rounds", "_max_rounds")

    def __init__(self, node, clock, events, alias, max_rounds=512):
        self.node = node
        self._clock = clock
        self._events = events  # the owning epoch's event list
        self._alias = alias
        self._rounds: OrderedDict[int, list] = OrderedDict()
        self._max_rounds = max_rounds

    def _translate(self, detail):
        if detail is None:
            return None
        head, sep, tail = detail.partition("|")
        if not sep:
            return detail
        return self._alias.get(head, head) + sep + tail

    def _emit(self, round_, stage, detail=None):
        self._events.append(
            (int(round_), stage, self._clock.now, self._translate(detail))
        )

    def _marks(self, round_):
        marks = self._rounds.get(round_)
        if marks is None:
            if len(self._rounds) >= self._max_rounds:
                self._rounds.popitem(last=False)
            marks = self._rounds[round_] = [None, None, None]
        return marks

    # -- the mark surface Core calls ---------------------------------------

    def mark_propose(self, round_: int, detail: str | None = None) -> None:
        marks = self._marks(round_)
        if marks[_PROPOSE] is None:
            marks[_PROPOSE] = self._clock.now
            self._emit(round_, "propose", detail)

    def mark_verified(self, round_: int) -> None:
        self._emit(round_, "verified")

    def mark_vote_send(self, round_: int) -> None:
        self._emit(round_, "vote_send")

    def mark_vote(self, round_: int) -> None:
        marks = self._marks(round_)
        if marks[_VOTE] is None:
            marks[_VOTE] = self._clock.now
            self._emit(round_, "first_vote")

    def mark_vote_rx(self, round_: int, detail: str) -> None:
        self._emit(round_, "vote_rx", detail)

    def mark_timeout(self, round_: int) -> None:
        self._emit(round_, "timeout")

    def mark_qc(self, round_: int) -> None:
        marks = self._marks(round_)
        if marks[_QC] is None:
            marks[_QC] = self._clock.now
            self._emit(round_, "qc")

    def mark_commit(self, round_: int, detail: str | None = None) -> None:
        self._emit(round_, "commit", detail)
        for r in [r for r in self._rounds if r <= round_]:
            del self._rounds[r]

    # The leader-side broadcast mark the real plane emits from the
    # Proposer actor (``trace_event(..., "propose_send", ...)``), not
    # through RoundTrace; the sim machine calls it from ``_make_block``.
    def propose_send(self, round_: int, detail: str | None = None) -> None:
        self._emit(round_, "propose_send", detail)


class _Epoch:
    """One writer lifetime of one instance: spawn → crash/scenario end."""

    __slots__ = ("node", "pid", "start", "end", "crashed", "events")

    def __init__(self, node, pid, start):
        self.node = node
        self.pid = pid
        self.start = start
        self.end: float | None = None
        self.crashed = False
        self.events: list[tuple] = []


class StreamRecorder:
    """Collects per-instance trace epochs from a ``SimWorld`` run and
    renders them as telemetry stream lines.

    Usage::

        rec = StreamRecorder(interval_s=0.5)
        world = SimWorld(scenario, 4, recorder=rec)
        result = world.run()
        streams = rec.render()            # {instance: [json line, ...]}
        watch, alerts = replay_watchtower(rec)

    The world calls ``bind`` (clock + pk→name alias) at construction,
    ``attach`` per spawn/restart, ``crashed`` per crash, and ``finish``
    when the run ends.
    """

    def __init__(self, interval_s: float = 0.5):
        self.interval_s = float(interval_s)
        self._epochs: dict[str, list[_Epoch]] = {}
        self._alias: dict[str, str] = {}
        self._clock = None
        self.virtual_end: float | None = None

    # -- SimWorld hooks ----------------------------------------------------

    def bind(self, clock, alias: dict[str, str]) -> None:
        self._clock = clock
        self._alias = dict(alias)

    def attach(self, slot) -> None:
        epochs = self._epochs.setdefault(slot.name, [])
        if epochs and epochs[-1].end is None:
            epochs[-1].end = self._clock.now
        epoch = _Epoch(
            node=slot.name,
            pid=SIM_PID_BASE + 100 * slot.index + slot.incarnation,
            start=self._clock.now,
        )
        epochs.append(epoch)
        trace = SimRoundTrace(slot.name, self._clock, epoch.events, self._alias)
        slot.machine.core._trace = trace
        slot.machine.trace = trace

    def crashed(self, name: str) -> None:
        epochs = self._epochs.get(name)
        if epochs and epochs[-1].end is None:
            epochs[-1].end = self._clock.now
            epochs[-1].crashed = True

    def finish(self) -> None:
        self.virtual_end = self._clock.now
        for epochs in self._epochs.values():
            if epochs and epochs[-1].end is None:
                epochs[-1].end = self._clock.now

    # -- rendering ---------------------------------------------------------

    def render(self) -> dict[str, list[str]]:
        """Stream lines per instance, byte-deterministic. Key order in
        the records is fixed at construction and ``json.dumps`` with the
        emitter's separators preserves it, so identical runs render
        identical bytes."""
        return {
            name: [
                json.dumps(obj, separators=(",", ":"))
                for _, obj in self._render_node(name)
            ]
            for name in sorted(self._epochs)
        }

    def timeline(self) -> list[tuple[float, str, dict]]:
        """The merged replay order: ``(emit_ts, instance, record)``
        sorted by emit time (ties broken by instance name, then by
        per-stream line order) — the order a tailing Watchtower would
        observe the lines appear across all per-node files. Records are
        the structured objects (no JSON round-trip: this is the sweep's
        hot path)."""
        merged = []
        for name in sorted(self._epochs):
            for i, (ts, obj) in enumerate(self._render_node(name)):
                merged.append((ts, name, i, obj))
        merged.sort(key=lambda item: (item[0], item[1], item[2]))
        return [(ts, name, obj) for ts, name, _, obj in merged]

    def write(self, directory: str) -> list[str]:
        """Write ``telemetry-<instance>.jsonl`` files (the layout
        ``DirectoryWatch`` and ``telemetry.validate`` expect)."""
        os.makedirs(directory, exist_ok=True)
        paths = []
        for name, lines in self.render().items():
            path = os.path.join(
                directory, f"telemetry-{name.replace('+', '_')}.jsonl"
            )
            with open(path, "w") as f:
                for line in lines:
                    f.write(line + "\n")
            paths.append(path)
        return paths

    def _render_node(self, name: str) -> list[tuple[float, dict]]:
        out: list[tuple[float, dict]] = []
        for epoch in self._epochs[name]:
            self._render_epoch(epoch, out)
        return out

    def _render_epoch(self, epoch: _Epoch, out: list[tuple[float, dict]]) -> None:
        anchor = {"mono": 0.0, "wall": 0.0}
        out.append(
            (
                epoch.start,
                {
                    "schema": META_SCHEMA,
                    "schemas": [
                        SCHEMA, TRACE_SCHEMA, DTRACE_SCHEMA,
                        PROFILE_SCHEMA, ALERT_SCHEMA,
                    ],
                    "node": epoch.node,
                    "pid": epoch.pid,
                    "ts": epoch.start,
                    "anchor": anchor,
                    "interval_s": self.interval_s,
                },
            )
        )
        end = epoch.end if epoch.end is not None else epoch.start
        # Emit boundaries: spawn, every interval after it, and — for a
        # clean shutdown only — a final flush at the epoch end. A crash
        # never reaches its next boundary, so the tail events are lost
        # with the writer (the detectors must work from what was durable,
        # exactly as on the real plane).
        boundaries = [epoch.start]
        k = 1
        while epoch.start + k * self.interval_s < end:
            boundaries.append(epoch.start + k * self.interval_s)
            k += 1
        if not epoch.crashed:
            boundaries.append(end)
        counters = {
            "consensus.commits_total": 0,
            "consensus.proposals_total": 0,
            "consensus.timeouts_total": 0,
            "consensus.votes_total": 0,
        }
        round_hi = 0
        height = 0
        idx = 0
        ev_seq = 0
        events = epoch.events
        for seq, bound in enumerate(boundaries):
            final = (not epoch.crashed) and bound is boundaries[-1] and seq > 0
            delta: list[list] = []
            while idx < len(events) and events[idx][2] <= bound:
                round_, stage, t, detail = events[idx]
                idx += 1
                ev = [ev_seq, epoch.node, round_, stage, t]
                if detail is not None:
                    ev.append(detail)
                delta.append(ev)
                ev_seq += 1
                round_hi = max(round_hi, round_)
                if stage == "commit":
                    counters["consensus.commits_total"] += 1
                    if isinstance(detail, str) and detail.startswith("h"):
                        try:
                            height = max(height, int(detail[1:]))
                        except ValueError:
                            pass
                elif stage == "propose_send":
                    counters["consensus.proposals_total"] += 1
                elif stage == "timeout":
                    counters["consensus.timeouts_total"] += 1
                elif stage == "vote_rx":
                    counters["consensus.votes_total"] += 1
            out.append(
                (
                    bound,
                    {
                        "schema": SCHEMA,
                        "node": epoch.node,
                        "pid": epoch.pid,
                        "seq": seq,
                        "ts": bound,
                        "final": final,
                        "counters": dict(counters),
                        "gauges": {
                            "consensus.last_committed_round": height,
                            "consensus.round": round_hi,
                        },
                        "histograms": {},
                    },
                )
            )
            if delta:
                out.append(
                    (
                        bound,
                        {
                            "schema": TRACE_SCHEMA,
                            "node": epoch.node,
                            "pid": epoch.pid,
                            "anchor": anchor,
                            "evicted": 0,
                            "events": delta,
                        },
                    )
                )


def replay_watchtower(
    recorder: StreamRecorder,
    config=None,
    *,
    label: str = "oracle",
):
    """Feed a recorded run's merged timeline through a fresh
    ``Watchtower`` on the virtual clock. Returns ``(watch, alerts)``;
    alert ``ts`` values are virtual seconds, directly comparable to the
    fault schedule's incident times."""
    watch = Watchtower(config, label=label)
    alerts = watch.feed(
        (obj, name) for _, name, obj in recorder.timeline()
    )
    alerts += watch.flush()
    return watch, alerts
