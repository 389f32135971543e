"""Round-trace spans: follow a block through propose -> vote fan-in ->
QC formation -> commit and record per-stage durations.

One ``RoundTrace`` lives in each consensus core (created only when
telemetry is enabled; the core holds ``None`` otherwise, so the disabled
hot path pays a single ``is not None`` check per event). Marks are
keyed by round; a commit closes every round up to it (the 2-chain rule
commits round r while the core works on r+2), so the table stays bounded
even without commits via the ``max_rounds`` FIFO cap. Rounds that fall
out of that FIFO *without ever committing* are counted
(``consensus.span.evicted_rounds``) — chaos runs shed trace data there
and the loss must be visible, not silent.

Stage semantics (all durations in milliseconds, monotonic clock):

- ``propose -> first_vote``: proposal seen/created to the first vote for
  that round arriving. Only the round's vote collector (the NEXT leader)
  receives votes, so only it observes this and the following span.
- ``first_vote -> qc``: vote fan-in window — first vote to the assembled
  QC passing verification.
- ``qc -> commit``: certificate to 2-chain commit of that round's block
  (spans the two follow-on rounds by construction).
- ``propose -> commit``: the whole round trace end to end.

Cross-node causality: when constructed with an ``events`` sink (a
:class:`~.trace.TraceBuffer`) and a ``node`` label, every mark — plus the
per-node-only ``verified``/``vote_send``/``vote_rx``/``timeout`` marks
that have no local span — is ALSO recorded as a trace event, so
``benchmark/trace_assemble.py`` can merge all nodes' streams into one
causal timeline per block and attribute milliseconds to each cross-node
edge, and ``hotstuff_tpu/telemetry/watchtower.py`` can score per-peer
behavior (vote participation, commit-height lag, timeout emission,
conflicting-vote evidence) from the same stream while it is written.

Port copy of ``hotstuff_tpu/telemetry/spans.py``, unchanged.
"""

from __future__ import annotations

import time
from collections import OrderedDict

from . import profiler as pyprof
from .registry import DURATION_MS_BUCKETS, FINE_DURATION_MS_BUCKETS, Registry

_PROPOSE, _VOTE, _QC = 0, 1, 2


class RoundTrace:
    __slots__ = (
        "_rounds", "_max_rounds", "_h_pv", "_h_vq", "_h_qc", "_h_pc",
        "_h_pc_faulted", "_c_faulted", "_c_evicted", "node", "_events",
    )

    #: fault annotation hook: a zero-arg callable set by
    #: ``faultline.runtime.install`` that reports whether fault injection
    #: is currently active. Rounds whose commit closes under active
    #: faults are recorded into the ``...propose_to_commit_faulted_ms``
    #: histogram instead of the clean one (and counted), so chaos runs
    #: separate degraded-round latency from steady-state latency.
    fault_flag = None

    def __init__(
        self,
        registry: Registry,
        max_rounds: int = 512,
        node: str = "",
        events=None,
    ) -> None:
        # round -> [propose_ts, first_vote_ts, qc_ts] (None until marked)
        self._rounds: OrderedDict[int, list[float | None]] = OrderedDict()
        self._max_rounds = max_rounds
        self.node = node
        self._events = events  # TraceBuffer or None
        h = registry.histogram
        # The two sub-round spans use the fine (µs-resolving) buckets:
        # at small committees and on the native path they sit well under
        # the coarse scale's 0.1 ms floor.
        self._h_pv = h(
            "consensus.span.propose_to_first_vote_ms", FINE_DURATION_MS_BUCKETS
        )
        self._h_vq = h(
            "consensus.span.first_vote_to_qc_ms", FINE_DURATION_MS_BUCKETS
        )
        self._h_qc = h("consensus.span.qc_to_commit_ms", DURATION_MS_BUCKETS)
        self._h_pc = h("consensus.span.propose_to_commit_ms", DURATION_MS_BUCKETS)
        self._h_pc_faulted = h(
            "consensus.span.propose_to_commit_faulted_ms", DURATION_MS_BUCKETS
        )
        self._c_faulted = registry.counter("consensus.span.faulted_rounds")
        self._c_evicted = registry.counter("consensus.span.evicted_rounds")

    def _emit(
        self, round_: int, stage: str, t: float, detail: str | None = None
    ) -> None:
        if self._events is not None:
            self._events.record(self.node, round_, stage, t, detail)

    def _marks(self, round_: int) -> list[float | None]:
        marks = self._rounds.get(round_)
        if marks is None:
            if len(self._rounds) >= self._max_rounds:
                # FIFO overflow: the evicted round never committed (a
                # commit would have GC'd it below) — count the loss.
                self._rounds.popitem(last=False)
                self._c_evicted.inc()
            marks = self._rounds[round_] = [None, None, None]
        return marks

    # Each mark flips the sampling profiler's per-thread stage tag to the
    # edge whose work FOLLOWS the mark (profiler samples between two
    # marks get blamed on the edge between them — the join key
    # benchmark/profile_assemble.py uses against the trace edges). One
    # module-attribute read per mark when no profiler session is live.

    def mark_propose(self, round_: int, detail: str | None = None) -> None:
        if pyprof.TAGGING:
            pyprof.set_thread_stage("verify")
        marks = self._marks(round_)
        if marks[_PROPOSE] is None:
            marks[_PROPOSE] = t = time.perf_counter()
            self._emit(round_, "propose", t, detail)

    def mark_verified(self, round_: int) -> None:
        """The proposal's certificates passed verification on this node
        (event-only: the cross-node assembler attributes the
        receive→verified edge; there is no local histogram)."""
        if pyprof.TAGGING:
            pyprof.set_thread_stage("vote")
        self._emit(round_, "verified", time.perf_counter())

    def mark_vote_send(self, round_: int) -> None:
        """This node created and dispatched its vote (event-only)."""
        if pyprof.TAGGING:
            pyprof.set_thread_stage("idle")
        self._emit(round_, "vote_send", time.perf_counter())

    def mark_vote(self, round_: int) -> None:
        if pyprof.TAGGING:
            pyprof.set_thread_stage("fanin")
        marks = self._marks(round_)
        if marks[_VOTE] is None:
            marks[_VOTE] = t = time.perf_counter()
            self._emit(round_, "first_vote", t)

    def mark_vote_rx(self, round_: int, detail: str) -> None:
        """One admitted vote arrived at this collector (event-only).
        ``detail`` is ``"<author>|<block digest>"`` — the per-peer
        accountability evidence (vote participation, conflicting-vote
        detection) the watchtower scores from."""
        self._emit(round_, "vote_rx", time.perf_counter(), detail)

    def mark_timeout(self, round_: int) -> None:
        """This node fired a local timeout for ``round_`` (event-only:
        the watchtower's timeout-emission-rate and grind evidence)."""
        self._emit(round_, "timeout", time.perf_counter())

    def mark_qc(self, round_: int) -> None:
        if pyprof.TAGGING:
            pyprof.set_thread_stage("qc_to_commit")
        marks = self._marks(round_)
        if marks[_QC] is None:
            marks[_QC] = t = time.perf_counter()
            self._emit(round_, "qc", t)
            if marks[_VOTE] is not None:
                self._h_vq.observe((marks[_QC] - marks[_VOTE]) * 1e3)
            if marks[_PROPOSE] is not None and marks[_VOTE] is not None:
                self._h_pv.observe((marks[_VOTE] - marks[_PROPOSE]) * 1e3)

    def mark_commit(self, round_: int, detail: str | None = None) -> None:
        """Close round ``round_`` (and GC every older round: commits are
        monotone, so anything below the committed round is finished).
        ``detail`` carries the node's commit height as ``"h<round>"`` so
        stream analyzers read the frontier off the event itself."""
        if pyprof.TAGGING:
            pyprof.set_thread_stage("idle")
        now = time.perf_counter()
        marks = self._rounds.get(round_)
        self._emit(round_, "commit", now, detail)
        if marks is not None:
            if marks[_QC] is not None:
                self._h_qc.observe((now - marks[_QC]) * 1e3)
            if marks[_PROPOSE] is not None:
                flag = RoundTrace.fault_flag
                if flag is not None and flag():
                    self._c_faulted.inc()
                    self._h_pc_faulted.observe((now - marks[_PROPOSE]) * 1e3)
                else:
                    self._h_pc.observe((now - marks[_PROPOSE]) * 1e3)
        while self._rounds:
            oldest = next(iter(self._rounds))
            if oldest > round_:
                break
            del self._rounds[oldest]

    def open_rounds(self) -> int:
        return len(self._rounds)
