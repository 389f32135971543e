"""Watchtower: the ONLINE observability plane — streaming detection and
per-peer accountability scoring over the telemetry streams as they are
written.

Everything else in this package is post-hoc: ``trace_assemble``,
``profile_assemble``, the SLO engine and the soak verdict all judge a
run after it ends, which is how the two committed incidents
(``results/soak-slo-n4-60s-chaos7.json``: post-heal vote withholding;
``soak-slo-n4-60s-chaos3.json``: a laggard that commits nothing in the
tail) were found minutes after the bytes explaining them were on disk.
The :class:`Watchtower` consumes the same records *incrementally* — one
``ingest_record`` call per stream line, fed by a tail-follower
(``benchmark.logs.StreamFollower``) or a replay loop — and maintains:

- **per-peer health scores** (:meth:`Watchtower.scoreboard`):
  vote-participation rate per round window, propose→vote turnaround
  percentile, commit-height lag vs. the quorum frontier,
  timeout-emission rate, equivocation evidence;
- **online detectors** that emit structured ``hotstuff-alert-v1``
  records naming the accused peers, the evidence window, and a
  confidence — see the detector catalog below;
- an **alert hook** (``on_alert``) for capture: an
  :class:`AlertCapture` dumps the flight record plus a bounded
  profiler session at the moment of detection, so the evidence is on
  disk when a human arrives.

Evidence model: trace events carry ``(seq, node, round, stage, t_mono
[, detail])`` where ``node`` is the OBSERVER. ``vote_rx`` details name
``"<author>|<block digest>"`` (who voted, for what — recorded by the
round's collector), ``propose``/``propose_send`` details name
``"<author>|<digest>"``, ``commit`` details carry ``"h<height>"``.
Accusations are therefore grounded in what *other* nodes observed
wherever possible — a withholding voter is one whose votes stop
arriving at collectors, not one who merely stops self-reporting.

Detector catalog (all tunable via :class:`WatchtowerConfig`):

- ``silent_voter``: a peer whose vote-participation rate stays under
  ``silent_participation_max`` for ``silent_windows`` consecutive
  closed windows while at least two other peers vote normally. The
  chaos-seed-7 signature (withholding post-heal); also fires on a
  crashed peer — the evidence says whether the peer was otherwise
  alive (``alive: true`` == verifying/proposing but not voting).
- ``laggard``: a peer whose commit height does not advance for
  ``laggard_windows`` consecutive windows while the quorum frontier
  advances, with lag ≥ ``laggard_min_lag``. The chaos-seed-3
  signature ("commits nothing in the tail").
- ``grinding_leader``: with the window's timeout rate elevated, a
  peer whose proposals repeatedly fail to commit
  (``mode: "uncommitted_proposals"``) or a peer that is demonstrably
  alive but never proposes while others do (``mode:
  "no_proposals"`` — the faultline ``silent_leader`` behavior).
- ``partitioned_clique``: the window's communication graph (vote
  author→collector, proposer→receiver edges) splits into ≥2
  connected components and at least one component shows liveness
  effort (votes/timeouts) without commits while another commits —
  the accused are the cut-off clique.
- ``slope_breach``: per-node RSS / store-size growth rate over a
  sliding window exceeds the bound — the same ``gauge_growth``
  semantics as :mod:`hotstuff_tpu_torch.telemetry.slo`, evaluated online.
- ``sync_stall``: a peer whose state-sync probe loop stays active
  (``statesync.active``) with a frontier gap ≥ ``sync_stall_min_gap``
  that is NOT closing for ``sync_stall_budget_s`` — a rejoining
  replica stuck behind the quorum (peers refusing to serve it, a
  snapshot it keeps rejecting, or a truncation horizon nobody can
  bridge). A closing gap re-anchors the budget: slow-but-progressing
  catch-up never fires.
- ``equivocation``: conflicting-vote or conflicting-proposal evidence
  — the same (author, round) seen with two different digests.
  Immediate, confidence 1.0: this is cryptographic-grade evidence of
  byzantine behavior, not a statistical inference.

Validation is the point: ``benchmark/detector_bench.py`` replays seeded
faultline schedules (the fault plan IS the label set) through this
exact ingest path and scores precision / recall / time-to-detection;
``benchmark/watchtower_smoke.py`` gates the attached-vs-detached
overhead and zero-false-positive behavior on fault-free runs in CI.

Port copy of ``hotstuff_tpu/telemetry/watchtower.py``: every detector of
the catalog, the same ``hotstuff-alert-v1`` fields and the same
scoreboard, so that one stream gives the same alerts in either package.
The scripts named above are the reference's; the port's ``chip_smoke.py``
feeds a scenario's stream through ``ingest_record`` one line at a time.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass

ALERT_SCHEMA = "hotstuff-alert-v1"
CAPTURE_SCHEMA = "hotstuff-capture-v1"

DETECTORS = (
    "silent_voter",
    "laggard",
    "grinding_leader",
    "partitioned_clique",
    "slope_breach",
    "digest_queue_starvation",
    "sync_stall",
    "equivocation",
)

#: Version of the detector catalog above (bump whenever a detector is
#: added, removed, or its evidence/confidence semantics change). Stamped
#: into every alert and every detector_bench/detector_sweep verdict next
#: to the config fingerprint, so scorecards are comparable across runs:
#: same (catalog, config hash) ⇒ same detection semantics.
DETECTOR_CATALOG_VERSION = 1

#: trace stages that constitute peer-behavior evidence. Anything else in
#: the ring (faultline injection audit events, future stages) must not
#: mint phantom peers or skew scores — observed live: the "faultline"
#: injection label being accused of withholding votes.
_PROTOCOL_STAGES = frozenset(
    (
        "propose_send", "propose", "verified", "vote_send", "vote_rx",
        "first_vote", "qc", "commit", "timeout",
    )
)


def validate_alert_record(obj) -> list[str]:
    """Schema check mirroring ``validate_snapshot``; returns problems."""
    problems: list[str] = []
    if not isinstance(obj, dict):
        return [f"alert record is {type(obj).__name__}, not an object"]
    if obj.get("schema") != ALERT_SCHEMA:
        problems.append(
            f"schema is {obj.get('schema')!r}, want {ALERT_SCHEMA!r}"
        )
    if obj.get("detector") not in DETECTORS:
        problems.append(f"unknown detector {obj.get('detector')!r}")
    accused = obj.get("accused")
    if (
        not isinstance(accused, list)
        or not accused
        or not all(isinstance(a, str) for a in accused)
    ):
        problems.append("accused missing or not a non-empty list of strings")
    conf = obj.get("confidence")
    if not isinstance(conf, (int, float)) or not (0.0 <= conf <= 1.0):
        problems.append("confidence missing or not in [0, 1]")
    if not isinstance(obj.get("ts"), (int, float)):
        problems.append("ts missing or not a number")
    if not isinstance(obj.get("evidence"), dict):
        problems.append("evidence missing or not an object")
    if not isinstance(obj.get("config"), str) or not obj.get("config"):
        problems.append("config fingerprint missing or not a string")
    if not isinstance(obj.get("catalog"), int):
        problems.append("catalog version missing or not an int")
    window = obj.get("window")
    if not isinstance(window, dict) or not all(
        isinstance(window.get(k), (int, float)) for k in ("t_lo", "t_hi")
    ):
        problems.append("window missing t_lo/t_hi")
    return problems


@dataclass
class WatchtowerConfig:
    """Detection knobs. Defaults are tuned on the seeded faultline
    schedules in ``benchmark/detector_bench.py`` (chaos seeds 3/7 plus
    fault-free controls) — change them there first."""

    #: close the evidence window after this many newly-seen rounds...
    window_rounds: int = 16
    #: ...or after this much wall time, whichever comes first.
    window_s: float = 5.0
    #: rounds whose newest event is younger than this are held back at
    #: window close (late cross-stream events are normal, not evidence).
    #: Raised automatically to ~1.2x the largest emit interval any
    #: stream's meta record declares: multi-process nodes flush commits
    #: in interval-sized bursts, and judging a round before every
    #: stream's burst covering it can have landed reads emission lag as
    #: misbehavior (observed live: three of four healthy soak nodes
    #: accused as laggards).
    settle_s: float = 1.0
    #: the emit-interval multiple a round must have settled for before a
    #: window will judge it (effective settle = max(settle_s,
    #: settle_multiplier × largest declared emit interval)). Was a
    #: hard-coded 1.2; the detector_sweep searches it.
    settle_multiplier: float = 1.2
    #: alerts below this confidence are suppressed at the source (0.0 =
    #: keep everything). The low-confidence branches (partition
    #: global_stall at 0.5, grinding no_proposals at 0.6) are the main
    #: false-alarm producers on short incidents; the sweep tunes this.
    alert_min_confidence: float = 0.0
    #: windows with fewer vote-active rounds than this are not judged.
    min_rounds: int = 4
    silent_participation_max: float = 0.10
    silent_windows: int = 2
    laggard_windows: int = 2
    laggard_min_lag: int = 8
    laggard_min_frontier_advance: int = 3
    #: a peer is only a laggard once its own stream has demonstrably
    #: lived on (events arriving) for this long WITHOUT a commit — an
    #: emission-lagged healthy stream shows frozen heights too, but its
    #: commits and its liveness signs go stale together. Effective value
    #: is at least 2x the settled emit interval.
    laggard_stale_s: float = 12.0
    grind_timeout_rate: float = 0.25
    grind_min_proposals: int = 2
    #: how long a peer must have gone WITHOUT any observed proposal
    #: before the "alive but never proposing" grinding mode may accuse
    #: it. A single evidence window during a timeout grind spans only a
    #: couple of rounds — far less than one leader rotation — so
    #: "didn't propose in-window" alone is the dominant wrong-peer
    #: attribution in the offline sweep: rotation simply never reached
    #: the accused. Cross-window proposal staleness discriminates: even
    #: mid-grind an honest peer proposes every rotation (~committee
    #: size seconds), while the silent leader stays stale for its whole
    #: fault. 0 keeps the legacy gate (in-window evidence only).
    grind_proposal_stale_s: float = 0.0
    rss_growth_max_bytes_per_s: float = 8 * 1024 * 1024
    store_growth_max_bytes_per_s: float = 32 * 1024 * 1024
    slope_window_s: float = 10.0
    #: sustained growth of the proposer's certified-digest queue
    #: (digests/s over slope_window_s) before ordering is judged to be
    #: starving behind ingest. A queue that merely sits deep but drains
    #: as fast as it fills does not fire — growth is the signal.
    digest_queue_growth_max_per_s: float = 50.0
    #: a state-syncing peer may lag the quorum frontier by at least this
    #: many rounds before the stall budget starts counting...
    sync_stall_min_gap: int = 8
    #: ...and must fail to close that gap for this long before the
    #: ``sync_stall`` detector fires (re-anchored whenever it shrinks).
    sync_stall_budget_s: float = 20.0
    #: per-(detector, accused-set) re-alert backoff, seconds.
    cooldown_s: float = 15.0
    #: alert ring bound (oldest dropped; never grows without bound).
    max_alerts: int = 1024
    #: per-peer turnaround sample reservoir per window history.
    history_windows: int = 8

    @classmethod
    def from_dict(cls, d: dict) -> "WatchtowerConfig":
        known = {f for f in cls.__dataclass_fields__}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown watchtower config keys: {sorted(unknown)}")
        return cls(**d)

    def fingerprint(self) -> str:
        """Short content hash of every knob — the ``config`` field every
        alert and sweep verdict carries. Field defaults count: adding a
        knob changes the fingerprint of the default config, which is the
        point (the detection surface changed)."""
        import hashlib

        payload = json.dumps(
            {k: getattr(self, k) for k in sorted(self.__dataclass_fields__)},
            sort_keys=True,
            separators=(",", ":"),
        )
        return hashlib.sha256(payload.encode()).hexdigest()[:12]

    @classmethod
    def preset(cls, name: str) -> "WatchtowerConfig":
        """Load a committed preset from ``telemetry/presets/<name>.json``
        (e.g. ``tuned-n4``, produced by ``benchmark.detector_sweep``)."""
        path = os.path.join(
            os.path.dirname(os.path.abspath(__file__)),
            "presets",
            f"{name}.json",
        )
        with open(path) as f:
            doc = json.load(f)
        return cls.from_dict(doc["config"] if "config" in doc else doc)


class _Round:
    """Evidence accumulated for one protocol round, across all streams."""

    __slots__ = (
        "votes", "proposes", "propose_t", "vote_send_t", "commit_nodes",
        "timeouts", "propose_senders", "edges", "first_wall", "last_wall",
    )

    def __init__(self) -> None:
        self.votes: dict[str, set[str]] = {}        # author -> digests
        self.proposes: dict[str, set[str]] = {}     # author -> digests
        self.propose_senders: set[str] = set()      # leaders that broadcast
        self.propose_t: dict[str, float] = {}       # receiver -> wall t
        self.vote_send_t: dict[str, float] = {}     # voter -> wall t
        self.commit_nodes: dict[str, float] = {}    # node -> wall t
        self.timeouts: dict[str, int] = {}          # node -> count
        self.edges: set[frozenset] = set()          # observed comms pairs
        self.first_wall = float("inf")
        self.last_wall = 0.0

    def touch(self, t: float) -> None:
        if t < self.first_wall:
            self.first_wall = t
        if t > self.last_wall:
            self.last_wall = t


class _Window:
    """One closed evidence window (a batch of settled rounds)."""

    __slots__ = (
        "rounds", "t_lo", "t_hi", "vote_active_rounds", "voted_rounds",
        "turnaround", "proposals", "proposals_committed", "timeouts",
        "commits", "edges", "active_peers",
    )

    def __init__(self) -> None:
        self.rounds: list[int] = []
        self.t_lo = float("inf")
        self.t_hi = 0.0
        self.vote_active_rounds = 0
        self.voted_rounds: dict[str, int] = defaultdict(int)
        self.turnaround: dict[str, list[float]] = defaultdict(list)
        self.proposals: dict[str, int] = defaultdict(int)
        self.proposals_committed: dict[str, int] = defaultdict(int)
        self.timeouts: dict[str, int] = defaultdict(int)
        self.commits: dict[str, int] = defaultdict(int)
        self.edges: set[frozenset] = set()
        self.active_peers: set[str] = set()


def _pct(sorted_vals: list[float], q: float) -> float | None:
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


class Watchtower:
    """Streaming analyzer over telemetry records (see module docstring).

    Feed it every parsed stream line via :meth:`ingest_record` (any
    schema — it routes internally) and call :meth:`tick` periodically
    (live mode) or :meth:`flush` at end of stream (replay mode). Both
    return the alerts fired by that call; :attr:`alerts` keeps the
    bounded full list. Single-writer: one thread ingests; ``alerts``
    and ``scoreboard()`` may be read from others (guarded)."""

    def __init__(
        self,
        config: WatchtowerConfig | None = None,
        *,
        alias: dict[str, str] | None = None,
        on_alert=None,
        label: str = "",
    ) -> None:
        self.config = config or WatchtowerConfig()
        self._config_hash = self.config.fingerprint()
        self.alias = dict(alias or {})
        self.on_alert = on_alert
        self.label = label
        self.alerts: list[dict] = []
        self._alerts_lock = threading.Lock()
        self._alert_seq = 0
        self._last_alert_at: dict[tuple, float] = {}

        self._rounds: dict[int, _Round] = {}
        self._max_round_seen = 0
        self._rounds_since_close = 0
        self._last_close_wall: float | None = None
        self._now = 0.0  # newest wall time observed (events or ticks)

        # Per-peer rolling state (survives window closes).
        self._peers: set[str] = set()
        self._heights: dict[str, int] = {}
        self._last_commit_seen: dict[str, float] = {}
        # Anchored at first sight like _last_commit_seen: staleness is
        # "silent since we started watching", never "since epoch".
        self._last_proposal_seen: dict[str, float] = {}
        # Last wall time one of the peer's proposed rounds was seen to
        # commit — healthy-leadership evidence for the grinding
        # detector's uncommitted_proposals mode (a proposal's commit
        # lands ~2 rounds later; judging a single window accuses honest
        # leaders for ordinary 2-chain commit lag under timeouts).
        self._last_proposal_commit_seen: dict[str, float] = {}
        self._max_interval = 0.0  # largest emit interval any meta declares
        self._prev_heights: dict[str, int] = {}
        self._prev_frontier = 0
        self._silent_streak: dict[str, int] = defaultdict(int)
        self._laggard_streak: dict[str, int] = defaultdict(int)
        self._last_seen: dict[str, float] = {}
        self._windows: deque[_Window] = deque(
            maxlen=self.config.history_windows
        )
        self._equivocations: dict[str, int] = defaultdict(int)

        # Per-stream state: wall-clock anchors and resource history.
        self._anchors: dict[str, float] = {}  # source -> wall-mono offset
        self._resources: dict[str, deque] = {}  # node -> (ts, pid, gauges)
        # Proposer digest-queue depth history per node (ROADMAP 3b: the
        # ordering-starved-behind-ingest inversion, judged by slope).
        self._digest_queue: dict[str, deque] = {}  # node -> (ts, pid, depth)
        # State-sync stall anchors: node -> (first_ts, pid, gap at anchor).
        self._sync_state: dict[str, tuple] = {}
        # Conveyor worker health per stream node (latest snapshot wins).
        self._worker_stats: dict[str, dict] = {}
        self._ingress_peak: dict[str, float] = {}
        self._meta: dict[str, dict] = {}

    # -- ingestion -----------------------------------------------------------

    def ingest_record(self, obj: dict, source: str = "") -> list[dict]:
        """Route one parsed stream record; returns alerts fired now."""
        schema = obj.get("schema")
        fired: list[dict] = []
        if schema == "hotstuff-trace-v1":
            anchor = obj.get("anchor") or {}
            if all(
                isinstance(anchor.get(k), (int, float))
                for k in ("mono", "wall")
            ):
                off = anchor["wall"] - anchor["mono"]
                self._anchors[source] = off
            else:
                off = self._anchors.get(source)
            if off is None:
                return fired  # no way onto the shared timeline
            for ev in obj.get("events", ()):
                detail = ev[5] if len(ev) > 5 else None
                fired += self._ingest_event(
                    ev[1], ev[2], ev[3], ev[4] + off, detail
                )
        elif schema == "hotstuff-telemetry-v1":
            fired += self._ingest_snapshot(obj, source)
        elif schema == "hotstuff-meta-v1":
            self._meta[source or obj.get("node", "")] = obj
            interval = obj.get("interval_s")
            if isinstance(interval, (int, float)) and interval > self._max_interval:
                self._max_interval = float(interval)
        # profile / alert / unknown records: not evidence, ignored.
        fired += self._maybe_close()
        return fired

    def _ingest_event(
        self, node: str, round_: int, stage: str, t: float, detail
    ) -> list[dict]:
        fired: list[dict] = []
        if stage not in _PROTOCOL_STAGES:
            return fired
        if t > self._now:
            self._now = t
        if self._last_close_wall is None:
            self._last_close_wall = t
        if node not in self._peers:
            self._peers.add(node)
            self._last_commit_seen.setdefault(node, t)
            self._last_proposal_seen.setdefault(node, t)
            self._last_proposal_commit_seen.setdefault(node, t)
        self._last_seen[node] = t
        if round_ > self._max_round_seen:
            self._max_round_seen = round_
        rd = self._rounds.get(round_)
        if rd is None:
            rd = self._rounds[round_] = _Round()
            self._rounds_since_close += 1
        rd.touch(t)

        if stage == "vote_rx" and detail:
            author, sep, digest = detail.partition("|")
            if not (sep and author and digest):
                return fired  # malformed detail: not evidence, not a peer
            if author not in self._peers:
                self._peers.add(author)
                self._last_commit_seen.setdefault(author, t)
                self._last_proposal_seen.setdefault(author, t)
                self._last_proposal_commit_seen.setdefault(author, t)
            self._last_seen[author] = max(self._last_seen.get(author, 0), t)
            seen = rd.votes.setdefault(author, set())
            if digest not in seen and seen:
                fired += self._alert(
                    "equivocation",
                    [author],
                    1.0,
                    t,
                    {"round": round_, "kind": "conflicting_votes",
                     "digests": sorted(seen | {digest})[:4],
                     "observer": node},
                    window=(t, t),
                )
                self._equivocations[author] += 1
            seen.add(digest)
            # The vote crossed author -> this collector: a live edge of
            # the communication graph (partition detection).
            rd.edges.add(frozenset((author, node)))
        elif stage in ("propose", "propose_send") and detail:
            author, sep, digest = detail.partition("|")
            if not (sep and author and digest):
                author = None  # malformed detail: keep the timing evidence
        else:
            author = None
        if stage in ("propose", "propose_send") and author is not None:
            self._peers.add(author)
            # Exoneration evidence must come from ANOTHER node's stream:
            # a silent leader's own telemetry still self-reports
            # propose_send (it builds and "sends"; the network eats it),
            # and a byzantine node can claim anything about itself. Only
            # a proposal some other node actually RECEIVED proves the
            # peer proposed.
            if (
                stage == "propose"
                and author != node
                and t > self._last_proposal_seen.get(author, 0)
            ):
                self._last_proposal_seen[author] = t
            seen = rd.proposes.setdefault(author, set())
            if digest not in seen and seen:
                fired += self._alert(
                    "equivocation",
                    [author],
                    1.0,
                    t,
                    {"round": round_, "kind": "conflicting_proposals",
                     "digests": sorted(seen | {digest})[:4],
                     "observer": node},
                    window=(t, t),
                )
                self._equivocations[author] += 1
            seen.add(digest)

        if stage == "propose_send":
            rd.propose_senders.add(node)
        elif stage == "propose":
            if node not in rd.propose_t:
                rd.propose_t[node] = t
        elif stage == "vote_send":
            if node not in rd.vote_send_t:
                rd.vote_send_t[node] = t
        elif stage == "commit":
            rd.commit_nodes.setdefault(node, t)
            if t > self._last_commit_seen.get(node, 0):
                self._last_commit_seen[node] = t
            height = round_
            if isinstance(detail, str) and detail.startswith("h"):
                try:
                    height = max(height, int(detail[1:]))
                except ValueError:
                    pass
            if height > self._heights.get(node, 0):
                self._heights[node] = height
        elif stage == "timeout":
            rd.timeouts[node] = rd.timeouts.get(node, 0) + 1
        return fired

    def _ingest_snapshot(self, snap: dict, source: str) -> list[dict]:
        fired: list[dict] = []
        ts = snap.get("ts")
        if not isinstance(ts, (int, float)):
            return fired
        if ts > self._now:
            self._now = ts
        node = snap.get("node") or source
        gauges = snap.get("gauges") or {}
        # Conveyor data-plane health per node: store depth + shed/cert
        # counters feed the scoreboard's dataplane section, so an SLO
        # breach under load names which node's workers were drowning.
        counters = snap.get("counters") or {}
        worker: dict[str, float] = {}
        for key, label in (
            ("mempool.worker.store_depth", "store_depth"),
            ("mempool.worker.ingress_depth", "ingress_depth"),
        ):
            v = gauges.get(key)
            if isinstance(v, (int, float)):
                worker[label] = v
        for key, label in (
            ("mempool.worker.ingress_tx", "ingress_tx"),
            ("mempool.worker.shed_tx", "shed_tx"),
            ("mempool.worker.batches_sealed", "batches_sealed"),
            ("mempool.worker.certs_formed", "certs_formed"),
            ("mempool.worker.throttle_events", "throttle_events"),
            ("mempool.resolver.unresolved", "resolver_unresolved"),
            ("net.native.ingress.reads", "ingress_reads"),
            ("net.native.ingress.frames", "ingress_frames"),
            ("net.native.ingress.batches", "ingress_batches"),
        ):
            v = counters.get(key)
            if isinstance(v, (int, float)):
                worker[label] = v
        if worker:
            depth = worker.get("ingress_depth")
            if isinstance(depth, (int, float)):
                self._ingress_peak[node] = max(
                    self._ingress_peak.get(node, 0.0), depth
                )
            self._worker_stats[node] = worker
        fired += self._check_digest_queue(node, snap, gauges, ts)
        fired += self._check_sync_stall(node, snap, gauges, ts)
        tracked = {
            k: gauges[k]
            for k in ("resource.rss_bytes", "resource.store_bytes")
            if isinstance(gauges.get(k), (int, float))
        }
        if not tracked:
            return fired
        hist = self._resources.setdefault(node, deque(maxlen=64))
        pid = snap.get("pid")
        if hist and hist[-1][1] != pid:
            hist.clear()  # restart: a fresh process, not growth
        hist.append((ts, pid, tracked))
        cfg = self.config
        bounds = {
            "resource.rss_bytes": cfg.rss_growth_max_bytes_per_s,
            "resource.store_bytes": cfg.store_growth_max_bytes_per_s,
        }
        # Oldest sample at least slope_window_s back bounds the slope.
        base = None
        for old_ts, _pid, old in hist:
            if ts - old_ts >= cfg.slope_window_s:
                base = (old_ts, old)
            else:
                break
        if base is None:
            return fired
        for metric, bound in bounds.items():
            a, b = tracked.get(metric), base[1].get(metric)
            if a is None or b is None:
                continue
            secs = ts - base[0]
            growth = (a - b) / secs if secs > 0 else 0.0
            if growth > bound:
                fired += self._alert(
                    "slope_breach",
                    [node],
                    min(1.0, 0.5 + 0.5 * (growth / bound - 1.0)),
                    ts,
                    {"metric": metric,
                     "growth_bytes_per_s": round(growth, 1),
                     "max_bytes_per_s": bound,
                     "window_s": round(secs, 1)},
                    window=(base[0], ts),
                )
        return fired

    def _check_digest_queue(
        self, node: str, snap: dict, gauges: dict, ts: float
    ) -> list[dict]:
        """Sustained growth of ``consensus.proposer.digest_queue_depth``
        — certified digests arriving faster than proposals drain them,
        the ordering-starves-behind-ingest inversion the data plane
        exists to prevent. Same slope machinery as the resource
        detectors: base sample ≥ slope_window_s back, growth judged in
        digests/s, a process restart clears the history."""
        depth = gauges.get("consensus.proposer.digest_queue_depth")
        if not isinstance(depth, (int, float)):
            return []
        hist = self._digest_queue.setdefault(node, deque(maxlen=64))
        pid = snap.get("pid")
        if hist and hist[-1][1] != pid:
            hist.clear()
        hist.append((ts, pid, depth))
        cfg = self.config
        base = None
        for old_ts, _pid, old_depth in hist:
            if ts - old_ts >= cfg.slope_window_s:
                base = (old_ts, old_depth)
            else:
                break
        if base is None:
            return []
        secs = ts - base[0]
        growth = (depth - base[1]) / secs if secs > 0 else 0.0
        bound = cfg.digest_queue_growth_max_per_s
        if growth <= bound:
            return []
        return self._alert(
            "digest_queue_starvation",
            [node],
            min(1.0, 0.5 + 0.5 * (growth / bound - 1.0)),
            ts,
            {"metric": "consensus.proposer.digest_queue_depth",
             "depth": depth,
             "growth_per_s": round(growth, 1),
             "max_per_s": bound,
             "window_s": round(secs, 1)},
            window=(base[0], ts),
        )

    def _check_sync_stall(
        self, node: str, snap: dict, gauges: dict, ts: float
    ) -> list[dict]:
        """A peer stuck in state-sync: probe loop active with a frontier
        gap that is not closing. Anchored on the first qualifying
        snapshot; re-anchored whenever the gap shrinks (progress resets
        the budget) or the process restarts."""
        cfg = self.config
        active = gauges.get("statesync.active")
        if not isinstance(active, (int, float)) or not active:
            self._sync_state.pop(node, None)
            return []
        gap = gauges.get("statesync.frontier_gap")
        gap = gap if isinstance(gap, (int, float)) else 0
        if gap < cfg.sync_stall_min_gap:
            self._sync_state.pop(node, None)
            return []
        pid = snap.get("pid")
        anchor = self._sync_state.get(node)
        if anchor is None or anchor[1] != pid:
            self._sync_state[node] = (ts, pid, gap)
            return []
        first_ts, _pid, anchor_gap = anchor
        if gap < anchor_gap:
            # Catch-up is working, just slow: restart the budget from
            # the improved gap so only a STALL — not a long but
            # progressing sync — ever fires.
            self._sync_state[node] = (ts, pid, gap)
            return []
        elapsed = ts - first_ts
        if elapsed < cfg.sync_stall_budget_s:
            return []
        return self._alert(
            "sync_stall",
            [node],
            min(1.0, 0.5 + 0.5 * (elapsed / cfg.sync_stall_budget_s - 1.0)),
            ts,
            {"frontier_gap": gap,
             "anchor_gap": anchor_gap,
             "stalled_s": round(elapsed, 1),
             "budget_s": cfg.sync_stall_budget_s},
            window=(first_ts, ts),
        )

    # -- windowing -----------------------------------------------------------

    def tick(self, now: float | None = None) -> list[dict]:
        """Periodic evaluation hook for live followers. ``now`` defaults
        to the newest wall time observed (replay) or ``time.time()``
        should the caller pass it (live)."""
        if now is not None and now > self._now:
            self._now = now
        return self._maybe_close()

    def feed(self, records, now: float | None = None) -> list[dict]:
        """Batch ingestion: drive a whole stream (or a merged timeline)
        through the tower in one call — no tail-follower, no sleeps.
        ``records`` yields parsed stream objects, or ``(obj, source)``
        pairs when per-source anchor keying matters (multi-stream
        replay). Windows close inline as the observed wall clock
        advances, exactly as they would under a live follower; a final
        ``tick(now)`` (``now=None`` → the newest observed wall time)
        judges anything due. Replaying a full schedule is milliseconds —
        this is Oracle's inner loop (``benchmark.detector_sweep``)."""
        fired: list[dict] = []
        for rec in records:
            if isinstance(rec, tuple):
                obj, source = rec
            else:
                obj, source = rec, ""
            fired.extend(self.ingest_record(obj, source))
        fired.extend(self.tick(now))
        return fired

    def flush(self) -> list[dict]:
        """End of stream: close every pending round and judge."""
        return self._maybe_close(force=True)

    def _effective_settle(self) -> float:
        # Streams flush in emit-interval bursts: a round is only fully
        # observable once every stream's burst covering it landed.
        return max(
            self.config.settle_s,
            self.config.settle_multiplier * self._max_interval,
        )

    def _maybe_close(self, force: bool = False) -> list[dict]:
        cfg = self.config
        if self._last_close_wall is None:
            return []
        due = (
            force
            or self._rounds_since_close >= cfg.window_rounds
            or (
                self._now - self._last_close_wall >= cfg.window_s
                and self._rounds
            )
        )
        if not due:
            return []
        settle_cut = self._now - (0.0 if force else self._effective_settle())
        folded = [
            r for r, rd in self._rounds.items() if rd.last_wall <= settle_cut
        ]
        if not folded:
            self._last_close_wall = self._now
            return []
        win = _Window()
        for r in sorted(folded):
            rd = self._rounds.pop(r)
            win.rounds.append(r)
            win.t_lo = min(win.t_lo, rd.first_wall)
            win.t_hi = max(win.t_hi, rd.last_wall)
            if rd.votes:
                win.vote_active_rounds += 1
                for author in rd.votes:
                    win.voted_rounds[author] += 1
                    win.active_peers.add(author)
            win.edges |= rd.edges
            for author in rd.proposes:
                win.proposals[author] += 1
                win.active_peers.add(author)
                if rd.commit_nodes:
                    win.proposals_committed[author] += 1
                    if rd.last_wall > self._last_proposal_commit_seen.get(
                        author, 0
                    ):
                        self._last_proposal_commit_seen[author] = rd.last_wall
                for receiver in rd.propose_t:
                    win.edges.add(frozenset((author, receiver)))
            for leader in rd.propose_senders:
                win.proposals[leader] = max(win.proposals[leader], 1)
                win.active_peers.add(leader)
                if rd.commit_nodes:
                    win.proposals_committed[leader] = max(
                        win.proposals_committed[leader], 1
                    )
                    if rd.last_wall > self._last_proposal_commit_seen.get(
                        leader, 0
                    ):
                        self._last_proposal_commit_seen[leader] = rd.last_wall
            for node, n in rd.timeouts.items():
                win.timeouts[node] += n
                win.active_peers.add(node)
            for node in rd.commit_nodes:
                win.commits[node] += 1
                win.active_peers.add(node)
            for node in rd.vote_send_t:
                win.active_peers.add(node)
                if node in rd.propose_t:
                    win.turnaround[node].append(
                        max(0.0, rd.vote_send_t[node] - rd.propose_t[node])
                    )
        self._rounds_since_close = len(self._rounds)
        self._last_close_wall = self._now
        self._windows.append(win)
        fired = self._run_windowed_detectors(win)
        return fired

    # -- detectors -----------------------------------------------------------

    def _run_windowed_detectors(self, win: _Window) -> list[dict]:
        cfg = self.config
        fired: list[dict] = []
        t = win.t_hi or self._now
        window = (win.t_lo if win.t_lo != float("inf") else t, t)
        rounds_span = (
            [min(win.rounds), max(win.rounds)] if win.rounds else None
        )

        # silent_voter -------------------------------------------------------
        if win.vote_active_rounds >= cfg.min_rounds:
            rates = {
                p: win.voted_rounds.get(p, 0) / win.vote_active_rounds
                for p in self._peers
            }
            strong = [p for p, r in rates.items() if r >= 0.5]
            if len(strong) >= 2:
                for p, rate in sorted(rates.items()):
                    if rate <= cfg.silent_participation_max:
                        self._silent_streak[p] += 1
                        if self._silent_streak[p] >= cfg.silent_windows:
                            alive = p in win.active_peers
                            fired += self._alert(
                                "silent_voter",
                                [p],
                                min(1.0, 0.6 + 0.2 * (self._silent_streak[p] - cfg.silent_windows) + (0.2 if alive else 0.0)),
                                t,
                                {"participation": round(rate, 3),
                                 "active_rounds": win.vote_active_rounds,
                                 "windows_silent": self._silent_streak[p],
                                 "alive": alive,
                                 "voting_peers": sorted(strong)},
                                window=window,
                                rounds=rounds_span,
                            )
                    else:
                        self._silent_streak[p] = 0
        # laggard ------------------------------------------------------------
        frontier = max(self._heights.values(), default=0)
        frontier_adv = frontier - self._prev_frontier
        commit_stale_s = max(
            cfg.laggard_stale_s, 2.0 * self._effective_settle()
        )
        if frontier_adv >= cfg.laggard_min_frontier_advance:
            for p in sorted(self._peers):
                h = self._heights.get(p, 0)
                lag = frontier - h
                if (
                    lag >= cfg.laggard_min_lag
                    and h <= self._prev_heights.get(p, 0)
                ):
                    self._laggard_streak[p] += 1
                    # The streak builds on height evidence alone, but the
                    # ACCUSATION additionally requires the peer's commits
                    # to be stale beyond any emission burst cadence — a
                    # healthy stream's frozen height between flushes is
                    # lag of the PIPE, not of the node.
                    if (
                        self._laggard_streak[p] >= cfg.laggard_windows
                        and self._now - self._last_commit_seen.get(p, 0.0)
                        >= commit_stale_s
                    ):
                        fired += self._alert(
                            "laggard",
                            [p],
                            min(1.0, 0.6 + min(0.4, lag / 50.0)),
                            t,
                            {"height": h,
                             "frontier": frontier,
                             "lag_rounds": lag,
                             "windows_stalled": self._laggard_streak[p],
                             "frontier_advance": frontier_adv,
                             "commit_stale_s": round(
                                 self._now
                                 - self._last_commit_seen.get(p, 0.0),
                                 1,
                             )},
                            window=window,
                            rounds=rounds_span,
                        )
                else:
                    self._laggard_streak[p] = 0
        self._prev_frontier = frontier
        self._prev_heights = dict(self._heights)

        # grinding_leader ----------------------------------------------------
        n_rounds = len(win.rounds)
        timeout_total = sum(win.timeouts.values())
        timeout_rate = timeout_total / n_rounds if n_rounds else 0.0
        if n_rounds >= cfg.min_rounds and timeout_rate >= cfg.grind_timeout_rate:
            committed_any = sum(win.proposals_committed.values()) > 0
            for p, n in sorted(win.proposals.items()):
                leadership_stale_s = self._now - (
                    self._last_proposal_commit_seen.get(p, 0.0)
                )
                if (
                    n >= cfg.grind_min_proposals
                    and win.proposals_committed.get(p, 0) == 0
                    and committed_any
                    and leadership_stale_s >= cfg.grind_proposal_stale_s
                ):
                    fired += self._alert(
                        "grinding_leader",
                        [p],
                        0.7,
                        t,
                        {"mode": "uncommitted_proposals",
                         "proposals": n,
                         "committed": 0,
                         "leadership_stale_s": round(leadership_stale_s, 1),
                         "timeout_rate": round(timeout_rate, 3)},
                        window=window,
                        rounds=rounds_span,
                    )
            proposers = {p for p, n in win.proposals.items() if n > 0}
            if len(proposers) >= 2:
                for p in sorted(win.active_peers - proposers):
                    # Alive (voting / timing out) but never proposing
                    # while the committee burns timeouts: the silent
                    # leader shape. Needs the peer visibly alive — a
                    # crashed peer is the laggard/silent detectors' job.
                    proposal_stale_s = self._now - self._last_proposal_seen.get(
                        p, 0.0
                    )
                    if (
                        win.voted_rounds.get(p, 0) or win.timeouts.get(p, 0)
                    ) and proposal_stale_s >= cfg.grind_proposal_stale_s:
                        fired += self._alert(
                            "grinding_leader",
                            [p],
                            0.6,
                            t,
                            {"mode": "no_proposals",
                             "proposing_peers": sorted(proposers),
                             "proposal_stale_s": round(proposal_stale_s, 1),
                             "timeout_rate": round(timeout_rate, 3)},
                            window=window,
                            rounds=rounds_span,
                        )

        # partitioned_clique -------------------------------------------------
        peers_in_window = set(win.active_peers)
        if len(peers_in_window) >= 2 and n_rounds >= 1:
            comp = self._components(peers_in_window, win.edges)
            if len(comp) >= 2:
                committing = [
                    c for c in comp if any(win.commits.get(p) for p in c)
                ]
                quiet = [
                    c
                    for c in comp
                    if not any(win.commits.get(p) for p in c)
                    and any(
                        win.timeouts.get(p) or win.voted_rounds.get(p)
                        for p in c
                    )
                ]
                if committing and quiet:
                    for c in quiet:
                        fired += self._alert(
                            "partitioned_clique",
                            sorted(c),
                            0.7,
                            t,
                            {"components": [sorted(x) for x in comp],
                             "committing": [sorted(x) for x in committing]},
                            window=window,
                            rounds=rounds_span,
                        )
                elif (
                    not committing
                    and timeout_total >= cfg.min_rounds
                    and any(len(c) >= 2 for c in comp)
                ):
                    # Global stall with visible clique structure: accuse
                    # the non-largest components. An all-singleton graph
                    # says nothing about WHO is cut from whom (total
                    # churn looks like that too) — the grind/laggard
                    # detectors own that shape.
                    largest = max(comp, key=len)
                    for c in comp:
                        if c is largest:
                            continue
                        fired += self._alert(
                            "partitioned_clique",
                            sorted(c),
                            0.5,
                            t,
                            {"components": [sorted(x) for x in comp],
                             "committing": [],
                             "global_stall": True},
                            window=window,
                            rounds=rounds_span,
                        )
        return fired

    @staticmethod
    def _components(peers: set[str], edges: set[frozenset]) -> list[set[str]]:
        parent = {p: p for p in peers}

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for e in edges:
            members = [p for p in e if p in parent]
            if len(members) == 2:
                ra, rb = find(members[0]), find(members[1])
                if ra != rb:
                    parent[ra] = rb
        groups: dict[str, set[str]] = defaultdict(set)
        for p in peers:
            groups[find(p)].add(p)
        return list(groups.values())

    # -- alerts --------------------------------------------------------------

    def _alert(
        self,
        detector: str,
        accused: list[str],
        confidence: float,
        t: float,
        evidence: dict,
        *,
        window: tuple[float, float],
        rounds: list[int] | None = None,
    ) -> list[dict]:
        if confidence < self.config.alert_min_confidence:
            # Suppressed at the source (cooldown untouched: a later
            # higher-confidence accusation must not find itself muted).
            return []
        accused = [self.alias.get(a, a) for a in accused]
        key = (detector, tuple(sorted(accused)))
        last = self._last_alert_at.get(key)
        if last is not None and t - last < self.config.cooldown_s:
            return []
        self._last_alert_at[key] = t
        alert = {
            "schema": ALERT_SCHEMA,
            "seq": self._alert_seq,
            "detector": detector,
            "accused": accused,
            "confidence": round(float(confidence), 3),
            "ts": t,
            "node": self.label,
            "config": self._config_hash,
            "catalog": DETECTOR_CATALOG_VERSION,
            "window": {
                "t_lo": window[0],
                "t_hi": window[1],
                **({"rounds": rounds} if rounds else {}),
            },
            "evidence": evidence,
        }
        self._alert_seq += 1
        with self._alerts_lock:
            self.alerts.append(alert)
            if len(self.alerts) > self.config.max_alerts:
                del self.alerts[0]
        if self.on_alert is not None:
            try:
                self.on_alert(alert)
            except Exception:  # noqa: BLE001 — capture must not kill ingest
                pass
        return [alert]

    def snapshot_alerts(self) -> list[dict]:
        with self._alerts_lock:
            return list(self.alerts)

    # -- scoreboard ----------------------------------------------------------

    def scoreboard(self) -> dict:
        """Per-peer accountability scores over the recent window history
        (1.0 = healthy). Pure data — harness verdicts embed it."""
        wins = list(self._windows)
        frontier = max(self._heights.values(), default=0)
        active_rounds = sum(w.vote_active_rounds for w in wins)
        n_rounds = sum(len(w.rounds) for w in wins)
        with self._alerts_lock:
            accusations: dict[str, int] = defaultdict(int)
            for a in self.alerts:
                for p in a["accused"]:
                    accusations[p] += 1
        board: dict[str, dict] = {}
        for p in sorted(self._peers):
            name = self.alias.get(p, p)
            voted = sum(w.voted_rounds.get(p, 0) for w in wins)
            participation = voted / active_rounds if active_rounds else None
            samples = sorted(
                s for w in wins for s in w.turnaround.get(p, ())
            )
            timeouts = sum(w.timeouts.get(p, 0) for w in wins)
            h = self._heights.get(p, 0)
            lag = frontier - h
            score = 1.0
            if participation is not None:
                score -= 0.4 * (1.0 - min(1.0, participation * 2))
            score -= 0.3 * min(1.0, lag / 50.0)
            if n_rounds:
                score -= 0.2 * min(1.0, timeouts / n_rounds)
            if accusations.get(name):
                score -= 0.1
            board[name] = {
                "participation": (
                    None if participation is None else round(participation, 3)
                ),
                "turnaround_p90_ms": (
                    None
                    if not samples
                    else round(_pct(samples, 0.9) * 1e3, 3)
                ),
                "commit_height": h,
                "lag_rounds": lag,
                "timeouts_per_round": (
                    round(timeouts / n_rounds, 3) if n_rounds else None
                ),
                "equivocations": self._equivocations.get(p, 0),
                "alerts": accusations.get(name, 0),
                "score": round(max(0.0, score), 3),
            }
        result = {
            "frontier": frontier,
            "windows": len(wins),
            "rounds": n_rounds,
            "peers": board,
        }
        if self._worker_stats:
            # Data-plane section, keyed by telemetry stream node (worker
            # metrics ride snapshots, not the per-peer trace events).
            result["dataplane"] = {
                node: dict(stats)
                for node, stats in sorted(self._worker_stats.items())
            }
        backlog = self.ingress_backlog()
        if backlog:
            result["ingress_backlog"] = backlog
        return result

    def ingress_backlog(self) -> dict:
        """Per-node ingress batching health from the
        ``net.native.ingress.*`` counters and the worker depth gauge:
        how many frames each socket read and each wakeup carried, plus
        the deepest the worker queue has been across the stream's
        snapshots. ``frames_per_wakeup`` near 1.0 under load means the
        transport regressed to the one-frame-per-wakeup floor the
        batched ingress path exists to remove; a rising ``depth_peak``
        with flat ``shed_tx`` is backlog building before the shed
        threshold bites."""
        view: dict[str, dict] = {}
        for node, stats in sorted(self._worker_stats.items()):
            reads = stats.get("ingress_reads")
            frames = stats.get("ingress_frames")
            batches = stats.get("ingress_batches")
            depth = stats.get("ingress_depth")
            peak = self._ingress_peak.get(node)
            if not any(
                isinstance(v, (int, float))
                for v in (reads, frames, batches, depth)
            ):
                continue
            entry: dict[str, float | None] = {
                "reads": reads,
                "frames": frames,
                "batches": batches,
                "depth": depth,
                "depth_peak": peak,
                "shed_tx": stats.get("shed_tx"),
                "frames_per_read": (
                    round(frames / reads, 3) if reads and frames else None
                ),
                "frames_per_wakeup": (
                    round(frames / batches, 3)
                    if batches and frames
                    else None
                ),
            }
            view[node] = entry
        return view


class AlertCapture:
    """Alert-triggered evidence capture (``on_alert`` hook).

    Always writes one ``hotstuff-capture-v1`` JSON per alert (the alert
    plus the watcher's scoreboard at that instant). When constructed
    with the live process's ``trace`` buffer and ``registry`` — the
    in-process testbeds, where the watchtower shares a process with the
    accused engines — it additionally dumps a flight record and runs a
    bounded sampling-profiler session, so the postmortem evidence is on
    disk at the moment of detection rather than at teardown. A follower
    watching another process's streams captures evidence only; the
    nodes' own flight recorders (``arm_shutdown_flush``) stay the
    capture path for their in-process state.
    """

    def __init__(
        self,
        directory: str,
        *,
        watchtower: Watchtower | None = None,
        trace=None,
        registry=None,
        profile_s: float = 2.0,
        profile_interval_ms: float = 5.0,
        max_captures: int = 4,
    ) -> None:
        self.directory = directory
        self.watchtower = watchtower
        self.trace = trace
        self.registry = registry
        self.profile_s = profile_s
        self.profile_interval_ms = profile_interval_ms
        self.max_captures = max_captures
        self.captured = 0
        self.paths: list[str] = []
        self._profiling = False
        os.makedirs(directory, exist_ok=True)

    def __call__(self, alert: dict) -> None:
        if self.captured >= self.max_captures:
            return
        self.captured += 1
        # Re-created per capture: harness setups may wipe the work tree
        # after this hook is armed.
        os.makedirs(self.directory, exist_ok=True)
        base = os.path.join(
            self.directory,
            f"watchtower-capture-{alert['seq']:03d}-{alert['detector']}",
        )
        capture: dict = {"evidence": base + ".json"}
        record = {
            "schema": CAPTURE_SCHEMA,
            "ts": time.time(),
            "alert": alert,
            "scoreboard": (
                self.watchtower.scoreboard()
                if self.watchtower is not None
                else None
            ),
        }
        if self.trace is not None:
            from .trace import dump_flight_record

            flight = dump_flight_record(
                base + "-flight.json",
                f"alert:{alert['detector']}",
                self.trace,
                self.registry,
            )
            if flight:
                capture["flight_record"] = flight
        if self.trace is not None and self.profile_s > 0 and not self._profiling:
            capture["profile"] = self._profile_session(base)
        try:
            with open(capture["evidence"], "w") as f:
                json.dump(record, f, indent=2, sort_keys=True)
                f.write("\n")
        except OSError:
            capture.pop("evidence", None)
        self.paths.append(base + ".json")
        alert["capture"] = capture

    def _profile_session(self, base: str) -> str | None:
        """Bounded profiler burst: start the all-thread sampler (unless
        one is already live), stop after ``profile_s`` on a timer, and
        write the folded stacks next to the capture."""
        from . import profiler as pyprof

        if pyprof.active() is not None:
            return None  # a session is already streaming records
        try:
            prof = pyprof.SamplingProfiler(
                interval_ms=self.profile_interval_ms
            )
            prof.start(mode="thread")
        except Exception:  # noqa: BLE001 — capture is advisory
            return None
        self._profiling = True
        path = base + "-profile.json"

        def _finish() -> None:
            try:
                prof.stop()
                rec = prof.drain_record(node="watchtower-capture")
                if rec is not None:
                    with open(path, "w") as f:
                        json.dump(rec, f)
                        f.write("\n")
            except Exception:  # noqa: BLE001
                pass
            finally:
                self._profiling = False

        timer = threading.Timer(self.profile_s, _finish)
        timer.daemon = True
        timer.start()
        return path
