"""Twins of ``tests/test_watchtower.py`` on the port's watchtower, and its
parity with the reference's.

- The reference file's non-slow tests that need nothing from
  ``benchmark/`` (one true-positive and one near-miss fixture per
  detector, restart and counter-reset tolerance, alert schema round trips,
  alert-triggered capture, the data plane's scoreboard sections), with the
  same inputs and assertions. Left out: ``test_incident_labels_from_
  schedule`` and the slow seed-7 replay, which call
  ``benchmark/detector_bench.py``.
- Twins of the 7 faultline and watchtower tests of
  ``tests/test_statesync.py`` (frontier availability, ``sync_stall``).
- Parity: the trace and snapshot records that a port committee streamed
  through a faultline run (a crash and a silent leader), fed one line at
  a time to each package's ``Watchtower``, give the same alerts and the
  same scoreboard; every record also passes the port's validator, alerts
  included. A synthetic stream in which every detector fires gives the
  same alerts and scoreboard too (the live run's alerts depend on its
  timing, the synthetic stream's do not).

Ports 23600-23619.
"""

from __future__ import annotations

import json
import time

import pytest

import hotstuff_tpu.telemetry.watchtower as j_watchtower
import hotstuff_tpu_torch.crypto as t_crypto
from hotstuff_tpu_torch import telemetry
from hotstuff_tpu_torch.consensus import cert_arena
from hotstuff_tpu_torch.telemetry import validate as t_validate
from hotstuff_tpu_torch.telemetry.watchtower import (
    ALERT_SCHEMA,
    AlertCapture,
    Watchtower,
    WatchtowerConfig,
    validate_alert_record,
)

from .common import async_test
from .test_torch_faultline_node import settle_telemetry

BASE = 23600


@pytest.fixture(autouse=True)
def _isolated_telemetry():
    telemetry.reset_for_tests()
    yield
    telemetry.reset_for_tests()


# -- synthetic stream helpers ------------------------------------------------

PEERS = ("n0", "n1", "n2", "n3")


class Feed:
    """Feeds synthetic trace events through the real ingest path (one
    hotstuff-trace-v1 record per event, wall==mono anchor)."""

    def __init__(self, watch: Watchtower) -> None:
        self.watch = watch
        self.alerts: list[dict] = []
        self._seq = 0

    def event(self, node, round_, stage, t, detail=None):
        self._seq += 1
        ev = [self._seq, node, round_, stage, t]
        if detail is not None:
            ev.append(detail)
        record = {
            "schema": "hotstuff-trace-v1",
            "node": node,
            "pid": 1,
            "anchor": {"mono": 0.0, "wall": 0.0},
            "evicted": 0,
            "events": [ev],
        }
        fired = self.watch.ingest_record(record, source="synthetic")
        self.alerts.extend(fired)
        return fired

    def healthy_round(self, r, t, *, voters=PEERS, committers=PEERS,
                      leader="n0", collector="n1"):
        digest = f"D{r}"
        self.event(leader, r, "propose_send", t, f"{leader}|{digest}")
        for n in PEERS:
            self.event(n, r, "propose", t + 0.002, f"{leader}|{digest}")
        for n in voters:
            self.event(n, r, "vote_send", t + 0.004)
            self.event(collector, r, "vote_rx", t + 0.005, f"{n}|{digest}")
        for n in committers:
            self.event(n, r, "commit", t + 0.01, f"h{r}")

    def flush(self):
        self.alerts.extend(self.watch.flush())
        return self.alerts


def _detectors(alerts):
    return sorted({a["detector"] for a in alerts})


# -- healthy baseline --------------------------------------------------------


def test_healthy_run_fires_nothing():
    feed = Feed(Watchtower(WatchtowerConfig()))
    for r in range(1, 60):
        feed.healthy_round(r, r * 0.2)
    feed.flush()
    assert feed.alerts == []
    board = feed.watch.scoreboard()
    assert board["frontier"] == 59
    for peer in PEERS:
        assert board["peers"][peer]["participation"] == 1.0
        assert board["peers"][peer]["score"] == 1.0


# -- silent_voter ------------------------------------------------------------


def test_silent_voter_detected_with_correct_peer():
    feed = Feed(Watchtower(WatchtowerConfig()))
    for r in range(1, 80):
        voters = PEERS if r < 25 else ("n0", "n1", "n2")
        feed.healthy_round(r, r * 0.2, voters=voters)
    feed.flush()
    silent = [a for a in feed.alerts if a["detector"] == "silent_voter"]
    assert silent, f"no silent_voter alert in {_detectors(feed.alerts)}"
    assert silent[0]["accused"] == ["n3"]
    assert validate_alert_record(silent[0]) == []
    assert silent[0]["evidence"]["participation"] <= 0.1


def test_silent_voter_near_miss_low_but_present_participation():
    """A peer voting in ~25% of rounds is degraded, not silent — no
    accusation (the threshold is 10%)."""
    feed = Feed(Watchtower(WatchtowerConfig()))
    for r in range(1, 80):
        voters = PEERS if r % 4 == 0 else ("n0", "n1", "n2")
        feed.healthy_round(r, r * 0.2, voters=voters)
    feed.flush()
    assert [a for a in feed.alerts if a["detector"] == "silent_voter"] == []


# -- laggard -----------------------------------------------------------------


def test_laggard_detected_when_height_stalls():
    feed = Feed(Watchtower(WatchtowerConfig()))
    # n3's commits stop at round 25; its stream stays alive (it keeps
    # proposing/voting) long past the commit-staleness grace, so this is
    # a node lagging, not a stream flushing in bursts.
    for r in range(1, 160):
        committers = PEERS if r < 25 else ("n0", "n1", "n2")
        feed.healthy_round(r, r * 0.2, committers=committers)
    feed.flush()
    lag = [a for a in feed.alerts if a["detector"] == "laggard"]
    assert lag and lag[0]["accused"] == ["n3"]
    assert lag[0]["evidence"]["lag_rounds"] >= 8
    assert lag[0]["evidence"]["frontier"] > lag[0]["evidence"]["height"]


def test_laggard_tolerates_emission_burst_lag():
    """Multi-process nodes flush their streams in emit-interval bursts:
    between flushes a healthy node's observed height freezes while the
    freshest stream's frontier races ahead. Observed live as three of
    four healthy soak nodes accused — the commit-staleness gate plus the
    meta-declared interval must suppress it."""
    watch = Watchtower(WatchtowerConfig())
    feed = Feed(watch)
    # The stream self-describes a 5 s emit interval.
    watch.ingest_record(
        {
            "schema": "hotstuff-meta-v1",
            "schemas": [],
            "node": "n3",
            "pid": 1,
            "ts": 0.0,
            "anchor": {"mono": 0.0, "wall": 0.0},
            "interval_s": 5.0,
        },
        source="synthetic",
    )
    # n0-n2 events arrive promptly; n3's commits arrive in bursts 5 s
    # late (but do arrive — the node itself is healthy).
    for r in range(1, 160):
        t = r * 0.2
        feed.healthy_round(r, t, committers=("n0", "n1", "n2"))
        if r % 25 == 0:
            for rr in range(r - 25 + 1, r + 1):
                feed.event("n3", rr, "commit", t + 0.012, f"h{rr}")
    feed.flush()
    assert [a for a in feed.alerts if a["detector"] == "laggard"] == []


def test_laggard_near_miss_small_lag_tolerated():
    """A node trailing by a few rounds (commit batching, slow stream
    flush) is normal — lag under the threshold never accuses."""
    cfg = WatchtowerConfig()
    feed = Feed(Watchtower(cfg))
    behind = cfg.laggard_min_lag - 2
    for r in range(1, 80):
        feed.healthy_round(r, r * 0.2, committers=("n0", "n1", "n2"))
        if r > behind:
            feed.event("n3", r - behind, "commit", r * 0.2 + 0.011,
                       f"h{r - behind}")
    feed.flush()
    assert [a for a in feed.alerts if a["detector"] == "laggard"] == []


# -- grinding_leader ---------------------------------------------------------


def test_grinding_leader_uncommitted_proposals():
    feed = Feed(Watchtower(WatchtowerConfig()))
    t = 0.0
    for r in range(1, 40):
        t = r * 0.3
        if r % 4 == 0:
            # n3's turns: proposal lands everywhere but never commits;
            # the committee burns a timeout each time.
            feed.event("n3", r, "propose_send", t, f"n3|D{r}")
            for n in PEERS:
                feed.event(n, r, "propose", t + 0.002, f"n3|D{r}")
                feed.event(n, r, "timeout", t + 0.25)
        else:
            feed.healthy_round(r, t)
    feed.flush()
    grind = [a for a in feed.alerts if a["detector"] == "grinding_leader"]
    assert grind and grind[0]["accused"] == ["n3"]
    assert grind[0]["evidence"]["mode"] == "uncommitted_proposals"


def test_grinding_leader_no_proposals_mode_needs_timeouts():
    """A peer that never proposes in a CALM window is just unlucky in
    the election — only elevated timeout rates make it suspicious."""
    feed = Feed(Watchtower(WatchtowerConfig()))
    for r in range(1, 60):
        # n3 votes but never leads; zero timeouts anywhere.
        feed.healthy_round(r, r * 0.2, leader=PEERS[r % 3])
    feed.flush()
    assert [a for a in feed.alerts if a["detector"] == "grinding_leader"] == []


# -- partitioned_clique ------------------------------------------------------


def test_partitioned_clique_accuses_cut_minority():
    feed = Feed(Watchtower(WatchtowerConfig()))
    for r in range(1, 40):
        t = r * 0.3
        # Majority {n0,n1,n2} keeps committing among itself...
        digest = f"D{r}"
        feed.event("n0", r, "propose_send", t, f"n0|{digest}")
        for n in ("n0", "n1", "n2"):
            feed.event(n, r, "propose", t + 0.002, f"n0|{digest}")
            feed.event(n, r, "vote_send", t + 0.004)
            feed.event("n1", r, "vote_rx", t + 0.005, f"{n}|{digest}")
            feed.event(n, r, "commit", t + 0.01, f"h{r}")
        # ...while isolated n3 only times out and self-collects.
        feed.event("n3", r, "timeout", t + 0.28)
        feed.event("n3", r, "vote_rx", t + 0.29, f"n3|Dx{r}")
    feed.flush()
    part = [a for a in feed.alerts if a["detector"] == "partitioned_clique"]
    assert part and part[0]["accused"] == ["n3"]
    assert ["n3"] in part[0]["evidence"]["components"]


def test_no_partition_alert_when_everyone_commits():
    feed = Feed(Watchtower(WatchtowerConfig()))
    for r in range(1, 40):
        feed.healthy_round(r, r * 0.3)
    feed.flush()
    assert [
        a for a in feed.alerts if a["detector"] == "partitioned_clique"
    ] == []


# -- equivocation ------------------------------------------------------------


def test_equivocation_conflicting_votes_immediate():
    feed = Feed(Watchtower(WatchtowerConfig()))
    fired = feed.event("n1", 5, "vote_rx", 1.0, "n2|Daaa")
    assert fired == []
    fired = feed.event("n1", 5, "vote_rx", 1.1, "n2|Dbbb")
    assert len(fired) == 1
    alert = fired[0]
    assert alert["detector"] == "equivocation"
    assert alert["accused"] == ["n2"]
    assert alert["confidence"] == 1.0
    assert alert["evidence"]["kind"] == "conflicting_votes"
    # Same digest resent (vote retransmission) is NOT equivocation.
    assert feed.event("n1", 5, "vote_rx", 1.2, "n2|Dbbb") == []


def test_equivocation_conflicting_proposals_across_receivers():
    feed = Feed(Watchtower(WatchtowerConfig()))
    assert feed.event("n1", 7, "propose", 1.0, "n0|Daaa") == []
    fired = feed.event("n2", 7, "propose", 1.1, "n0|Dbbb")
    assert len(fired) == 1
    assert fired[0]["accused"] == ["n0"]
    assert fired[0]["evidence"]["kind"] == "conflicting_proposals"


# -- slope_breach + restart tolerance ---------------------------------------


def _snapshot(ts, node, pid, rss):
    return {
        "schema": "hotstuff-telemetry-v1",
        "node": node,
        "pid": pid,
        "seq": 0,
        "ts": ts,
        "final": False,
        "counters": {},
        "gauges": {"resource.rss_bytes": rss},
        "histograms": {},
    }


def test_slope_breach_fires_on_runaway_rss():
    cfg = WatchtowerConfig(slope_window_s=5.0)
    watch = Watchtower(cfg)
    fired = []
    for i in range(8):
        # 64 MiB/s of growth, far past the 8 MiB/s bound.
        fired += watch.ingest_record(
            _snapshot(i * 2.0, "n2", 42, 10_000_000 + i * 128 * 1024 * 1024),
            source="s",
        )
    breach = [a for a in fired if a["detector"] == "slope_breach"]
    assert breach and breach[0]["accused"] == ["n2"]
    assert breach[0]["evidence"]["metric"] == "resource.rss_bytes"


def test_slope_breach_tolerates_restart_counter_reset():
    """A node restart makes the RSS gauge start over from a fresh pid;
    the detector must clear its history instead of comparing across
    lives (the counter-reset tolerance contract the SLO engine has)."""
    cfg = WatchtowerConfig(slope_window_s=5.0)
    watch = Watchtower(cfg)
    fired = []
    fired += watch.ingest_record(_snapshot(0.0, "n2", 41, 500_000_000), "s")
    fired += watch.ingest_record(_snapshot(6.0, "n2", 41, 500_000_001), "s")
    # Restart: new pid, RSS far lower, then modest growth — the cross-
    # life delta would be a huge negative then a huge positive jump.
    fired += watch.ingest_record(_snapshot(12.0, "n2", 99, 10_000_000), "s")
    fired += watch.ingest_record(_snapshot(18.0, "n2", 99, 11_000_000), "s")
    assert [a for a in fired if a["detector"] == "slope_breach"] == []


def test_slope_breach_near_miss_under_bound():
    cfg = WatchtowerConfig(slope_window_s=5.0)
    watch = Watchtower(cfg)
    fired = []
    for i in range(8):
        # 4 MiB/s: busy but inside the 8 MiB/s bound.
        fired += watch.ingest_record(
            _snapshot(i * 2.0, "n2", 42, 10_000_000 + i * 8 * 1024 * 1024),
            source="s",
        )
    assert fired == []


# -- digest_queue_starvation (ROADMAP 3b: ordering starving behind ingest) ---


def _queue_snapshot(ts, node, pid, depth):
    return {
        "schema": "hotstuff-telemetry-v1",
        "node": node,
        "pid": pid,
        "seq": 0,
        "ts": ts,
        "final": False,
        "counters": {},
        "gauges": {"consensus.proposer.digest_queue_depth": depth},
        "histograms": {},
    }


def test_digest_queue_starvation_fires_on_sustained_growth():
    cfg = WatchtowerConfig(slope_window_s=5.0, digest_queue_growth_max_per_s=50.0)
    watch = Watchtower(cfg)
    fired = []
    for i in range(8):
        # 200 digests/s of sustained queue growth, 4x the bound.
        fired += watch.ingest_record(
            _queue_snapshot(i * 2.0, "n1", 42, i * 400), source="s"
        )
    alerts = [a for a in fired if a["detector"] == "digest_queue_starvation"]
    assert alerts and alerts[0]["accused"] == ["n1"]
    assert (
        alerts[0]["evidence"]["metric"]
        == "consensus.proposer.digest_queue_depth"
    )
    assert alerts[0]["evidence"]["growth_per_s"] > 50.0
    from hotstuff_tpu_torch.telemetry import validate_alert_record

    assert validate_alert_record(alerts[0]) == []


def test_digest_queue_starvation_near_miss_under_bound():
    """Growth just UNDER the bound must stay silent — the detector
    judges sustained slope against the configured bound, not busyness."""
    cfg = WatchtowerConfig(slope_window_s=5.0, digest_queue_growth_max_per_s=50.0)
    watch = Watchtower(cfg)
    fired = []
    for i in range(8):
        # 45 digests/s: close to, but inside, the 50/s bound.
        fired += watch.ingest_record(
            _queue_snapshot(i * 2.0, "n1", 42, i * 90), source="s"
        )
    assert fired == []


def test_digest_queue_deep_but_draining_is_healthy():
    """A deep-but-flat queue is pipelining, not starvation: depth alone
    never fires, only growth does."""
    cfg = WatchtowerConfig(slope_window_s=5.0, digest_queue_growth_max_per_s=50.0)
    watch = Watchtower(cfg)
    fired = []
    for i in range(8):
        fired += watch.ingest_record(
            _queue_snapshot(i * 2.0, "n1", 42, 40_000 + (i % 2) * 10),
            source="s",
        )
    assert fired == []


def test_digest_queue_starvation_restart_clears_history():
    cfg = WatchtowerConfig(slope_window_s=5.0, digest_queue_growth_max_per_s=50.0)
    watch = Watchtower(cfg)
    fired = []
    fired += watch.ingest_record(_queue_snapshot(0.0, "n1", 41, 0), "s")
    fired += watch.ingest_record(_queue_snapshot(6.0, "n1", 41, 10), "s")
    # Restart: fresh pid; a large absolute jump across lives is not growth.
    fired += watch.ingest_record(_queue_snapshot(12.0, "n1", 99, 5_000), "s")
    fired += watch.ingest_record(_queue_snapshot(18.0, "n1", 99, 5_010), "s")
    assert [
        a for a in fired if a["detector"] == "digest_queue_starvation"
    ] == []


def test_dataplane_slos_include_digest_queue_growth():
    from hotstuff_tpu_torch.telemetry import slo as slo_mod

    specs = {s.name: s for s in slo_mod.dataplane_slos()}
    spec = specs["digest_queue_growth_per_s"]
    assert spec.kind == "gauge_growth"
    assert spec.metric == "consensus.proposer.digest_queue_depth"
    # Two snapshots 10 s apart growing 100 digests/s: violated; near-miss
    # growth under the bound: healthy.
    hot = [
        _queue_snapshot(0.0, "n1", 1, 0),
        _queue_snapshot(10.0, "n1", 1, 1_000),
    ]
    cool = [
        _queue_snapshot(0.0, "n1", 1, 0),
        _queue_snapshot(10.0, "n1", 1, 400),
    ]
    bad = slo_mod.evaluate_streams({"s": hot}, [spec], window_s=10.0)
    good = slo_mod.evaluate_streams({"s": cool}, [spec], window_s=10.0)
    assert not bad["ok"]
    assert good["ok"]


# -- alert plumbing ----------------------------------------------------------


def test_alert_schema_roundtrip_and_cooldown():
    cfg = WatchtowerConfig(cooldown_s=100.0)
    feed = Feed(Watchtower(cfg))
    feed.event("n1", 5, "vote_rx", 1.0, "n2|Da")
    feed.event("n1", 5, "vote_rx", 1.1, "n2|Db")
    feed.event("n1", 6, "vote_rx", 2.0, "n2|Dc")
    feed.event("n1", 6, "vote_rx", 2.1, "n2|Dd")  # same accused: cooled down
    assert len(feed.alerts) == 1
    rt = json.loads(json.dumps(feed.alerts[0]))
    assert rt["schema"] == ALERT_SCHEMA
    assert validate_alert_record(rt) == []
    assert validate_alert_record({"schema": ALERT_SCHEMA}) != []
    assert validate_alert_record(dict(rt, confidence=3.0)) != []
    assert validate_alert_record(dict(rt, accused=[])) != []


def test_alias_maps_accusations_to_friendly_names():
    feed = Feed(Watchtower(WatchtowerConfig(), alias={"n2": "validator-two"}))
    feed.event("n1", 5, "vote_rx", 1.0, "n2|Da")
    feed.event("n1", 5, "vote_rx", 1.1, "n2|Db")
    assert feed.alerts[0]["accused"] == ["validator-two"]


def test_config_from_dict_rejects_unknown_keys():
    assert WatchtowerConfig.from_dict({"window_s": 2.0}).window_s == 2.0
    with pytest.raises(ValueError, match="unknown watchtower config"):
        WatchtowerConfig.from_dict({"windowz": 1})


def test_malformed_details_never_mint_peers():
    """A corrupt detail string (missing separator, empty author/digest)
    is not evidence: it must neither raise nor create a phantom peer
    that later detectors could accuse."""
    feed = Feed(Watchtower(WatchtowerConfig()))
    feed.event("n1", 5, "vote_rx", 1.0, "no-separator")
    feed.event("n1", 5, "vote_rx", 1.1, "|onlydigest")
    feed.event("n1", 5, "vote_rx", 1.2, "onlyauthor|")
    feed.event("n1", 5, "propose", 1.3, "garbage")
    feed.event("n1", 5, "commit", 1.4, "hNOTANUMBER")
    assert feed.alerts == []
    assert sorted(feed.watch.scoreboard()["peers"]) == ["n1"]


def test_non_protocol_stages_never_mint_peers():
    """Faultline injection audit events share the trace ring; they must
    not create phantom peers that then get accused of silence."""
    feed = Feed(Watchtower(WatchtowerConfig()))
    for r in range(1, 60):
        feed.healthy_round(r, r * 0.2)
        feed.event("faultline", r, "fault_injected", r * 0.2 + 0.001)
    feed.flush()
    assert feed.alerts == []
    assert "faultline" not in feed.watch.scoreboard()["peers"]


def test_alert_capture_writes_evidence_flight_and_profile(tmp_path):
    telemetry.enable()
    buf = telemetry.trace_buffer()
    registry = telemetry.get_registry()
    watch = Watchtower(WatchtowerConfig())
    capture = AlertCapture(
        str(tmp_path / "captures"),
        watchtower=watch,
        trace=buf,
        registry=registry,
        profile_s=0.05,
        max_captures=1,
    )
    watch.on_alert = capture
    feed = Feed(watch)
    feed.event("n1", 5, "vote_rx", 1.0, "n2|Da")
    feed.event("n1", 5, "vote_rx", 1.1, "n2|Db")
    alert = feed.alerts[0]
    assert "capture" in alert
    evidence = json.load(open(alert["capture"]["evidence"]))
    assert evidence["schema"] == "hotstuff-capture-v1"
    assert evidence["alert"]["detector"] == "equivocation"
    assert evidence["scoreboard"] is not None
    flight = json.load(open(alert["capture"]["flight_record"]))
    assert flight["reason"] == "alert:equivocation"
    # Bounded profiler session: the record lands after profile_s.
    profile_path = alert["capture"].get("profile")
    assert profile_path is not None
    deadline = time.time() + 5.0
    import os

    while not os.path.exists(profile_path) and time.time() < deadline:
        time.sleep(0.02)
    assert os.path.exists(profile_path)
    prof = json.load(open(profile_path))
    assert prof["schema"] == "hotstuff-profile-v1"
    # max_captures bounds the spam.
    feed.event("n1", 9, "vote_rx", 30.0, "n3|Da")
    feed.event("n1", 9, "vote_rx", 30.1, "n3|Db")
    assert "capture" not in feed.alerts[-1]


def test_scoreboard_surfaces_dataplane_worker_stats():
    """Worker gauges/counters riding a node's snapshot stream land in
    the scoreboard's `dataplane` section, keyed by stream node."""
    wt = Watchtower(config=WatchtowerConfig())
    snap = {
        "schema": "hotstuff-telemetry-v1",
        "node": "n1",
        "pid": 7,
        "seq": 0,
        "ts": 1.0,
        "final": False,
        "counters": {
            "mempool.worker.ingress_tx": 1000,
            "mempool.worker.shed_tx": 25,
            "mempool.worker.certs_formed": 12,
            "mempool.resolver.unresolved": 0,
        },
        "gauges": {"mempool.worker.store_depth": 17},
        "histograms": {},
    }
    wt.ingest_record(snap, source="n1")
    board = wt.scoreboard()
    assert board["dataplane"]["n1"]["store_depth"] == 17
    assert board["dataplane"]["n1"]["shed_tx"] == 25
    assert board["dataplane"]["n1"]["certs_formed"] == 12
    # Streams without worker metrics contribute no dataplane section.
    wt2 = Watchtower(config=WatchtowerConfig())
    wt2.ingest_record({**snap, "counters": {}, "gauges": {}}, source="n1")
    assert "dataplane" not in wt2.scoreboard()


def test_ingress_backlog_view_derives_batching_ratios():
    """The `ingress_backlog` view folds the net.native.ingress.*
    counters and the worker depth gauge into per-node batching ratios,
    and tracks the depth high-water mark across snapshots."""
    wt = Watchtower(config=WatchtowerConfig())
    base = {
        "schema": "hotstuff-telemetry-v1",
        "node": "n1",
        "pid": 7,
        "final": False,
        "histograms": {},
    }
    wt.ingest_record(
        {
            **base,
            "seq": 0,
            "ts": 1.0,
            "counters": {
                "net.native.ingress.reads": 40,
                "net.native.ingress.frames": 400,
                "net.native.ingress.batches": 50,
                "mempool.worker.shed_tx": 0,
            },
            "gauges": {"mempool.worker.ingress_depth": 96},
        },
        source="n1",
    )
    # Later snapshot: counters advanced, depth drained — the peak must
    # remember the earlier high-water mark.
    wt.ingest_record(
        {
            **base,
            "seq": 1,
            "ts": 2.0,
            "counters": {
                "net.native.ingress.reads": 100,
                "net.native.ingress.frames": 800,
                "net.native.ingress.batches": 100,
                "mempool.worker.shed_tx": 3,
            },
            "gauges": {"mempool.worker.ingress_depth": 4},
        },
        source="n1",
    )
    view = wt.ingress_backlog()
    assert view["n1"]["reads"] == 100
    assert view["n1"]["frames"] == 800
    assert view["n1"]["frames_per_read"] == 8.0
    assert view["n1"]["frames_per_wakeup"] == 8.0
    assert view["n1"]["depth"] == 4
    assert view["n1"]["depth_peak"] == 96
    assert view["n1"]["shed_tx"] == 3
    # The scoreboard carries the same view for harness verdicts.
    board = wt.scoreboard()
    assert board["ingress_backlog"]["n1"]["frames_per_wakeup"] == 8.0
    # A stream with only protocol metrics yields no backlog view.
    wt2 = Watchtower(config=WatchtowerConfig())
    wt2.ingest_record(
        {**base, "seq": 0, "ts": 1.0, "counters": {}, "gauges": {}},
        source="n1",
    )
    assert wt2.ingress_backlog() == {}
    assert "ingress_backlog" not in wt2.scoreboard()


# -- frontier-availability checker ------------------------------------------


def _schedule(nodes=("n0", "n1", "n2", "n3")):
    from hotstuff_tpu_torch.faultline.policy import Schedule

    return Schedule(scenario="t", seed=0, nodes=list(nodes))


def test_frontier_availability_ok_via_resolvers():
    from hotstuff_tpu_torch.faultline.checker import check_frontier_availability

    committed = {(1, b"a"), (2, b"b")}
    resolvers = {b"a": {"n0", "n1"}, b"b": {"n0", "n1", "n2"}}
    verdict = check_frontier_availability(_schedule(), committed, resolvers, {})
    assert verdict["ok"] and verdict["required_servers"] == 2
    assert verdict["checked"] == 2 and verdict["violations"] == []


def test_frontier_availability_snapshot_floor_serves_truncated_block():
    from hotstuff_tpu_torch.faultline.checker import check_frontier_availability

    # Block at round 5 resolvable only at n0; n1 truncated it but its
    # snapshot floor (>= 5) subsumes it — still two servers.
    committed = {(5, b"x")}
    verdict = check_frontier_availability(
        _schedule(), committed, {b"x": {"n0"}}, {"n1": 7}
    )
    assert verdict["ok"]
    # A floor BELOW the block's round does not serve it.
    verdict = check_frontier_availability(
        _schedule(), committed, {b"x": {"n0"}}, {"n1": 4}
    )
    assert not verdict["ok"]
    assert verdict["violations"][0]["type"] == "unservable_commit"


def test_frontier_availability_excludes_byzantine_servers():
    from hotstuff_tpu_torch.faultline.checker import check_frontier_availability
    from hotstuff_tpu_torch.faultline.policy import FaultEvent

    sched = _schedule()
    sched.events.append(
        FaultEvent(at=0.0, kind="byzantine", params={"node": "n1", "behavior": "equivocate"})
    )
    committed = {(3, b"y")}
    # Only byzantine n1 plus honest n0 resolve it: one honest server < f+1.
    verdict = check_frontier_availability(
        sched, committed, {b"y": {"n0", "n1"}}, {}
    )
    assert not verdict["ok"]


# -- Watchtower sync_stall detector -----------------------------------------


def _sync_snapshot(ts, node, pid, active, gap):
    return {
        "schema": "hotstuff-telemetry-v1",
        "node": node,
        "pid": pid,
        "seq": 0,
        "ts": ts,
        "final": False,
        "counters": {},
        "gauges": {"statesync.active": active, "statesync.frontier_gap": gap},
        "histograms": {},
    }


def test_sync_stall_fires_when_gap_never_closes():
    from hotstuff_tpu_torch.telemetry.watchtower import Watchtower, WatchtowerConfig

    watch = Watchtower(WatchtowerConfig(sync_stall_budget_s=20.0))
    fired = []
    for i in range(6):
        fired += watch.ingest_record(
            _sync_snapshot(i * 5.0, "n3", 7, active=1, gap=40), source="s"
        )
    alerts = [a for a in fired if a["detector"] == "sync_stall"]
    assert alerts and alerts[0]["accused"] == ["n3"]
    assert alerts[0]["evidence"]["frontier_gap"] == 40


def test_sync_stall_quiet_while_gap_shrinks():
    from hotstuff_tpu_torch.telemetry.watchtower import Watchtower, WatchtowerConfig

    watch = Watchtower(WatchtowerConfig(sync_stall_budget_s=20.0))
    fired = []
    for i, gap in enumerate([64, 48, 32, 16, 9, 8]):
        fired += watch.ingest_record(
            _sync_snapshot(i * 5.0, "n3", 7, active=1, gap=gap), source="s"
        )
    assert [a for a in fired if a["detector"] == "sync_stall"] == []


def test_sync_stall_resets_on_restart_and_inactive():
    from hotstuff_tpu_torch.telemetry.watchtower import Watchtower, WatchtowerConfig

    watch = Watchtower(WatchtowerConfig(sync_stall_budget_s=20.0))
    fired = []
    # Stalled under pid 7, but the node restarts (pid 9) before the budget:
    # the anchor must reset, not accumulate across lives.
    fired += watch.ingest_record(_sync_snapshot(0.0, "n3", 7, 1, 40), "s")
    fired += watch.ingest_record(_sync_snapshot(15.0, "n3", 9, 1, 40), "s")
    fired += watch.ingest_record(_sync_snapshot(25.0, "n3", 9, 1, 40), "s")
    assert [a for a in fired if a["detector"] == "sync_stall"] == []
    # Sync completing (active=0) clears the anchor too.
    fired += watch.ingest_record(_sync_snapshot(30.0, "n3", 9, 0, 0), "s")
    fired += watch.ingest_record(_sync_snapshot(50.0, "n3", 9, 0, 0), "s")
    assert [a for a in fired if a["detector"] == "sync_stall"] == []


def test_sync_stall_ignores_small_gaps():
    from hotstuff_tpu_torch.telemetry.watchtower import Watchtower, WatchtowerConfig

    watch = Watchtower(WatchtowerConfig(sync_stall_budget_s=20.0, sync_stall_min_gap=8))
    fired = []
    for i in range(8):
        fired += watch.ingest_record(
            _sync_snapshot(i * 5.0, "n3", 7, active=1, gap=3), source="s"
        )
    assert [a for a in fired if a["detector"] == "sync_stall"] == []


# -- parity with the reference's watchtower -----------------------------------


@async_test(timeout=90)
async def _record_stream(path: str) -> dict:
    """A port committee under a crash and a silent leader, telemetry on,
    its trace and snapshot records streamed to ``path``."""
    from hotstuff_tpu_torch.faultline import Scenario, run_scenario

    emitter = telemetry.TelemetryEmitter(
        telemetry.get_registry(), path, node="committee-4", interval_s=0.5,
        trace=telemetry.trace_buffer(),
    )
    emitter.emit()
    emitter.spawn()
    try:
        scenario = Scenario(
            name="watch-parity", seed=31, duration_s=5.0,
            events=[
                {"kind": "crash", "node": 2, "at": 1.0},
                {"kind": "restart", "node": 2, "at": 2.5},
                {"kind": "byzantine", "node": 0, "behavior": "silent_leader",
                 "at": 1.5, "until": 4.0},
            ],
        )
        return await run_scenario(scenario, 4, base_port=BASE, timeout_delay=500,
                                  recovery_timeout_s=30.0)
    finally:
        await emitter.shutdown()


def test_recorded_stream_gives_the_references_alerts_and_scoreboard(tmp_path, monkeypatch):
    monkeypatch.setattr(t_crypto, "_BACKEND", None)
    t_crypto.set_backend(t_crypto.CpuBackend())
    cert_arena.reset()
    telemetry.enable()
    path = str(tmp_path / "telemetry-committee-4.jsonl")
    try:
        result = _record_stream(path)
    finally:
        settle_telemetry()
    assert result["verdict"]["safety"]["ok"]
    lines = open(path).read().splitlines()
    records = [json.loads(line) for line in lines]
    schemas = {r["schema"] for r in records}
    assert {"hotstuff-trace-v1", "hotstuff-telemetry-v1"} <= schemas
    ours = Watchtower(WatchtowerConfig())
    theirs = j_watchtower.Watchtower(j_watchtower.WatchtowerConfig())
    fired = ([], [])
    for line in lines:  # one line at a time, as the follower feeds it
        fired[0].extend(ours.ingest_record(json.loads(line), source=path))
        fired[1].extend(theirs.ingest_record(json.loads(line), source=path))
    fired[0].extend(ours.flush())
    fired[1].extend(theirs.flush())
    assert fired[0] == fired[1]
    assert ours.alerts == theirs.alerts
    assert ours.scoreboard() == theirs.scoreboard()
    assert ours.scoreboard()["rounds"] > 0
    for alert in fired[0]:
        assert validate_alert_record(alert) == []
    # The port's validator reads the stream and the alerts as the
    # reference's does (alert records are no longer an unknown schema).
    alerts_path = tmp_path / "telemetry-alerts.jsonl"
    alerts_path.write_text("".join(json.dumps(a) + "\n" for a in fired[0]))
    for p in (path, str(alerts_path)):
        report = t_validate.validate_stream(p)
        assert report["ok"], report["problems"][:5]
    assert t_validate.VALIDATORS[ALERT_SCHEMA] is validate_alert_record


class _Recorder:
    """Stands in for a watchtower under ``Feed``: keeps the records."""

    def __init__(self) -> None:
        self.records: list[dict] = []

    def ingest_record(self, record, source=None):
        self.records.append(json.loads(json.dumps(record)))
        return []

    def flush(self):
        return []


def test_synthetic_incidents_give_the_references_alerts_and_scoreboard():
    rec = _Recorder()
    feed = Feed(rec)
    for r in range(1, 160):
        voters = PEERS if r < 25 else ("n0", "n1", "n2")
        committers = PEERS if r < 40 else ("n0", "n1", "n2")
        feed.healthy_round(r, r * 0.2, voters=voters, committers=committers)
    feed.event("n1", 170, "vote_rx", 40.0, "n2|Daaa")
    feed.event("n1", 170, "vote_rx", 40.1, "n2|Dbbb")
    feed.event("n1", 171, "propose", 40.2, "n0|Daaa")
    feed.event("n2", 171, "propose", 40.3, "n0|Dbbb")
    for i in range(8):
        rec.ingest_record(_snapshot(i * 2.0, "n2", 42, 10_000_000 + i * 128 * 1024 * 1024))
        rec.ingest_record(_sync_snapshot(i * 5.0, "n3", 7, active=1, gap=40))
    watches = (Watchtower(WatchtowerConfig(sync_stall_budget_s=20.0)),
               j_watchtower.Watchtower(j_watchtower.WatchtowerConfig(sync_stall_budget_s=20.0)))
    fired = ([], [])
    for record in rec.records:
        for watch, out in zip(watches, fired):
            out.extend(watch.ingest_record(json.loads(json.dumps(record)), source="s"))
    for watch, out in zip(watches, fired):
        out.extend(watch.flush())
    assert fired[0] == fired[1]
    assert watches[0].scoreboard() == watches[1].scoreboard()
    assert {"silent_voter", "laggard", "equivocation", "slope_breach",
            "sync_stall"} <= {a["detector"] for a in fired[0]}


def test_tuned_preset_loads_and_equals_the_references():
    """``WatchtowerConfig.preset("tuned-n4")`` reads the port's own copy
    of the committed preset (``telemetry/presets/tuned-n4.json``, byte for
    byte the reference's): the same config field for field and the same
    fingerprint as the reference's call."""
    ours = WatchtowerConfig.preset("tuned-n4")
    ref = j_watchtower.WatchtowerConfig.preset("tuned-n4")
    assert ours.__dict__ == ref.__dict__
    assert ours.fingerprint() == ref.fingerprint() == "e9e99f16bffb"
