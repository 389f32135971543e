"""The port's stream readers and assemblers
(``hotstuff_tpu_torch/benchmark/{logs,trace_assemble,profile_assemble,
watchtower}.py``) against the reference's ``benchmark/`` copies, on the
same inputs.

- ``StreamFollower``: each case of ``tests/test_stream_follow.py`` run
  through both packages' followers gives the same records and counters.
- A port committee's telemetry stream (``committee_scale.run_committee``
  at N = 4 with ``--pyprof``'s sampling profiler, so the stream carries
  snapshots, trace records and profile records) read by both packages:
  equal ``read_stream_records``, ``read_telemetry_stream`` and
  ``TelemetryParser`` figures, equal ``trace_assemble.assemble`` reports
  (also on the reference tests' skewed synthetic committee), equal
  ``profile_assemble.attribute`` reports, human summaries and speedscope
  exports.
- ``DirectoryWatch`` and ``replay_directory`` over one directory of
  synthetic incident streams raise the same alerts in both packages.
- Both ``LogParser``s reject a log with a traceback.

Tolerance: exact equality throughout. Ports 24400-24409.
"""

from __future__ import annotations

import json
import threading
import time

import pytest

import benchmark.logs as j_logs
import benchmark.profile_assemble as j_profile
import benchmark.trace_assemble as j_trace
import benchmark.watchtower as j_watch
import hotstuff_tpu.telemetry.watchtower as j_wt
import hotstuff_tpu_torch.crypto as t_crypto
from hotstuff_tpu_torch import telemetry
from hotstuff_tpu_torch.benchmark import committee_scale
from hotstuff_tpu_torch.benchmark import logs as t_logs
from hotstuff_tpu_torch.benchmark import profile_assemble as t_profile
from hotstuff_tpu_torch.benchmark import trace_assemble as t_trace
from hotstuff_tpu_torch.benchmark import watchtower as t_watch
from hotstuff_tpu_torch.consensus import cert_arena
from hotstuff_tpu_torch.telemetry import build_snapshot
from hotstuff_tpu_torch.telemetry import profiler as pyprof
from hotstuff_tpu_torch.telemetry import watchtower as t_wt
from hotstuff_tpu_torch.telemetry.registry import Registry

from .test_torch_watchtower import PEERS, Feed, _Recorder, _snapshot, _sync_snapshot
from .test_trace_assemble import _committee_streams

BASE = 24400
PACKAGES = {"port": t_logs, "reference": j_logs}


@pytest.fixture(autouse=True)
def _isolated_telemetry():
    telemetry.reset_for_tests()
    yield
    telemetry.reset_for_tests()


def _snap_line(seq=0, node="n"):
    """One snapshot line, the same bytes whichever package's follower reads
    it (its clock and pid fixed)."""
    snap = build_snapshot(Registry(), node=node, seq=seq)
    snap.update(ts=1000.0 + seq, pid=1)
    return json.dumps(snap)


# -- StreamFollower: the cases of tests/test_stream_follow.py ------------------


def _growth(logs, path):
    follower = logs.StreamFollower(str(path), poll_s=0.01)
    seen = [follower.drain()]
    path.write_text(_snap_line(0) + "\n")
    seen.append(follower.drain())
    with open(path, "a") as f:
        f.write(_snap_line(1) + "\n" + _snap_line(2) + "\n")
    seen += [follower.drain(), follower.drain()]
    return seen, follower.records_read, follower.skipped, follower.truncations


def _partial_line(logs, path):
    line = _snap_line(0)
    path.write_text(line[: len(line) // 2])
    follower = logs.StreamFollower(str(path))
    seen = [follower.drain(), follower.skipped]
    with open(path, "a") as f:
        f.write(line[len(line) // 2:] + "\n")
    seen.append(follower.drain())
    return seen, follower.records_read, follower.skipped, follower.truncations


def _truncation(logs, path):
    path.write_text(_snap_line(0) + "\n" + _snap_line(1) + "\n")
    follower = logs.StreamFollower(str(path))
    seen = [follower.drain()]
    path.write_text(_snap_line(0, node="fresh") + "\n")
    seen.append(follower.drain())
    return seen, follower.records_read, follower.skipped, follower.truncations


def _malformed(logs, path):
    path.write_text("not json\n" + json.dumps({"schema": "hotstuff-future-v9"}) + "\n"
                    + _snap_line(0) + "\n")
    follower = logs.StreamFollower(str(path))
    return [follower.drain()], follower.records_read, follower.skipped, follower.truncations


def _iter_stop(logs, path):
    path.write_text(_snap_line(0) + "\n")
    follower = logs.StreamFollower(str(path), poll_s=0.01)
    got: list[dict] = []
    t = threading.Thread(target=lambda: got.extend(follower))
    t.start()
    deadline = time.time() + 5.0
    while not got and time.time() < deadline:
        time.sleep(0.01)
    with open(path, "a") as f:
        f.write(_snap_line(1) + "\n")
    follower.stop()
    t.join(5.0)
    assert not t.is_alive()
    return [got], follower.records_read, follower.skipped, follower.truncations


def _stop_when(logs, path):
    path.write_text(_snap_line(0) + "\n")
    follower = logs.StreamFollower(str(path), poll_s=0.01, stop_when=lambda: True)
    return [list(follower)], follower.records_read, follower.skipped, follower.truncations


CASES = {"growth": _growth, "partial_line": _partial_line, "truncation": _truncation,
         "malformed": _malformed, "iter_stop": _iter_stop, "stop_when": _stop_when}


@pytest.mark.parametrize("case", sorted(CASES))
def test_stream_follower_behaves_as_the_references(tmp_path, case):
    out = {}
    for label, logs in PACKAGES.items():
        path = tmp_path / f"telemetry-{label}.jsonl"
        seen, *counters = CASES[case](logs, path)
        out[label] = (seen, counters)
    assert out["port"] == out["reference"]
    assert any(out["port"][0])  # every case reads something


# -- one port committee's stream through both packages' readers ----------------


@pytest.fixture(scope="module")
def committee_stream(tmp_path_factory):
    """A port committee at N = 4 under the ``cpu`` backend, as
    ``committee_scale --mode protocol --nodes 4 --rounds 3 --profile
    --pyprof --telemetry <path>`` runs it: its stream path."""
    import asyncio

    telemetry.reset_for_tests()
    saved = t_crypto._BACKEND
    t_crypto.set_backend("cpu")
    cert_arena.reset()
    telemetry.enable()
    path = str(tmp_path_factory.mktemp("committee") / "telemetry-committee-4.jsonl")
    profiler = pyprof.SamplingProfiler(interval_ms=2.0)
    profiler.start(mode="auto")
    try:
        _, stages = asyncio.run(committee_scale.run_committee(
            4, 3, BASE, 1_000, profile=True, telemetry_path=path, profiler=profiler))
    finally:
        profiler.stop()
        t_crypto._BACKEND = saved
        cert_arena.reset()
        telemetry.reset_for_tests()
    assert stages and "propose" in stages
    return path


def test_stream_records_read_alike(committee_stream):
    ours = t_logs.read_stream_records(committee_stream)
    theirs = j_logs.read_stream_records(committee_stream)
    for kind in ("snapshots", "traces", "profiles", "meta", "dtraces", "alerts", "skipped"):
        assert getattr(ours, kind) == getattr(theirs, kind), kind
    assert ours.snapshots and ours.traces and ours.profiles
    assert list(t_logs.read_telemetry_stream(committee_stream)) == list(
        j_logs.read_telemetry_stream(committee_stream))


def test_telemetry_parser_gives_the_references_figures(committee_stream):
    import os

    directory = os.path.dirname(committee_stream)
    ours = t_logs.TelemetryParser.process(directory, tx_size=512)
    theirs = j_logs.TelemetryParser.process(directory, tx_size=512)
    assert ours.result() == theirs.result()


def test_trace_assemble_gives_the_references_report(committee_stream, tmp_path):
    ours, theirs = t_trace.assemble([committee_stream]), j_trace.assemble([committee_stream])
    assert ours == theirs and ours["rounds"] > 0
    assert t_trace._human(ours) == j_trace._human(theirs)
    skewed = _committee_streams(tmp_path, skew={"n2": 0.5})
    assert t_trace.assemble(skewed) == j_trace.assemble(skewed)
    assert t_trace.load_events(skewed) == j_trace.load_events(skewed)


def test_profile_attribution_gives_the_references_report(committee_stream):
    ours, theirs = t_profile.attribute([committee_stream]), j_profile.attribute([committee_stream])
    assert ours == theirs
    assert t_profile._human(ours) == j_profile._human(theirs)
    records = t_profile.load_profiles([committee_stream])
    assert records == j_profile.load_profiles([committee_stream]) and records
    (stages, meta), theirs = t_profile.aggregate(records), j_profile.aggregate(records)
    assert (stages, meta) == theirs and stages
    assert (t_profile.to_speedscope(stages, meta["interval_ms"], "committee-4")
            == j_profile.to_speedscope(stages, meta["interval_ms"], "committee-4"))


# -- the live watchtower over a directory ---------------------------------------


def _incident_directory(tmp_path):
    """Synthetic incidents (a silent voter, a lagging committer, an equivocation, a
    runaway RSS, a stalled sync) written as one stream per node."""
    rec = _Recorder()
    feed = Feed(rec)
    for r in range(1, 160):
        voters = PEERS if r < 25 else ("n0", "n1", "n2")
        committers = PEERS if r < 40 else ("n0", "n1", "n2")
        feed.healthy_round(r, r * 0.2, voters=voters, committers=committers)
    feed.event("n1", 170, "vote_rx", 40.0, "n2|Daaa")
    feed.event("n1", 170, "vote_rx", 40.1, "n2|Dbbb")
    for i in range(8):
        rec.ingest_record(_snapshot(i * 2.0, "n2", 42, 10_000_000 + i * 128 * 1024 * 1024))
        rec.ingest_record(_sync_snapshot(i * 5.0, "n3", 7, active=1, gap=40))
    streams = {}
    for record in rec.records:
        streams.setdefault(record["node"], []).append(json.dumps(record))
    for node, lines in streams.items():
        (tmp_path / f"telemetry-{node}.jsonl").write_text("\n".join(lines) + "\n")
    return str(tmp_path)


def test_directory_watch_raises_the_references_alerts(tmp_path):
    directory = _incident_directory(tmp_path)
    out = {}
    for label, mod, wt in (("port", t_watch, t_wt), ("reference", j_watch, j_wt)):
        config = wt.WatchtowerConfig(sync_stall_budget_s=20.0)
        fired = []
        watch = mod.DirectoryWatch(directory, config=config, on_alert=fired.append,
                                   alerts_path=str(tmp_path / f"alerts-{label}.jsonl"),
                                   poll_s=0.01, tick_with_wall_clock=False)
        watch.start()
        watch.stop()
        replayed = mod.replay_directory(directory, config=config)
        out[label] = (fired, watch.alerts(), watch.scoreboard(), watch.stats(),
                      replayed.snapshot_alerts(), replayed.scoreboard(),
                      (tmp_path / f"alerts-{label}.jsonl").read_text())
    assert out["port"] == out["reference"]
    detectors = {a["detector"] for a in out["port"][1]}
    assert {"silent_voter", "equivocation", "slope_breach", "sync_stall"} <= detectors


def test_both_log_parsers_reject_a_traceback():
    for logs in PACKAGES.values():
        with pytest.raises(logs.ParseError):
            logs.LogParser(["Traceback (most recent call last):"], ["x"], 0)
