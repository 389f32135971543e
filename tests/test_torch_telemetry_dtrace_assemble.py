"""Twin of ``tests/test_dtrace_assemble.py``, run against the port's copy
(``hotstuff_tpu_torch.telemetry``) and the port's assembler
(``hotstuff_tpu_torch.benchmark.dtrace_assemble`` over its
``trace_assemble``).

Lifeline assembly tests mirroring ``tests/test_trace_assemble``:
multi-node batch-timeline merge, clock-skew correction via the round
trace's causality offsets, open-edge reporting for batches that died
mid-pipeline, own-vs-peer cert enqueue selection, and the multi-process
engine-group merge by wall anchor."""

from __future__ import annotations

import json

import pytest

from hotstuff_tpu_torch.benchmark.dtrace_assemble import (
    assemble,
    assemble_batches,
    load_dtrace_events,
)
from hotstuff_tpu_torch.benchmark.trace_assemble import estimate_offsets, load_events
from hotstuff_tpu_torch import telemetry
from hotstuff_tpu_torch.telemetry import TraceBuffer, build_dtrace_record, build_trace_record


@pytest.fixture(autouse=True)
def _isolated_telemetry():
    telemetry.reset_for_tests()
    yield
    telemetry.reset_for_tests()


# -- helpers: synthesize node streams ---------------------------------------


def _record(events, node, *, kind, anchor_mono=0.0, anchor_wall=1000.0):
    buf = TraceBuffer(capacity=1024)
    buf.anchor_mono = anchor_mono
    buf.anchor_wall = anchor_wall
    build = build_dtrace_record if kind == "dtrace" else build_trace_record
    return build(buf, events, node=node)


def _write_stream(path, records):
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    return str(path)


L = "batchAAAA0000000"  # interned digest label (slot 2 of every event)


def _worker_leader_stream(path, *, wall=1000.0):
    """n0 seals, certifies, proposes (round 5), commits, resolves."""
    dtrace = [
        (1, "n0", L, "ingress", 0.000),
        (2, "n0", L, "seal", 0.010, "w0|8tx|4096B|s0,1"),
        (3, "n0", L, "disseminate", 0.011),
        (4, "n0", L, "ack", 0.020, "pk1"),
        (5, "n0", L, "ack", 0.024, "pk2"),
        (6, "n0", L, "cert", 0.030),
        (7, "n0", L, "enqueue", 0.031, "own"),
        (8, "n0", L, "proposed", 0.040, "r5"),
        (9, "n0", L, "committed", 0.090, "r5"),
        (10, "n0", L, "resolved", 0.095, "local"),
    ]
    trace = [
        (1, "n0", 5, "propose_send", 0.040),
        (2, "n0", 5, "commit", 0.090, "h5"),
    ]
    return _write_stream(
        path,
        [
            _record(trace, "n0", kind="trace", anchor_wall=wall),
            _record(dtrace, "n0", kind="dtrace", anchor_wall=wall),
        ],
    )


def _replica_stream(path, *, wall=1000.0):
    """n1 receives the cert on the wire (peer enqueue) and commits."""
    dtrace = [
        (1, "n1", L, "enqueue", 0.034, "peer"),
        (2, "n1", L, "committed", 0.091, "r5"),
        (3, "n1", L, "resolved", 0.097, "local"),
    ]
    trace = [
        (1, "n1", 5, "propose", 0.042),
        (2, "n1", 5, "commit", 0.091, "h5"),
    ]
    return _write_stream(
        path,
        [
            _record(trace, "n1", kind="trace", anchor_wall=wall),
            _record(dtrace, "n1", kind="dtrace", anchor_wall=wall),
        ],
    )


# -- assembly ---------------------------------------------------------------


def test_two_node_merge_closes_all_seven_edges(tmp_path):
    paths = [
        _worker_leader_stream(tmp_path / "telemetry-n0.jsonl"),
        _replica_stream(tmp_path / "telemetry-n1.jsonl"),
    ]
    report = assemble(paths)
    assert report["batches"] == 1 and report["complete"] == 1
    (b,) = report["per_batch"]
    assert b["open_edges"] == []
    assert all(v is not None for v in b["edges_ms"].values())
    assert b["round"] == 5
    assert "round_edges_ms" in b  # joined onto the round trace
    assert b["edges_ms"]["ingress_wait"] == pytest.approx(10.0, abs=0.5)
    assert b["edges_ms"]["ack_fanin"] == pytest.approx(10.0, abs=0.5)
    assert b["edges_ms"]["ordering"] == pytest.approx(50.0, abs=0.5)
    # queue_wait uses the PROPOSING node's enqueue (0.031), not n1's
    # later peer-cert enqueue (0.034).
    assert b["edges_ms"]["queue_wait"] == pytest.approx(9.0, abs=0.5)


def test_clock_skew_corrected_via_round_trace_offsets(tmp_path):
    # n1's wall clock is 50 ms behind: uncorrected, its commit would land
    # BEFORE the leader's proposal. The round-trace causality offsets
    # (propose must follow propose_send) also realign the dtrace events.
    paths = [
        _worker_leader_stream(tmp_path / "telemetry-n0.jsonl"),
        _replica_stream(tmp_path / "telemetry-n1.jsonl", wall=999.950),
    ]
    offsets = estimate_offsets(load_events(paths))
    assert offsets.get("n1", 0.0) == pytest.approx(0.048, abs=0.005)
    report = assemble(paths)
    (b,) = report["per_batch"]
    assert b["open_edges"] == []
    # The commit mark stays the earliest POST-ALIGNMENT commit; the
    # ordering edge must remain in the unskewed ballpark, not collapse
    # to the clamped zero a raw merge would produce.
    assert b["edges_ms"]["ordering"] == pytest.approx(50.0, abs=5.0)


def test_committed_but_never_resolved_reports_open_edge(tmp_path):
    # The resolver timed out (availability violation): the lifeline must
    # surface the open resolve edge, not crash or invent a close.
    dtrace = [
        (1, "n0", L, "seal", 0.010, "w0|8tx|4096B"),
        (2, "n0", L, "disseminate", 0.011),
        (3, "n0", L, "cert", 0.030),
        (4, "n0", L, "enqueue", 0.031, "own"),
        (5, "n0", L, "proposed", 0.040, "r5"),
        (6, "n0", L, "committed", 0.090, "r5"),
    ]
    path = _write_stream(
        tmp_path / "telemetry-n0.jsonl",
        [_record(dtrace, "n0", kind="dtrace")],
    )
    report = assemble([path])
    (b,) = report["per_batch"]
    assert b["stage_reached"] == "committed"
    assert "resolve" in b["open_edges"]
    assert b["edges_ms"]["resolve"] is None
    assert b["edges_ms"]["ordering"] == pytest.approx(50.0, abs=0.5)
    assert report["complete"] == 0
    assert report["incomplete_by_stage_reached"] == {"committed": 1}


def test_peer_only_enqueue_still_closes_queue_wait(tmp_path):
    # The proposing node learned the digest from a wire cert (v1 or v2
    # frame — both land as enqueue/"peer"): queue_wait must still close
    # from that node's enqueue mark.
    dtrace = [
        (1, "n2", L, "enqueue", 0.035, "peer"),
        (2, "n2", L, "proposed", 0.050, "r7"),
        (3, "n2", L, "committed", 0.080, "r7"),
        (4, "n2", L, "resolved", 0.085, "fetched"),
    ]
    path = _write_stream(
        tmp_path / "telemetry-n2.jsonl",
        [_record(dtrace, "n2", kind="dtrace")],
    )
    (b,) = assemble([path])["per_batch"]
    assert b["edges_ms"]["queue_wait"] == pytest.approx(15.0, abs=0.5)
    assert b["round"] == 7
    # Upstream stages never observed: those edges are open, not invented.
    assert "ingress_wait" in b["open_edges"] or b["edges_ms"]["ingress_wait"] is None


def test_multi_process_engine_group_merges_by_wall_anchor(tmp_path):
    # One stream FILE, two dtrace records from different processes with
    # different monotonic anchors: the wall anchor is what places both
    # on one timeline (the engine-group layout — processes share files).
    rec_a = _record(
        [(1, "n0", L, "seal", 5.000), (2, "n0", L, "disseminate", 5.001)],
        "n0", kind="dtrace", anchor_mono=5.0, anchor_wall=1000.010,
    )
    rec_b = _record(
        [(1, "n1", L, "committed", 900.060, "r5"),
         (2, "n1", L, "resolved", 900.065, "local")],
        "n1", kind="dtrace", anchor_mono=900.0, anchor_wall=1000.000,
    )
    path = _write_stream(tmp_path / "telemetry-g0.jsonl", [rec_a, rec_b])
    events = load_dtrace_events([path])
    by_stage = {e["stage"]: e["t"] for e in events}
    assert by_stage["seal"] == pytest.approx(1000.010, abs=1e-6)
    assert by_stage["committed"] == pytest.approx(1000.060, abs=1e-6)
    (b,) = assemble_batches(events)
    assert b["edges_ms"]["resolve"] == pytest.approx(5.0, abs=0.5)


def test_unreadable_stream_is_skipped_not_fatal(tmp_path):
    good = _worker_leader_stream(tmp_path / "telemetry-n0.jsonl")
    bad = tmp_path / "telemetry-bad.jsonl"
    bad.write_text('{"schema": "hotstuff-telemetry-v1", "node": 3}\n')
    report = assemble([good, str(bad)])
    assert report["batches"] == 1
    assert "telemetry-bad.jsonl" in report["skipped_streams"]
