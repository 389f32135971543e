"""Twin of ``tests/test_dtrace.py``, run against the port's copy
(``hotstuff_tpu_torch.telemetry``).

Lifeline plumbing tests: digest-label interning, the dtrace ring +
emitter roundtrip, the ``HOTSTUFF_DTRACE=0`` detach switch, and the
stream reader / validate CLI handling of ``hotstuff-dtrace-v1`` lines."""

from __future__ import annotations

import json

import pytest

from benchmark.logs import StreamFollower, read_stream_records
from hotstuff_tpu_torch import telemetry
from hotstuff_tpu_torch.crypto import Digest
from hotstuff_tpu_torch.telemetry import (
    DTRACE_SCHEMA,
    META_SCHEMA,
    TelemetryEmitter,
    build_dtrace_record,
    intern_label,
    validate_dtrace_record,
)
from hotstuff_tpu_torch.telemetry.registry import Registry
from hotstuff_tpu_torch.telemetry.validate import validate_stream


@pytest.fixture(autouse=True)
def _isolated_telemetry():
    telemetry.reset_for_tests()
    yield
    telemetry.reset_for_tests()


# -- label interning ---------------------------------------------------------


def test_intern_label_matches_digest_repr():
    data = b"\x02" * Digest.SIZE
    assert intern_label(data) == repr(Digest(data))
    # Stable across calls (cache hit path).
    assert intern_label(data) == intern_label(data)


def test_intern_cache_eviction_keeps_labels_consistent():
    from hotstuff_tpu_torch.telemetry import dtrace as dtrace_mod

    first = bytes(32)
    label = intern_label(first)
    # Blow past the cap; the evicted digest must re-encode identically.
    for i in range(dtrace_mod._INTERN_CAP + 8):
        intern_label(i.to_bytes(8, "big"))
    assert intern_label(first) == label
    with dtrace_mod._intern_lock:
        assert len(dtrace_mod._interned) <= dtrace_mod._INTERN_CAP


# -- recording + enablement --------------------------------------------------


def test_dtrace_event_noop_when_disabled():
    telemetry.dtrace_event("n0", b"\x01" * 32, "seal")
    assert telemetry.dtrace_buffer().events_since(0) == []


def test_dtrace_event_records_interned_label_and_backdate():
    telemetry.enable()
    data = b"\x03" * 32
    telemetry.dtrace_event("n0", data, "ingress", t=1.25)
    telemetry.dtrace_event("n0", intern_label(data), "seal", detail="w0|1tx|9B")
    events = telemetry.dtrace_buffer().events_since(0)
    assert len(events) == 2
    seq, node, label, stage, t = events[0][:5]
    assert (node, label, stage, t) == ("n0", intern_label(data), "ingress", 1.25)
    assert events[1][3] == "seal" and events[1][5] == "w0|1tx|9B"


def test_hotstuff_dtrace_env_detaches_only_the_lifeline(monkeypatch):
    monkeypatch.setenv("HOTSTUFF_DTRACE", "0")
    telemetry.reset_for_tests()
    telemetry.enable()
    assert telemetry.enabled() is True
    assert telemetry.dtrace_enabled() is False
    telemetry.dtrace_event("n0", b"\x04" * 32, "seal")
    telemetry.trace_event("n0", 1, "propose")
    assert telemetry.dtrace_buffer().events_since(0) == []
    assert len(telemetry.trace_buffer().events_since(0)) == 1
    monkeypatch.delenv("HOTSTUFF_DTRACE")
    telemetry.reset_for_tests()
    telemetry.enable()
    assert telemetry.dtrace_enabled() is True


# -- record validation -------------------------------------------------------


def test_validate_dtrace_record_roundtrip_and_rejections():
    telemetry.enable()
    telemetry.dtrace_event("n0", b"\x05" * 32, "cert")
    buf = telemetry.dtrace_buffer()
    rec = build_dtrace_record(buf, buf.events_since(0), node="n0")
    assert validate_dtrace_record(json.loads(json.dumps(rec))) == []
    assert validate_dtrace_record([]) != []
    assert validate_dtrace_record(dict(rec, schema="hotstuff-trace-v1")) != []
    # Slot 2 must be the batch LABEL (str); a round-trace style int event
    # is the one structural difference between the two planes.
    bad = dict(rec, events=[[1, "n0", 7, "cert", 0.5]])
    assert any("event 0" in p for p in validate_dtrace_record(bad))
    no_anchor = dict(rec)
    no_anchor.pop("anchor")
    assert any("anchor" in p for p in validate_dtrace_record(no_anchor))


# -- emitter + reader integration --------------------------------------------


def _emit_stream(path) -> None:
    telemetry.enable()
    emitter = TelemetryEmitter(
        Registry(),
        str(path),
        node="x",
        trace=telemetry.trace_buffer(),
        dtrace=telemetry.dtrace_buffer(),
    )
    telemetry.trace_event("n0", 1, "propose")
    telemetry.dtrace_event("n0", b"\x06" * 32, "seal", detail="w0|2tx|64B")
    telemetry.dtrace_event("n0", b"\x06" * 32, "disseminate")
    emitter.emit(final=True)


def test_emitter_drains_dtrace_delta_into_stream(tmp_path):
    path = tmp_path / "telemetry-x.jsonl"
    _emit_stream(path)
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    assert lines[0]["schema"] == META_SCHEMA
    assert DTRACE_SCHEMA in lines[0]["schemas"]
    drecs = [r for r in lines if r["schema"] == DTRACE_SCHEMA]
    assert len(drecs) == 1 and len(drecs[0]["events"]) == 2
    records = read_stream_records(str(path))
    assert len(records.dtraces) == 1
    assert len(records.traces) == 1
    assert records.skipped == 0


def test_stream_follower_parses_dtrace_records(tmp_path):
    path = tmp_path / "telemetry-x.jsonl"
    _emit_stream(path)
    follower = StreamFollower(str(path))
    got = [r for r in follower.drain() if r.get("schema") == DTRACE_SCHEMA]
    assert len(got) == 1 and follower.skipped == 0


def test_validate_cli_counts_dtrace_and_diagnoses_bad_lines(tmp_path):
    path = tmp_path / "telemetry-x.jsonl"
    _emit_stream(path)
    report = validate_stream(str(path))
    assert report["ok"] is True
    assert report["counts"][DTRACE_SCHEMA] == 1

    # A malformed dtrace line is named with its line number and schema.
    with open(path) as f:
        n_lines = sum(1 for _ in f)
    with open(path, "a") as f:
        f.write(
            json.dumps(
                {
                    "schema": DTRACE_SCHEMA,
                    "node": "x",
                    "pid": 1,
                    "anchor": {"mono": 0.0, "wall": 1.0},
                    "evicted": 0,
                    "events": [[1, "n0", 7, "seal", 0.5]],
                }
            )
            + "\n"
        )
    report = validate_stream(str(path))
    assert report["ok"] is False
    (problem,) = report["problems"]
    assert problem["line"] == n_lines + 1
    assert problem["schema"] == DTRACE_SCHEMA
    assert any("event 0" in p for p in problem["problems"])
