"""The port's lifeline assembler (``hotstuff_tpu_torch/benchmark/
dtrace_assemble.py``) against the reference's ``benchmark/dtrace_assemble.py``
on the same records.

- The six cases of ``tests/test_dtrace_assemble.py`` (streams written by the
  port's telemetry): both assemblers give the same report, and in the
  engine-group case the same events and batches.
- A port committee of N = 4 with one worker each (``LocalBench`` under
  ``cpu``, telemetry on, about 10 s): both assemble its node streams and
  client logs into the same report, and every batch either closes the seven
  edges or names its open edge.

Tolerance: exact equality of the reports. Ports: 24600-24619.
"""

from __future__ import annotations

import glob
import json
import os

import pytest

import benchmark.dtrace_assemble as j_dtrace
from hotstuff_tpu_torch import telemetry
from hotstuff_tpu_torch.benchmark import dtrace_assemble as t_dtrace
from hotstuff_tpu_torch.benchmark.local import LocalBench

from .test_torch_telemetry_dtrace_assemble import (
    L,
    _record,
    _replica_stream,
    _worker_leader_stream,
    _write_stream,
)

BASE_PORT = 24600


@pytest.fixture(autouse=True)
def _isolated_telemetry():
    telemetry.reset_for_tests()
    yield
    telemetry.reset_for_tests()


def _two_node(tmp_path):
    return [_worker_leader_stream(tmp_path / "telemetry-n0.jsonl"),
            _replica_stream(tmp_path / "telemetry-n1.jsonl")]


def _clock_skew(tmp_path):
    return [_worker_leader_stream(tmp_path / "telemetry-n0.jsonl"),
            _replica_stream(tmp_path / "telemetry-n1.jsonl", wall=999.950)]


def _never_resolved(tmp_path):
    dtrace = [
        (1, "n0", L, "seal", 0.010, "w0|8tx|4096B"),
        (2, "n0", L, "disseminate", 0.011),
        (3, "n0", L, "cert", 0.030),
        (4, "n0", L, "enqueue", 0.031, "own"),
        (5, "n0", L, "proposed", 0.040, "r5"),
        (6, "n0", L, "committed", 0.090, "r5"),
    ]
    return [_write_stream(tmp_path / "telemetry-n0.jsonl", [_record(dtrace, "n0", kind="dtrace")])]


def _peer_only_enqueue(tmp_path):
    dtrace = [
        (1, "n2", L, "enqueue", 0.035, "peer"),
        (2, "n2", L, "proposed", 0.050, "r7"),
        (3, "n2", L, "committed", 0.080, "r7"),
        (4, "n2", L, "resolved", 0.085, "fetched"),
    ]
    return [_write_stream(tmp_path / "telemetry-n2.jsonl", [_record(dtrace, "n2", kind="dtrace")])]


def _engine_group(tmp_path):
    rec_a = _record([(1, "n0", L, "seal", 5.000), (2, "n0", L, "disseminate", 5.001)],
                    "n0", kind="dtrace", anchor_mono=5.0, anchor_wall=1000.010)
    rec_b = _record([(1, "n1", L, "committed", 900.060, "r5"),
                     (2, "n1", L, "resolved", 900.065, "local")],
                    "n1", kind="dtrace", anchor_mono=900.0, anchor_wall=1000.000)
    return [_write_stream(tmp_path / "telemetry-g0.jsonl", [rec_a, rec_b])]


def _unreadable(tmp_path):
    good = _worker_leader_stream(tmp_path / "telemetry-n0.jsonl")
    bad = tmp_path / "telemetry-bad.jsonl"
    bad.write_text('{"schema": "hotstuff-telemetry-v1", "node": 3}\n')
    return [good, str(bad)]


CASES = {
    "two_node_merge": _two_node,
    "clock_skew": _clock_skew,
    "committed_never_resolved": _never_resolved,
    "peer_only_enqueue": _peer_only_enqueue,
    "engine_group_wall_anchor": _engine_group,
    "unreadable_stream_skipped": _unreadable,
}


def _same(a, b):
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


@pytest.mark.parametrize("case", sorted(CASES))
def test_case_gives_the_references_report(tmp_path, case):
    paths = CASES[case](tmp_path)
    ours = t_dtrace.assemble(paths)
    _same(ours, j_dtrace.assemble(paths))
    assert ours["batches"] == 1
    events = t_dtrace.load_dtrace_events(paths)
    _same(events, j_dtrace.load_dtrace_events(paths))
    _same(t_dtrace.assemble_batches(events), j_dtrace.assemble_batches(events))


def test_port_committee_streams_assemble_alike(tmp_path):
    bench = LocalBench(nodes=4, rate=2_000, tx_size=512, duration=3, base_port=BASE_PORT,
                       timeout_delay=2_000, batch_size=250_000, max_batch_delay=50,
                       work_dir=str(tmp_path / "bench"), workers=1, telemetry=True,
                       crypto_backend="cpu")
    bench.run()
    logs_dir = tmp_path / "bench" / "logs"
    streams = sorted(glob.glob(os.path.join(logs_dir, "telemetry-*.jsonl")))
    clients = sorted(glob.glob(os.path.join(logs_dir, "client-*.log")))
    assert len(streams) == 4 and len(clients) == 4
    ours = t_dtrace.assemble(streams, client_paths=clients)
    _same(ours, j_dtrace.assemble(streams, client_paths=clients))
    assert ours["batches"] > 0 and ours["complete"] > 0
    for batch in ours["per_batch"]:
        closed = all(v is not None for v in batch["edges_ms"].values())
        assert closed or batch["open_edges"], batch
