"""The port's local benchmark (``hotstuff_tpu_torch/benchmark/local.py`` and
``run_local.py``) on the CPU: four ``python -m hotstuff_tpu_torch.node``
processes and four ``python -m hotstuff_tpu_torch.node.client`` processes
under the ``cpu`` backend, their logs and telemetry streams read by both
packages.

- ``LocalBench(nodes=4, crypto_backend="cpu", duration=5, telemetry=True)``
  commits; the port's and the reference's ``LogParser`` give the same
  SUMMARY on its logs, their ``TelemetryParser``s the same figures on its
  streams, and both packages' ``replay_directory`` the same alerts.
- ``python -m hotstuff_tpu_torch.benchmark.run_local --crypto-backend cpu``
  prints the SUMMARY block with committed throughput, and the telemetry
  SUMMARY with ``--telemetry``.

Tolerance: exact equality of the parsed figures. Ports 24480-24519.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

import benchmark.logs as j_logs
import benchmark.watchtower as j_watch
from hotstuff_tpu_torch.benchmark import logs as t_logs
from hotstuff_tpu_torch.benchmark import watchtower as t_watch
from hotstuff_tpu_torch.benchmark.local import LocalBench

BASE = 24480
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def bench_logs(tmp_path_factory):
    work = tmp_path_factory.mktemp("local") / "bench"
    bench = LocalBench(nodes=4, crypto_backend="cpu", duration=5, base_port=BASE,
                       work_dir=str(work), telemetry=True)
    parser = bench.run()
    return str(work / "logs"), parser


def consensus_tps(summary: str) -> int:
    return int(re.search(r" Consensus TPS: ([\d,]+) tx/s", summary)[1].replace(",", ""))


def test_local_bench_commits_and_both_log_parsers_agree(bench_logs):
    logs_dir, parser = bench_logs
    ours = parser.result()
    assert consensus_tps(ours) > 0
    assert t_logs.LogParser.process(logs_dir).result() == ours
    assert j_logs.LogParser.process(logs_dir).result() == ours
    names = sorted(os.listdir(logs_dir))
    assert [n for n in names if n.endswith(".log")] == [
        *(f"client-{i}.log" for i in range(4)), *(f"node-{i}.log" for i in range(4))]


def test_both_telemetry_parsers_agree_on_the_node_streams(bench_logs):
    logs_dir, _ = bench_logs
    ours = t_logs.TelemetryParser.process(logs_dir, tx_size=512)
    theirs = j_logs.TelemetryParser.process(logs_dir, tx_size=512)
    assert ours.result() == theirs.result()
    assert len([n for n in os.listdir(logs_dir) if n.startswith("telemetry-")]) == 4
    assert consensus_tps(ours.result()) > 0


def test_both_watchtowers_replay_the_node_streams_alike(bench_logs):
    logs_dir, _ = bench_logs
    ours, theirs = t_watch.replay_directory(logs_dir), j_watch.replay_directory(logs_dir)
    assert ours.snapshot_alerts() == theirs.snapshot_alerts()
    assert ours.scoreboard() == theirs.scoreboard()
    assert ours.scoreboard()["rounds"] > 0


def test_run_local_prints_the_summary_blocks(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "hotstuff_tpu_torch.benchmark.run_local", "--nodes", "4",
         "--duration", "3", "--telemetry", "--crypto-backend", "cpu", "--base-port",
         str(BASE + 20), "--work-dir", str(tmp_path / "bench")],
        capture_output=True, text=True, timeout=240, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert " SUMMARY:" in out.stdout and " TELEMETRY SUMMARY:" in out.stdout
    assert consensus_tps(out.stdout) > 0
    assert " Committee size: 4 nodes" in out.stdout
