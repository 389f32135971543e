"""The port's data-plane harness (``hotstuff_tpu_torch/benchmark/
{dataplane_sweep,fleet_bench}.py``) against the reference's scripts on the
same input.

- ``dataplane_sweep.run_point`` on a port committee of N = 4 with one worker
  each, under ``cpu``, with ``--dtrace``: the reference's ``run_point``,
  handed the same logs and streams, makes the same row (keys, figures, shed
  count and lifeline report).
- The gate: ``best_committed_tps`` on the same results directory, then each
  script's ``--gate`` on a fixed sweep point above, below and without a
  baseline: the same gate section and exit code. The port's ``REPO_ROOT`` is
  the repository, so its gate reads the committed sweeps as the reference's
  does.
- ``fleet_bench.run_fleet`` (``--fleet 16 --churn 1``) on a port committee
  under ``cpu``: the reference's ``run_fleet`` on the same logs gives the same
  results, ``_churn_total`` and ``_ingress_watermark`` included.

Tolerance: exact equality. Ports: 24620-24639 (the sweep point) and
24640-24659 (the fleet).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import pytest

import benchmark.dataplane_sweep as j_sweep
import benchmark.fleet_bench as j_fleet
from benchmark.logs import LogParser as JLogParser
from hotstuff_tpu_torch.benchmark import dataplane_sweep as t_sweep
from hotstuff_tpu_torch.benchmark import fleet_bench as t_fleet

REPO = Path(__file__).resolve().parents[1]
SWEEP_PORT = 24620
FLEET_PORT = 24640


class Replay:
    """Stands in for the reference's ``LocalBench``: its ``run`` parses the
    logs a port run left in ``work_dir`` with the reference's parser."""

    def __init__(self, **kwargs):
        self.work_dir = kwargs["work_dir"]

    def run(self):
        return JLogParser.process(os.path.join(os.path.abspath(self.work_dir), "logs"))


def _same(a, b):
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def test_run_point_gives_the_references_row(tmp_path, monkeypatch):
    kwargs = dict(nodes=4, workers=1, tx_size=512, duration=3, base_port=SWEEP_PORT,
                  work_dir=str(tmp_path / "bench"), batch_size=250_000, max_batch_delay=50,
                  timeout=2_000, dtrace=True)
    monkeypatch.setenv("HOTSTUFF_CRYPTO_BACKEND", "cpu")
    ours = t_sweep.run_point(2_000, **kwargs)
    monkeypatch.setattr(j_sweep, "LocalBench", Replay)
    ref = j_sweep.run_point(2_000, **kwargs)
    _same(ours, ref)
    assert set(ours) == {"rate", "e2e_tps", "e2e_bps", "e2e_latency_ms", "consensus_tps",
                         "consensus_latency_ms", "duration_s", "shed", "rate_misses", "dtrace"}
    assert ours["e2e_tps"] > 0 and "error" not in ours["dtrace"]
    assert ours["dtrace"]["batches"] > 0


def _write_sweep(results: Path, name: str, peak):
    results.mkdir(parents=True, exist_ok=True)
    (results / name).write_text(json.dumps({"peak": {"e2e_tps": peak} if peak else {}}))


def test_best_committed_tps_is_the_references(tmp_path):
    results = tmp_path / "results"
    _write_sweep(results, "dataplane-sweep-a.json", 1_200)
    _write_sweep(results, "dataplane-sweep-b.json", 3_400)
    _write_sweep(results, "dataplane-sweep-c.json", None)
    (results / "dataplane-sweep-d.json").write_text("{not json")
    _write_sweep(results, "fleet-x.json", 99_999)
    ours = t_sweep.best_committed_tps(str(results))
    assert ours == j_sweep.best_committed_tps(str(results))
    assert ours == {"e2e_tps": 3_400, "source": "dataplane-sweep-b.json"}
    assert t_sweep.best_committed_tps(str(tmp_path)) is None


def test_the_gate_reads_the_repositorys_committed_sweeps():
    assert Path(t_sweep.REPO_ROOT) == REPO
    committed = t_sweep.best_committed_tps(os.path.join(t_sweep.REPO_ROOT, "results"))
    assert committed is not None
    assert committed == j_sweep.best_committed_tps(os.path.join(j_sweep.REPO_ROOT, "results"))


def _gate(module, argv, monkeypatch, capsys, root, fresh):
    """``module.main(argv)`` on one fixed sweep point under ``root``: the
    printed report's gate section and the exit code."""
    monkeypatch.setattr(module, "REPO_ROOT", str(root))
    monkeypatch.setattr(module, "run_point", lambda rate, **_: {
        "rate": rate, "e2e_tps": fresh, "e2e_bps": fresh * 512, "e2e_latency_ms": 10,
        "consensus_tps": fresh, "consensus_latency_ms": 5, "duration_s": 3.0, "shed": 0,
        "rate_misses": 0})
    monkeypatch.setattr(sys, "argv", ["dataplane_sweep", *argv])
    capsys.readouterr()
    code = 0
    try:
        module.main() if module is j_sweep else module.main(argv)
    except SystemExit as e:
        code = e.code
    lines = capsys.readouterr().out.splitlines()
    report = json.loads("\n".join(lines[lines.index("{"):lines.index("}") + 1]))
    return report["gate"], code, lines[-1]


@pytest.mark.parametrize("fresh,baseline", [(2_600, 3_400), (900, 3_400), (900, None)],
                         ids=["green", "red", "no-baseline"])
def test_the_gate_is_the_references(tmp_path, monkeypatch, capsys, fresh, baseline):
    if baseline:
        _write_sweep(tmp_path / "results", "dataplane-sweep-n4-w1-512B.json", baseline)
    argv = ["--rates", "2000,4000", "--gate", "--min-tps", "500"]
    ours = _gate(t_sweep, argv, monkeypatch, capsys, tmp_path, fresh)
    assert ours == _gate(j_sweep, argv, monkeypatch, capsys, tmp_path, fresh)
    gate, code, last = ours
    if baseline:
        assert gate["floor"] == round(min(baseline, 4_000) * 0.5)
    else:
        assert gate["status"] == "no-baseline"
    assert (code, last) == ((0, "dataplane gate: GREEN") if gate["ok"]
                            else (1, "dataplane gate: RED"))
    assert gate["ok"] == (fresh != 900 or baseline is None)


def test_run_fleet_gives_the_references_results(tmp_path, monkeypatch):
    args = argparse.Namespace(
        nodes=4, workers=1, rate=2_000, tx_size=512, duration=3, timeout=2_000,
        batch_size=250_000, max_batch_delay=50, base_port=FLEET_PORT,
        work_dir=str(tmp_path / "fleet"), fleet=16, bundle_txs=8, burst_every=0.0,
        burst_len=0.0, burst_x=1.0, churn=1.0)
    monkeypatch.setenv("HOTSTUFF_CRYPTO_BACKEND", "cpu")
    ours = t_fleet.run_fleet(args)
    monkeypatch.setattr(j_fleet, "LocalBench", Replay)
    _same(ours, j_fleet.run_fleet(args))
    logs_dir = os.path.join(args.work_dir, "logs")
    assert t_fleet._churn_total(logs_dir) == j_fleet._churn_total(logs_dir) == ours["churns"]
    assert (t_fleet._ingress_watermark(logs_dir) == j_fleet._ingress_watermark(logs_dir)
            == ours["ingress_depth_peak"])
    assert ours["e2e_tps"] > 0 and ours["churns"] > 0
    assert set(ours) == {"e2e_tps", "e2e_bps", "e2e_latency_ms", "e2e_latency_p99_ms",
                         "e2e_latency_p999_ms", "consensus_latency_ms", "duration_s", "shed",
                         "churns", "ingress_depth_peak", "rate_misses"}
