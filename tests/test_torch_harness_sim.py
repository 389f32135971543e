"""The port's sim-plane harness (``hotstuff_tpu_torch/benchmark/
{sim_sweep,detector_sweep}.py``) against the reference's scripts.

- ``sim_sweep --seeds 0:30 --twins 4 --inject-wedge --gate``: the summary
  equals the reference's (every count, violation and injected failure; the
  host and the wall-clock figures aside) and the shrunk reproducer's bytes
  are the reference's.
- Both scripts run with ``HOTSTUFF_CRYPTO_BACKEND`` unset: each sets the
  ``cpu`` backend for its run and puts the one before it back (ROADMAP's
  departure; the sim plane has no device path in either package).
- The cases of ``tests/test_detector_sweep.py`` on the port: deterministic
  scoring (and the reference's report on the same corpus), pinned and
  isolated single-fault scenarios, the match window's edges, control alerts
  as false alarms, labelled chaos incidents, the port's tuned preset against
  its own hash and the committed scorecard's, and the scorecard's gate.
- ``detector_sweep`` on a small corpus with ``--config preset:tuned-n4
  --gate``: the reference's scorecard, less host, timing and the
  ``generated_by`` name.

Backend: ``cpu``. Tolerance: exact. Ports: none.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import pytest

import benchmark.detector_sweep as j_sweep
import benchmark.sim_sweep as j_sim_sweep
import hotstuff_tpu_torch.crypto as t_crypto
from hotstuff_tpu.faultline.policy import chaos_scenario as j_chaos_scenario
from hotstuff_tpu_torch.benchmark import detector_sweep as t_sweep
from hotstuff_tpu_torch.benchmark import sim_sweep as t_sim_sweep
from hotstuff_tpu_torch.faultline.policy import chaos_scenario
from hotstuff_tpu_torch.telemetry.watchtower import DETECTOR_CATALOG_VERSION, WatchtowerConfig

from .torch_sim_cases import cpu_backends, settle  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
SCORECARD = REPO / "results" / "detector-scorecard-n4.json"
PRESET = REPO / "hotstuff_tpu_torch" / "telemetry" / "presets" / "tuned-n4.json"


@pytest.fixture(autouse=True)
def isolated(cpu_backends):  # noqa: F811
    yield


def _sweep_summary(main, out: Path) -> dict:
    assert main(["--seeds", "0:30", "--twins", "4", "--inject-wedge", "--gate",
                 "--artifacts", str(out), "--out", str(out / "sim.json")]) == 0
    summary = json.loads((out / "sim.json").read_text())
    summary.pop("host")
    for key in ("wall_s", "schedules_per_min"):
        summary["totals"].pop(key)
    for entry in summary["failures"] + summary["injected"]:
        entry["artifact"] = os.path.basename(entry["artifact"])
    return summary


def test_sim_sweep_summary_and_reproducer_are_the_references(tmp_path):
    ours = _sweep_summary(t_sim_sweep.main, tmp_path / "port")
    settle()
    ref = _sweep_summary(j_sim_sweep.main, tmp_path / "reference")
    assert ours == ref
    assert ours["totals"]["runs"] == 35 and ours["totals"]["twins_runs"] == 4
    assert ours["failures"] == []
    (wedge,) = ours["injected"]
    assert wedge["violation"] == "liveness" and wedge["artifact"]
    name = wedge["artifact"]
    assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "reference" / name).read_bytes()


@pytest.mark.parametrize("script", ["sim_sweep", "detector_sweep"])
def test_script_runs_with_the_backend_switch_unset(tmp_path, monkeypatch, script):
    monkeypatch.delenv("HOTSTUFF_CRYPTO_BACKEND", raising=False)
    monkeypatch.setattr(t_crypto, "_BACKEND", None)
    if script == "sim_sweep":
        assert t_sim_sweep.main(["--seeds", "0:3", "--gate", "--artifacts", str(tmp_path)]) == 0
    else:
        t_sweep.main(["--seeds", "0:2", "--labeled-seeds", "0", "--controls", "1",
                      "--out", str(tmp_path / "sweep.json")])
        assert json.loads((tmp_path / "sweep.json").read_text())["tuned"]["schedules"] == 3
    assert t_crypto._BACKEND is None  # put back as it was


def _score(module, config, specs):
    acc = module.ScoreAccumulator()
    for tag, is_control, scenario in specs:
        timeline, incidents, _ = module.run_schedule(scenario)
        alerts = module.replay_config(timeline, config)
        module.match_alerts(incidents, alerts)
        acc.add(tag, incidents, alerts, control=is_control)
    return acc


def _small_specs(module):
    specs = [(f"single:{kind}:0", False, module.single_fault_scenario(kind, 0))
             for kind in ("crash", "byzantine:equivocate")]
    specs.append(("control:0", True, module.control_scenario(0)))
    return specs


def test_scoring_is_deterministic_and_the_references():
    cfg = WatchtowerConfig()
    a = _score(t_sweep, cfg, _small_specs(t_sweep)).report()
    b = _score(t_sweep, cfg, _small_specs(t_sweep)).report()
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    settle()
    ref = _score(j_sweep, j_sweep.WatchtowerConfig(), _small_specs(j_sweep)).report()
    assert json.dumps(a, sort_keys=True) == json.dumps(ref, sort_keys=True)


def test_single_fault_scenarios_are_pinned_and_isolated():
    for kind in t_sweep.PINNED_CLASSES:
        scenario = t_sweep.single_fault_scenario(kind, 1)
        assert scenario.to_json() == j_sweep.single_fault_scenario(kind, 1).to_json()
        _, incidents, _ = t_sweep.run_schedule(scenario)
        pinned = [i for i in incidents if i.get("pinned")]
        assert len(pinned) == 1, (kind, incidents)
        assert pinned[0]["class"] == kind
        assert pinned[0]["until"] - pinned[0]["t"] >= 5.0


def test_match_window_attributes_alerts_to_incidents():
    incidents = [{"class": "crash", "kind": "crash", "peer": "n001", "t": 10.0, "until": 17.0,
                  "duration_s": 7.0, "pinned": True}]
    inside = {"detector": "silent_voter", "accused": ["n001"], "ts": 10.0 - t_sweep.MATCH_LEAD_S,
              "confidence": 0.9}
    outside = dict(inside, ts=17.0 + t_sweep.MATCH_SLACK_S + 0.1)
    wrong_peer = dict(inside, accused=["n002"])
    alerts = [dict(inside), dict(outside), dict(wrong_peer)]
    t_sweep.match_alerts(incidents, alerts)
    assert incidents[0]["detected"]
    assert [a["matched"] for a in alerts] == [True, False, False]
    assert (t_sweep.MATCH_LEAD_S, t_sweep.MATCH_SLACK_S) == (j_sweep.MATCH_LEAD_S,
                                                             j_sweep.MATCH_SLACK_S)


def test_control_alerts_count_as_false_alarms():
    acc = t_sweep.ScoreAccumulator()
    acc.add("control:x", [], [{"detector": "laggard", "accused": ["n000"], "ts": 3.0,
                               "confidence": 0.8, "matched": False}], control=True)
    assert acc.control_alerts == 1
    assert not acc.feasible()


def test_chaos_schedule_yields_labeled_incidents():
    _, incidents, _ = t_sweep.run_schedule(chaos_scenario(seed=0, duration_s=11.0))
    assert len(incidents) >= 4
    assert any(i["class"].startswith("byzantine") for i in incidents)
    settle()
    _, ref, _ = j_sweep.run_schedule(j_chaos_scenario(seed=0, duration_s=11.0))
    assert incidents == ref


def test_tuned_preset_round_trips_to_committed_hash():
    cfg = WatchtowerConfig.preset("tuned-n4")
    preset_doc = json.loads(PRESET.read_text())
    assert cfg.fingerprint() == preset_doc["config_hash"] == "e9e99f16bffb"
    assert preset_doc["detector_catalog"] == DETECTOR_CATALOG_VERSION
    scorecard = json.loads(SCORECARD.read_text())
    assert scorecard["tuned"]["config_hash"] == preset_doc["config_hash"]
    assert scorecard["detector_catalog"] == DETECTOR_CATALOG_VERSION


def test_committed_scorecard_meets_the_gate():
    gate = json.loads(SCORECARD.read_text())["gate"]
    assert gate["ok"], gate
    assert gate["recall_pinned"] == 1.0
    assert gate["control_alerts"] == 0
    tuned_p, default_p = gate["precision_vs_default"]
    assert tuned_p > default_p
    assert json.loads(SCORECARD.read_text())["tuned"]["incidents"] >= 2000


def _scorecard(main, path: Path) -> dict:
    main(["--seeds", "0:6", "--labeled-seeds", "1", "--controls", "2",
          "--config", "preset:tuned-n4", "--gate", "--out", str(path)])
    report = json.loads(path.read_text())
    for key in ("host", "generated_by"):
        report.pop(key)
    for side in ("default", "tuned"):
        report[side].pop("timing")
    return report


def test_detector_sweep_scorecard_is_the_references(tmp_path, monkeypatch):
    ours = _scorecard(t_sweep.main, tmp_path / "port.json")
    settle()
    monkeypatch.setattr("sys.argv", ["detector_sweep", "--seeds", "0:6", "--labeled-seeds", "1",
                                     "--controls", "2", "--config", "preset:tuned-n4", "--gate",
                                     "--out", str(tmp_path / "reference.json")])
    ref = _scorecard(lambda argv: j_sweep.main(), tmp_path / "reference.json")
    assert ours == ref
    assert ours["gate"]["ok"] and ours["tuned"]["config_hash"] == "e9e99f16bffb"
