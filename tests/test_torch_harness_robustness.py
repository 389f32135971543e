"""The port's robustness harness on live committees (``hotstuff_tpu_torch/
benchmark/{fault_matrix,soak,detector_bench}.py``), under ``cpu``.

- ``fault_matrix.build_scenarios`` gives the reference's three scenarios at
  N = 4 and N = 20, and ``run_plane`` runs them on one plane (asyncio, this
  process's) at N = 4: every verdict safe and recovered, with its SLO section
  and injection counts.
- ``soak --watch-config preset:tuned-n4``, 6 s at N = 4 on node processes,
  without chaos (a chaos run waits up to 45 s more for its recovery, which
  a loaded host can need; chip_smoke.py's 19c runs chaos seed 7 on the
  card): the verdict file under the reference's name, its verdict line the
  verdict's, no panic in the logs, the tuned preset loaded for the live
  watchtower over the four node streams, and every alert stamped with the
  preset's fingerprint.
- ``detector_bench`` with one fault-free control and ``--gate``: zero alerts,
  the report under the reference's name.

Tolerance: exact. Ports: 24700-24743 (the plane), 24750-24761 (the soak),
24770-24773 (the control).
"""

from __future__ import annotations

import argparse
import json

import pytest

import benchmark.fault_matrix as j_fault_matrix
from hotstuff_tpu_torch.benchmark import detector_bench, fault_matrix, soak

from .torch_sim_cases import cpu_backends  # noqa: F401

TUNED = "e9e99f16bffb"


@pytest.fixture(autouse=True)
def isolated(cpu_backends):  # noqa: F811
    yield


@pytest.mark.parametrize("n,duration", [(4, 8.0), (20, 12.0)])
def test_build_scenarios_are_the_references(n, duration):
    ours = [s.to_json() for s in fault_matrix.build_scenarios(n, duration)]
    assert ours == [s.to_json() for s in j_fault_matrix.build_scenarios(n, duration)]
    assert [s["name"] for s in ours] == [f"crash-f{max(1, (n - 1) // 3)}",
                                         "minority-partition", "delay-dup-reorder"]


def test_one_plane_at_n4_is_safe_and_recovered():
    args = argparse.Namespace(nodes=4, duration=4.0, timeout=1_000, base_port=24700,
                              plane="asyncio")
    verdicts = fault_matrix.run_plane(args)
    assert list(verdicts) == ["crash-f1", "minority-partition", "delay-dup-reorder"]
    for name, v in verdicts.items():
        assert v["safety"]["ok"] and v["liveness"]["recovered"], (name, v)
        assert v["slo"]["source"] == name
        assert v["injections"]["counts"]["events_applied"] > 0, name


def test_short_soak_runs_with_the_tuned_preset(tmp_path, capsys, monkeypatch):
    work = tmp_path / "soak"
    out = tmp_path / "out"
    loaded = []
    preset = soak.WatchtowerConfig.preset
    monkeypatch.setattr(soak.WatchtowerConfig, "preset",
                        lambda name: loaded.append(preset(name)) or loaded[-1])
    code = 0
    try:
        soak.main(["--nodes", "4", "--rate", "200", "--duration", "6",
                   "--watch-config", "preset:tuned-n4", "--base-port", "24750",
                   "--work-dir", str(work), "--output", str(out)])
    except SystemExit as e:
        code = e.code
    last = capsys.readouterr().out.splitlines()[-1]
    assert last == ("soak verdict: PASS" if code == 0 else "soak verdict: FAIL")
    verdict = json.loads((out / "soak-slo-n4-6s-clean.json").read_text())
    assert verdict["schema"] == "hotstuff-soak-verdict-v1"
    assert verdict["ok"] == (code == 0)
    assert verdict["chaos"] is None and verdict["summary"]
    assert verdict["parse_error"] is None
    assert [c.fingerprint() for c in loaded] == [TUNED]
    assert verdict["alerts"]["streams"]["streams"] == 4
    assert all(a["config"] == TUNED for a in verdict["alerts"]["alerts"])
    assert verdict["config"]["chaos_seed"] is None


def test_detector_bench_control_fires_no_alert(tmp_path, capsys):
    detector_bench.main(["--seeds", "", "--controls", "1", "--duration", "6",
                         "--base-port", "24770", "--output", str(tmp_path), "--gate"])
    assert capsys.readouterr().out.splitlines()[-1] == "detector bench PASS"
    report = json.loads((tmp_path / "watchtower-detect-n4-seeds.json").read_text())
    assert report["ok"] and report["problems"] == [] and report["runs"] == []
    (control,) = report["controls"]
    assert control["alerts"] == [] and control["checker"]["safety_ok"]
    assert report["schema"] == "hotstuff-watchtower-detect-v1"
