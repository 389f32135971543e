"""Twins of ``tests/test_statesync_sim.py`` on the port's state-sync sim
model (``hotstuff_tpu_torch/sim/statesync.py``), and its parity with the
reference's.

- The reference file's 7 tests: the rejoin schedule's shape and
  determinism, a cold (wiped) join past truncated peers landing by
  snapshot, a warm lagging rejoin, a small sweep, retention 0 truncating
  nothing, and (``slow``, as there) the real-plane wipe-restart scenario
  of ``benchmark/scenarios/rejoin.json`` on port engines.
- Parity: rejoin seeds 0:6 give the reference's verdicts (frontier
  availability included), rejoin metrics and commit sequences; the entry
  point's sweep summary, less its wall-clock fields, equals the
  reference's.

Backend: ``cpu`` through ``HOTSTUFF_CRYPTO_BACKEND``. The slow test binds
24300-24303. Tolerance: exact.
"""

from __future__ import annotations

import asyncio
import json
import pathlib

import pytest

from hotstuff_tpu.sim import statesync as j_statesync
from hotstuff_tpu_torch import telemetry
from hotstuff_tpu_torch.sim import statesync as t_statesync
from hotstuff_tpu_torch.sim.statesync import _violation, rejoin_scenario, run_rejoin

from .torch_sim_cases import cpu_backends  # noqa: F401


@pytest.fixture(autouse=True)
def isolated(cpu_backends):  # noqa: F811
    telemetry.reset_for_tests()
    yield
    telemetry.reset_for_tests()


def _find_seed(want_wipe: bool, start: int = 0) -> int:
    for seed in range(start, start + 64):
        restart = next(e for e in rejoin_scenario(seed).events if e["kind"] == "restart")
        if bool(restart.get("wipe")) == want_wipe:
            return seed
    raise AssertionError("no matching seed in range")


def test_rejoin_scenario_shape():
    sc = rejoin_scenario(3)
    kinds = [e["kind"] for e in sc.events]
    assert "crash" in kinds and "restart" in kinds
    crash = next(e for e in sc.events if e["kind"] == "crash")
    restart = next(e for e in sc.events if e["kind"] == "restart")
    assert crash["at"] < restart["at"]
    assert crash["node"] == restart["node"]


def test_rejoin_scenario_deterministic():
    a, b = rejoin_scenario(11), rejoin_scenario(11)
    assert a.to_json() == b.to_json()
    assert rejoin_scenario(12).to_json() != a.to_json()


def test_cold_join_recovers_past_truncation():
    result = run_rejoin(_find_seed(want_wipe=True))
    verdict = result["verdict"]
    assert _violation(verdict) is None, verdict
    rejoin = result["rejoin"]
    assert rejoin["wipe"] is True
    assert rejoin["post_rejoin_commits"] > 0, "victim never committed again"
    assert rejoin["victim_snapshot_round"] is not None, "cold join must land via snapshot install"
    assert verdict["frontier_availability"]["ok"]


def test_warm_lag_rejoin_recovers():
    result = run_rejoin(_find_seed(want_wipe=False))
    assert _violation(result["verdict"]) is None, result["verdict"]
    assert result["rejoin"]["wipe"] is False
    assert result["rejoin"]["post_rejoin_commits"] > 0


def test_rejoin_sweep_small():
    for seed in range(6):
        result = run_rejoin(seed)
        assert _violation(result["verdict"]) is None, (seed, result["verdict"])


def test_retention_zero_never_truncates():
    result = run_rejoin(_find_seed(want_wipe=False), retention_rounds=0)
    verdict = result["verdict"]
    assert _violation(verdict) is None
    assert not verdict["frontier_availability"].get("floors")


@pytest.mark.slow
def test_real_plane_wipe_restart_rejoin():
    """``benchmark/scenarios/rejoin.json`` end to end on port engines over
    asyncio and TCP: crash n1 at 2 s, wipe and restart at 8 s against
    retention-truncated peers; safe, recovered, frontier available."""
    from hotstuff_tpu_torch.faultline import Scenario, run_scenario

    path = pathlib.Path(__file__).resolve().parents[1] / "benchmark" / "scenarios" / "rejoin.json"
    result = asyncio.run(run_scenario(Scenario.load(str(path)), 4, base_port=24300,
                                      retention_rounds=16))
    verdict = result["verdict"]
    assert verdict["safety"]["ok"], verdict["safety"]
    assert verdict["liveness"]["recovered"], verdict["liveness"]
    assert verdict["frontier_availability"]["ok"], verdict["frontier_availability"]


@pytest.mark.parametrize("seed", range(6))
def test_rejoin_seed_matches_the_reference(seed):
    port, ref = t_statesync.run_rejoin(seed), j_statesync.run_rejoin(seed)
    assert port["verdict"] == ref["verdict"]
    assert port["rejoin"] == ref["rejoin"]
    assert port["commit_streams"] == ref["commit_streams"]
    assert port["events"] == ref["events"]


@pytest.mark.parametrize("backend", [None, "cuda", "cuda-batched"])
def test_entry_point_requires_a_cpu_backend(backend, monkeypatch, capsys):
    """The port's departure: the entry point runs only under a cpu backend
    that the caller names; unset, or naming ``cuda``, it exits with a usage
    error before any schedule runs, and installs no backend."""
    if backend is None:
        monkeypatch.delenv("HOTSTUFF_CRYPTO_BACKEND", raising=False)
    else:
        monkeypatch.setenv("HOTSTUFF_CRYPTO_BACKEND", backend)
    with pytest.raises(SystemExit) as exc:
        t_statesync.main(["--seeds", "0:1"])
    assert exc.value.code == 2
    captured = capsys.readouterr()
    assert "set HOTSTUFF_CRYPTO_BACKEND=cpu" in captured.err
    assert "schedules" not in captured.out
    assert t_statesync.crypto._BACKEND is None


def test_entry_point_summary_equals_the_references(tmp_path, capsys):
    summaries = {}
    for label, mod in (("port", t_statesync), ("reference", j_statesync)):
        out = tmp_path / f"{label}.json"
        # --verbose: without it the entry point quiets the loggers for the
        # rest of the process.
        assert mod.main(["--seeds", "0:3", "--gate", "--verbose", "--out", str(out)]) == 0
        summary = json.loads(out.read_text())
        for key in ("wall_s", "schedules_per_min"):
            summary["totals"].pop(key)
        summaries[label] = summary
    assert summaries["port"] == summaries["reference"]
    out = capsys.readouterr().out
    assert "statesync-sweep: 3 schedules" in out
    assert "statesync-sweep: crypto backend cpu" in out
