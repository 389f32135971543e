"""Twins of ``tests/test_sim_streams.py`` on the port's sim-to-stream
bridge (``hotstuff_tpu_torch/sim/streams.py``) and watchtower, and its
parity with the reference's.

- The reference file's 11 tests: byte-deterministic rendering, streams
  that pass the port's ``telemetry.validate``, a restart as a new epoch
  with a new pid, a crash that loses the unflushed tail, each detector
  firing on its labelled fixture and accusing the victim, the near-miss
  negatives staying quiet, and alert times in virtual seconds. The
  fixtures are the reference's ``benchmark/detector_sweep.py`` scenarios,
  carried into the port's ``Scenario`` by their JSON.
- Parity: a fault-free run's rendered records, and a crash run's, equal the
  reference's byte for byte; the port's watchtower raises the reference's
  alerts on the same recording.

Backend: ``cpu`` through ``HOTSTUFF_CRYPTO_BACKEND``. Tolerance: exact.
"""

import json

import pytest

from benchmark.detector_sweep import control_scenario, single_fault_scenario
from hotstuff_tpu.faultline.policy import Scenario as JScenario
from hotstuff_tpu.sim.streams import StreamRecorder as JRecorder
from hotstuff_tpu.sim.streams import replay_watchtower as j_replay
from hotstuff_tpu.sim.world import SimWorld as JWorld
from hotstuff_tpu_torch.faultline.policy import Scenario
from hotstuff_tpu_torch.sim.streams import StreamRecorder, replay_watchtower
from hotstuff_tpu_torch.sim.world import SimWorld
from hotstuff_tpu_torch.telemetry.emitter import META_SCHEMA, SCHEMA
from hotstuff_tpu_torch.telemetry.validate import validate_stream
from hotstuff_tpu_torch.telemetry.watchtower import WatchtowerConfig

from .torch_sim_cases import cpu_backends  # noqa: F401


@pytest.fixture(autouse=True)
def isolated(cpu_backends):  # noqa: F811
    yield


# The small-window tuning of the reference's fixtures.
SMALL = dict(window_s=2.0, window_rounds=12, min_rounds=3, settle_s=1.0, laggard_windows=1,
             laggard_min_lag=6, laggard_stale_s=4.0, silent_windows=1)


def port(scenario) -> Scenario:
    """A reference scenario (the detector sweep's fixtures) in the port."""
    return Scenario.from_json(scenario.to_json())


def _record(scenario, interval_s=0.5):
    rec = StreamRecorder(interval_s=interval_s)
    result = SimWorld(port(scenario), 4, recorder=rec).run()
    return rec, result


def _alerts(scenario, config=None):
    rec, _ = _record(scenario)
    _, alerts = replay_watchtower(rec, config)
    return alerts


def _victim(scenario):
    nodes = [f"n{i:03d}" for i in range(4)]
    for ev in scenario.events:
        if "node" in ev:
            return nodes[ev["node"] % 4]
    raise AssertionError("scenario has no node-targeted event")


def test_render_is_byte_deterministic():
    scenario = single_fault_scenario("crash", 0)
    a = _record(scenario)[0].render()
    b = _record(scenario)[0].render()
    assert list(a) == list(b)
    for name in a:
        assert a[name] == b[name], f"stream {name} diverged between runs"


def test_written_streams_pass_telemetry_validate(tmp_path):
    rec, _ = _record(single_fault_scenario("crash", 0))
    paths = rec.write(str(tmp_path))
    assert len(paths) == 4
    for path in paths:
        report = validate_stream(path)
        assert report["ok"], report["problems"]
        assert report["self_described"]
        assert report["counts"][SCHEMA] > 0


def test_restart_opens_new_epoch_with_new_pid():
    scenario = single_fault_scenario("crash", 0)
    victim = _victim(scenario)
    rec, _ = _record(scenario)
    metas = [json.loads(line) for line in rec.render()[victim]
             if json.loads(line)["schema"] == META_SCHEMA]
    assert len(metas) == 2
    assert metas[0]["pid"] != metas[1]["pid"]
    assert metas[1]["ts"] > metas[0]["ts"]


def test_crash_loses_the_unflushed_tail():
    scenario = JScenario(name="streams-crash-tail", seed=3, duration_s=8.0,
                         events=[{"kind": "crash", "node": 1, "at": 4.0}])
    rec, _ = _record(scenario)
    streams = {name: [json.loads(line) for line in lines] for name, lines in rec.render().items()}
    assert [r for r in streams["n001"] if r["schema"] == SCHEMA and r.get("final")] == []
    for r in streams["n001"]:
        if "ts" in r:
            assert r["ts"] <= 4.0
        for ev in r.get("events", ()):
            assert ev[4] <= 4.0, "event past the last durable boundary"
    for survivor in ("n000", "n002", "n003"):
        finals = [r for r in streams[survivor] if r["schema"] == SCHEMA and r.get("final")]
        assert len(finals) == 1


def test_detector_equivocation_fires_on_equivocating_victim():
    scenario = single_fault_scenario("byzantine:equivocate", 0)
    victim = _victim(scenario)
    alerts = _alerts(scenario)
    assert any(a["detector"] == "equivocation" and a["accused"] == [victim] for a in alerts), alerts


def test_detector_grinding_leader_fires_on_silent_leader():
    scenario = single_fault_scenario("byzantine:silent_leader", 15)
    victim = _victim(scenario)
    alerts = _alerts(scenario)
    assert any(a["detector"] == "grinding_leader" and a["accused"] == [victim]
               for a in alerts), alerts


def test_detector_laggard_fires_on_crashed_node():
    scenario = single_fault_scenario("crash", 2)
    victim = _victim(scenario)
    alerts = _alerts(scenario, WatchtowerConfig(**SMALL))
    assert any(a["detector"] == "laggard" and a["accused"] == [victim] for a in alerts), alerts


def test_detector_partitioned_clique_fires_on_partition_victim():
    alerts = _alerts(single_fault_scenario("partition", 2), WatchtowerConfig(**SMALL))
    assert any(a["detector"] == "partitioned_clique" for a in alerts), alerts


def test_detector_silent_voter_fires_on_partition_victim():
    alerts = _alerts(single_fault_scenario("partition", 3), WatchtowerConfig(**SMALL))
    assert any(a["detector"] == "silent_voter" for a in alerts), alerts


def test_near_miss_negatives_stay_quiet():
    assert _alerts(control_scenario(0)) == []
    blip = JScenario(name="near-miss-partition", seed=9, duration_s=8.0,
                     events=[{"kind": "partition", "at": 3.0, "until": 3.8}])
    assert _alerts(blip) == []
    late = JScenario(name="near-miss-late-crash", seed=9, duration_s=8.0,
                     events=[{"kind": "crash", "node": 1, "at": 7.4}])
    assert _alerts(late) == []


def test_alert_timestamps_are_virtual_seconds():
    scenario = single_fault_scenario("byzantine:equivocate", 0)
    alerts = _alerts(scenario)
    assert alerts
    for a in alerts:
        assert 0.0 <= a["ts"] <= scenario.duration_s + 10.0


@pytest.mark.parametrize("fixture", ["control", "crash", "byzantine:equivocate"])
def test_rendered_records_equal_the_references(fixture, tmp_path):
    scenario = control_scenario(0) if fixture == "control" else single_fault_scenario(fixture, 0)
    t_rec, j_rec = StreamRecorder(interval_s=0.5), JRecorder(interval_s=0.5)
    SimWorld(port(scenario), 4, recorder=t_rec).run()
    JWorld(scenario, 4, recorder=j_rec).run()
    assert t_rec.render() == j_rec.render()
    t_paths = t_rec.write(str(tmp_path / "port"))
    j_paths = j_rec.write(str(tmp_path / "reference"))
    assert [open(p, "rb").read() for p in t_paths] == [open(p, "rb").read() for p in j_paths]
    t_alerts = replay_watchtower(t_rec)[1]
    j_alerts = j_replay(j_rec)[1]
    assert t_alerts == j_alerts
    if fixture == "control":
        assert t_alerts == []
