"""Twins of ``tests/test_sim_shrink.py`` on the port's shrinker
(``hotstuff_tpu_torch/sim/shrink.py``), and its parity with the
reference's.

- The reference file's 4 tests: convergence to a one-event core on a
  synthetic predicate, refusal of a passing scenario, the violation class
  kept, and the injected liveness wedge (two permanent crashes at N = 4)
  shrunk end to end to a reproducer that replays to the same violation.
- Parity: the wedge shrinks to the same scenario, steps and probe count
  in both packages, and the reproducer artifacts are equal.

Backend: ``cpu`` through ``HOTSTUFF_CRYPTO_BACKEND``. Tolerance: exact.
"""

import json

import pytest

from hotstuff_tpu.faultline.policy import Scenario as JScenario
from hotstuff_tpu.sim import shrink as j_shrink
from hotstuff_tpu_torch.faultline.policy import Scenario
from hotstuff_tpu_torch.sim.shrink import shrink, sim_failure_probe, write_reproducer

from .torch_sim_cases import cpu_backends  # noqa: F401


@pytest.fixture(autouse=True)
def isolated(cpu_backends):  # noqa: F811
    yield


NOISE = [
    {"kind": "link", "src": "?", "dst": "*", "at": 1.0, "until": 2.0,
     "drop": 0.1, "delay_ms": [1.0, 5.0]},
    {"kind": "partition", "at": 1.5, "until": 2.5},
    {"kind": "byzantine", "node": 0, "behavior": "stale_vote_flood", "at": 2.0, "until": 3.0},
    {"kind": "crash", "node": 2, "at": 2.2},
    {"kind": "restart", "node": 2, "at": 2.8},
]
BUG = {"kind": "crash", "node": 1, "at": 2.5}
WEDGE = dict(name="wedge", seed=3, duration_s=8.0, events=[
    NOISE[0],
    {"kind": "partition", "at": 2.0, "until": 4.0},
    {"kind": "crash", "node": 1, "at": 2.5},
    NOISE[2],
    {"kind": "crash", "node": 2, "at": 3.5},
    {"kind": "link", "src": "*", "dst": "?", "at": 4.0, "until": 5.5,
     "drop": 0.1, "delay_ms": [1.0, 10.0]},
])


def _synthetic_probe(scenario):
    """Fails iff a crash of node 1 is present: a one-event minimal core."""
    failing = any(e.get("kind") == "crash" and e.get("node") == 1 for e in scenario.events)
    return ("liveness" if failing else None), {"synthetic": failing}


def test_shrink_converges_to_single_event_core():
    scenario = Scenario(name="synth", seed=1, duration_s=8.0,
                        events=[*NOISE[:3], BUG, *NOISE[3:]])
    res = shrink(scenario, _synthetic_probe)
    assert res.violation == "liveness"
    assert res.scenario.events == [BUG]
    assert res.runs <= 40  # greedy pass, not exponential
    assert res.scenario.duration_s < scenario.duration_s  # pass 3 fired


def test_shrink_refuses_passing_scenario():
    with pytest.raises(ValueError):
        shrink(Scenario(name="fine", seed=1, duration_s=4.0, events=[]), _synthetic_probe)


def test_shrink_preserves_violation_class():
    def probe(scenario):
        if any(e == BUG for e in scenario.events):
            return "liveness", {}
        if any(e.get("kind") == "partition" for e in scenario.events):
            return "safety", {}  # a different class: not the same bug
        return None, {}

    scenario = Scenario(name="classes", seed=1, duration_s=8.0,
                        events=[{"kind": "partition", "at": 1.0, "until": 2.0}, BUG])
    res = shrink(scenario, probe)
    assert res.violation == "liveness"
    assert BUG in res.scenario.events


def test_shrink_real_liveness_wedge_end_to_end(tmp_path):
    probe = sim_failure_probe(4, recovery_timeout_s=10.0)
    res = shrink(Scenario(**WEDGE), probe)
    assert res.violation == "liveness"
    kinds = sorted(e["kind"] for e in res.scenario.events)
    assert kinds.count("crash") == 2  # the wedge core survives
    assert len(res.scenario.events) <= 4  # noise gone
    assert res.runs < 60
    path = write_reproducer(str(tmp_path), res.scenario, 4, res.verdict, steps=res.steps,
                            tag="sim-shrunk")
    with open(path) as f:
        data = json.load(f)
    assert data["schema"] == "simulant-repro-v1"
    violation, _ = probe(Scenario.from_json(data["scenario"]))
    assert violation == "liveness"  # the artifact reproduces as written


def test_wedge_shrinks_as_the_reference_does(tmp_path):
    t_res = shrink(Scenario(**WEDGE), sim_failure_probe(4, recovery_timeout_s=10.0))
    j_res = j_shrink.shrink(JScenario(**WEDGE), j_shrink.sim_failure_probe(
        4, recovery_timeout_s=10.0))
    assert t_res.scenario.to_json() == j_res.scenario.to_json()
    assert (t_res.violation, t_res.runs, t_res.steps) == (j_res.violation, j_res.runs, j_res.steps)
    assert t_res.verdict == j_res.verdict
    paths = [write_reproducer(str(tmp_path / "port"), t_res.scenario, 4, t_res.verdict,
                              steps=t_res.steps, tag="sim-shrunk"),
             j_shrink.write_reproducer(str(tmp_path / "reference"), j_res.scenario, 4,
                                       j_res.verdict, steps=j_res.steps, tag="sim-shrunk")]
    port_bytes, ref_bytes = (open(p, "rb").read() for p in paths)
    assert port_bytes == ref_bytes
