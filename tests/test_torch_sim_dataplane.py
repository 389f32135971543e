"""Twins of ``tests/test_sim_dataplane.py`` on the port's Conveyor model
(``hotstuff_tpu_torch/sim/dataplane.py``), and its parity with the
reference's.

- The reference file's 4 tests: certified ordering holds availability
  across 40 seeded storms with a batch-withholding node, the naive
  order-on-send rule is caught by the checker, certified ordering survives
  that counterexample, and a run is deterministic.
- Parity: the same storms through both packages give equal verdicts,
  traces, committed digests and event counts.

The model runs no crypto. Tolerance: exact.
"""

import pytest

from hotstuff_tpu.faultline.policy import Scenario as JScenario
from hotstuff_tpu.faultline.policy import chaos_scenario as j_chaos
from hotstuff_tpu.sim.dataplane import run_dataplane_sim as j_run
from hotstuff_tpu_torch.faultline.policy import Scenario, chaos_scenario
from hotstuff_tpu_torch.sim.dataplane import DataPlaneSim, run_dataplane_sim


def _with_withholding(scenario, cls=Scenario):
    """Layer a batch-withholding byzantine node onto a seeded storm."""
    events = list(scenario.events) + [{
        "kind": "byzantine", "node": "?", "behavior": "batch_withhold",
        "at": 0.2 * scenario.duration_s, "until": 0.8 * scenario.duration_s,
    }]
    return cls(name=scenario.name + "+withhold", seed=scenario.seed,
               duration_s=scenario.duration_s, events=events)


NAIVE = dict(
    seed=7, duration_s=2.0,
    events=[{"kind": "partition", "groups": [["n000"], ["n001", "n002", "n003"]], "at": 0.0},
            {"kind": "crash", "node": "n000", "at": 1.5}],
)


def test_certified_ordering_holds_availability_across_seeded_storms():
    total_committed = 0
    for seed in range(40):
        scenario = _with_withholding(chaos_scenario(seed, duration_s=4.0, byzantine=0))
        result = run_dataplane_sim(scenario, 4, workers=2)
        v = result["verdict"]
        assert v["ok"], (seed, v["violations"][:3])
        total_committed += result["committed"]
    assert total_committed > 500  # the sweep ordered real work


def test_naive_ordering_is_caught_by_the_checker():
    result = run_dataplane_sim(Scenario(name="naive-violation", **NAIVE), 4, require_certs=False)
    v = result["verdict"]
    assert not v["ok"]
    assert any(viol["type"] == "unresolvable_commit" for viol in v["violations"])


def test_certified_ordering_survives_the_naive_counterexample():
    result = run_dataplane_sim(Scenario(name="cert-survives", **NAIVE), 4, require_certs=True)
    assert result["verdict"]["ok"]
    assert result["committed"] > 0
    assert all(not d.startswith("n000/") for d in result["digests"])


def test_dataplane_sim_is_deterministic():
    scenario = _with_withholding(chaos_scenario(11, duration_s=3.0))
    a = DataPlaneSim(scenario, 4, workers=2).run()
    b = DataPlaneSim(scenario, 4, workers=2).run()
    assert a["trace"] == b["trace"]
    assert a["committed"] == b["committed"]
    assert a["events"] == b["events"]
    assert a["verdict"] == b["verdict"]


@pytest.mark.parametrize("seed", [0, 7, 11, 23])
@pytest.mark.parametrize("require_certs", [True, False])
def test_storm_matches_the_reference(seed, require_certs):
    port = run_dataplane_sim(_with_withholding(chaos_scenario(seed, duration_s=4.0)), 4,
                             workers=2, require_certs=require_certs)
    ref = j_run(_with_withholding(j_chaos(seed, duration_s=4.0), JScenario), 4,
                workers=2, require_certs=require_certs)
    assert port == ref
