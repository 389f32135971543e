"""Twins of ``tests/test_sim_twins.py`` on the port's Twins generator
(``hotstuff_tpu_torch/sim/twins.py``), and its parity with the
reference's.

- The reference file's 9 tests: enumeration separates each twin pair,
  seed determinism, a correct core keeps safety and recovers under 10
  systematic twins scenarios, a weakened (f+1) quorum still cannot
  dual-commit at N = 4, the checker flags a forked stream, the dual-commit
  boundary reached beyond tolerance and unreachable within it, input
  validation, and per-round scenarios deterministic and safe.
- Parity: the enumerated, seed-drawn and per-round configurations equal
  the reference's, and the dual-commit boundary runs give equal verdicts
  and commit sequences.

Backend: ``cpu`` through ``HOTSTUFF_CRYPTO_BACKEND``. Tolerance: exact.
"""

import pytest

from hotstuff_tpu.sim import SimWorld as JWorld
from hotstuff_tpu.sim import twins as j_twins
from hotstuff_tpu_torch.sim.twins import (
    TWIN_SUFFIX,
    dual_commit_config,
    enumerate_twins,
    run_twins,
    twins_round_scenario,
    twins_scenario,
)

from .torch_sim_cases import commit_sequences, cpu_backends  # noqa: F401


@pytest.fixture(autouse=True)
def isolated(cpu_backends):  # noqa: F811
    yield


def test_enumeration_separates_the_twin_pair():
    seen = 0
    for scenario, twins_map in enumerate_twins(4, limit=16):
        (twin_inst, base), = twins_map.items()
        assert twin_inst == base + TWIN_SUFFIX
        for event in scenario.events:
            assert event["kind"] == "partition"
            groups = event["groups"]
            sides_a = [twin_inst in g for g in groups]
            sides_b = [base in g for g in groups]
            assert sides_a.count(True) == 1 and sides_b.count(True) == 1
            assert sides_a.index(True) != sides_b.index(True)
            assert max(len(g) for g in groups) >= 3
        seen += 1
    assert seen == 16


def test_twins_scenarios_are_seed_deterministic():
    a_sc, a_map = twins_scenario(7)
    b_sc, b_map = twins_scenario(7)
    assert a_sc.to_json() == b_sc.to_json()
    assert a_map == b_map
    c_sc, _ = twins_scenario(8)
    assert c_sc.to_json() != a_sc.to_json()


def test_correct_core_survives_systematic_twins():
    ran = 0
    for scenario, twins_map in enumerate_twins(4, limit=10):
        result = run_twins(scenario, twins_map, 4)
        v = result["verdict"]
        assert v["safety"]["ok"], (scenario.name, v["safety"])
        assert v["liveness"]["recovered"], (scenario.name, v["liveness"])
        (twin_inst, base), = twins_map.items()
        assert len(result["commit_streams"][twin_inst]) > 0
        assert len(result["commit_streams"][base]) > 0
        ran += 1
    assert ran == 10


def test_weakened_quorum_still_cannot_dual_commit_at_n4(monkeypatch):
    from hotstuff_tpu_torch.consensus.config import Committee

    monkeypatch.setattr(Committee, "quorum_threshold", Committee.validity_threshold)  # f+1
    for scenario, twins_map in enumerate_twins(4, limit=6):
        assert run_twins(scenario, twins_map, 4)["verdict"]["safety"]["ok"]


def test_checker_flags_forked_commit_streams():
    from hotstuff_tpu_torch.faultline.checker import CommitRecord, check
    from hotstuff_tpu_torch.sim.world import SimWorld

    scenario, twins_map = twins_scenario(3)
    result = run_twins(scenario, twins_map, 4)
    assert result["verdict"]["safety"]["ok"]
    world = SimWorld(scenario, 4, twins=twins_map)
    streams = {name: [CommitRecord(r, b"same-digest", t) for r, t in stream]
               for name, stream in result["commit_streams"].items()}
    twinned_base = next(iter(twins_map.values()))
    victim = next(n for n in ("n000", "n001", "n002", "n003") if n != twinned_base)
    for rec in streams[victim]:
        if rec.round == 5:
            rec.digest = b"forked-digest"
    verdict = check(world.schedule, streams, honest=world._honest_set())
    assert not verdict["safety"]["ok"]
    assert "conflicting_commit" in {v["type"] for v in verdict["safety"]["violations"]}


def test_dual_commit_boundary_is_reachable_beyond_tolerance():
    scenario, twins_map, sim_kwargs = dual_commit_config(pairs=2)
    result = run_twins(scenario, twins_map, 4, **sim_kwargs)
    v = result["verdict"]
    assert not v["safety"]["ok"], "beyond-tolerance split must dual-commit"
    assert v["safety"]["violations"]
    assert "conflicting_commit" in {viol["type"] for viol in v["safety"]["violations"]}
    committed = {n for n, s in result["commit_streams"].items() if s}
    assert {"n002", "n003"} <= committed


def test_dual_commit_boundary_is_unreachable_within_tolerance():
    scenario, twins_map, sim_kwargs = dual_commit_config(pairs=1)
    v = run_twins(scenario, twins_map, 4, **sim_kwargs)["verdict"]
    assert v["safety"]["ok"], v["safety"]
    assert v["safety"]["violations"] == []


def test_dual_commit_config_validates_inputs():
    with pytest.raises(ValueError):
        dual_commit_config(n=5)
    with pytest.raises(ValueError):
        dual_commit_config(pairs=3)


def test_round_scenarios_are_seed_deterministic_and_safe():
    a_sc, a_map, a_kw = twins_round_scenario(5)
    b_sc, b_map, b_kw = twins_round_scenario(5)
    assert a_sc.to_json() == b_sc.to_json()
    assert a_map == b_map
    assert a_kw == b_kw
    c_sc, _, c_kw = twins_round_scenario(6)
    assert (c_sc.to_json(), c_kw) != (a_sc.to_json(), a_kw)
    for seed in range(3):
        scenario, twins_map, sim_kwargs = twins_round_scenario(seed)
        result = run_twins(scenario, twins_map, 4, **sim_kwargs)
        assert result["verdict"]["safety"]["ok"], (seed, result["verdict"])


def test_generated_configurations_equal_the_references():
    port = [(sc.to_json(), m) for sc, m in enumerate_twins(4, limit=24)]
    ref = [(sc.to_json(), m) for sc, m in j_twins.enumerate_twins(4, limit=24)]
    assert port == ref
    for seed in range(8):
        (t_sc, t_map), (j_sc, j_map) = twins_scenario(seed), j_twins.twins_scenario(seed)
        assert (t_sc.to_json(), t_map) == (j_sc.to_json(), j_map)
        t_sc, t_map, t_kw = twins_round_scenario(seed)
        j_sc, j_map, j_kw = j_twins.twins_round_scenario(seed)
        assert (t_sc.to_json(), t_map, t_kw) == (j_sc.to_json(), j_map, j_kw)


@pytest.mark.parametrize("pairs", [1, 2])
def test_dual_commit_runs_match_the_reference(pairs):
    from hotstuff_tpu_torch.sim.world import SimWorld

    t_sc, t_map, t_kw = dual_commit_config(pairs=pairs)
    j_sc, j_map, j_kw = j_twins.dual_commit_config(pairs=pairs)
    t_world = SimWorld(t_sc, 4, twins=t_map, **t_kw)
    j_world = JWorld(j_sc, 4, twins=j_map, **j_kw)
    t_res, j_res = t_world.run(), j_world.run()
    assert t_res["verdict"] == j_res["verdict"]
    assert commit_sequences(t_world) == commit_sequences(j_world)
