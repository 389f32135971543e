"""Twins of ``tests/test_sim_equivalence.py`` on the port: the same
scenario on the port's asyncio plane (``faultline.run_scenario``, real TCP
and time) and on its simulation plane tells the same protocol story.

- The reference file's 3 tests: the compiled schedule is plane
  independent; a fault-free pinned seed commits the consecutive round
  sequence on both planes; chaos seed 12 (the reputation-grind schedule)
  gets the same verdict on both.
- Parity: the sim plane's trace and verdict for those scenarios equal the
  reference sim plane's.

Wall-clock interleavings differ between planes, so the claim is the round
structure and the checker's verdict, not byte-equal commits. Backend:
``cpu`` through ``HOTSTUFF_CRYPTO_BACKEND``. Ports 24200-24239.
"""

import pytest

from hotstuff_tpu.faultline.policy import chaos_scenario as j_chaos
from hotstuff_tpu.sim import run_sim as j_run_sim
from hotstuff_tpu_torch.faultline import Scenario, chaos_scenario, run_scenario
from hotstuff_tpu_torch.faultline.policy import Schedule
from hotstuff_tpu_torch.sim import run_sim

from .common import async_test
from .torch_sim_cases import cpu_backends  # noqa: F401

BASE = 24200
GRIND = dict(crashes=1, partitions=1, byzantine=1, links=1)


@pytest.fixture(autouse=True)
def isolated(cpu_backends):  # noqa: F811
    yield


def test_compiled_schedule_is_plane_independent():
    scenario = chaos_scenario(12, duration_s=8.0)
    names = [f"n{i:03d}" for i in range(4)]
    a: Schedule = scenario.compile(names)
    b: Schedule = scenario.compile(names)
    sim_trace = run_sim(scenario, 4)["trace"]
    assert a.trace() == b.trace() == sim_trace
    assert sim_trace == j_run_sim(j_chaos(12, duration_s=8.0), 4)["trace"]


@async_test(timeout=150)
async def test_fault_free_pinned_seed_matches_across_planes():
    scenario = Scenario(name="equiv-ff", seed=31, duration_s=3.0, events=[])
    sim = run_sim(scenario, 4, recovery_timeout_s=10.0)
    real = await run_scenario(scenario, 4, base_port=BASE, timeout_delay=1_000,
                              recovery_timeout_s=30.0)
    for result, plane in ((sim, "sim"), (real, "real")):
        v = result["verdict"]
        assert v["safety"]["ok"], (plane, v["safety"])
        assert v["liveness"]["recovered"], (plane, v["liveness"])
    for name in ("n000", "n001", "n002", "n003"):
        sim_rounds = [r for r, _ in sim["commit_streams"][name]]
        real_rounds = [r for r, _ in real["commit_streams"][name]]
        depth = min(len(sim_rounds), len(real_rounds))
        assert depth > 5, (name, depth)
        assert sim_rounds[:depth] == real_rounds[:depth] == list(range(1, depth + 1)), name


@async_test(timeout=200)
async def test_pinned_chaos_seed_verdict_matches_across_planes():
    scenario = chaos_scenario(12, duration_s=8.0, **GRIND)
    sim = run_sim(scenario, 4, timeout_delay=500, leader_elector="reputation",
                  recovery_timeout_s=60.0)
    real = await run_scenario(scenario, 4, base_port=BASE + 20, timeout_delay=500,
                              leader_elector="reputation", recovery_timeout_s=60.0)
    assert sim["trace"] == real["trace"]  # identical fault schedule
    sim_v, real_v = sim["verdict"], real["verdict"]
    for key in ("safety", "liveness"):
        assert sim_v[key]["ok"] == real_v[key]["ok"] is True, (key, sim_v[key], real_v[key])
    assert sim_v["byzantine"] == real_v["byzantine"]
    for name, count in sim_v["commits"].items():
        if name in sim_v["byzantine"]:
            continue
        assert count > 0, (name, "sim")
        assert real_v["commits"][name] > 0, (name, "real")


def test_sim_verdicts_equal_the_reference_sims():
    for port, ref, kwargs in (
            (Scenario(name="equiv-ff", seed=31, duration_s=3.0, events=[]),
             None, dict(recovery_timeout_s=10.0)),
            (chaos_scenario(12, duration_s=8.0, **GRIND), j_chaos(12, duration_s=8.0, **GRIND),
             dict(timeout_delay=500, leader_elector="reputation", recovery_timeout_s=60.0))):
        if ref is None:
            from hotstuff_tpu.faultline.policy import Scenario as JScenario

            ref = JScenario.from_json(port.to_json())
        t_res, j_res = run_sim(port, 4, **kwargs), j_run_sim(ref, 4, **kwargs)
        assert (t_res["trace"], t_res["verdict"], t_res["commit_streams"]) == (
            j_res["trace"], j_res["verdict"], j_res["commit_streams"])
