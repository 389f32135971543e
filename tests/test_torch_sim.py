"""Twins of ``tests/test_sim.py`` on the port's simulation plane
(``hotstuff_tpu_torch/sim``), its parity with the reference's, and the
sim's backend contract.

- The reference file's 13 tests: the event heap and virtual clock, the
  timer on the clock, fault-free and faulted committees (determinism,
  jitter, a partition, crash and restart, the grind seeds under the
  reputation elector, a batch of chaos seeds) and the verdict memo.
- Parity: for the reference tests' pinned scenarios, chaos seeds 0:20 at
  N = 4 and 4 enumerated twins scenarios, the port's ``SimWorld`` returns
  the reference's verdict, trace and event count and, on every instance,
  the same commit sequence (round, block digest, virtual time).
- The backend contract: a backend whose name holds ``cuda`` sends
  verifications to the crypto bridge's pool, which has no loop to run on
  in the sim, so ``run_sim`` fails as the reference's does under a
  ``tpu``-named backend (the same ``RuntimeError``), having verified
  nothing.

Both packages run under ``HOTSTUFF_CRYPTO_BACKEND=cpu``; each test ends
with the memo off (``tests/torch_sim_cases.py``). Tolerance: exact.
"""

import pytest

import hotstuff_tpu.crypto as j_crypto
import hotstuff_tpu_torch.crypto as t_crypto
from hotstuff_tpu.faultline.policy import Scenario as JScenario
from hotstuff_tpu.faultline.policy import chaos_scenario as j_chaos
from hotstuff_tpu.sim import SimWorld as JWorld
from hotstuff_tpu.sim import twins as j_twins
from hotstuff_tpu_torch.consensus.timer import Timer
from hotstuff_tpu_torch.faultline.policy import Scenario, chaos_scenario
from hotstuff_tpu_torch.sim import EventHeap, SimWorld, VirtualClock, run_sim
from hotstuff_tpu_torch.sim import twins as t_twins

from .torch_sim_cases import commit_sequences, cpu_backends  # noqa: F401


@pytest.fixture(autouse=True)
def isolated(cpu_backends):  # noqa: F811
    yield


def _ok(result):
    v = result["verdict"]
    return v["safety"]["ok"] and v["liveness"]["recovered"]


# -- scheduler primitives ----------------------------------------------------


def test_event_heap_ties_break_in_push_order():
    heap = EventHeap()
    heap.push(1.0, "late")
    heap.push(0.5, "a")
    heap.push(0.5, "b")
    heap.push(0.5, "c")
    heap.push(0.2, "first")
    order = [heap.pop() for _ in range(len(heap))]
    assert order == [(0.2, "first"), (0.5, "a"), (0.5, "b"), (0.5, "c"), (1.0, "late")]


def test_event_heap_unorderable_payloads_never_compared():
    heap = EventHeap()
    heap.push(1.0, {"dict": "is not orderable"})
    heap.push(1.0, object())
    heap.push(1.0, ("tuple", object()))
    assert len(heap) == 3
    for _ in range(3):
        heap.pop()  # would raise TypeError if payloads were compared


def test_virtual_clock_monotonic():
    clock = VirtualClock()
    clock.advance_to(1.5)
    clock.advance_to(1.5)  # equal is fine
    assert clock() == 1.5
    with pytest.raises(ValueError):
        clock.advance_to(1.0)


def test_timer_over_virtual_clock():
    clock = VirtualClock(10.0)
    timer = Timer(500, clock=clock)
    assert timer.deadline == pytest.approx(10.5)
    clock.advance_to(12.0)
    timer.reset()
    assert timer.deadline == pytest.approx(12.5)


# -- protocol on the sim plane ----------------------------------------------


def test_fault_free_run_commits_consecutive_rounds():
    result = run_sim(Scenario(name="ff", seed=1, duration_s=3.0, events=[]), 4,
                     recovery_timeout_s=5.0)
    assert _ok(result), result["verdict"]
    for name, stream in result["commit_streams"].items():
        rounds = [r for r, _ in stream]
        assert rounds == list(range(1, len(rounds) + 1)), name
        assert len(rounds) > 10  # virtual seconds, real progress


def test_same_seed_same_world_is_byte_deterministic():
    def one():
        return SimWorld(chaos_scenario(42, duration_s=6.0), 4).run()

    a, b = one(), one()
    assert a["commit_streams"] == b["commit_streams"]
    assert a["trace"] == b["trace"]
    assert a["events"] == b["events"]
    assert a["verdict"] == b["verdict"]


def test_jitter_changes_interleaving_not_verdict():
    scenario = chaos_scenario(43, duration_s=6.0)
    base = run_sim(scenario, 4, jitter=0)
    other = run_sim(scenario, 4, jitter=1)
    assert _ok(base) and _ok(other)
    assert base["trace"] == other["trace"]  # the fault schedule is pinned
    assert base["commit_streams"] != other["commit_streams"]


CUT = dict(name="cut", seed=5, duration_s=6.0,
           events=[{"kind": "partition", "groups": [["n003"], ["n000", "n001", "n002"]],
                    "at": 2.0, "until": 4.0}])
CRASH_RESTART = dict(name="cr", seed=6, duration_s=6.0,
                     events=[{"kind": "crash", "node": 1, "at": 2.0},
                             {"kind": "restart", "node": 1, "at": 3.5}])
BYZ = dict(name="byz", seed=9, duration_s=6.0,
           events=[{"kind": "byzantine", "node": 2, "behavior": "equivocate",
                    "at": 1.0, "until": 4.0}])


def test_partitioned_minority_is_silent_during_cut():
    # timeout_delay 250 ms: round-robin elects the cut seat 2 rounds in 4,
    # so the majority commits in bursts between timeout pairs.
    result = run_sim(Scenario(**CUT), 4, timeout_delay=250)
    assert _ok(result), result["verdict"]
    inside = [t for _, t in result["commit_streams"]["n003"] if 2.3 < t < 4.0]
    assert inside == [], inside
    majority = [t for _, t in result["commit_streams"]["n000"] if 2.3 < t < 4.0]
    assert len(majority) > 3


def test_crash_restart_recovers_from_persisted_state():
    result = run_sim(Scenario(**CRASH_RESTART), 4)
    assert _ok(result), result["verdict"]
    stream = result["commit_streams"]["n001"]
    gap = [t for _, t in stream if 2.0 < t < 3.5]
    post = [r for r, t in stream if t > 3.5]
    assert gap == []  # dead nodes don't commit
    assert len(post) >= 3  # restarted from its own store and caught up


def test_grind_seeds_survive_on_sim_plane():
    for seed in (11, 12):
        scenario = chaos_scenario(seed, duration_s=8.0, crashes=1, partitions=1, byzantine=1,
                                  links=1)
        result = run_sim(scenario, 4, leader_elector="reputation")
        v = result["verdict"]
        assert v["safety"]["ok"], (seed, v["safety"])
        assert v["liveness"]["recovered"], (seed, v["liveness"])


def test_sim_chaos_seed_batch():
    for seed in range(20, 35):
        result = run_sim(chaos_scenario(seed, duration_s=6.0), 4)
        assert _ok(result), (seed, result["verdict"])


# -- the crypto memo stays semantically invisible ---------------------------


def test_verify_memo_caches_both_verdicts():
    pk, sk = t_crypto.generate_keypair(seed=b"m" * 32)
    digest = t_crypto.sha512_digest(b"memo-test")
    sig = t_crypto.Signature.new(digest, sk)
    bad = t_crypto.Signature(bytes(32) + sig.data[32:])
    t_crypto.enable_verify_memo(True)
    for _ in range(2):  # the second pass is served from the memo
        sig.verify(digest, pk)
        with pytest.raises(t_crypto.CryptoError):
            bad.verify(digest, pk)
    t_crypto.Signature.verify_batch(digest, [(pk, sig)])
    t_crypto.Signature.verify_batch(digest, [(pk, sig)])
    with pytest.raises(t_crypto.CryptoError):
        t_crypto.Signature.verify_batch(digest, [(pk, bad)])
    with pytest.raises(t_crypto.CryptoError):
        t_crypto.Signature.verify_batch(digest, [(pk, bad)])


def test_byzantine_signature_rejected_under_memo():
    result = run_sim(Scenario(**BYZ), 4)
    v = result["verdict"]
    assert v["safety"]["ok"], v["safety"]
    assert v["liveness"]["recovered"], v["liveness"]


# -- parity with the reference ----------------------------------------------

def _fixed(fields):
    return Scenario(**fields), JScenario(**fields)


def _chaos(seed, duration_s=6.0, **knobs):
    return (chaos_scenario(seed, duration_s=duration_s, **knobs),
            j_chaos(seed, duration_s=duration_s, **knobs))


# The reference tests' pinned runs: the scenario in each package (port's,
# reference's), and the world's keywords.
PINNED = {
    "fault-free": (lambda: _fixed(dict(name="ff", seed=1, duration_s=3.0, events=[])),
                   dict(recovery_timeout_s=5.0)),
    "chaos-42": (lambda: _chaos(42), {}),
    "chaos-43-jitter-1": (lambda: _chaos(43), dict(jitter=1)),
    "cut": (lambda: _fixed(CUT), dict(timeout_delay=250)),
    "crash-restart": (lambda: _fixed(CRASH_RESTART), {}),
    "grind-11-reputation": (lambda: _chaos(11, 8.0, crashes=1, partitions=1, byzantine=1, links=1),
                            dict(leader_elector="reputation")),
    "byzantine": (lambda: _fixed(BYZ), {}),
}


def _same_run(port_world, ref_world):
    port, ref = port_world.run(), ref_world.run()
    assert port["verdict"] == ref["verdict"]
    assert port["trace"] == ref["trace"]
    assert port["events"] == ref["events"]
    assert commit_sequences(port_world) == commit_sequences(ref_world)
    return port


@pytest.mark.parametrize("name", sorted(PINNED))
def test_pinned_scenarios_match_the_reference(name):
    make, kwargs = PINNED[name]
    t_sc, j_sc = make()
    result = _same_run(SimWorld(t_sc, 4, **kwargs), JWorld(j_sc, 4, **kwargs))
    assert any(result["commit_streams"].values())


@pytest.mark.parametrize("seed", range(20))
def test_chaos_seed_matches_the_reference(seed):
    t_sc, j_sc = _chaos(seed, 8.0)
    result = _same_run(SimWorld(t_sc, 4), JWorld(j_sc, 4))
    assert _ok(result), (seed, result["verdict"])


@pytest.mark.parametrize("index", range(4))
def test_twins_scenario_matches_the_reference(index):
    (t_sc, t_map), = list(t_twins.enumerate_twins(4, limit=index + 1))[index:]
    (j_sc, j_map), = list(j_twins.enumerate_twins(4, limit=index + 1))[index:]
    assert t_sc.to_json() == j_sc.to_json() and t_map == j_map
    result = _same_run(SimWorld(t_sc, 4, twins=t_map), JWorld(j_sc, 4, twins=j_map))
    assert result["verdict"]["safety"]["ok"]


# -- the backend contract ----------------------------------------------------


class _Stub:
    """A CPU verifier under a card backend's name, counting its calls."""

    def __init__(self, crypto, name):
        self.name = name
        self.calls = 0
        self._inner = crypto.CpuBackend()

    def verify_batch(self, msgs, pubs, sigs):
        self.calls += 1
        self._inner.verify_batch(msgs, pubs, sigs)


def test_run_sim_under_a_cuda_named_backend_fails_as_the_reference_under_tpu():
    scenario = dict(name="ff", seed=1, duration_s=3.0, events=[])
    errors = {}
    for label, crypto, scenario_cls, world_cls, name in (
            ("port", t_crypto, Scenario, SimWorld, "cuda-stub"),
            ("reference", j_crypto, JScenario, JWorld, "tpu-stub")):
        stub = _Stub(crypto, name)
        crypto.set_backend(stub)
        with pytest.raises(RuntimeError) as info:
            world_cls(scenario_cls(**scenario), 4).run()
        errors[label] = (type(info.value).__name__, str(info.value))
        assert stub.calls == 0, label  # nothing verified, inline or off the loop
    assert errors["port"] == errors["reference"]
