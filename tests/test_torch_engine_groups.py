"""Twins of ``tests/test_engine_groups.py`` on the port's engine groups
(``hotstuff_tpu_torch/parallel/engine_groups.py``), its ring against the
reference's, and the port's departures.

- The reference file's 8 tests: the SPSC ring (order, wraps and their
  pricing, back-pressure, the size check, a producer in another process),
  ``groups_from_env``, an import that pulls in neither jax nor the
  reference package, and a grouped committee of 4 over 2 worker processes
  that commits and merges telemetry.
- Parity: a reference ``ShmRing`` producer and a port consumer on one
  segment give the same records and counters, and the other way round,
  across many wraps and sliver skips.
- Departures: the groups start by ``spawn``, without the caller's main
  module; a group under ``cuda`` on a host without a card raises out of
  ``measure`` and never runs on the CPU; the parent's ``close`` unlinks
  each ring exactly once and Python's resource tracker reports no leaked
  segment; ``stop`` merges the groups' kernel launches (none on the CPU)
  and ``measure`` keeps its timings.

Groups run under ``HOTSTUFF_CRYPTO_BACKEND=cpu`` (inherited by the spawned
workers). Ports 24100-24115.
"""

import json
import multiprocessing
import os
import struct
import subprocess
import sys
from multiprocessing import shared_memory

import pytest
import torch

from hotstuff_tpu.parallel import engine_groups as j_groups
from hotstuff_tpu_torch.parallel import engine_groups as t_groups
from hotstuff_tpu_torch.parallel.engine_groups import (
    OP_COMMIT,
    OP_READY,
    EngineGroupRuntime,
    ShmRing,
    groups_from_env,
    run_grouped_committee,
)

_REC = struct.Struct("<BI")
BASE = 24100


@pytest.fixture
def ring():
    r = ShmRing(create=True, capacity=1 << 10)
    yield r
    r.close()


@pytest.fixture
def cpu_groups(monkeypatch):
    monkeypatch.setenv("HOTSTUFF_CRYPTO_BACKEND", "cpu")


def test_ring_roundtrip_preserves_order_and_payloads(ring):
    records = [(OP_READY, b""), (OP_COMMIT, b"x" * 17), (7, bytes(range(64)))]
    for op, payload in records:
        assert ring.try_push(op, payload)
    assert ring.pop_all() == records
    assert ring.pop_all() == []  # drained


def test_ring_wraps_and_prices_the_wrap(ring):
    payload = bytes(100)
    pushed = popped = 0
    for _ in range(64):  # 64 * ~105 B through a 1 KiB arena: many wraps
        assert ring.try_push(OP_COMMIT, payload)
        pushed += 1
        for op, got in ring.pop_all():
            assert op == OP_COMMIT and got == payload
            popped += 1
    assert popped == pushed
    assert ring.wraps >= 5
    c = ring.counters()
    assert c["pushes"] == pushed and c["pops"] == popped
    assert c["push_bytes"] == pushed * (_REC.size + len(payload))


def test_ring_backpressure_full_then_drains(ring):
    payload = bytes(200)
    pushed = 0
    while ring.try_push(OP_COMMIT, payload):
        pushed += 1
    assert 0 < pushed < 6  # 1 KiB arena holds at most 4 such records
    assert not ring.try_push(OP_COMMIT, payload)
    assert len(ring.pop_all()) == pushed
    assert ring.try_push(OP_COMMIT, payload)  # freed space reusable


def test_ring_rejects_record_larger_than_arena(ring):
    with pytest.raises(ValueError):
        ring.try_push(OP_COMMIT, bytes(1 << 10))


def _producer(name, count):
    r = ShmRing(name=name)
    try:
        for i in range(count):
            r.push(OP_COMMIT, struct.pack("<I", i))
    finally:
        r.close()


def test_ring_cross_process_visibility():
    """The deployment shape: the producer in a spawned child (the port's
    start method), the consumer here, records in order with no loss."""
    ring = ShmRing(create=True, capacity=1 << 12)
    try:
        p = multiprocessing.get_context("spawn").Process(target=_producer, args=(ring.name, 500))
        p.start()
        got = []
        while len(got) < 500:
            got.extend(ring.pop_all())
            assert p.exitcode in (None, 0)
        p.join(timeout=60)
        assert p.exitcode == 0
        assert [struct.unpack("<I", pl)[0] for _, pl in got] == list(range(500))
    finally:
        ring.close()


def test_groups_from_env(monkeypatch):
    monkeypatch.delenv("HOTSTUFF_ENGINE_GROUPS", raising=False)
    assert groups_from_env() == 0  # the switch's default: one process
    monkeypatch.setenv("HOTSTUFF_ENGINE_GROUPS", "4")
    assert groups_from_env() == 4
    monkeypatch.setenv("HOTSTUFF_ENGINE_GROUPS", "junk")
    assert groups_from_env() == 0
    monkeypatch.setenv("HOTSTUFF_ENGINE_GROUPS", "-2")
    assert groups_from_env() == 0


def test_engine_groups_import_is_jax_free():
    """A worker pays no jax import: the runtime, imported through the
    package, pulls in neither jax nor the reference package."""
    code = ("import sys\n"
            "import hotstuff_tpu_torch.parallel.engine_groups\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.split('.')[0] == 'hotstuff_tpu']\n"
            "sys.exit(1 if bad else 0)\n")
    assert subprocess.run([sys.executable, "-c", code], timeout=120).returncode == 0


def test_grouped_committee_commits_and_merges_telemetry(cpu_groups):
    """n = 4 over 2 worker processes commits rounds; the parent sees
    per-node commit sequence numbers and a merged counter registry with
    each group's ring pricing."""
    per_round, merged = run_grouped_committee(n=4, rounds_target=3, n_groups=2, base_port=BASE)
    assert per_round > 0
    counters = merged["counters"]
    assert counters  # workers enabled telemetry before building engines
    assert any(k.startswith("consensus.") for k in counters)
    assert counters.get("crypto.dispatch.cpu", 0) > 0  # the groups verified, on the CPU
    rings = merged["rings"]
    assert rings["group0"]["pushes"] >= 1  # ready + commits + telemetry
    assert rings["group1"]["pushes"] >= 1
    assert rings["group0.parent"]["commands"]["pushes"] >= 1  # OP_STOP
    # Each group's kernel launches, merged: every kernel counted, none
    # launched under the cpu backend.
    assert merged["launches"] == {name: 0 for name in (
        "decompress", "sqrt_pow", "msm_partials_signed", "msm_partials", "msm_combine",
        "verdict", "verdict_tree", "sha512")}


@pytest.mark.parametrize("producer,consumer", [("reference", "port"), ("port", "reference")])
def test_ring_records_cross_between_the_packages(producer, consumer):
    """One segment, one package on each side: the same records in order
    through wrap markers and trailing-sliver skips, and equal counters to a
    run inside either package alone."""
    mods = {"port": t_groups, "reference": j_groups}
    owner = mods[consumer].ShmRing(create=True, capacity=1 << 9)
    peer = mods[producer].ShmRing(name=owner.name)
    alone = {label: mod.ShmRing(create=True, capacity=1 << 9) for label, mod in mods.items()}
    try:
        sizes = [0, 1, 3, 17, 40, 100, 7, 250, 2, 90, 13, 200, 5, 64, 31, 150] * 8
        sent, got = [], []
        for i, size in enumerate(sizes):
            record = (1 + i % 6, bytes((i + k) % 256 for k in range(size)))
            while not peer.try_push(*record):
                got.extend(owner.pop_all())
            sent.append(record)
            for ring in alone.values():
                while not ring.try_push(*record):
                    ring.pop_all()
        got.extend(owner.pop_all())
        assert got == sent
        assert peer.wraps > 0
        assert peer.counters()["pushes"] == len(sent) == owner.counters()["pops"]
        for label, ring in alone.items():
            ring.pop_all()
            want = ring.counters()
            assert (peer.counters()["wraps"], peer.counters()["push_bytes"]) == (
                want["wraps"], want["push_bytes"]), label
    finally:
        peer.close()
        owner.close()
        for ring in alone.values():
            ring.close()


def test_group_under_cuda_without_a_card_raises_out_of_measure(monkeypatch):
    """``HOTSTUFF_CRYPTO_BACKEND=cuda`` on a host with no card: each group
    fails before any engine runs (``OP_ERROR``), ``measure`` raises
    ``RuntimeError("group g: ...")``, and nothing committed, so nothing
    ran on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the check is for a host without one")
    monkeypatch.setenv("HOTSTUFF_CRYPTO_BACKEND", "cuda")
    rt = EngineGroupRuntime(4, 2, base_port=BASE + 12)
    rt.start()
    try:
        with pytest.raises(RuntimeError, match=r"^group [01]: .*no CUDA device"):
            rt.measure(1, boot_timeout=120)
    finally:
        merged = rt.stop()
    assert rt.commit_counts == [0, 0, 0, 0]
    assert not any(g.ready for g in rt.groups)
    assert merged["counters"] == {}


_TRACKED_RUN = """
import json, sys
from multiprocessing import shared_memory
from hotstuff_tpu_torch.parallel import engine_groups
unlinked = []
_unlink = shared_memory.SharedMemory.unlink
def counting_unlink(self):
    unlinked.append(self.name)
    _unlink(self)
shared_memory.SharedMemory.unlink = counting_unlink
if __name__ == "__main__":
    rt = engine_groups.EngineGroupRuntime(4, 2, base_port=int(sys.argv[1]))
    rt.start()
    kinds = [type(g.process).__name__ for g in rt.groups]
    names = [n for g in rt.groups for n in (g.events.name, g.commands.name)]
    try:
        per_round = rt.measure(2)
    finally:
        merged = rt.stop()
    print(json.dumps({"kinds": kinds, "names": names, "unlinked": unlinked,
                      "per_round": per_round, "alive": [g.process.is_alive() for g in rt.groups],
                      "counters": merged["counters"], "timing": rt.timing}))
"""


@pytest.fixture(scope="module")
def tracked_run():
    """One grouped committee (N = 4, 2 groups) in a fresh interpreter, so
    that its resource tracker's exit report can be read; unlinks counted."""
    env = {**os.environ, "HOTSTUFF_CRYPTO_BACKEND": "cpu"}
    out = subprocess.run([sys.executable, "-c", _TRACKED_RUN, str(BASE + 8)],
                         capture_output=True, text=True, timeout=240, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


def test_groups_start_by_spawn_where_the_reference_forks(tracked_run):
    """Each group is a spawned process (a CUDA context cannot be
    re-initialised in a forked child); its keys arrive as bytes and the
    committee commits."""
    rec, _ = tracked_run
    assert rec["kinds"] == ["SpawnProcess"] * 2
    assert rec["per_round"] > 0 and rec["alive"] == [False, False]
    assert rec["counters"].get("crypto.dispatch.cpu", 0) > 0


def test_close_unlinks_each_ring_once_and_the_tracker_reports_no_leak(tracked_run):
    """Python 3.12's resource tracker: a spawned worker that attaches a
    segment registers it with the tracker it inherits. The parent's close
    still unlinks each of its rings exactly once, no segment survives, and
    the tracker warns of no leaked shared_memory at exit."""
    rec, stderr = tracked_run
    assert sorted(rec["unlinked"]) == sorted(rec["names"]) and len(rec["names"]) == 4
    for name in rec["names"]:
        with pytest.raises(FileNotFoundError):
            shared_memory.SharedMemory(name=name)
    assert "leaked shared_memory" not in stderr
    assert "resource_tracker" not in stderr


def test_measure_keeps_the_ready_first_commit_and_stall_times(tracked_run):
    """``measure``'s ``timing``, in seconds from ``start``: each group's
    ready time, then the first commit on every node, then the timed
    rounds, whose stall bound covers at least their span."""
    rec, _ = tracked_run
    timing = rec["timing"]
    ready = timing["ready_s"]
    assert sorted(ready) == ["0", "1"]
    assert 0 < max(ready.values()) <= timing["first_commit_s"]
    assert timing["stall_s"] >= 2 * rec["per_round"] > 0


_MAIN_SCRIPT = """
import multiprocessing, sys, time
from hotstuff_tpu_torch.parallel import engine_groups
with open(sys.argv[1], "a") as f:
    f.write(__name__ + "\\n")
if __name__ == "__main__":
    ctx = multiprocessing.get_context("spawn")
    for start in (engine_groups._start, ctx.Process.start):
        p = ctx.Process(target=time.sleep, args=(0,))
        start(p)
        p.join(60)
        assert p.exitcode == 0, p.exitcode
        with open(sys.argv[1], "a") as f:
            f.write("joined\\n")
"""


def test_groups_start_without_the_callers_main_module(tmp_path):
    """A spawned group does not re-run the caller's main module (its
    imports and top-level work): a script that notes its module name at
    its top sees only its own run through ``_start``, where a plain
    spawn start re-runs it as ``__mp_main__``."""
    script, marks = tmp_path / "caller.py", tmp_path / "marks.txt"
    script.write_text(_MAIN_SCRIPT)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}
    out = subprocess.run([sys.executable, str(script), str(marks)], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert marks.read_text().split() == ["__main__", "joined", "__mp_main__", "joined"]
