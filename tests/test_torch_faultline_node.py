"""Faultline through the port's node, and the data plane's telemetry.

- ``HOTSTUFF_FAULTLINE=<scenario.json>`` arms a port ``Node`` as it arms a
  reference one (``hotstuff_tpu/node/node.py:28-69``): the same node
  names from the committee file, the same address map (consensus,
  mempool and worker ports), the same compiled schedule, the node's own
  name as its identity, armed before any actor spawns; ``crash`` and
  ``restart`` count ``faultline.injected.crashes``/``restarts`` and
  ``crash`` dumps the ``node_crash`` flight record.
- Four port nodes with one worker each, booted in one process (each in a
  task of its own, so that each keeps its own identity, under the one
  plane the first armed) while node 2 runs ``batch_withhold``: node 2's
  worker stores batches but withholds its acks
  (``faultline.injected.acks_withheld``), and the payload still commits
  on every node.
- After a worker committee's run (two port and two reference nodes), the
  data plane's registered metric names in the port's registry equal those
  in the reference's: ``mempool.worker.*``, ``mempool.resolver.*``, the
  watermark's ``<name>.store_depth`` and ``<name>.throttle_events``.

Ports 23500-23599.
"""

import asyncio
import json
import os

import pytest

import hotstuff_tpu.consensus.decode_arena as j_decode_arena
import hotstuff_tpu.faultline as j_faultline
import hotstuff_tpu.node.node as j_node_mod
import hotstuff_tpu.telemetry as j_telemetry
import hotstuff_tpu_torch.consensus.decode_arena as t_decode_arena
import hotstuff_tpu_torch.faultline as t_faultline
import hotstuff_tpu_torch.node.node as t_node_mod
from hotstuff_tpu_torch import telemetry

from .common import async_test
from .test_torch_dataplane_e2e import (  # noqa: F401  (the backends fixture)
    backends,
    boot,
    next_payload_commit,
    send_bundle,
    t_node,
    write_worker_testbed,
)

BASE = 23500


def settle_telemetry() -> None:
    """Both packages' telemetry reset and off, and each decode arena told
    so: the arena re-takes its counters only when it sees the enabled
    state flip, so one that last decoded while telemetry was on would keep
    counters of the registry this reset dropped, and a later file's
    committee would count its arena hits nowhere."""
    for tm, arena in ((telemetry, t_decode_arena), (j_telemetry, j_decode_arena)):
        tm.reset_for_tests()
        tm.disable()
        arena.arena()._metrics()


@pytest.fixture(autouse=True)
def faultline_isolated(monkeypatch):
    monkeypatch.setattr(t_node_mod, "_armed", None)
    settle_telemetry()
    yield
    t_faultline.uninstall()
    j_faultline.uninstall()
    settle_telemetry()


def write_scenario(tmp_path, events, duration_s=30.0) -> str:
    path = str(tmp_path / "scenario.json")
    t_faultline.Scenario(name="node-hook", seed=5, duration_s=duration_s,
                         events=events).save(path)
    return path


@async_test(timeout=60)
async def test_faultline_env_arms_a_port_node_as_the_reference_does(tmp_path, monkeypatch):
    committee_file, params_file, key_files = write_worker_testbed(tmp_path, BASE, workers=1)
    scenario = write_scenario(tmp_path, [
        {"kind": "partition", "groups": [[0, 1], [2, 3]], "at": 5.0, "until": 9.0},
        {"kind": "link", "src": 2, "dst": "*", "at": 1.0, "drop": 0.1},
    ])
    monkeypatch.setenv("HOTSTUFF_FAULTLINE", scenario)
    monkeypatch.setenv("HOTSTUFF_FLIGHT_DIR", str(tmp_path / "flight"))
    os.makedirs(tmp_path / "flight")
    telemetry.enable()

    # The reference's hook, on the same files, in a context of its own.
    j_committee = j_node_mod.Committee.read(committee_file)
    j_secret = j_node_mod.Secret.read(key_files[1])

    def arm_reference():
        j_node_mod._install_faultline_from_env(j_committee, j_secret.name)
        return j_faultline.hooks.NODE.get()

    j_identity = __import__("contextvars").copy_context().run(arm_reference)
    j_plane = j_faultline.hooks.plane

    async def boot_port():
        node = (await boot(["port"], committee_file, params_file, [key_files[1]], tmp_path))[0]
        return node, t_faultline.hooks.NODE.get()

    node, identity = await asyncio.create_task(boot_port())
    try:
        plane = t_faultline.hooks.plane
        assert plane is not None and j_plane is not None
        assert identity == j_identity == "n001"
        assert t_faultline.hooks.NODE.get() is None  # set in the node's boot context only
        assert plane.schedule.trace() == j_plane.schedule.trace()
        assert plane.addr_to_node == j_plane.addr_to_node
        assert plane.consensus_addrs == j_plane.consensus_addrs
        assert len(plane.addr_to_node) == 12  # consensus, mempool and worker ports
        # Every actor was spawned under the node's identity.
        for task in node.consensus.tasks + node.mempool.tasks:
            assert task.get_context()[t_faultline.hooks.NODE] == "n001"
        await node.crash()
        await node.restart()
        counters = telemetry.get_registry().snapshot()["counters"]
        assert counters["faultline.injected.crashes"] == 1
        assert counters["faultline.injected.restarts"] == 1
        flights = os.listdir(tmp_path / "flight")
        assert len(flights) == 1
        record = json.load(open(tmp_path / "flight" / flights[0]))
        assert record["reason"] == "node_crash"
    finally:
        await node.shutdown()


@async_test(timeout=90)
async def test_batch_withhold_node_withholds_acks_and_payload_commits(tmp_path, monkeypatch):
    committee_file, params_file, key_files = write_worker_testbed(tmp_path, BASE + 30, workers=1)
    scenario = write_scenario(tmp_path, [
        {"kind": "byzantine", "node": 2, "behavior": "batch_withhold", "at": 0.0, "until": 30.0},
    ])
    monkeypatch.setenv("HOTSTUFF_FAULTLINE", scenario)
    telemetry.enable()

    async def boot_one(i):
        return (await boot(["port"], committee_file, params_file, [key_files[i]], tmp_path / f"n{i}"))[0]

    for i in range(4):
        os.makedirs(tmp_path / f"n{i}")
    nodes = [await asyncio.create_task(boot_one(i)) for i in range(4)]
    writers = []
    try:
        plane = t_faultline.hooks.plane
        assert plane is not None
        committee = t_node.Committee.read(committee_file)
        for k in range(3):
            tx = b"\x00" + (20 + k).to_bytes(8, "big") + bytes([0x40 + k]) * 250
            writers.append(await send_bundle(committee, nodes[k % 2].name, tx))
        blocks = await asyncio.wait_for(
            asyncio.gather(*[next_payload_commit(n) for n in nodes]), 40)
        assert len({b.digest() for b in blocks}) == 1
        counters = telemetry.get_registry().snapshot()["counters"]
        assert counters.get("faultline.injected.acks_withheld", 0) > 0
        assert sum(w.certs_formed for n in nodes[:2] for w in n.mempool.dataplane.workers) > 0
        # Only node 2 withholds: the others' peer handlers acked.
        withholding = [plane.behavior_active(f"n{i:03d}", "batch_withhold") for i in range(4)]
        assert withholding == [False, False, True, False]
    finally:
        for w in writers:
            w.close()
        for n in nodes:
            await n.shutdown()


@async_test(timeout=90)
async def test_dataplane_metric_names_equal_the_references(tmp_path):
    telemetry.enable()
    j_telemetry.enable()
    packages = ["port", "reference", "port", "reference"]
    committee_file, params_file, key_files = write_worker_testbed(tmp_path, BASE + 60, "reference")
    nodes = await boot(packages, committee_file, params_file, key_files, tmp_path)
    writers = []
    try:
        committee = t_node.Committee.read(committee_file)
        for i in (0, 1):  # a port worker's batch and a reference worker's
            tx = b"\x00" + (30 + i).to_bytes(8, "big") + bytes([0x70 + i]) * 250
            writers.append(await send_bundle(committee, t_node.Secret.read(key_files[i]).name, tx))
        await asyncio.wait_for(asyncio.gather(*[next_payload_commit(n) for n in nodes]), 40)
    finally:
        for w in writers:
            w.close()
        for n in nodes:
            await n.shutdown()

    def dataplane_names(registry):
        snap = registry.snapshot()
        return {kind: sorted(k for k in snap[kind] if k.startswith(("mempool.worker.",
                                                                    "mempool.resolver.")))
                for kind in ("counters", "gauges", "histograms")}

    ours = dataplane_names(telemetry.get_registry())
    theirs = dataplane_names(j_telemetry.get_registry())
    assert ours == theirs
    assert "mempool.worker.store_depth" in ours["gauges"]
    assert "mempool.worker.throttle_events" in ours["counters"]
    assert "mempool.resolver.fetch_wait_ms" in ours["histograms"]
    assert "mempool.worker.ack_latency_ms" in ours["histograms"]
