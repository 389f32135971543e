"""Replica rejoin on the port, on the CPU, over localhost TCP.

- Four port engines (``Consensus.spawn``, mempool channels sunk) at
  ``retention_rounds = 4`` on ``LogEngine`` stores: a cold rejoin (engine 1
  crashes uncleanly, the survivors compact past it, it restarts on an
  empty store and installs one verified snapshot, then commits again) and
  a warm restart (it restarts on its own store, restores its floor from
  its own record and commits again). The shape of the reference's
  ``benchmark/scenarios/rejoin.json``, shortened.
- Mixed committees of two reference engines and two port engines: a wiped
  port engine rejoins from a record that reference engines hold, and a
  wiped reference engine from one that port engines hold (the record, the
  ``state_request``/``state_response`` frames and the floors are the
  same bytes in both packages).
- The node's supervised ``crash``/``restart`` on both packages' ``Node``
  (four nodes from the same files, one crashing and coming back on its own
  store), with ``workers = 0`` and with the data plane's ``workers = 1``
  through the commit resolver; and a port node that crashes during its
  compactor's background log rewrite, then restarts or shuts down.

Tolerance: every block committed at a round has the same digest on every
engine; each engine's commits after its first form one chain (each block's
parent is the block committed before it, the joiner's first after the
restart is the snapshot's frontier's child). Ports 22600-22799.
"""

from __future__ import annotations

import asyncio
import random
import threading
import time

import pytest

import hotstuff_tpu.consensus as j_consensus
import hotstuff_tpu.consensus.cert_arena as j_cert_arena
import hotstuff_tpu.consensus.helper as j_helper
import hotstuff_tpu.consensus.statesync as j_statesync
import hotstuff_tpu.crypto as j_crypto
import hotstuff_tpu.store as j_store
import hotstuff_tpu_torch.consensus as t_consensus
import hotstuff_tpu_torch.consensus.helper as t_helper
import hotstuff_tpu_torch.consensus.statesync as t_statesync
import hotstuff_tpu_torch.crypto as t_crypto
import hotstuff_tpu_torch.store as t_store
from hotstuff_tpu_torch.consensus import cert_arena
from hotstuff_tpu_torch.network.receiver import write_frame

from .common import async_test
from .test_torch_dataplane_e2e import PKG as NODE_PKG
from .test_torch_dataplane_e2e import next_payload_commit, send_bundle, write_worker_testbed

BASE = 22600
RETENTION = 4
PKG = {
    "port": (t_consensus, t_crypto, t_store, t_statesync),
    "reference": (j_consensus, j_crypto, j_store, j_statesync),
}


@pytest.fixture(autouse=True)
def backends(monkeypatch):
    monkeypatch.setattr(t_crypto, "_BACKEND", None)
    monkeypatch.setattr(j_crypto, "_BACKEND", None)
    t_crypto.set_backend("cpu")
    j_crypto.set_backend("cpu")
    cert_arena.reset()
    yield
    cert_arena.reset()


class Seat:
    """One engine of a committee: its package, keys, store directory, live
    ``Consensus``, and every block it committed."""

    def __init__(self, package: str, index: int, seed: bytes, base: int, tmp_path) -> None:
        self.package, self.index, self.tmp_path = package, index, tmp_path
        self.consensus_pkg, crypto, self.store_pkg, self.statesync = PKG[package]
        self.pk, self.sk = crypto.generate_keypair(seed=seed)[:2]
        self.crypto = crypto
        self.generation = 0
        self.records: list[bytes] = []  # every snapshot record it wrote
        self.store = self._open_store()
        self.consensus = None
        self.crashed = None  # the Consensus a crash left behind
        self.tasks: list[asyncio.Task] = []
        self.commits: list = []  # (generation, block)
        self.installs: list[tuple[int, bytes]] = []  # (commits seen before it, record)

    def _open_store(self):
        store = self.store_pkg.Store(engine=self.store_pkg.LogEngine(
            str(self.tmp_path / f"{self.package}_{self.index}_{self.generation}")))
        write_meta = store.write_meta

        async def recorded(key, value, sync=False):
            if key == self.statesync.SNAPSHOT_KEY:
                self.records.append(value)
            await write_meta(key, value, sync=sync)

        store.write_meta = recorded
        return store

    def core(self):
        """The engine's Core (the reference keeps it local to ``spawn``: it
        is the run coroutine's ``self``)."""
        if self.package == "port":
            return self.consensus.core
        return self.consensus.tasks[0].get_coro().cr_frame.f_locals["self"]

    async def spawn(self, committee, parameters) -> None:
        rx_mempool, tx_mempool, tx_commit = asyncio.Queue(), asyncio.Queue(), asyncio.Queue()

        async def drain():
            while True:
                await tx_mempool.get()

        async def collect(generation=self.generation):
            while True:
                self.commits.append((generation, await tx_commit.get()))

        self.consensus = await self.consensus_pkg.Consensus.spawn(
            self.pk, committee, parameters, self.crypto.SignatureService(self.sk), self.store,
            rx_mempool, tx_mempool, tx_commit,
        )
        self.tasks = [asyncio.create_task(drain()), asyncio.create_task(collect())]
        await asyncio.sleep(0)  # the core's run starts: its frame exists
        statesync = self.core()._statesync
        install = statesync._install

        async def counted(snap, raw):
            self.installs.append((len(self.commits), raw))
            await install(snap, raw)

        statesync._install = counted

    async def crash(self) -> None:
        """Unclean, as a process crash: cancel the actor tasks and abort the
        listeners' transports; the store stays open (it is the disk)."""
        c = self.consensus
        if self.package == "port":
            c.crash()
        else:  # as the reference's faultline harness crashes an engine
            for t in c.tasks:
                t.cancel()
            c.synchronizer.shutdown()
            c.mempool_driver.shutdown()
            for r in c.receivers:
                r._closing = True
                r._server.close()
                for task in list(r._conn_tasks):
                    task.cancel()
                for w in list(r._writers):
                    w.transport.abort()
        for t in self.tasks:
            t.cancel()
        self.crashed, self.consensus = c, None

    async def restart(self, committee, parameters, wipe: bool) -> None:
        """Back on the same store, or on an empty one (the disk was lost)."""
        self.generation += 1
        if wipe:
            if self.crashed.compactor is not None:
                await self.crashed.compactor.drain()
            self.store.close()
            self.store = self._open_store()
        await self.spawn(committee, parameters)

    async def snapshot(self) -> bytes | None:
        return await self.store.read_meta(self.statesync.SNAPSHOT_KEY)

    def blocks(self, generation=None) -> list:
        return [b for g, b in self.commits if generation is None or g == generation]

    async def shutdown(self) -> None:
        if self.consensus is not None:
            await self.consensus.shutdown()
        for t in self.tasks:
            t.cancel()
        self.store.close()


def committee_of(package: str, seats, base: int):
    consensus = PKG[package][0]
    return consensus.Committee({
        PKG[package][1].PublicKey(seat.pk.data): consensus.Authority(1, ("127.0.0.1", base + i))
        for i, seat in enumerate(seats)
    })


def parameters_of(package: str):
    return PKG[package][0].Parameters(
        timeout_delay=1_000, sync_retry_delay=1_000, batch_vote_verification=True,
        retention_rounds=RETENTION,
    )


async def wait_for(cond, limit_s: float, what: str) -> None:
    deadline = time.monotonic() + limit_s
    while not await cond():
        assert time.monotonic() < deadline, what
        await asyncio.sleep(0.05)


def agree(seats) -> None:
    """Every round committed by several engines has one digest, and each
    engine's commits of one life form a chain: a block's parent is the block
    committed before it, or the frontier of a snapshot it installed above
    that block."""
    by_round: dict = {}
    for seat in seats:
        for _, b in seat.commits:
            by_round.setdefault(b.round, set()).add(bytes(b.digest().data))
        floors = dict(seat.statesync.peek_frontier(raw)[::-1] for _, raw in seat.installs)
        for (g0, prev), (g1, b) in zip(seat.commits, seat.commits[1:]):
            if g0 != g1 or b.parent() == prev.digest():
                continue
            assert floors.get(b.parent(), -1) >= prev.round, \
                f"{seat.package} engine {seat.index}: commit gap at round {b.round}"
    assert all(len(digests) == 1 for digests in by_round.values()), "engines disagree"


async def truncated(seat) -> bool:
    """Whether ``seat`` has compacted: after its rewrite in flight ends, no
    block it committed below its floor reads back from its store."""
    await seat.consensus.compactor.drain()
    record = await seat.snapshot()
    if record is None:
        return False
    floor, _ = seat.statesync.peek_frontier(record)
    for _, b in seat.commits:
        if b.round < floor:
            assert await seat.store.read(b.digest().data) is None, \
                f"round {b.round} below the floor {floor} reads back"
    return True


async def run_rejoin(tmp_path, packages, victim: int, base: int, wipe: bool):
    """Engines of ``packages`` at ``RETENTION`` commit; ``victim`` crashes;
    the survivors compact past it; the victim restarts (on an empty store
    when ``wipe``) and commits 3 more blocks. Returns the seats, the round
    the victim had committed when it crashed, and its snapshot record
    then."""
    rng = random.Random(9)
    seeds = [rng.randbytes(32) for _ in packages]
    seats = [Seat(p, i, seeds[i], base, tmp_path) for i, p in enumerate(packages)]
    committees = {p: committee_of(p, seats, base) for p in set(packages)}
    try:
        # Spawned in descending leader order, so that the votes of round 1
        # find the leader of round 2 listening.
        leaders = [pk.data for pk in committees[packages[0]].sorted_keys()]
        for seat in sorted(seats, key=lambda s: leaders.index(s.pk.data), reverse=True):
            await seat.spawn(committees[seat.package],
                             parameters_of(seat.package))

        async def all_committed():
            return all(seat.commits for seat in seats)

        await wait_for(all_committed, 30, "no first commit everywhere")
        victim_seat = seats[victim]
        await victim_seat.crash()
        before = max(b.round for b in victim_seat.blocks())
        victim_floor = await victim_seat.snapshot()
        truncating = [s for s in seats if s is not victim_seat]

        async def compacted_past_the_victim():
            for s in truncating:
                if not await truncated(s):
                    return False
                if s.statesync.peek_frontier(await s.snapshot())[0] <= before + RETENTION:
                    return False
            return True

        await wait_for(compacted_past_the_victim, 40,
                       "the survivors never truncated past the victim")
        cert_arena.reset()
        j_cert_arena.reset()
        await victim_seat.restart(committees[victim_seat.package],
                                  parameters_of(victim_seat.package), wipe)

        async def recovered():
            return len(victim_seat.blocks(victim_seat.generation)) >= 3

        await wait_for(recovered, 30, "the restarted engine did not commit 3 blocks")
        agree(seats)
        return seats, before, victim_floor
    finally:
        for seat in seats:
            await seat.shutdown()


@async_test(timeout=120)
async def test_wiped_port_engine_rejoins_past_the_truncation_floor(tmp_path):
    seats, before, _ = await run_rejoin(tmp_path, ["port"] * 4, 1, BASE, wipe=True)
    victim = seats[1]
    assert victim.installs, "the joiner installed no snapshot"
    snap = t_statesync.decode_snapshot(victim.installs[0][1])
    assert snap.frontier.round > before
    # The record it persisted first, or the joiner's own later compaction's.
    assert t_statesync.peek_frontier(await victim.snapshot())[0] >= snap.frontier.round
    assert victim.core()._statesync.snapshots_installed == len(victim.installs)
    # Its first commit of the new life extends the installed frontier.
    assert victim.installs[0][0] == len(victim.blocks(0))
    for seat in seats:
        assert seat.core().backend_failures == 0
        if seat is not victim:
            assert seat.consensus.compactor.compactions >= 2
            assert seat.consensus.compactor.bytes_freed > 0
            assert seat.consensus.compactor.keys_dropped > 0


@async_test(timeout=120)
async def test_port_engine_restarts_warm_on_its_own_store(tmp_path):
    seats, before, floor = await run_rejoin(tmp_path, ["port"] * 4, 1, BASE + 10, wipe=False)
    victim = seats[1]
    core = victim.core()
    assert core.last_committed_round > before
    assert core.backend_failures == 0
    if floor is not None:
        # The floor restored from its own record at start.
        assert core.synchronizer._floor_round >= t_statesync.peek_frontier(floor)[0]


@pytest.mark.parametrize("packages,victim", [
    (["reference", "reference", "port", "port"], 3),
    (["reference", "port", "port", "reference"], 0),
], ids=["port-joins-reference-peers", "reference-joins-port-peers"])
@async_test(timeout=120)
async def test_mixed_committee_wiped_engine_rejoins_from_the_other_package(
        tmp_path, packages, victim, monkeypatch):
    """Every survivor truncates past the joiner, and the joiner's own
    package's survivor answers its state requests with the frontier alone
    (as a peer whose snapshot replies are rate-limited does), so the joiner
    can neither catch up by walking the chain nor take a record of its own
    package: every snapshot it is offered was written and served by the
    other package's engines."""
    served = {"port": [], "reference": []}
    joiner_package = packages[victim]
    for package, modules in (("port", (t_helper, t_statesync)),
                             ("reference", (j_helper, j_statesync))):
        for module in modules:
            def encode(round_, digest, snapshot, real=module.encode_state_response, package=package):
                if snapshot is not None:
                    if package == joiner_package:
                        snapshot = None
                    else:
                        served[package].append(snapshot)
                return real(round_, digest, snapshot)

            monkeypatch.setattr(module, "encode_state_response", encode)
    seats, before, _ = await run_rejoin(tmp_path, packages, victim,
                                        BASE + 20 + 10 * (victim == 0), wipe=True)
    joiner = seats[victim]
    other = "port" if joiner_package == "reference" else "reference"
    assert joiner.installs, "the joiner installed no snapshot"
    for _, raw in joiner.installs:
        assert raw in served[other]
        assert any(raw in s.records for s in seats if s.package == other)
        snap = joiner.statesync.decode_snapshot(raw)
        # The record decodes alike in the other package.
        again = PKG[other][3].decode_snapshot(raw)
        assert again.frontier.serialize() == snap.frontier.serialize()
    assert joiner.statesync.decode_snapshot(joiner.installs[0][1]).frontier.round > before
    for seat in seats:
        if seat.package == "port":
            assert seat.core().backend_failures == 0


# -- the node's supervised crash/restart ----------------------------------------


def node_core(node, package: str):
    if package == "port":
        return node.consensus.core
    return node.consensus.tasks[0].get_coro().cr_frame.f_locals["self"]


async def submit(committee, name, workers: int, tag: int):
    """One transaction to ``name``'s ingress (its worker's with the data
    plane); returns the open writer."""
    tx = b"\x00" + tag.to_bytes(8, "big") + bytes([tag % 256]) * 250
    if workers:
        return await send_bundle(committee, name, tx)
    address = committee.mempool.transactions_address(name)
    _, writer = await asyncio.open_connection("127.0.0.1", address[1])
    write_frame(writer, tx)
    await writer.drain()
    return writer


async def commit_through(nodes, committee, name, workers: int, first_tag: int, writers):
    """Send transactions to ``name`` until every node of ``nodes`` commits a
    block holding one of them; returns those blocks. A transaction is sent
    again every 2 s: a block proposed just before a round whose leader is
    down gets no QC and is abandoned with its payload, which every proposer
    has already dropped from its buffer on processing the block (as in the
    reference)."""
    tags = []

    async def holds_ours(n):
        while True:
            block = await next_payload_commit(n)
            for d in block.payload:
                data = await n.store.read(d.data) or b""  # stored, unless compacted since
                if any(tag in data for tag in tags):
                    return block

    waiting = asyncio.ensure_future(asyncio.gather(*[holds_ours(n) for n in nodes]))
    try:
        for k in range(20):
            tags.append((first_tag + k).to_bytes(8, "big"))
            writers.append(await submit(committee, name, workers, first_tag + k))
            done, _ = await asyncio.wait({waiting}, timeout=2)
            if done:
                return waiting.result()
        raise AssertionError("no transaction committed on every node in 40 s")
    finally:
        waiting.cancel()


@pytest.mark.parametrize("workers", [0, 1], ids=["legacy-mempool", "data-plane"])
@pytest.mark.parametrize("package", ["port", "reference"])
@async_test(timeout=150)
async def test_node_crash_and_restart_on_its_own_store(tmp_path, package, workers):
    """Both packages' ``Node``: four nodes from the same files, at
    ``retention_rounds = 4`` (a parameters file with it runs); node 2
    crashes uncleanly (the store stays open, a second crash is a no-op),
    the others commit on, node 2 restarts on its own store (its last vote,
    round and high QC restored, its floor from its own record when it has
    one) and commits a transaction sent to it, through the commit resolver
    with the data plane."""
    # 13 ports a committee without workers, 25 with one worker each.
    base = BASE + 100 + 30 * workers + (15 + 15 * workers) * (package == "reference")
    node_pkg, consensus, mempool, _ = NODE_PKG[package]
    committee_file, params_file, key_files = write_worker_testbed(
        tmp_path, base, package, workers=workers)
    node_pkg.Parameters(
        consensus.Parameters(timeout_delay=1_000, sync_retry_delay=1_000,
                             retention_rounds=RETENTION),
        mempool.Parameters(batch_size=200, max_batch_delay=50, workers=workers),
    ).write(params_file)
    assert node_pkg.Parameters.read(params_file).consensus.retention_rounds == RETENTION
    kwargs = {"device": "cpu"} if package == "port" else {}
    nodes = [await node_pkg.Node.new(committee_file, key_files[i], str(tmp_path / f"db_{i}"),
                                     parameters_file=params_file, **kwargs) for i in range(4)]
    committee = node_pkg.Committee.read(committee_file)
    names = sorted(committee.consensus.authorities, key=lambda pk: committee.consensus.address(pk))
    writers = []
    try:
        first = await commit_through(nodes, committee, names[0], workers, 1, writers)
        assert len({b.digest() for b in first}) == 1

        node = nodes[2]
        core = node_core(node, package)
        voted = core.last_voted_round
        await node.crash()
        assert node.crashed and node.consensus is None and node.mempool is None
        assert node.resolver_task is None
        await node.crash()  # a second crash is a no-op
        assert await node.store.read(first[2].digest().data) is not None  # the disk stays

        survivors = await commit_through([nodes[0], nodes[1], nodes[3]], committee, names[1],
                                         workers, 100, writers)
        assert len({b.digest() for b in survivors}) == 1

        assert await node.restart() is node
        assert not node.crashed and await node.restart() is node  # a no-op when running
        assert (node.resolver_task is not None) == bool(workers)
        core = node_core(node, package)
        await asyncio.sleep(0.05)  # the core's run preamble restores its state
        # The vote is persisted before it leaves, so a restart never votes
        # again at or below it; the round and high QC come back as persisted.
        assert core.last_voted_round >= voted and core.round > 1 and core.high_qc.round > 0
        record = await node.store.read_meta(t_statesync.SNAPSHOT_KEY)
        if record is not None:
            assert core.synchronizer._floor_round >= t_statesync.peek_frontier(record)[0]

        # Once it has caught up, a transaction sent to it commits everywhere.
        head = node_core(nodes[0], package).last_committed_round

        async def caught_up():
            return core.last_committed_round >= head

        await wait_for(caught_up, 30, "the restarted node did not catch up")
        again = await commit_through(nodes, committee, names[2], workers, 200, writers)
        assert len({b.digest() for b in again}) == 1, "the nodes committed different blocks"
    finally:
        for w in writers:
            w.close()
        for n in nodes:
            await n.shutdown()


@pytest.mark.parametrize("then", ["restart", "shutdown"])
@async_test(timeout=60)
async def test_node_crash_during_a_log_rewrite(tmp_path, then):
    """A port node crashes while its compactor's background log rewrite is
    in flight: ``restart`` and ``shutdown`` wait for the rewrite to end
    before they spawn the engine again or close the store, so the rewrite
    never commits into a closed store."""
    node_pkg, consensus, mempool, _ = NODE_PKG["port"]
    committee_file, params_file, key_files = write_worker_testbed(
        tmp_path, BASE + 185, "port", workers=0)
    node_pkg.Parameters(
        consensus.Parameters(timeout_delay=1_000, retention_rounds=RETENTION),
        mempool.Parameters(batch_size=200, max_batch_delay=50, workers=0),
    ).write(params_file)
    node = await node_pkg.Node.new(committee_file, key_files[0], str(tmp_path / "db"),
                                   parameters_file=params_file, device="cpu")
    engine = node.store._engine
    events, gate = [], threading.Event()
    write, commit, close = engine.compact_write, engine.compact_commit, engine.close

    def gated_write(state):
        gate.wait(10)
        return write(state)

    engine.compact_write = gated_write
    engine.compact_commit = lambda state: events.append("commit") or commit(state)
    engine.close = lambda: events.append("close") or close()
    try:
        key = b"k" * 32
        await node.store.write(key, b"v" * 64)
        compactor = node.consensus.compactor
        compactor._rewrite_task = asyncio.create_task(node.store.compact([key]))
        await asyncio.sleep(0.05)  # the rewrite's thread waits at the gate
        await node.crash()
        asyncio.get_running_loop().call_later(0.2, gate.set)
        if then == "restart":
            await node.restart()
            assert events == ["commit"], "the node restarted before its rewrite ended"
            assert await node.store.read(key) is None
        await node.shutdown()
        assert events == ["commit", "close"], "the store closed under a live rewrite"
    finally:
        gate.set()
