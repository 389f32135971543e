"""The data plane end to end on the port's node, on the CPU.

- Twins of ``tests/test_dataplane_e2e.py``: a worker committee's files
  round-trip (written by either package, read by both, the same bytes
  written back), and four port nodes with one worker each commit a client
  bundle: worker ingress → dissemination → availability certificate →
  consensus → the commit resolver; every store then holds the batch, and
  the certificate that let consensus order it decodes and verifies.
- A mixed committee: two reference nodes and two port nodes, one worker
  each, commit the same payload blocks carrying a batch from a port worker
  and one from a reference worker; every store holds both batches and a
  certificate of each that verifies in both packages.
- The harness reads the port: four ``python -m hotstuff_tpu_torch.node run``
  processes with two workers each and a sharded ``node.client``
  (``--shards``), their logs parsed by ``benchmark.logs.LogParser``.
- A stopped worker committee leaves no sender task behind (ROADMAP §3 F3).

The same committee on a card is ``tests/test_torch_dataplane_card.py``.

Tolerance: every node commits the same block digests; stored bytes equal
and hash to their digest. Ports 22350-22499.
"""

import asyncio
import hashlib
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

import hotstuff_tpu.consensus as j_consensus
import hotstuff_tpu.crypto as j_crypto
import hotstuff_tpu.mempool as j_mempool
import hotstuff_tpu.mempool.dataplane as j_dp
import hotstuff_tpu.node as j_node
import hotstuff_tpu_torch.consensus as t_consensus
import hotstuff_tpu_torch.crypto as t_crypto
import hotstuff_tpu_torch.mempool as t_mempool
import hotstuff_tpu_torch.mempool.dataplane as t_dp
import hotstuff_tpu_torch.node as t_node
from benchmark.logs import LogParser
from hotstuff_tpu_torch.consensus import cert_arena
from hotstuff_tpu_torch.mempool.dataplane import messages as dpm
from hotstuff_tpu_torch.network.receiver import write_frame

from .common import async_test

BASE = 22350
REPO = Path(__file__).resolve().parents[1]
PKG = {
    "port": (t_node, t_consensus, t_mempool, t_dp),
    "reference": (j_node, j_consensus, j_mempool, j_dp),
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


def write_worker_testbed(tmp_path: Path, base: int, writer="port", n=4, workers=1, **mempool):
    """Files of an n-node worker testbed in ``benchmark/local.py``'s port
    layout: consensus base+i, transactions base+n+i, mempool base+2n+i,
    worker w's ingress base+(3+2w)n+i and its peer port base+(4+2w)n+i."""
    node, consensus, mp, _ = PKG[writer]
    secrets = [node.Secret.new() for _ in range(n)]
    committee = node.Committee(
        consensus.Committee({
            s.name: consensus.Authority(stake=1, address=("127.0.0.1", base + i))
            for i, s in enumerate(secrets)
        }),
        mp.Committee({
            s.name: mp.Authority(
                stake=1,
                transactions_address=("127.0.0.1", base + n + i),
                mempool_address=("127.0.0.1", base + 2 * n + i),
                workers=[mp.WorkerEntry(("127.0.0.1", base + (3 + 2 * w) * n + i),
                                        ("127.0.0.1", base + (4 + 2 * w) * n + i))
                         for w in range(workers)],
            )
            for i, s in enumerate(secrets)
        }),
    )
    committee_file = str(tmp_path / "committee.json")
    committee.write(committee_file)
    params_file = str(tmp_path / "parameters.json")
    node.Parameters(
        consensus.Parameters(timeout_delay=2_000),
        mp.Parameters(**{"batch_size": 200, "max_batch_delay": 50, "workers": workers, **mempool}),
    ).write(params_file)
    key_files = []
    for i, s in enumerate(secrets):
        key_files.append(str(tmp_path / f"node_{i}.json"))
        s.write(key_files[-1])
    return committee_file, params_file, key_files


@pytest.mark.parametrize("writer, reader", [("port", "port"), ("port", "reference"),
                                            ("reference", "port")])
def test_worker_committee_config_roundtrips(tmp_path, writer, reader):
    committee_file, params_file, _ = write_worker_testbed(tmp_path, BASE, writer, workers=2)
    node = PKG[reader][0]
    committee = node.Committee.read(committee_file)
    for pk in committee.mempool.authorities:
        assert len(committee.mempool.workers_of(pk)) == 2
        assert committee.mempool.worker_address(pk, 1) is not None
        assert len(committee.mempool.worker_peers(pk, 0)) == 3
    params = node.Parameters.read(params_file)
    assert params.mempool.workers == 2
    assert params.mempool.store_high_watermark == 256
    for obj, path in ((committee, committee_file), (params, params_file)):
        again = str(tmp_path / "again.json")
        obj.write(again)
        assert Path(again).read_bytes() == Path(path).read_bytes(), path


async def boot(packages, committee_file, params_file, key_files, tmp_path, **port_kwargs):
    nodes = []
    for i, package in enumerate(packages):
        kwargs = {"device": "cpu", **port_kwargs} if package == "port" else {}
        nodes.append(await PKG[package][0].Node.new(
            committee_file, key_files[i], str(tmp_path / f"db_{i}"),
            parameters_file=params_file, **kwargs))
    return nodes


async def next_payload_commit(node):
    while True:
        block = await node.commit.get()
        if block.payload:
            return block


async def send_bundle(committee, name, tx: bytes, worker: int = 0):
    entry = committee.mempool.workers_of(name)[worker]
    _, writer = await asyncio.open_connection("127.0.0.1", entry.transactions_address[1])
    write_frame(writer, dpm.encode_bundle([tx]))
    await writer.drain()
    return writer


async def stored_cert(node, digest, package, seats, committee, wait_s: float = 10):
    """The certificate under ``cert_key`` in ``node``'s store, decoded by
    ``package`` and verified (the author's, or a peer's broadcast copy,
    which may still be on its way)."""
    dp = PKG[package][3]
    deadline = time.monotonic() + wait_s
    while (raw := await node.store.read(dpm.cert_key(digest))) is None:
        assert time.monotonic() < deadline, "no availability certificate in a store"
        await asyncio.sleep(0.05)
    cert = dp.AvailabilityCert.decode(raw, seats)
    assert bytes(cert.digest) == digest
    cert.verify(committee)
    return raw


@async_test(timeout=60)
async def test_four_node_committee_round_trip_over_workers(tmp_path):
    committee_file, params_file, key_files = write_worker_testbed(tmp_path, BASE + 30)
    nodes = await boot(["port"] * 4, committee_file, params_file, key_files, tmp_path)
    writer = None
    try:
        assert all(n.mempool.dataplane is not None for n in nodes)
        assert all(n.resolver_task is not None for n in nodes)
        committee = t_node.Committee.read(committee_file)
        payload_tx = b"\x00" + (7).to_bytes(8, "big") + b"\xab" * 250  # > batch_size
        writer = await send_bundle(committee, nodes[0].name, payload_tx)

        blocks = await asyncio.wait_for(
            asyncio.gather(*[next_payload_commit(n) for n in nodes]), 40)
        assert len({b.digest() for b in blocks}) == 1, "nodes committed different payload blocks"
        batch_digest = blocks[0].payload[0]
        seats = t_dp.WorkerSeatTable.for_committee(committee.mempool)
        for node in nodes:
            raw = await asyncio.wait_for(node.store.notify_read(batch_digest.data), 10)
            assert hashlib.sha512(raw).digest()[:32] == batch_digest.data
            _, _, samples, blob = dpm.decode_worker_batch(raw)
            assert payload_tx in dpm.split_blob(blob) and samples == [7]
            await stored_cert(node, batch_digest.data, "port", seats, committee.mempool)
        assert sum(w.batches_sealed for w in nodes[0].mempool.dataplane.workers) == 1
        assert sum(w.certs_formed for w in nodes[0].mempool.dataplane.workers) == 1
    finally:
        if writer is not None:
            writer.close()
        for n in nodes:
            await n.shutdown()


@async_test(timeout=60)
async def test_port_and_reference_nodes_commit_the_same_worker_batches(tmp_path):
    packages = ["port", "reference", "port", "reference"]
    committee_file, params_file, key_files = write_worker_testbed(tmp_path, BASE + 60, "reference")
    nodes = await boot(packages, committee_file, params_file, key_files, tmp_path)
    writers = []
    try:
        assert all(n.mempool.dataplane is not None for n in nodes)
        committee = t_node.Committee.read(committee_file)
        names = [t_crypto.PublicKey(bytes(n.name if p == "port" else n._boot[0].name))
                 for n, p in zip(nodes, packages)]
        txs = [b"\x00" + (11 + i).to_bytes(8, "big") + bytes([0xC0 + i]) * 250 for i in range(2)]
        for tx, i in zip(txs, (0, 1)):  # a port worker's batch and a reference worker's
            writers.append(await send_bundle(committee, names[i], tx))

        seen: list[list] = [[] for _ in nodes]  # payload digests in commit order, per node

        async def collect(i):
            while sum(len(b.payload) for b in seen[i]) < 2:
                seen[i].append(await next_payload_commit(nodes[i]))

        await asyncio.wait_for(asyncio.gather(*[collect(i) for i in range(4)]), 40)
        sequences = [[bytes(b.digest()) for b in s] for s in seen]
        assert all(s == sequences[0] for s in sequences), "the packages committed different blocks"
        digests = [bytes(d) for b in seen[0] for d in b.payload]
        j_committee = j_node.Committee.read(committee_file).mempool
        seats = {"port": t_dp.WorkerSeatTable.for_committee(committee.mempool),
                 "reference": j_dp.WorkerSeatTable.for_committee(j_committee)}
        found = []
        for digest in digests:
            stored = [await asyncio.wait_for(n.store.notify_read(digest), 10) for n in nodes]
            assert stored == [stored[0]] * 4
            assert hashlib.sha512(stored[0]).digest()[:32] == digest
            found.extend(dpm.split_blob(dpm.decode_worker_batch(stored[0])[3]))
            for node in nodes:
                raw = await stored_cert(node, digest, "port", seats["port"], committee.mempool)
                j_dp.AvailabilityCert.decode(raw, seats["reference"]).verify(j_committee)
        assert sorted(found) == sorted(txs)
    finally:
        for w in writers:
            w.close()
        for n in nodes:
            await n.shutdown()


def reliable_sender_tasks() -> list[asyncio.Task]:
    return [t for t in asyncio.all_tasks()
            if t.get_coro().cr_code.co_filename.endswith("reliable_sender.py")]


def worker_sender_tasks(nodes) -> list[asyncio.Task]:
    """The connection tasks of every worker's ReliableSender and
    SimpleSenders (dissemination, cert broadcast, batch serving)."""
    tasks = []
    for node in nodes:
        for w in node.mempool.dataplane.workers:
            for sender in (w.network, w.cert_network, w.peer_handler.helper_net):
                for conn in sender._connections.values():
                    tasks += [conn.task, getattr(conn, "pump_task", conn.task)]
    return tasks


@async_test(timeout=60)
async def test_worker_committee_shutdown_closes_its_senders(tmp_path):
    """A stopped worker committee leaves no worker sender behind: left
    running, a worker's ReliableSender retransmits its batches to whatever
    listens on the peers' worker ports next (a second committee on the same
    ports)."""
    committee_file, params_file, key_files = write_worker_testbed(tmp_path, BASE + 90)
    nodes = await boot(["port"] * 4, committee_file, params_file, key_files, tmp_path)
    writer = None
    try:
        committee = t_node.Committee.read(committee_file)
        writer = await send_bundle(committee, nodes[0].name, b"\x01" * 300)
        await asyncio.wait_for(asyncio.gather(*[next_payload_commit(n) for n in nodes]), 40)
        workers = worker_sender_tasks(nodes)
        assert workers and reliable_sender_tasks(), "no batch or certificate went out"
    finally:
        if writer is not None:
            writer.close()
        for n in nodes:
            await n.shutdown()
    await asyncio.sleep(0.1)
    assert all(t.done() for t in workers)
    assert reliable_sender_tasks() == []


def test_log_parser_reads_a_port_worker_committee(tmp_path):
    """The harness's measurement path on the port's CLI processes, started
    as ``benchmark/local.py`` starts a worker committee."""
    base, n = BASE + 120, 4
    committee_file, params_file, key_files = write_worker_testbed(
        tmp_path, base, workers=2, batch_size=15_000, max_batch_delay=10)
    env = dict(os.environ, HOTSTUFF_CRYPTO_BACKEND="cpu", PYTHONPATH=str(REPO))
    procs, logs = [], []
    try:
        for i in range(n - 1, -1, -1):
            logs.append(tmp_path / f"node-{i}.log")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "hotstuff_tpu_torch.node", "run", "--keys", key_files[i],
                 "--committee", committee_file, "--store", str(tmp_path / f"db_{i}"),
                 "--parameters", params_file],
                stderr=logs[-1].open("w"), stdout=subprocess.DEVNULL, env=env, cwd=REPO))
        client_log = tmp_path / "client-0.log"
        fronts = [f"127.0.0.1:{base + n + i}" for i in range(n)]
        shards = ",".join(f"127.0.0.1:{base + (3 + 2 * w) * n}" for w in range(2))
        subprocess.run(
            [sys.executable, "-m", "hotstuff_tpu_torch.node.client", fronts[0], "--size", "512",
             "--rate", "400", "--timeout", "1000", "--duration", "4", "--nodes", *fronts,
             "--shards", shards],
            stderr=client_log.open("w"), stdout=subprocess.DEVNULL, env=env, cwd=REPO,
            timeout=60, check=True)
        time.sleep(1.5)  # the last batches commit
    finally:
        for p in procs:
            p.send_signal(signal.SIGTERM)
        for p in procs:
            p.wait(timeout=20)
    client_text = client_log.read_text()
    assert "Worker shards: " + shards.replace(",", ", ") in client_text
    node_texts = [log.read_text() for log in sorted(logs)]
    assert all("Conveyor data plane booted with 2 worker(s)" in t for t in node_texts)
    parser = LogParser([client_text], node_texts)
    summary = parser.result()
    assert parser.configs[0]["mempool"]["batch_size"] == 15_000
    tps, _, _ = parser._consensus_throughput()
    assert tps > 0 and parser._consensus_latency() > 0, summary
    assert parser._e2e_latency_samples(), summary
    assert parser.timeouts <= 2 and parser.sheds == 0, summary
