"""The port's node (``hotstuff_tpu_torch/node``) on the CPU.

- Config files cross-read: committee, parameters and key files written by
  either package read back in the other with the same contents, and the
  two packages write the same bytes; malformed files raise ``ConfigError``.
- Four port nodes (``device="cpu"``, the serial ``cpu`` backend, device
  digests on, so drains run the SHA-512 kernel's plain version) commit a
  client transaction: the twin of ``tests/test_node.py``'s testbed. The
  committed batch reads back from every node's store.
- Two port nodes beside two reference nodes commit the same payload block
  carrying a port node's batch.
- The harness reads the port: four ``python -m hotstuff_tpu_torch.node
  run`` processes and one ``python -m hotstuff_tpu_torch.node.client``
  under ``HOTSTUFF_CRYPTO_BACKEND=cpu``, their logs parsed by the
  reference's ``benchmark.logs.LogParser`` into consensus TPS and latency
  and end-to-end latency (about 15 s).

Tolerance: every node commits the same digest; stored bytes equal. Ports
22100-22199.
"""

import asyncio
import json
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
import hotstuff_tpu.node as j_node
import hotstuff_tpu_torch.consensus as t_consensus
import hotstuff_tpu_torch.crypto as t_crypto
import hotstuff_tpu_torch.mempool as t_mempool
import hotstuff_tpu_torch.node as t_node
from benchmark.logs import LogParser
from hotstuff_tpu_torch.consensus import cert_arena
from hotstuff_tpu_torch.mempool import processor as t_processor
from hotstuff_tpu_torch.mempool.messages import decode
from hotstuff_tpu_torch.network.receiver import write_frame

from .common import async_test

BASE = 22100
REPO = Path(__file__).resolve().parents[1]
PKG = {
    "port": (t_node, t_consensus, t_mempool),
    "reference": (j_node, j_consensus, j_mempool),
}


@pytest.fixture(autouse=True)
def backends(monkeypatch):
    monkeypatch.setattr(t_crypto, "_BACKEND", None)
    monkeypatch.setattr(j_crypto, "_BACKEND", None)
    t_crypto.set_backend("cpu")
    j_crypto.set_backend("cpu")
    cert_arena.reset()
    t_processor.reset_stats()
    yield
    cert_arena.reset()


def write_testbed(tmp_path: Path, base_port: int, writer="port", n=4, **mempool):
    """Committee, parameters and key files of an n-node localhost testbed,
    written by ``writer``'s package: consensus on base+i, transactions on
    base+10+i, mempool on base+20+i."""
    node, consensus, mp = PKG[writer]
    secrets = [node.Secret.new() for _ in range(n)]
    committee = node.Committee(
        consensus.Committee({
            s.name: consensus.Authority(stake=1, address=("127.0.0.1", base_port + i))
            for i, s in enumerate(secrets)
        }),
        mp.Committee({
            s.name: mp.Authority(
                stake=1,
                transactions_address=("127.0.0.1", base_port + 10 + i),
                mempool_address=("127.0.0.1", base_port + 20 + i),
            )
            for i, s in enumerate(secrets)
        }),
    )
    committee_file = str(tmp_path / "committee.json")
    committee.write(committee_file)
    params_file = str(tmp_path / "parameters.json")
    node.Parameters(
        consensus.Parameters(timeout_delay=2_000),
        mp.Parameters(batch_size=200, max_batch_delay=50, **mempool),
    ).write(params_file)
    key_files = []
    for i, s in enumerate(secrets):
        key_files.append(str(tmp_path / f"node_{i}.json"))
        s.write(key_files[-1])
    return committee_file, params_file, key_files


@pytest.mark.parametrize("writer, reader", [("port", "reference"), ("reference", "port")])
def test_config_files_cross_read(tmp_path, writer, reader):
    committee_file, params_file, key_files = write_testbed(
        tmp_path, BASE, writer, device_batch_digests=True)
    node = PKG[reader][0]
    committee = node.Committee.read(committee_file)
    assert committee.consensus.size() == 4 and committee.mempool.quorum_threshold() == 3
    params = node.Parameters.read(params_file)
    assert params.consensus.timeout_delay == 2_000
    assert (params.mempool.batch_size, params.mempool.max_batch_delay) == (200, 50)
    assert params.mempool.device_batch_digests is True and params.mempool.workers == 0
    secret = node.Secret.read(key_files[0])
    assert secret.name in committee.consensus.authorities
    assert secret.secret.public_key() == secret.name
    # Written back by the reader's package: the same bytes.
    for obj, path in ((committee, committee_file), (params, params_file), (secret, key_files[0])):
        again = str(tmp_path / "again.json")
        obj.write(again)
        assert Path(again).read_bytes() == Path(path).read_bytes(), path


@pytest.mark.parametrize("kind, text", [
    ("committee", "{}"),
    ("committee", "not json"),
    ("committee", json.dumps({"consensus": {"authorities": {"x": {"name": "@@", "stake": 1,
                                                                   "address": "h:1"}}}})),
    ("parameters", json.dumps({"consensus": {"timeout_delay": "soon"}})),
    ("parameters", "[1, 2"),
    ("secret", json.dumps({"name": "AAAA"})),
    ("secret", None),
])
def test_config_errors(tmp_path, kind, text):
    path = tmp_path / f"{kind}.json"
    if text is not None:
        path.write_text(text)
    reader = {"committee": t_node.Committee, "parameters": t_node.Parameters,
              "secret": t_node.Secret}[kind]
    with pytest.raises(t_node.ConfigError):
        reader.read(str(path))


async def next_payload_commit(node):
    while True:
        block = await node.commit.get()
        if block.payload:
            return block


async def boot(packages, committee_file, params_file, key_files, tmp_path):
    nodes = []
    for i, package in enumerate(packages):
        kwargs = {"device": "cpu"} if package == "port" else {}
        nodes.append(await PKG[package][0].Node.new(
            committee_file, key_files[i], str(tmp_path / f"db_{i}"),
            parameters_file=params_file, **kwargs))
    return nodes


@async_test(timeout=90)
async def test_four_port_nodes_commit_a_client_transaction(tmp_path):
    committee_file, params_file, key_files = write_testbed(
        tmp_path, BASE + 30, device_batch_digests=True)
    nodes = await boot(["port"] * 4, committee_file, params_file, key_files, tmp_path)
    try:
        _, writer = await asyncio.open_connection("127.0.0.1", BASE + 30 + 10)
        tx = b"\x01" + (7).to_bytes(8, "big") + b"\xab" * 300  # > batch_size: sealed at once
        write_frame(writer, tx)
        await writer.drain()
        blocks = await asyncio.wait_for(
            asyncio.gather(*[next_payload_commit(n) for n in nodes]), 60)
        assert len({b.digest() for b in blocks}) == 1, "nodes committed different blocks"
        digest = blocks[0].payload[0]
        stored = [await n.store.read(digest.data) for n in nodes]
        assert stored[0] is not None and stored == [stored[0]] * 4
        kind, txs = decode(stored[0])
        assert kind == "batch" and tx in txs
        assert t_crypto.sha512_digest(stored[0]) == digest
        assert all(not n.mempool.failed.done() for n in nodes)
        writer.close()
    finally:
        for n in nodes:
            await n.shutdown()


@async_test(timeout=90)
async def test_port_and_reference_nodes_commit_the_same_payload_block(tmp_path):
    packages = ["port", "reference", "port", "reference"]
    committee_file, params_file, key_files = write_testbed(tmp_path, BASE + 60, "reference")
    nodes = await boot(packages, committee_file, params_file, key_files, tmp_path)
    try:
        _, writer = await asyncio.open_connection("127.0.0.1", BASE + 60 + 10)  # a port node
        tx = b"\x00" + (11).to_bytes(8, "big") + b"\xcd" * 300
        write_frame(writer, tx)
        await writer.drain()
        blocks = await asyncio.wait_for(
            asyncio.gather(*[next_payload_commit(n) for n in nodes]), 60)
        assert len({b.digest().data for b in blocks}) == 1, "the packages committed different blocks"
        digest = blocks[0].payload[0].data
        stored = [await n.store.read(digest) for n in nodes]
        assert stored[0] is not None and stored == [stored[0]] * 4
        assert tx in decode(stored[0])[1]
        writer.close()
    finally:
        for n in nodes:
            await n.shutdown()


def test_log_parser_reads_the_port(tmp_path):
    """The harness's own measurement path on the port's CLI processes."""
    base = BASE + 90
    committee_file, _, key_files = write_testbed(tmp_path, base)
    params_file = str(tmp_path / "bench_parameters.json")
    t_node.Parameters(
        t_consensus.Parameters(timeout_delay=1_000),
        t_mempool.Parameters(batch_size=15_000, max_batch_delay=10),
    ).write(params_file)
    env = dict(os.environ, HOTSTUFF_CRYPTO_BACKEND="cpu", PYTHONPATH=str(REPO))
    procs, logs = [], []
    try:
        for i in range(3, -1, -1):
            logs.append(tmp_path / f"node-{i}.log")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "hotstuff_tpu_torch.node", "run", "--keys", key_files[i],
                 "--committee", committee_file, "--store", str(tmp_path / f"db_{i}"),
                 "--parameters", params_file],
                stderr=logs[-1].open("w"), stdout=subprocess.DEVNULL, env=env, cwd=REPO))
        client_log = tmp_path / "client-0.log"
        nodes = [f"127.0.0.1:{base + 10 + i}" for i in range(4)]
        subprocess.run(
            [sys.executable, "-m", "hotstuff_tpu_torch.node.client", nodes[0], "--size", "512",
             "--rate", "200", "--timeout", "1000", "--duration", "4", "--nodes", *nodes],
            stderr=client_log.open("w"), stdout=subprocess.DEVNULL, env=env, cwd=REPO,
            timeout=60, check=True)
        time.sleep(1.5)  # the last batches commit
    finally:
        for p in procs:
            p.send_signal(signal.SIGTERM)
        for p in procs:
            p.wait(timeout=20)
    # As ``LogParser.process`` reads a run's directory: client i pairs with
    # node i, the node it sent to.
    parser = LogParser([client_log.read_text()], [log.read_text() for log in sorted(logs)])
    summary = parser.result()
    assert parser.configs[0]["mempool"]["batch_size"] == 15_000
    assert parser.configs[0]["consensus"]["timeout_delay"] == 1_000
    tps, _, _ = parser._consensus_throughput()
    assert tps > 0 and parser._consensus_latency() > 0, summary
    assert parser._e2e_latency_samples(), summary
    assert parser.timeouts <= 2, summary
