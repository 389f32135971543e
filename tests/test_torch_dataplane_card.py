"""Four port nodes with two workers each commit a client bundle under
``cuda-batched`` on the card: every QC the committee forms and checks goes
``QC.verify`` → ``BatchingBackend`` → ``CudaBackend`` → the decompression,
K2, K3 and the verdict; K4 must not launch.

Needs a CUDA card with nvcc (``cuda`` marker; it skips without one).
Imports neither JAX nor the JAX package, so it runs on a host without
them. Ports 10700-10727: below the H100 host's ephemeral range (16000-65535),
where an earlier engine's outgoing connection could hold one, and clear of
``chip_smoke.py``'s (10000-10599) and the bench's (10600-10699).
"""

import asyncio
import hashlib

import pytest
import torch

import hotstuff_tpu_torch.crypto as t_crypto
from hotstuff_tpu_torch.consensus import Authority, Committee, Parameters, cert_arena
from hotstuff_tpu_torch.crypto.batching import BatchingBackend
from hotstuff_tpu_torch.crypto.cuda_backend import CudaBackend
from hotstuff_tpu_torch.mempool import Authority as MempoolAuthority
from hotstuff_tpu_torch.mempool import Committee as MempoolCommittee
from hotstuff_tpu_torch.mempool import Parameters as MempoolParameters
from hotstuff_tpu_torch.mempool import WorkerEntry
from hotstuff_tpu_torch.mempool.dataplane import messages as dpm
from hotstuff_tpu_torch.network.receiver import write_frame
from hotstuff_tpu_torch.node import Committee as NodeCommittee
from hotstuff_tpu_torch.node import Node, Secret
from hotstuff_tpu_torch.node import Parameters as NodeParameters
from hotstuff_tpu_torch.ops import msm_kernels as mk

pytestmark = pytest.mark.cuda
BASE = 10700


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(t_crypto, "_BACKEND", None)
    t_crypto.set_backend("cuda-batched")
    cert_arena.reset()
    yield torch.device("cuda")
    cert_arena.reset()


def write_testbed(tmp_path, n=4, workers=2):
    """``benchmark/local.py``'s port layout: consensus BASE+i, transactions
    BASE+n+i, mempool BASE+2n+i, worker w's ingress BASE+(3+2w)n+i and its
    peer port BASE+(4+2w)n+i."""
    secrets = [Secret.new() for _ in range(n)]
    mempool = MempoolCommittee({s.name: MempoolAuthority(
        1, ("127.0.0.1", BASE + n + i), ("127.0.0.1", BASE + 2 * n + i),
        [WorkerEntry(("127.0.0.1", BASE + (3 + 2 * w) * n + i),
                     ("127.0.0.1", BASE + (4 + 2 * w) * n + i)) for w in range(workers)])
        for i, s in enumerate(secrets)})
    consensus = Committee({s.name: Authority(1, ("127.0.0.1", BASE + i))
                           for i, s in enumerate(secrets)})
    NodeCommittee(consensus, mempool).write(str(tmp_path / "committee.json"))
    NodeParameters(Parameters(timeout_delay=2_000),
                   MempoolParameters(batch_size=200, max_batch_delay=50, workers=workers)
                   ).write(str(tmp_path / "parameters.json"))
    for i, s in enumerate(secrets):
        s.write(str(tmp_path / f"node_{i}.json"))
    return mempool


def test_four_port_worker_nodes_commit_on_the_card(tmp_path, cuda):
    mempool = write_testbed(tmp_path)
    assert isinstance(t_crypto.get_backend(), BatchingBackend)
    assert isinstance(t_crypto.get_backend().inner, CudaBackend)

    async def main():
        nodes = []
        try:
            for i in range(4):
                nodes.append(await Node.new(
                    str(tmp_path / "committee.json"), str(tmp_path / f"node_{i}.json"),
                    str(tmp_path / f"db_{i}"), parameters_file=str(tmp_path / "parameters.json"),
                    device=cuda))
            assert all(len(n.mempool.dataplane.workers) == 2 for n in nodes)
            mk.reset_launches()
            entry = mempool.workers_of(nodes[0].name)[1]
            _, writer = await asyncio.open_connection(*entry.transactions_address)
            write_frame(writer, dpm.encode_bundle([b"\x01" * 300]))
            await writer.drain()

            async def first_payload(node):
                while not (block := await node.commit.get()).payload:
                    pass
                return block

            blocks = await asyncio.wait_for(asyncio.gather(*map(first_payload, nodes)), 60)
            assert len({b.digest() for b in blocks}) == 1
            digest = blocks[0].payload[0].data
            stored = [await asyncio.wait_for(n.store.notify_read(digest), 10) for n in nodes]
            assert stored == [stored[0]] * 4
            assert hashlib.sha512(stored[0]).digest()[:32] == digest
            assert dpm.decode_worker_batch(stored[0])[0] == 1  # worker 1's batch
            writer.close()
        finally:
            for n in nodes:
                await n.shutdown()

    asyncio.run(asyncio.wait_for(main(), 120))
    for name in ("decompress", "msm_partials_signed", "msm_combine", "verdict"):
        assert mk.LAUNCHES[name] > 0, name
    assert mk.LAUNCHES["msm_partials"] == 0
