"""In-process committees of the port's consensus engines, on the CPU.

- Four port engines (``Consensus.spawn``) on localhost TCP, mempool
  channels sunk, commit the same first four blocks: the twin of
  ``tests/test_consensus_e2e.py``, with and without
  ``batch_vote_verification``.
- A mixed committee, two reference engines and two port engines, commits
  the same blocks on the v2 wire and on v1 (``HOTSTUFF_WIRE_V2=0``).
- Four port engines behind ``BatchingBackend(CudaBackend(device="cpu"))``
  commit two blocks, so the card path's Python runs end to end on the
  kernels' plain versions (about 15 s).

Tolerance: every engine commits the same digests, round by round. Ports
21500-21599, below the ephemeral range (no reference test binds them).
"""

import asyncio
import random

import pytest

import hotstuff_tpu.consensus as j_consensus
import hotstuff_tpu.crypto as j_crypto
import hotstuff_tpu.store as j_store
import hotstuff_tpu_torch.consensus as t_consensus
import hotstuff_tpu_torch.crypto as t_crypto
import hotstuff_tpu_torch.store as t_store
from hotstuff_tpu_torch.consensus import cert_arena
from hotstuff_tpu_torch.consensus import core as t_core
from hotstuff_tpu_torch.consensus import helper as t_helper
from hotstuff_tpu_torch.consensus import synchronizer as t_synchronizer
from hotstuff_tpu_torch.crypto.batching import BatchingBackend
from hotstuff_tpu_torch.crypto.cuda_backend import CudaBackend
from hotstuff_tpu_torch.network import SimpleSender

from .common import async_test

BASE = 21500
PKG = {
    "port": (t_consensus, t_crypto, t_store),
    "reference": (j_consensus, j_crypto, j_store),
}


def seeded(n: int) -> list[bytes]:
    """The key seeds of ``tests/common.keys``."""
    rng = random.Random(0)
    return [rng.randbytes(32) for _ in range(n)]


@pytest.fixture(autouse=True)
def backends(monkeypatch):
    monkeypatch.delenv("HOTSTUFF_WIRE_V2", raising=False)
    monkeypatch.setattr(t_crypto, "_BACKEND", None)
    monkeypatch.setattr(j_crypto, "_BACKEND", None)
    t_crypto.set_backend(t_crypto.CpuBackend())
    j_crypto.set_backend("cpu")
    cert_arena.reset()
    yield
    cert_arena.reset()


async def run_committee(base_port: int, packages, blocks: int, timeout_delay: int = 2_000,
                        **params):
    """Engines of ``packages`` (one package name per seat, keys of
    ``tests/common.keys``) commit ``blocks`` blocks each; returns the
    digests each engine committed, round by round, and the engines."""
    seeds = seeded(len(packages))
    engines, commits, sinks = [], [], []
    for i, name in enumerate(packages):
        consensus, crypto, store = PKG[name]
        pairs = [crypto.generate_keypair(seed=s)[:2] for s in seeds]
        committee = consensus.Committee(
            {p: consensus.Authority(1, ("127.0.0.1", base_port + j)) for j, (p, _) in enumerate(pairs)}
        )
        pk, sk = pairs[i]
        rx_mempool, tx_mempool, tx_commit = asyncio.Queue(), asyncio.Queue(), asyncio.Queue()

        async def drain(q=tx_mempool):
            while True:
                await q.get()

        sinks.append(asyncio.create_task(drain()))
        engine = await consensus.Consensus.spawn(
            pk, committee, consensus.Parameters(timeout_delay=timeout_delay, **params),
            crypto.SignatureService(sk), store.Store(), rx_mempool, tx_mempool, tx_commit,
        )
        engines.append(engine)
        commits.append(tx_commit)
    rounds = []
    try:
        for _ in range(blocks):
            got = await asyncio.wait_for(asyncio.gather(*[q.get() for q in commits]), 60)
            rounds.append([(b.round, b.digest().data) for b in got])
    finally:
        for e in engines:
            await e.shutdown()
        for s in sinks:
            s.cancel()
    return rounds, engines


def agree(rounds) -> None:
    for i, got in enumerate(rounds):
        assert len(set(got)) == 1, f"engines committed different blocks at commit {i}: {got}"
    assert rounds[0][0][0] == 1


@async_test
async def test_end_to_end_four_port_engines():
    rounds, engines = await run_committee(BASE, ["port"] * 4, blocks=4)
    agree(rounds)
    for e in engines:
        assert e.core.blocks_committed >= 4 and e.core.timeouts_fired == 0


@async_test
async def test_stopped_engines_keep_no_simple_sender_connection(monkeypatch):
    """Each engine's core, helper and synchronizer ``SimpleSender`` holds a
    connection (each opens one to a listener that keeps it) while four
    port engines commit; once they are shut down, none is left. The
    reference's stay open."""
    made = []
    hold_port = BASE + 80

    class Opened(SimpleSender):
        def __init__(self):
            super().__init__()
            made.append(self)
            self.send(("127.0.0.1", hold_port), b"open")

    async def hold(reader, writer):
        while await reader.read(1 << 16):
            pass
        writer.close()

    for module in (t_core, t_helper, t_synchronizer):
        monkeypatch.setattr(module, "SimpleSender", Opened)
    server = await asyncio.start_server(hold, "127.0.0.1", hold_port)
    try:
        rounds, _ = await run_committee(BASE + 70, ["port"] * 4, blocks=2)
        agree(rounds)
        await asyncio.sleep(0.1)
    finally:
        server.close()
    assert len(made) == 12
    assert all(not sender._connections for sender in made)
    assert [t for t in asyncio.all_tasks()
            if t.get_coro().cr_code.co_filename.endswith("simple_sender.py")] == []


@async_test
async def test_end_to_end_with_batched_vote_verification():
    rounds, engines = await run_committee(BASE + 10, ["port"] * 4, blocks=4,
                                          batch_vote_verification=True)
    agree(rounds)
    assert sum(e.core.qcs_formed for e in engines) >= 4


@pytest.mark.parametrize("wire_v2", ["1", "0"])
@async_test
async def test_mixed_committee_commits_the_same_blocks(monkeypatch, wire_v2):
    """Two reference engines and two port engines (seats alternate) on one
    committee: proposals, votes and certificates cross the packages both
    ways, and all four commit the same blocks."""
    monkeypatch.setenv("HOTSTUFF_WIRE_V2", wire_v2)
    port = BASE + 20 + 10 * int(wire_v2)
    rounds, _ = await run_committee(port, ["reference", "port"] * 2, blocks=4,
                                    batch_vote_verification=True)
    agree(rounds)


@async_test(timeout=180)
async def test_port_engines_behind_batched_cuda_backend_on_plain_kernels():
    """The node's crypto setting (``cuda-batched``) with the card's kernels
    replaced by their plain versions: verifications leave the event loop
    (the backend's name holds "cuda"), go through the flusher thread into
    ``CudaBackend``, and the committee commits."""
    backend = BatchingBackend(CudaBackend(device="cpu"))
    t_crypto.set_backend(backend)
    rounds, engines = await run_committee(BASE + 50, ["port"] * 4, blocks=2, timeout_delay=30_000,
                                          batch_vote_verification=True)
    agree(rounds)
    assert backend.inner_calls > 0 and backend.inner.dispatches == backend.inner_calls
    assert sum(e.core.backend_failures for e in engines) == 0
