"""Four port engines on the native (C++ epoll) transport commit under
``cuda-batched`` on the card: consensus receivers and every engine's
best-effort sender are the native classes (selected by monkeypatching the
module names, as the reference's native tests do), votes reach the leader
through the C++ vote pre-stage in batches, every card verification counts
once in ``crypto.dispatch.cuda`` (so the counter equals the verdict
kernel's launches), and K4 never launches.

Needs a CUDA card with nvcc (``cuda`` marker; it skips without one).
Imports neither JAX nor the JAX package. Ports 10940-10959: below the H100
host's ephemeral range (16000-65535), clear of ``chip_smoke.py``'s and of
the other card tests'.
"""

import asyncio
import random

import pytest
import torch

import hotstuff_tpu_torch.consensus.consensus as consensus_mod
import hotstuff_tpu_torch.consensus.core as core_mod
import hotstuff_tpu_torch.crypto as t_crypto
from hotstuff_tpu_torch import telemetry
from hotstuff_tpu_torch.consensus import Authority, Committee, Consensus, Parameters, cert_arena
from hotstuff_tpu_torch.crypto.batching import BatchingBackend
from hotstuff_tpu_torch.crypto.cuda_backend import CudaBackend
from hotstuff_tpu_torch.network import native as hsnative
from hotstuff_tpu_torch.ops import msm_kernels as mk
from hotstuff_tpu_torch.store import Store

pytestmark = pytest.mark.cuda
BASE = 10940


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(consensus_mod, "Receiver", hsnative.NativeReceiver)
    monkeypatch.setattr(core_mod, "SimpleSender", hsnative.NativeSimpleSender)
    telemetry.reset_for_tests()
    telemetry.enable()
    monkeypatch.setattr(t_crypto, "_BACKEND", None)
    t_crypto.set_backend("cuda-batched")
    cert_arena.reset()
    yield torch.device("cuda")
    cert_arena.reset()
    telemetry.reset_for_tests()


def test_native_committee_verifies_on_the_card(cuda):
    backend = t_crypto.get_backend()
    assert isinstance(backend, BatchingBackend) and isinstance(backend.inner, CudaBackend)
    rng = random.Random(11)
    keys = [t_crypto.generate_keypair(seed=rng.randbytes(32))[:2] for _ in range(4)]
    committee = Committee({pk: Authority(1, ("127.0.0.1", BASE + i))
                           for i, (pk, _) in enumerate(keys)})
    secret = dict(keys)
    registry = telemetry.get_registry()

    async def main():
        mk.reset_launches()
        before = registry.snapshot()["counters"]
        stats0 = hsnative.NativeTransport.get().stats()
        engines, commits, sinks = [], [], []
        try:
            for pk in reversed(committee.sorted_keys()):
                rx, tx_mempool, tx_commit = asyncio.Queue(), asyncio.Queue(), asyncio.Queue()

                async def drain(q=tx_mempool):
                    while True:
                        await q.get()

                sinks.append(asyncio.create_task(drain()))
                engines.append(await Consensus.spawn(
                    pk, committee, Parameters(timeout_delay=5_000, batch_vote_verification=True),
                    t_crypto.SignatureService(secret[pk]), Store(), rx, tx_mempool, tx_commit))
                commits.append(tx_commit)
            assert all(isinstance(e.receivers[0], hsnative.NativeReceiver) for e in engines)
            for _ in range(4):
                got = await asyncio.wait_for(asyncio.gather(*[q.get() for q in commits]), 60)
                assert len({b.digest() for b in got}) == 1
            timeouts = sum(e.core.timeouts_fired for e in engines)
        finally:
            for e in engines:
                await e.shutdown()
            for s in sinks:
                s.cancel()
        await asyncio.to_thread(backend.verify_batch, [], [], [])  # the flusher's barrier
        stats = hsnative.NativeTransport.get().stats()
        return (telemetry.diff_counters(before, registry.snapshot()["counters"]), timeouts,
                stats["votes_batched"] - stats0["votes_batched"])

    deltas, timeouts, votes_batched = asyncio.run(main())
    launches = dict(mk.LAUNCHES)
    assert timeouts == 0
    assert votes_batched > 0
    assert deltas["crypto.dispatch.cuda"] > 0
    assert deltas["crypto.dispatch.cuda"] == launches["verdict"], (deltas, launches)
    assert launches["msm_partials_signed"] == launches["msm_combine"] == 2 * launches["verdict"]
    assert launches["msm_partials"] == 0
