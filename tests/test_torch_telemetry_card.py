"""Four port engines commit under ``cuda-batched`` on the card with telemetry
on: every card verification counts once in ``crypto.dispatch.cuda`` and its
signatures in ``crypto.dispatch.cuda_sigs``, so the counter equals the
verdict kernel's launches (each ``CudaBackend`` call on the cached path
launches it once), and the superbatcher's flush histograms observe.

Needs a CUDA card with nvcc (``cuda`` marker; it skips without one).
Imports neither JAX nor the JAX package. Ports 10740-10747: below the H100
host's ephemeral range (16000-65535), clear of ``chip_smoke.py``'s
(10000-10599, 10800-10899), the bench's (10600-10699) and
``tests/test_torch_dataplane_card.py``'s (10700-10727).
"""

import asyncio
import random

import pytest
import torch

import hotstuff_tpu_torch.crypto as t_crypto
from hotstuff_tpu_torch import telemetry
from hotstuff_tpu_torch.consensus import Authority, Committee, Consensus, Parameters, cert_arena
from hotstuff_tpu_torch.crypto.batching import BatchingBackend
from hotstuff_tpu_torch.crypto.cuda_backend import CudaBackend
from hotstuff_tpu_torch.ops import msm_kernels as mk
from hotstuff_tpu_torch.store import Store

pytestmark = pytest.mark.cuda
BASE = 10740


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    telemetry.reset_for_tests()
    telemetry.enable()
    monkeypatch.setattr(t_crypto, "_BACKEND", None)
    t_crypto.set_backend("cuda-batched")  # made with telemetry on: live histograms
    cert_arena.reset()
    yield torch.device("cuda")
    cert_arena.reset()
    telemetry.reset_for_tests()


def test_dispatch_counter_equals_the_verdict_launches(cuda):
    backend = t_crypto.get_backend()
    assert isinstance(backend, BatchingBackend) and isinstance(backend.inner, CudaBackend)
    rng = random.Random(7)
    keys = [t_crypto.generate_keypair(seed=rng.randbytes(32))[:2] for _ in range(4)]
    committee = Committee({pk: Authority(1, ("127.0.0.1", BASE + i))
                           for i, (pk, _) in enumerate(keys)})
    secret = dict(keys)
    registry = telemetry.get_registry()

    async def main():
        mk.reset_launches()
        before = registry.snapshot()["counters"]
        sigs0 = backend.inner.sigs
        engines, commits, sinks = [], [], []
        try:
            # Descending leader order, as chip_smoke.py's committee.
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
            for _ in range(4):
                got = await asyncio.wait_for(asyncio.gather(*[q.get() for q in commits]), 60)
                assert len({b.digest() for b in got}) == 1
        finally:
            for e in engines:
                await e.shutdown()
            for s in sinks:
                s.cancel()
        # A barrier: the flusher takes requests in order, so once this empty
        # one returns, every earlier inner call has ended.
        await asyncio.to_thread(backend.verify_batch, [], [], [])
        return telemetry.diff_counters(before, registry.snapshot()["counters"]), sigs0

    deltas, sigs0 = asyncio.run(main())
    launches = dict(mk.LAUNCHES)
    assert deltas["crypto.dispatch.cuda"] > 0
    assert deltas["crypto.dispatch.cuda"] == launches["verdict"], (deltas, launches)
    assert deltas["crypto.dispatch.cuda_sigs"] == backend.inner.sigs - sigs0
    assert launches["msm_partials_signed"] == launches["msm_combine"] == 2 * launches["verdict"]
    assert launches["msm_partials"] == 0
    assert deltas["consensus.qcs_formed"] > 0 and deltas["consensus.blocks_committed"] >= 16
    hist = registry.snapshot()["histograms"]
    assert hist["crypto.superbatch.flush_ms"]["count"] > 0
    assert hist["crypto.superbatch.per_sig_ms"]["count"] > 0
