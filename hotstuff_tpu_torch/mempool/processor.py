"""Processor: hash batches (SHA-512/32), persist them, emit the digest to
consensus (reference ``mempool/src/processor.rs:18-38``). Spawned twice:
once for our own quorum-ACKed batches, once for batches from peers.

Port of ``hotstuff_tpu/mempool/processor.py``, with its telemetry
counters (``mempool.batches_processed``, ``mempool.batch_bytes_stored``). With
``device_digests=True`` the processor drains its input queue, up to
``MAX_DEVICE_BATCH`` batches, and hashes a drain of more than one batch in
one launch of the SHA-512 kernel (``ops.sha512.sha512_32_batch``, through
``asyncio.to_thread``); a lone batch goes to ``hashlib``, the reference's
latency choice. Then, batch by batch and in order, the store write and the
digest to consensus.

Two differences from the reference, by design:

- a drain of batches of mixed lengths goes to the kernel, which takes a
  length a lane; the reference's equal-length ``_pad_messages`` sends such
  a drain to ``hashlib`` through its assert;
- a failure of the kernel is raised, not logged and re-done on the host:
  the processor's task fails, emits no digest for the drain, and the
  node's run fails with it (``Node.analyze_block``).

``device`` (default ``"cuda"``) is resolved when the processor spawns, so
a node with device digests on fails at boot without a card. ``STATS`` and
``DRAIN_SIZES`` count, over every processor of the process, the drains,
the batches hashed on the card and on the host, and the drains by size.
"""

from __future__ import annotations

import asyncio
import collections
import logging

from hotstuff_tpu_torch import telemetry
from hotstuff_tpu_torch.crypto import Digest, sha512_digest
from hotstuff_tpu_torch.store import Store
from hotstuff_tpu_torch.utils.device import resolve

log = logging.getLogger("mempool")

# Bound on a drain: keeps the packed transfer bounded.
MAX_DEVICE_BATCH = 128

STATS = {"drains": 0, "device_batches": 0, "host_batches": 0}
DRAIN_SIZES: collections.Counter = collections.Counter()


def reset_stats() -> None:
    for key in STATS:
        STATS[key] = 0
    DRAIN_SIZES.clear()


def _device_digest_many(batches: list[bytes], device) -> list[Digest]:
    from hotstuff_tpu_torch.ops.sha512 import sha512_32_batch

    return [Digest(d) for d in sha512_32_batch(batches, device)]


class Processor:
    @classmethod
    def spawn(
        cls,
        store: Store,
        rx_batch: asyncio.Queue,
        tx_digest: asyncio.Queue,
        device_digests: bool = False,
        device="cuda",
    ) -> asyncio.Task:
        dev = resolve(device) if device_digests else None

        async def run():
            m_batches = telemetry.counter("mempool.batches_processed")
            m_bytes = telemetry.counter("mempool.batch_bytes_stored")
            while True:
                batch: bytes = await rx_batch.get()
                batches = [batch]
                if dev is not None:
                    while len(batches) < MAX_DEVICE_BATCH:
                        try:
                            batches.append(rx_batch.get_nowait())
                        except asyncio.QueueEmpty:
                            break
                STATS["drains"] += 1
                DRAIN_SIZES[len(batches)] += 1
                if dev is not None and len(batches) > 1:
                    digests = await asyncio.to_thread(_device_digest_many, batches, dev)
                    STATS["device_batches"] += len(batches)
                else:
                    digests = [sha512_digest(b) for b in batches]
                    STATS["host_batches"] += len(batches)
                for digest, b in zip(digests, batches):
                    m_batches.inc()
                    m_bytes.inc(len(b))
                    await store.write(digest.data, b)
                    await tx_digest.put(digest)

        return asyncio.create_task(run(), name="processor")
