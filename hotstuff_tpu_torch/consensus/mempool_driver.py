"""Payload availability gate (reference ``consensus/src/mempool.rs``).

Port copy of ``hotstuff_tpu/consensus/mempool_driver.py``, whole.

``verify(block)`` checks every payload digest is AVAILABLE: either the
batch itself is in the store, or a verified **availability certificate**
(the mempool data plane's 2f+1 signed acks, stored under
``cert_key(digest)``) proves the committee holds it — the Narwhal rule
that lets a replica vote on a block whose batches it never received,
keeping dissemination bandwidth off the ordering critical path. When
neither is present it sends ``Synchronize`` to the mempool and parks the
block in the PayloadWaiter, which re-injects it to the Core once all
batches arrive (store ``notify_read`` on each missing digest).
``cleanup(round)`` propagates GC to the mempool and cancels stale
waiters.
"""

from __future__ import annotations

import asyncio
import logging

from hotstuff_tpu_torch.crypto import Digest
from hotstuff_tpu_torch.mempool import Cleanup as MempoolCleanup
from hotstuff_tpu_torch.mempool import Synchronize as MempoolSynchronize
from hotstuff_tpu_torch.mempool.dataplane.messages import cert_key
from hotstuff_tpu_torch.store import Store

from .config import Round
from .messages import Block

log = logging.getLogger("consensus")


class MempoolDriver:
    def __init__(
        self,
        store: Store,
        tx_mempool: asyncio.Queue,
        tx_loopback: asyncio.Queue,
    ) -> None:
        self.store = store
        self.tx_mempool = tx_mempool
        self.tx_loopback = tx_loopback
        # block digest -> (round, waiter task)
        self._pending: dict[Digest, tuple[Round, asyncio.Task]] = {}

    async def verify(self, block: Block) -> bool:
        """True if every payload batch is local OR carries a stored
        availability certificate; otherwise triggers sync and parks the
        block (reference ``mempool.rs:40-64``). Certificates are verified
        against the mempool committee BEFORE they are stored (worker
        ingress / cert formation), so presence here is proof."""
        missing = []
        for d in block.payload:
            if await self.store.read(d.data) is not None:
                continue
            if await self.store.read(cert_key(d.data)) is not None:
                continue  # certified available: vote without the bytes
            missing.append(d)
        if not missing:
            return True
        await self.tx_mempool.put(MempoolSynchronize(missing, block.author))
        digest = block.digest()
        if digest not in self._pending:
            task = asyncio.create_task(self._waiter(missing, block))
            self._pending[digest] = (block.round, task)
        return False

    async def _waiter(self, missing: list[Digest], block: Block) -> None:
        await asyncio.gather(*[self.store.notify_read(d.data) for d in missing])
        self._pending.pop(block.digest(), None)
        await self.tx_loopback.put(("loopback", block))

    async def cleanup(self, round_: Round) -> None:
        await self.tx_mempool.put(MempoolCleanup(round_))
        stale = [d for d, (r, _) in self._pending.items() if r <= round_]
        for d in stale:
            _, task = self._pending.pop(d)
            task.cancel()

    def shutdown(self) -> None:
        for _, task in self._pending.values():
            task.cancel()
