"""QuorumWaiter: hold each batch until 2f+1 stake has ACKed its dissemination
(reference ``mempool/src/quorum_waiter.rs``).

Port copy of ``hotstuff_tpu/mempool/quorum_waiter.py``, whole. Own stake
counts toward the quorum (``quorum_waiter.rs:92-102``). After quorum, the
remaining (slow-node) handlers get up to 500 ms extra dissemination time in
a bounded background set (``quorum_waiter.rs:18-21``).
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass

from hotstuff_tpu_torch.crypto import PublicKey
from hotstuff_tpu_torch.utils.quorum import cancel_remaining, wait_for_ack_quorum

from .config import Committee

log = logging.getLogger("mempool")

DISSEMINATION_DEADLINE = 0.5  # s — extra time for the f slowest nodes
DISSEMINATION_QUEUE_MAX = 10_000


@dataclass
class QuorumWaiterMessage:
    batch: bytes  # serialized MempoolMessage::Batch
    handlers: list[tuple[PublicKey, asyncio.Future]]


class QuorumWaiter:
    def __init__(
        self,
        committee: Committee,
        name: PublicKey,
        rx_message: asyncio.Queue,
        tx_batch: asyncio.Queue,
    ) -> None:
        self.committee = committee
        self.stake = committee.stake(name)
        self.rx_message = rx_message
        self.tx_batch = tx_batch
        self._background: set[asyncio.Task] = set()

    @classmethod
    def spawn(cls, *args, **kwargs) -> asyncio.Task:
        self = cls(*args, **kwargs)
        return asyncio.create_task(self._run(), name="quorum_waiter")

    async def _run(self) -> None:
        while True:
            msg: QuorumWaiterMessage = await self.rx_message.get()
            reached, remaining = await wait_for_ack_quorum(
                msg.handlers,
                self.committee.stake,
                self.stake,  # our own batch counts for our stake
                self.committee.quorum_threshold(),
            )
            if reached:
                await self.tx_batch.put(msg.batch)
            else:
                log.warning("batch dissemination failed to reach quorum")
            # Let the f slowest nodes keep receiving for a bounded grace
            # period instead of cancelling their retransmissions immediately
            # (reference ``quorum_waiter.rs:104-122``).
            if remaining and len(self._background) < DISSEMINATION_QUEUE_MAX:
                task = asyncio.create_task(self._linger(remaining))
                self._background.add(task)
                task.add_done_callback(self._background.discard)
            elif remaining:
                cancel_remaining(remaining)

    @staticmethod
    async def _linger(remaining: dict[asyncio.Task, asyncio.Future]) -> None:
        """Give slow peers DISSEMINATION_DEADLINE more, then cancel their
        handlers so the ReliableSender stops replaying those messages."""
        try:
            await asyncio.wait_for(
                asyncio.gather(*remaining), DISSEMINATION_DEADLINE
            )
        except asyncio.TimeoutError:
            for handler in remaining.values():
                if not handler.done():
                    handler.cancel()
