"""Mempool synchronizer: fetch batches referenced by consensus that we miss
(reference ``mempool/src/synchronizer.rs``).

Port copy of ``hotstuff_tpu/mempool/synchronizer.py``, whole: the
consensus-to-mempool messages ``Synchronize`` and ``Cleanup`` and the actor.

On ``Synchronize(digests, target)``: registers store ``notify_read`` waiters
for each missing digest and sends a ``BatchRequest`` to the block author. A
coarse timer rebroadcasts unanswered requests after ``sync_retry_delay`` to
``sync_retry_nodes`` random peers via ``lucky_broadcast``
(``synchronizer.rs:175-206``). ``Cleanup(round)`` cancels waiters older than
``gc_depth`` rounds (``synchronizer.rs:143-159``). The idle tick does no
work while nothing is outstanding, and each retry re-arms its request for a
full ``sync_retry_delay``.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass

from hotstuff_tpu_torch.crypto import Digest, PublicKey
from hotstuff_tpu_torch.network import SimpleSender
from hotstuff_tpu_torch.store import Store

from .config import Committee
from .messages import encode_batch_request

log = logging.getLogger("mempool")

TIMER_RESOLUTION = 1.0  # s (reference ``synchronizer.rs`` 1s-resolution timer)


@dataclass
class Synchronize:
    digests: list[Digest]
    target: PublicKey


@dataclass
class Cleanup:
    round: int


class Synchronizer:
    def __init__(
        self,
        name: PublicKey,
        committee: Committee,
        store: Store,
        gc_depth: int,
        sync_retry_delay: int,
        sync_retry_nodes: int,
        rx_message: asyncio.Queue,
        clock=time.monotonic,
    ) -> None:
        self.name = name
        self.committee = committee
        self.store = store
        self.gc_depth = gc_depth
        self.sync_retry_delay = sync_retry_delay / 1000.0
        self.sync_retry_nodes = sync_retry_nodes
        self.rx_message = rx_message
        # Injectable clock: retry expiry is judged without sleeping.
        self._clock = clock
        self.network = SimpleSender()
        self.round = 0
        # digest -> (round registered, waiter task, last request time)
        self.pending: dict[Digest, tuple[int, asyncio.Task, float]] = {}

    @classmethod
    def spawn(cls, *args, **kwargs) -> asyncio.Task:
        self = cls(*args, **kwargs)
        return asyncio.create_task(self._run(), name="mempool_synchronizer")

    async def _waiter(self, digest: Digest) -> None:
        await self.store.notify_read(digest.data)
        self.pending.pop(digest, None)

    async def _run(self) -> None:
        timer = asyncio.create_task(asyncio.sleep(TIMER_RESOLUTION))
        get_msg = asyncio.create_task(self.rx_message.get())
        try:
            while True:
                done, _ = await asyncio.wait(
                    {timer, get_msg}, return_when=asyncio.FIRST_COMPLETED
                )
                if get_msg in done:
                    message = get_msg.result()
                    get_msg = asyncio.create_task(self.rx_message.get())
                    if isinstance(message, Synchronize):
                        await self._handle_synchronize(message)
                    elif isinstance(message, Cleanup):
                        self._handle_cleanup(message.round)
                if timer in done:
                    timer = asyncio.create_task(asyncio.sleep(TIMER_RESOLUTION))
                    # With nothing outstanding (the steady state) the tick
                    # does no work at all, not even a clock read.
                    if self.pending:
                        self._retry_expired()
        finally:
            timer.cancel()
            get_msg.cancel()
            for _, task, _ in self.pending.values():
                if task is not None:
                    task.cancel()

    async def _handle_synchronize(self, message: Synchronize) -> None:
        now = self._clock()
        missing = []
        for digest in message.digests:
            if digest in self.pending:
                continue  # never send the same sync request twice
            if await self.store.read(digest.data) is not None:
                continue
            log.debug("requesting sync for batch %s", digest)
            task = asyncio.create_task(self._waiter(digest))
            self.pending[digest] = (self.round, task, now)
            missing.append(digest)
        if not missing:
            return
        address = self.committee.mempool_address(message.target)
        if address is None:
            log.error("consensus asked us to sync with unknown node %s", message.target)
            return
        self.network.send(address, encode_batch_request(missing, self.name))

    def _handle_cleanup(self, round_: int) -> None:
        self.round = round_
        if self.round < self.gc_depth:
            return
        gc_round = self.round - self.gc_depth
        for digest in [d for d, (r, _, _) in self.pending.items() if r <= gc_round]:
            _, task, _ = self.pending.pop(digest)
            task.cancel()

    def _expired(self, now: float) -> list[Digest]:
        """Digests whose LAST request aged past ``sync_retry_delay``; each
        is re-armed for a full delay, so one retry per window, never one
        per poll tick."""
        expired = [
            d
            for d, (_, _, ts) in self.pending.items()
            if ts + self.sync_retry_delay < now
        ]
        for d in expired:
            r, task, _ = self.pending[d]
            self.pending[d] = (r, task, now)
        return expired

    def _retry_expired(self) -> None:
        expired = self._expired(self._clock())
        if not expired:
            return
        # Best-effort gossip to a few random peers (``synchronizer.rs:190-202``).
        addresses = [a for _, a in self.committee.broadcast_addresses(self.name)]
        self.network.lucky_broadcast(
            addresses, encode_batch_request(expired, self.name), self.sync_retry_nodes
        )
