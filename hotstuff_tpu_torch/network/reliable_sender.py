"""At-least-once sender (reference ``network/src/reliable_sender.rs``).

Port copy of ``hotstuff_tpu/network/reliable_sender.py`` with its telemetry
counters (``net.frames_out``, ``net.bytes_out``, ``net.writes``) and the
faultline link filter (drop, and delay through a side task).

``send`` returns a ``CancelHandler`` — a future resolved with the peer's ACK
bytes. Per-peer connection tasks reconnect with exponential backoff (200 ms,
x2, capped 60 s) and replay every un-ACKed message across reconnects
(reference ``reliable_sender.rs:131,166,185-247``). Dropping/cancelling the
handler cancels the message: it is skipped on replay and its ACK discarded
(reference ``reliable_sender.rs:175,195-197``).

Back-pressure model (deliberately tighter than the reference): ``send``
awaits capacity, and capacity is measured in LIVE (un-cancelled,
un-ACKed) messages buffered for the peer. A pump task always moves the
bounded send queue into the replay buffer — connected, disconnected, or
mid-connect — pruning cancelled messages as it goes. So:

- a SLOW live peer back-pressures its senders once ``PENDING_CAP`` live
  messages are outstanding (never dropped — the reference's
  ``reliable_sender.rs:60-72`` contract);
- a DEAD or byzantine-stalled peer cannot wedge anyone: callers that give
  up (the proposer/quorum-waiter after 2f+1 ACKs) cancel their handlers,
  which frees the buffered slots. The reference wedges in this case (its
  channel only drains while disconnected); here cancellation always
  reclaims capacity.
"""

from __future__ import annotations

import asyncio
import logging
import random
from collections import deque

from hotstuff_tpu_torch import telemetry
from hotstuff_tpu_torch.faultline import hooks as _faultline

from .budget import BUDGET
from .receiver import read_frame, write_frame

log = logging.getLogger("network")

QUEUE_CAPACITY = 1_000
PENDING_CAP = 1_000  # live messages buffered per peer before back-pressure
RETRY_DELAY_MS = 200
RETRY_CAP_MS = 60_000

CancelHandler = asyncio.Future  # resolves to the peer's ACK bytes


class _Connection:
    def __init__(self, address: tuple[str, int]) -> None:
        self.address = address
        self.queue: asyncio.Queue[tuple[bytes, CancelHandler]] = asyncio.Queue(
            QUEUE_CAPACITY
        )
        # Messages awaiting (re)transmission, FIFO; unbounded but pruned of
        # cancelled entries on reconnect. The LIVE count (un-cancelled,
        # un-ACKed, whether still pending or in flight on the current
        # socket) is tracked by ``self.live`` via handler done-callbacks,
        # and the pump stalls at PENDING_CAP live ones.
        self.pending: deque[tuple[bytes, CancelHandler]] = deque()
        self.live = 0
        self.capacity = asyncio.Event()
        self.capacity.set()
        self.new_work = asyncio.Event()
        self.evicted = False
        self.task = asyncio.create_task(self._keep_alive())
        self.pump_task = asyncio.create_task(self._pump())
        BUDGET.register(self)

    def evictable(self) -> bool:
        # Only a fully-drained connection may be closed: nothing queued,
        # nothing awaiting (re)transmission, nothing un-ACKed. Every
        # outstanding CancelHandler keeps the connection pinned, so the
        # at-least-once contract survives eviction.
        if self.live == 0 and self.pending:
            # live == 0 means every handler is done, and an entry sitting
            # in ``pending`` (un-transmitted, or reassembled after a
            # disconnect before its ACK) can only have completed by
            # cancellation — ACKed entries leave via the ack_loop. The
            # leftovers are all dead: without this, a cancelled message to
            # a crashed peer (whose _run never executes, so _prune never
            # runs) would pin the connection forever, exempting dead-peer
            # connections from the fd budget in exactly the storm regime
            # it exists for.
            self.pending.clear()
        return self.live == 0 and not self.pending and self.queue.empty()

    def evict(self) -> None:
        self.evicted = True
        self.task.cancel()
        self.pump_task.cancel()

    def _prune(self) -> None:
        self.pending = deque(
            (d, h) for d, h in self.pending if not h.cancelled()
        )

    def _on_handler_done(self, _fut) -> None:
        # ACKed or cancelled: either way the message stops counting against
        # the peer's live budget; wake the pump if it was stalled.
        self.live -= 1
        if self.live < PENDING_CAP:
            self.capacity.set()

    async def _pump(self) -> None:
        """Move the send queue into ``pending`` regardless of connection
        state. Stalls (propagating back-pressure to ``send``) only while
        PENDING_CAP LIVE messages are outstanding — pending OR written but
        un-ACKed — so a connected peer that reads frames without ACKing
        them is bounded exactly like a disconnected one. Completion
        callbacks (ACK or cancel) free slots and wake the pump; no
        polling."""
        while True:
            item = await self.queue.get()
            while self.live >= PENDING_CAP:
                self.capacity.clear()
                if self.live < PENDING_CAP:  # completion raced the clear
                    break
                await self.capacity.wait()
            data, handler = item
            if handler.cancelled():
                continue  # dead before it ever counted
            self.live += 1
            handler.add_done_callback(self._on_handler_done)
            self.pending.append(item)
            self.new_work.set()

    async def _keep_alive(self) -> None:
        host, port = self.address
        delay = RETRY_DELAY_MS
        try:
            while True:
                try:
                    reader, writer = await asyncio.open_connection(host, port)
                except OSError as e:
                    log.debug("retrying %s:%d in %dms: %s", host, port, delay, e)
                    await asyncio.sleep(delay / 1000)
                    delay = min(delay * 2, RETRY_CAP_MS)
                    continue
                delay = RETRY_DELAY_MS
                try:
                    await self._run(reader, writer)
                except (ConnectionError, OSError, asyncio.IncompleteReadError) as e:
                    log.debug("connection to %s:%d dropped: %s", host, port, e)
                finally:
                    writer.close()
        finally:
            BUDGET.unregister(self)

    async def _run(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self._prune()
        # Sent but not yet ACKed on THIS connection; replayed on reconnect.
        inflight: deque[tuple[bytes, CancelHandler]] = deque()
        m_frames = telemetry.counter("net.frames_out")
        m_bytes = telemetry.counter("net.bytes_out")
        m_writes = telemetry.counter("net.writes")

        async def write_loop() -> None:
            while True:
                while self.pending:
                    data, handler = self.pending.popleft()
                    if handler.cancelled():
                        continue
                    inflight.append((data, handler))
                    write_frame(writer, data)
                    m_frames.inc()
                    m_bytes.inc(len(data) + 4)
                    m_writes.inc()
                    await writer.drain()
                self.new_work.clear()
                await self.new_work.wait()

        async def ack_loop() -> None:
            while True:
                ack = await read_frame(reader)  # raises on disconnect
                # Pair the ACK with the oldest live in-flight message.
                while inflight:
                    _, handler = inflight.popleft()
                    if handler.cancelled():
                        continue
                    handler.set_result(ack)
                    break

        write_task = asyncio.create_task(write_loop())
        ack_task = asyncio.create_task(ack_loop())
        try:
            done, _ = await asyncio.wait(
                {write_task, ack_task}, return_when=asyncio.FIRST_EXCEPTION
            )
            for t in done:
                t.result()  # re-raise the connection error
        finally:
            write_task.cancel()
            ack_task.cancel()
            # Neither child can run again before we await, so reassembling
            # synchronously here is race-free: un-ACKed messages precede
            # queued ones on the next connection.
            self.pending = deque([*inflight, *self.pending])
            # return_exceptions captures the CHILDREN's cancellation; if
            # the connection task itself is being cancelled (node
            # shutdown), the await re-raises OUR CancelledError — it must
            # propagate, or the task would absorb its own cancellation and
            # reconnect forever (wedging event-loop teardown).
            await asyncio.gather(write_task, ack_task, return_exceptions=True)


class ReliableSender:
    def __init__(self) -> None:
        self._connections: dict[tuple[str, int], _Connection] = {}
        self._rng = random.Random()
        self._delayed: set[asyncio.Task] = set()

    def _connection(self, address: tuple[str, int]) -> _Connection:
        conn = self._connections.get(address)
        if conn is None or conn.evicted or conn.task.done():
            conn = _Connection(address)
            self._connections[address] = conn
        return conn

    async def send(self, address: tuple[str, int], data: bytes) -> CancelHandler:
        """Queue one frame for ``address``; the returned handler resolves
        with the peer's ACK bytes (reference ``reliable_sender.rs:60-72``).

        Awaits capacity: when PENDING_CAP live messages are already
        buffered for the peer, the caller is back-pressured, never
        dropped. Cancelled handlers free capacity immediately, so only a
        slow LIVE peer (with callers awaiting its ACKs) ever delays
        anyone."""
        handler: CancelHandler = asyncio.get_running_loop().create_future()
        # Faultline link filter: a dropped reliable message models the
        # network eating the frame before any replay machinery could see
        # it — the ACK future stays pending forever, exactly what callers
        # observe from a dead peer (they cancel after their quorum).
        # Delays enqueue through a side task so the CALLER's latency and
        # back-pressure stay untouched; duplicates are a best-effort-
        # channel phenomenon and are not applied to reliable sends.
        plane = _faultline.plane
        if plane is not None:
            plan = plane.filter_send(address, data)
            if plan is not None:
                action, delay, _copies = plan
                if action == "drop":
                    return handler
                if delay > 0:

                    async def enqueue_later() -> None:
                        await asyncio.sleep(delay)
                        if handler.cancelled():
                            return
                        conn = self._connection(address)
                        await conn.queue.put((data, handler))
                        BUDGET.touch(conn)

                    task = asyncio.create_task(enqueue_later())
                    self._delayed.add(task)
                    task.add_done_callback(self._delayed.discard)
                    return handler
        conn = self._connection(address)
        await conn.queue.put((data, handler))
        BUDGET.touch(conn)
        return handler

    async def broadcast(
        self, addresses: list[tuple[str, int]], data: bytes
    ) -> list[CancelHandler]:
        return [await self.send(addr, data) for addr in addresses]

    async def lucky_broadcast(
        self, addresses: list[tuple[str, int]], data: bytes, nodes: int
    ) -> list[CancelHandler]:
        """Reliably send to ``nodes`` randomly-picked addresses (reference
        ``reliable_sender.rs:91-100``)."""
        picked = self._rng.sample(addresses, min(nodes, len(addresses)))
        return [await self.send(addr, data) for addr in picked]

    def shutdown(self) -> None:
        for conn in self._connections.values():
            conn.task.cancel()
            conn.pump_task.cancel()
        self._connections.clear()
        for task in self._delayed:
            task.cancel()
        self._delayed.clear()
