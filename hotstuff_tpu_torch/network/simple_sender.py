"""Best-effort sender (reference ``network/src/simple_sender.rs:22-143``).

Port copy of ``hotstuff_tpu/network/simple_sender.py`` with its telemetry
counters (``net.frames_out``, ``net.bytes_out``, ``net.writes``,
``net.send_drops``) and the faultline link filter (drop, delay and
duplicate). Unlike the reference, ``shutdown`` also cancels the frames
that the filter holds back, so a crashed engine sends nothing after its
crash (ROADMAP §3).

One connection task per peer holding a bounded queue; no retry — on socket
error the connection task dies and queued messages are dropped; the next
``send`` to that peer spawns a fresh connection. Replies from the peer are
read and discarded (keeps the socket's receive window drained), and when
that read ends, the peer closed or reset the connection and it ends too, as
in ``simple_sender.rs``: a peer that crashed and came back on the same
address gets the next frame on a new connection, not down the dead one.
"""

from __future__ import annotations

import asyncio
import logging
import random
import struct

from hotstuff_tpu_torch import telemetry
from hotstuff_tpu_torch.faultline import hooks as _faultline

from .budget import BUDGET
from .receiver import read_frame

log = logging.getLogger("network")

QUEUE_CAPACITY = 1_000
_LEN = struct.Struct(">I")
# Frames gathered into one write/drain round trip when the queue has a
# backlog.
_WRITE_BATCH = 64


class _Connection:
    """Holds PRE-FRAMED bytes: the length prefix is attached once by the
    sender (once per BROADCAST, not once per peer), and the write loop
    gathers every immediately-available frame into a single write+drain."""

    def __init__(self, address: tuple[str, int]) -> None:
        self.address = address
        self.queue: asyncio.Queue[bytes] = asyncio.Queue(QUEUE_CAPACITY)
        self.evicted = False
        self.closed = False  # the peer closed or reset the connection
        self._writing = False
        self._m_frames = telemetry.counter("net.frames_out")
        self._m_bytes = telemetry.counter("net.bytes_out")
        self._m_writes = telemetry.counter("net.writes")
        self._m_drops = telemetry.counter("net.send_drops")
        self.task = asyncio.create_task(self._run())
        BUDGET.register(self)

    def evictable(self) -> bool:
        # ``_writing`` guards the frame popped from the queue but still in
        # ``drain()`` — cancelling mid-write would tear it on the wire.
        return self.queue.empty() and not self._writing

    def evict(self) -> None:
        # Best-effort channel: closing an idle connection loses nothing;
        # the owner spawns a fresh one on the next send.
        self.evicted = True
        self.task.cancel()

    async def _run(self) -> None:
        host, port = self.address
        try:
            try:
                reader, writer = await asyncio.open_connection(host, port)
            except OSError as e:
                log.debug("failed to connect to %s:%d: %s", host, port, e)
                return
            sink = asyncio.create_task(self._sink_replies(reader))
            try:
                while True:
                    data = await self.queue.get()
                    self._writing = True
                    writer.write(data)
                    nbytes = len(data)
                    # Gather the backlog: every already-queued frame rides
                    # the same drain (one flow-control round trip).
                    burst = 1
                    while burst < _WRITE_BATCH and not self.queue.empty():
                        chunk = self.queue.get_nowait()
                        writer.write(chunk)
                        nbytes += len(chunk)
                        burst += 1
                    self._m_frames.inc(burst)
                    self._m_bytes.inc(nbytes)
                    self._m_writes.inc()
                    await writer.drain()
                    self._writing = False
            except (ConnectionError, OSError) as e:
                log.debug("connection to %s:%d died: %s", host, port, e)
            finally:
                sink.cancel()
                writer.close()
        finally:
            BUDGET.unregister(self)

    async def _sink_replies(self, reader: asyncio.StreamReader) -> None:
        try:
            while True:
                await read_frame(reader)
        except Exception:
            pass
        # The read ended: the peer is gone. What is queued here is lost with
        # it, and the next send opens a fresh connection.
        self.closed = True
        self.task.cancel()

    def try_send(self, data: bytes) -> bool:
        if self.evicted or self.closed or self.task.done():
            return False
        try:
            self.queue.put_nowait(data)
            BUDGET.touch(self)
            return True
        except asyncio.QueueFull:
            log.warning("dropping message to %s: channel full", self.address)
            self._m_drops.inc()
            return True  # best-effort: dropped, but connection is alive


class SimpleSender:
    def __init__(self) -> None:
        self._connections: dict[tuple[str, int], _Connection] = {}
        self._rng = random.Random()
        self._delayed: set[asyncio.TimerHandle] = set()

    def _send_framed(self, address: tuple[str, int], framed: bytes) -> None:
        # Faultline link filter (one module-global load when disabled):
        # the active FaultPlane may drop this frame, delay it, or fan it
        # out as duplicates — per-link, seeded, and counted.
        plane = _faultline.plane
        if plane is not None:
            plan = plane.filter_send(address, framed, payload_off=4)
            if plan is not None:
                action, delay, copies = plan
                if action == "drop":
                    return
                for _ in range(copies):
                    self._deliver_later(delay, address, framed)
                return
        self._deliver_framed(address, framed)

    def _deliver_later(self, delay: float, address: tuple[str, int], framed: bytes) -> None:
        def deliver() -> None:
            self._delayed.discard(handle)
            self._deliver_framed(address, framed)

        handle = asyncio.get_running_loop().call_later(delay, deliver)
        self._delayed.add(handle)

    def _deliver_framed(self, address: tuple[str, int], framed: bytes) -> None:
        conn = self._connections.get(address)
        if conn is None or not conn.try_send(framed):
            conn = _Connection(address)
            self._connections[address] = conn
            conn.try_send(framed)

    def send(self, address: tuple[str, int], data: bytes) -> None:
        """Fire-and-forget one frame to ``address``."""
        self._send_framed(address, _LEN.pack(len(data)) + data)

    def broadcast(self, addresses: list[tuple[str, int]], data: bytes) -> None:
        # Shared encode: the wire frame is built ONCE and the same bytes
        # object is queued to every peer.
        framed = _LEN.pack(len(data)) + data
        for addr in addresses:
            self._send_framed(addr, framed)

    def lucky_broadcast(
        self, addresses: list[tuple[str, int]], data: bytes, nodes: int
    ) -> None:
        """Send to ``nodes`` randomly-picked addresses (reference
        ``simple_sender.rs:76-85``) — the sync-retry gossip primitive."""
        picked = self._rng.sample(addresses, min(nodes, len(addresses)))
        framed = _LEN.pack(len(data)) + data
        for addr in picked:
            self._send_framed(addr, framed)

    def shutdown(self) -> None:
        for conn in self._connections.values():
            conn.task.cancel()
        self._connections.clear()
        for handle in self._delayed:
            handle.cancel()
        self._delayed.clear()
