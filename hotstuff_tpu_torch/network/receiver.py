"""TCP receiver: accept loop + per-connection runners dispatching frames to a
user-supplied handler (reference ``network/src/receiver.rs:38-88``).

Port copy of ``hotstuff_tpu/network/receiver.py`` with its telemetry
counters (``net.frames_in``, ``net.bytes_in``) and the faultline ingress
filter (``side: "recv"`` link rules). Frames and ACKs are the reference's:
4-byte big-endian length prefix, ``b"Ack"`` replies.
"""

from __future__ import annotations

import asyncio
import logging
import struct

from hotstuff_tpu_torch import telemetry
from hotstuff_tpu_torch.faultline import hooks as _faultline

log = logging.getLogger("network")

_LEN = struct.Struct(">I")
MAX_FRAME = 64 * 1024 * 1024


class FrameError(Exception):
    pass


async def read_frame(reader: asyncio.StreamReader) -> bytes:
    hdr = await reader.readexactly(4)
    (n,) = _LEN.unpack(hdr)
    if n > MAX_FRAME:
        raise FrameError(f"frame length {n} exceeds MAX_FRAME")
    return await reader.readexactly(n)


# Per-await read size for the batched ingress path. One chunk holds many
# small frames while bulk frames span several chunks via the carryover
# buffer.
_READ_CHUNK = 256 * 1024


async def read_frames(reader: asyncio.StreamReader, buf: bytearray) -> list[bytes]:
    """Await at least one complete frame, then drain every complete frame
    already buffered. ``buf`` carries partial-frame bytes across calls
    (caller-owned, initially empty). Returns ``[]`` on clean EOF; raises
    ``IncompleteReadError`` on EOF mid-frame and ``FrameError`` on an
    oversized length prefix."""
    frames: list[bytes] = []
    while True:
        off = 0
        n_buf = len(buf)
        while n_buf - off >= 4:
            (n,) = _LEN.unpack_from(buf, off)
            if n > MAX_FRAME:
                raise FrameError(f"frame length {n} exceeds MAX_FRAME")
            if n_buf - off - 4 < n:
                break
            frames.append(bytes(buf[off + 4 : off + 4 + n]))
            off += 4 + n
        if off:
            del buf[:off]
        if frames:
            return frames
        data = await reader.read(_READ_CHUNK)
        if not data:
            if buf:
                raise asyncio.IncompleteReadError(bytes(buf), None)
            return []
        buf += data


def write_frame(writer: asyncio.StreamWriter, payload: bytes) -> None:
    writer.write(_LEN.pack(len(payload)) + payload)


class FramedWriter:
    """Reply-side of a connection handed to ``MessageHandler.dispatch`` —
    the channel receivers use to write ACKs back on the same socket
    (reference ``network/src/receiver.rs:20-27``)."""

    __slots__ = ("_writer",)

    def __init__(self, writer: asyncio.StreamWriter) -> None:
        self._writer = writer

    async def send(self, payload: bytes) -> None:
        write_frame(self._writer, payload)
        await self._writer.drain()


class MessageHandler:
    """Dispatch one frame; may await replies via ``writer.send``."""

    async def dispatch(self, writer: FramedWriter, message: bytes) -> None:
        raise NotImplementedError


class _AckedWriter:
    """Writer handed to handlers on auto-ack receivers: the ACK already
    went out when the frame was read, so the handler's own
    ``writer.send(b"Ack")`` is a no-op (a second ACK would mispair the
    sender's FIFO ACK accounting)."""

    __slots__ = ()

    async def send(self, payload: bytes) -> None:
        pass


class Receiver:
    """Listens on ``(host, port)``; spawns one runner task per connection.

    With ``auto_ack`` the runner writes the ACK frame the moment a frame
    is read, before dispatch — the sender's back-pressure signal means
    "received", not "processed"."""

    def __init__(
        self,
        address: tuple[str, int],
        handler: MessageHandler,
        auto_ack: bool = False,
    ) -> None:
        self.address = address
        self.handler = handler
        self.auto_ack = auto_ack
        self._server: asyncio.base_events.Server | None = None
        self._writers: set[asyncio.StreamWriter] = set()
        self._conn_tasks: set[asyncio.Task] = set()
        self._closing = False

    @classmethod
    async def spawn(
        cls,
        address: tuple[str, int],
        handler: MessageHandler,
        auto_ack: bool = False,
    ) -> "Receiver":
        self = cls(address, handler, auto_ack)
        host, port = address
        self._server = await asyncio.start_server(self._on_connection, host, port)
        log.debug("listening on %s:%d", host, port)
        return self

    async def _on_connection(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        if self._closing:
            # Accepted between shutdown() snapshotting _conn_tasks and this
            # handler's first iteration: bail so wait_closed() need not wait.
            writer.transport.abort()
            return
        peer = writer.get_extra_info("peername")
        framed = _AckedWriter() if self.auto_ack else FramedWriter(writer)
        self._writers.add(writer)
        self._conn_tasks.add(asyncio.current_task())
        m_frames = telemetry.counter("net.frames_in")
        m_bytes = telemetry.counter("net.bytes_in")
        dispatch_frames = getattr(self.handler, "dispatch_frames", None)
        buf = bytearray()
        try:
            while True:
                frames = await read_frames(reader, buf)
                if not frames:
                    break  # clean EOF
                m_frames.inc(len(frames))
                m_bytes.inc(sum(len(f) + 4 for f in frames))
                # Faultline ingress filter (``side: "recv"`` link rules):
                # a dropped frame vanishes before the ACK — the sender
                # sees exactly what a lossy ingress NIC produces; a delay
                # stalls this in-order connection, as real queueing would.
                plane = _faultline.plane
                if plane is not None:
                    kept = []
                    for frame in frames:
                        plan = plane.filter_recv(self.address)
                        if plan is not None:
                            action, delay = plan
                            if delay > 0:
                                await asyncio.sleep(delay)
                            if action == "drop":
                                continue
                        kept.append(frame)
                    frames = kept
                    if not frames:
                        continue
                if self.auto_ack:
                    for _ in frames:
                        write_frame(writer, b"Ack")
                    # drain() keeps flow control: a peer that floods frames
                    # but never reads its ACKs pauses this read loop.
                    await writer.drain()
                if dispatch_frames is not None and len(frames) > 1:
                    await dispatch_frames([(framed, f) for f in frames])
                else:
                    for frame in frames:
                        await self.handler.dispatch(framed, frame)
        except (asyncio.IncompleteReadError, ConnectionError):
            pass  # peer went away — normal
        except FrameError as e:
            log.warning("bad frame from %s: %s", peer, e)
        except Exception:
            log.exception("handler error for peer %s", peer)
        finally:
            self._conn_tasks.discard(asyncio.current_task())
            self._writers.discard(writer)
            writer.close()

    def abort(self) -> None:
        """Stop listening, cancel every connection's handler and abort its
        transport: the unclean half of ``shutdown``, and all of a crash."""
        if self._server is not None:
            self._closing = True
            self._server.close()
            for t in list(self._conn_tasks):
                t.cancel()
            for w in list(self._writers):
                w.transport.abort()

    async def shutdown(self) -> None:
        if self._server is not None:
            # Python 3.12's wait_closed() waits for every connection
            # HANDLER to return, and a handler parked in ``dispatch`` never
            # observes the closed socket: cancel the handlers outright and
            # ABORT the transports (a graceful close first flushes a write
            # buffer that may never drain).
            self.abort()
            try:
                await asyncio.wait_for(self._server.wait_closed(), timeout=5)
            except asyncio.TimeoutError:  # pragma: no cover - defensive
                log.error(
                    "receiver %s: wait_closed timed out; abandoning "
                    "%d lingering connection(s)",
                    self.address,
                    len(self._conn_tasks),
                )
