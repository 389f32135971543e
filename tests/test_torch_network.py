"""The port's asyncio transport, on the CPU.

Twins of ``tests/test_network.py`` run on ``hotstuff_tpu_torch.network``:
receiver dispatch, simple/reliable send and broadcast, reliable retry and
replay, back-pressure, and the connection budget's evictions. Then the
wire is held across the two packages: one frame each way between a
reference ``Receiver`` and the port's senders, and between the port's
``Receiver`` and the reference's senders, ACKs included. Tolerance: the
same bytes.

Ports 21000-21199, below the ephemeral range (no reference test binds them).
"""

import asyncio

import hotstuff_tpu.network as j_network
from hotstuff_tpu_torch.network import (
    MessageHandler,
    Receiver,
    ReliableSender,
    SimpleSender,
)
from hotstuff_tpu_torch.network.receiver import read_frame, write_frame

from .common import async_test, listener

BASE_PORT = 21000  # distinct per-test ports, like the reference fixtures


class _EchoHandler(MessageHandler):
    def __init__(self):
        self.received = []

    async def dispatch(self, writer, message: bytes) -> None:
        self.received.append(message)
        await writer.send(b"Ack")


@async_test
async def test_receiver_dispatch():
    handler = _EchoHandler()
    receiver = await Receiver.spawn(("127.0.0.1", BASE_PORT), handler)
    reader, writer = await asyncio.open_connection("127.0.0.1", BASE_PORT)
    write_frame(writer, b"hello")
    await writer.drain()
    assert await read_frame(reader) == b"Ack"
    write_frame(writer, b"again")
    await writer.drain()
    assert await read_frame(reader) == b"Ack"
    assert handler.received == [b"hello", b"again"]
    writer.close()
    await receiver.shutdown()


@async_test
async def test_simple_send():
    addr = ("127.0.0.1", BASE_PORT + 1)
    task = asyncio.create_task(listener(BASE_PORT + 1, expected=b"payload"))
    await asyncio.sleep(0.05)
    sender = SimpleSender()
    sender.send(addr, b"payload")
    assert await task == b"payload"
    sender.shutdown()


@async_test
async def test_simple_broadcast():
    ports = [BASE_PORT + 2 + i for i in range(3)]
    tasks = [asyncio.create_task(listener(p, expected=b"bcast")) for p in ports]
    await asyncio.sleep(0.05)
    sender = SimpleSender()
    sender.broadcast([("127.0.0.1", p) for p in ports], b"bcast")
    assert await asyncio.gather(*tasks) == [b"bcast"] * 3
    sender.shutdown()


@async_test
async def test_reliable_send_resolves_with_ack():
    port = BASE_PORT + 10
    task = asyncio.create_task(listener(port, expected=b"important"))
    await asyncio.sleep(0.05)
    sender = ReliableSender()
    handler = await sender.send(("127.0.0.1", port), b"important")
    assert await asyncio.wait_for(handler, 5) == b"Ack"
    await task
    sender.shutdown()


@async_test
async def test_reliable_broadcast():
    ports = [BASE_PORT + 11 + i for i in range(3)]
    tasks = [asyncio.create_task(listener(p)) for p in ports]
    await asyncio.sleep(0.05)
    sender = ReliableSender()
    handlers = await sender.broadcast([("127.0.0.1", p) for p in ports], b"rb")
    acks = await asyncio.gather(*handlers)
    assert acks == [b"Ack"] * 3
    await asyncio.gather(*tasks)
    sender.shutdown()


@async_test
async def test_reliable_retry_before_listener_exists():
    """The at-least-once contract: the message is sent while nobody is
    listening; the listener appears later; the ACK still arrives."""
    port = BASE_PORT + 20
    sender = ReliableSender()
    handler = await sender.send(("127.0.0.1", port), b"retry-me")
    await asyncio.sleep(0.4)  # let at least one connect attempt fail
    assert not handler.done()
    payload = await asyncio.wait_for(
        asyncio.gather(listener(port, expected=b"retry-me"), handler), 15
    )
    assert payload[1] == b"Ack"
    sender.shutdown()


@async_test
async def test_reliable_replays_unacked_on_reconnect():
    """A connection that dies before ACKing: the message must be replayed to
    the next listener on the same address."""
    port = BASE_PORT + 21

    # First listener: accepts, reads the frame, then hangs up WITHOUT acking.
    got_first = asyncio.get_running_loop().create_future()

    async def rude(reader, writer):
        frame = await read_frame(reader)
        if not got_first.done():
            got_first.set_result(frame)
        writer.close()

    server = await asyncio.start_server(rude, "127.0.0.1", port)
    sender = ReliableSender()
    handler = await sender.send(("127.0.0.1", port), b"replay-me")
    assert await asyncio.wait_for(got_first, 5) == b"replay-me"
    server.close()
    await server.wait_closed()
    assert not handler.done()

    # Second listener on the same port ACKs properly.
    result = await asyncio.wait_for(
        asyncio.gather(listener(port, expected=b"replay-me"), handler), 15
    )
    assert result[1] == b"Ack"
    sender.shutdown()


@async_test
async def test_reliable_lucky_broadcast():
    ports = [BASE_PORT + 30 + i for i in range(4)]
    tasks = [asyncio.create_task(listener(p)) for p in ports]
    await asyncio.sleep(0.05)
    sender = ReliableSender()
    handlers = await sender.lucky_broadcast(
        [("127.0.0.1", p) for p in ports], b"lucky", 2
    )
    assert len(handlers) == 2
    acks = await asyncio.gather(*[asyncio.wait_for(h, 5) for h in handlers])
    assert acks == [b"Ack"] * 2
    for t in tasks:
        t.cancel()
    sender.shutdown()


@async_test
async def test_reliable_send_backpressures_never_drops():
    """A live but SLOW peer must DELAY the sender, not lose messages
    (reference ``reliable_sender.rs:60-72`` awaits channel capacity): with
    the peer's socket stalled and the per-peer queue full, ``send`` blocks
    until the peer drains, and every message is still delivered in order."""
    import hotstuff_tpu_torch.network.reliable_sender as rs

    port = BASE_PORT + 23
    orig = rs.QUEUE_CAPACITY
    orig_cap = rs.PENDING_CAP
    rs.QUEUE_CAPACITY = 2
    rs.PENDING_CAP = 2
    payload = bytes(4 * 1024 * 1024)  # exceeds loopback socket buffers
    try:
        start_reading = asyncio.Event()
        received: list[int] = []

        async def stalled_then_drain(reader, writer):
            await start_reading.wait()
            while True:
                frame = await read_frame(reader)
                received.append(len(frame))
                write_frame(writer, b"Ack")
                await writer.drain()

        server = await asyncio.start_server(
            stalled_then_drain, "127.0.0.1", port
        )
        sender = ReliableSender()
        addr = ("127.0.0.1", port)
        handlers = []
        # Fill the peer's TCP buffers and the per-peer queue: some send
        # must eventually block (back-pressure) instead of dropping.
        blocked_at = None
        for i in range(10):
            task = asyncio.create_task(sender.send(addr, payload))
            done, _ = await asyncio.wait({task}, timeout=0.5)
            if not done:
                blocked_at = i
                break
            handlers.append(task.result())
        assert blocked_at is not None, "sender never back-pressured"
        # The peer starts draining: the blocked send completes and every
        # message (including the back-pressured one) is ACKed.
        start_reading.set()
        handlers.append(await asyncio.wait_for(task, 30))
        acks = await asyncio.wait_for(asyncio.gather(*handlers), 60)
        assert acks == [b"Ack"] * (blocked_at + 1)
        assert received == [len(payload)] * (blocked_at + 1)
        sender.shutdown()
        server.close()
    finally:
        rs.QUEUE_CAPACITY = orig
        rs.PENDING_CAP = orig_cap


@async_test
async def test_reliable_backpressure_counts_unacked_inflight():
    """A CONNECTED peer that reads frames but withholds ACKs must still
    back-pressure the sender at PENDING_CAP live messages: capacity is
    measured in un-ACKed messages, not just not-yet-written ones."""
    import hotstuff_tpu_torch.network.reliable_sender as rs

    port = BASE_PORT + 27
    orig_q, orig_cap = rs.QUEUE_CAPACITY, rs.PENDING_CAP
    rs.QUEUE_CAPACITY = 100  # queue must NOT be the binding constraint
    rs.PENDING_CAP = 3
    try:
        release = asyncio.Event()
        frames_before_release = 0
        unacked = 0
        peer_writer: list = []

        async def read_but_withhold_acks(reader, writer):
            nonlocal frames_before_release, unacked
            peer_writer.append(writer)
            while True:
                await read_frame(reader)  # consume eagerly: no TCP pressure
                if release.is_set():
                    write_frame(writer, b"Ack")
                    await writer.drain()
                else:
                    frames_before_release += 1
                    unacked += 1

        server = await asyncio.start_server(
            read_but_withhold_acks, "127.0.0.1", port
        )
        sender = ReliableSender()
        addr = ("127.0.0.1", port)
        tasks = [
            asyncio.create_task(sender.send(addr, b"m%d" % i)) for i in range(8)
        ]
        await asyncio.sleep(1.0)
        conn = sender._connections[addr]
        assert conn.live <= rs.PENDING_CAP, "live cap exceeded"
        assert frames_before_release <= rs.PENDING_CAP, (
            "peer received more than CAP un-ACKed frames"
        )
        # The peer flushes the withheld ACKs and ACKs everything further:
        # the stalled sends unblock and all eight messages resolve.
        release.set()
        for _ in range(unacked):
            write_frame(peer_writer[-1], b"Ack")
        await peer_writer[-1].drain()
        handlers = await asyncio.wait_for(asyncio.gather(*tasks), 30)
        acks = await asyncio.wait_for(asyncio.gather(*handlers), 30)
        assert acks == [b"Ack"] * 8
        sender.shutdown()
        server.close()
    finally:
        rs.QUEUE_CAPACITY = orig_q
        rs.PENDING_CAP = orig_cap


@async_test
async def test_reliable_send_to_stalled_peer_cancellation_frees_capacity():
    """A byzantine peer that ACCEPTS but never reads must not wedge
    senders that give up: cancelling handlers reclaims buffer capacity,
    so a back-pressured send completes once older messages are cancelled
    (this is where the design is deliberately stricter than the
    reference, whose channel only drains while disconnected)."""
    import hotstuff_tpu_torch.network.reliable_sender as rs

    port = BASE_PORT + 25
    orig_q, orig_cap = rs.QUEUE_CAPACITY, rs.PENDING_CAP
    rs.QUEUE_CAPACITY = 2
    rs.PENDING_CAP = 2
    payload = bytes(4 * 1024 * 1024)
    try:
        server = await asyncio.start_server(
            lambda r, w: asyncio.sleep(3600), "127.0.0.1", port
        )
        sender = ReliableSender()
        addr = ("127.0.0.1", port)
        granted = []
        blocked = None
        for _ in range(10):
            task = asyncio.create_task(sender.send(addr, payload))
            done, _ = await asyncio.wait({task}, timeout=0.5)
            if not done:
                blocked = task
                break
            granted.append(task.result())
        assert blocked is not None, "stalled peer never back-pressured"
        # The proposer's pattern: quorum reached elsewhere, give up on the
        # stalled peer. Capacity must come back and unblock the send.
        for h in granted:
            h.cancel()
        handler = await asyncio.wait_for(blocked, 5)
        handler.cancel()
        later = await asyncio.wait_for(sender.send(addr, payload), 5)
        later.cancel()
        sender.shutdown()
        server.close()
    finally:
        rs.QUEUE_CAPACITY = orig_q
        rs.PENDING_CAP = orig_cap


@async_test
async def test_reliable_send_to_dead_peer_does_not_block_forever():
    """Back-pressure must come from a SLOW live peer, not a dead one: while
    disconnected the connection task drains its queue into the replay
    buffer (pruning cancelled messages), so a crashed replica cannot wedge
    the proposer's broadcast loop (reference ``reliable_sender.rs:160-177``)."""
    import hotstuff_tpu_torch.network.reliable_sender as rs

    port = BASE_PORT + 24  # nothing ever listens here
    orig = rs.QUEUE_CAPACITY
    rs.QUEUE_CAPACITY = 2
    try:
        sender = ReliableSender()
        addr = ("127.0.0.1", port)
        # 3x the queue capacity: every send must still complete promptly.
        handlers = []
        for i in range(6):
            handlers.append(
                await asyncio.wait_for(sender.send(addr, b"m%d" % i), 10)
            )
        # Cancelling handlers must also free buffered slots for later sends.
        for h in handlers:
            h.cancel()
        await asyncio.wait_for(sender.send(addr, b"after-cancel"), 10)
        sender.shutdown()
    finally:
        rs.QUEUE_CAPACITY = orig


@async_test
async def test_cancelled_handler_skips_replay():
    port = BASE_PORT + 22
    sender = ReliableSender()
    h1 = await sender.send(("127.0.0.1", port), b"cancelled")
    h2 = await sender.send(("127.0.0.1", port), b"kept")
    h1.cancel()
    await asyncio.sleep(0.3)
    payload, ack = await asyncio.wait_for(
        asyncio.gather(listener(port, expected=b"kept"), h2), 15
    )
    assert ack == b"Ack"
    sender.shutdown()


@async_test
async def test_connection_budget_evicts_idle_simple_connections():
    """Above the process fd budget, idle SimpleSender connections are
    closed LRU-first; sends to an evicted peer transparently reconnect.
    (The N=100 one-process committee is a ~20k-connection full mesh
    against RLIMIT_NOFILE=20k — without reaping it EMFILE-storms.)"""
    from hotstuff_tpu_torch.network.budget import BUDGET

    ports = [BASE_PORT + 40 + i for i in range(6)]
    handlers = []
    receivers = []
    for p in ports:
        h = _EchoHandler()
        handlers.append(h)
        receivers.append(await Receiver.spawn(("127.0.0.1", p), h))

    old_cap = BUDGET.cap
    BUDGET.cap = 3
    sender = SimpleSender()
    try:
        for p in ports:
            sender.send(("127.0.0.1", p), b"m1")
        await asyncio.sleep(0.3)
        assert len(BUDGET) <= 3, "budget must reap down to cap"
        assert BUDGET.evictions >= 3
        # The first (LRU) peers were evicted; a new send must still arrive.
        sender.send(("127.0.0.1", ports[0]), b"m2")
        await asyncio.sleep(0.3)
        assert handlers[0].received == [b"m1", b"m2"]
    finally:
        BUDGET.cap = old_cap
        sender.shutdown()
        for r in receivers:
            await r.shutdown()


@async_test
async def test_connection_budget_never_evicts_unacked_reliable():
    """A ReliableSender connection with an un-ACKed (live) message is
    pinned: the at-least-once contract survives budget pressure. Idle
    (fully-ACKed) reliable connections are evicted and reconnect on the
    next send."""
    from hotstuff_tpu_torch.network.budget import BUDGET

    dead_port = BASE_PORT + 50  # no listener: message stays live forever
    live_ports = [BASE_PORT + 51 + i for i in range(4)]
    handlers_srv = []
    receivers = []
    for p in live_ports:
        h = _EchoHandler()
        handlers_srv.append(h)
        receivers.append(await Receiver.spawn(("127.0.0.1", p), h))

    old_cap = BUDGET.cap
    BUDGET.cap = 2
    sender = ReliableSender()
    try:
        pinned = await sender.send(("127.0.0.1", dead_port), b"must-not-drop")
        acked = []
        for p in live_ports:
            acked.append(await sender.send(("127.0.0.1", p), b"ok"))
        for h in acked:
            assert await asyncio.wait_for(h, 5) == b"Ack"
        await asyncio.sleep(0.2)
        conns = sender._connections
        assert not conns[("127.0.0.1", dead_port)].evicted, (
            "live (un-ACKed) connection must never be evicted"
        )
        assert not pinned.done()
        # Evicted idle peer still reachable through a fresh connection.
        evicted_port = next(
            p for p in live_ports if conns[("127.0.0.1", p)].evicted
        )
        h2 = await sender.send(("127.0.0.1", evicted_port), b"again")
        assert await asyncio.wait_for(h2, 5) == b"Ack"
        pinned.cancel()
    finally:
        BUDGET.cap = old_cap
        sender.shutdown()
        for r in receivers:
            await r.shutdown()


@async_test
async def test_connection_budget_reclaims_dead_peer_after_cancellation():
    """A connection to a crashed peer whose only message was CANCELLED
    (proposer reached 2f+1 ACKs elsewhere) must become evictable: its
    _run never executes, so only evictable() can prune the dead entry.
    Otherwise dead-peer connections are exempt from the fd budget in
    exactly the timeout-storm regime it exists for."""
    dead_port = BASE_PORT + 60  # nothing listens
    sender = ReliableSender()
    handler = await sender.send(("127.0.0.1", dead_port), b"doomed")
    await asyncio.sleep(0.3)  # pump seats it in pending; connect keeps failing
    conn = sender._connections[("127.0.0.1", dead_port)]
    assert not conn.evictable(), "un-cancelled message must pin the connection"
    handler.cancel()
    await asyncio.sleep(0.05)  # let the done-callback drop live to 0
    assert conn.evictable(), "cancelled-only pending must not pin a dead peer"
    sender.shutdown()


# -- the wire across the two packages ------------------------------------------


class _Recorder:
    """A handler that records frames and ACKs each (both packages' handler
    protocol: ``dispatch(writer, message)``)."""

    def __init__(self):
        self.received = []
        self.arrived = asyncio.Event()

    async def dispatch(self, writer, message: bytes) -> None:
        self.received.append(message)
        await writer.send(b"Ack")
        self.arrived.set()


PAYLOADS = [b"vote-frame" * 13, bytes(range(256)) * 40]


async def _exchange(receiver_net, sender_net, port: int):
    """One best-effort frame and one reliable frame (with its ACK) from
    ``sender_net``'s senders to ``receiver_net``'s Receiver."""
    handler = _Recorder()
    receiver = await receiver_net.Receiver.spawn(("127.0.0.1", port), handler)
    simple, reliable = sender_net.SimpleSender(), sender_net.ReliableSender()
    try:
        simple.send(("127.0.0.1", port), PAYLOADS[0])
        await asyncio.wait_for(handler.arrived.wait(), 5)
        ack = await asyncio.wait_for(await reliable.send(("127.0.0.1", port), PAYLOADS[1]), 5)
        assert ack == b"Ack"
        assert handler.received == PAYLOADS
    finally:
        simple.shutdown()
        reliable.shutdown()
        await receiver.shutdown()


@async_test
async def test_port_senders_to_a_reference_receiver():
    import hotstuff_tpu_torch.network as t_network

    await _exchange(j_network, t_network, BASE_PORT + 70)


@async_test
async def test_reference_senders_to_a_port_receiver():
    import hotstuff_tpu_torch.network as t_network

    await _exchange(t_network, j_network, BASE_PORT + 71)


@async_test
async def test_auto_ack_receiver_acks_each_frame_of_a_burst():
    """An auto-ack receiver writes one ACK per frame on arrival, before
    dispatch, and the handler's own ACK is a no-op (a reference sender's
    FIFO ACK pairing stays right)."""
    port = BASE_PORT + 72
    handler = _Recorder()
    receiver = await Receiver.spawn(("127.0.0.1", port), handler, auto_ack=True)
    sender = j_network.ReliableSender()
    try:
        handlers = [await sender.send(("127.0.0.1", port), b"m%d" % i) for i in range(20)]
        acks = await asyncio.wait_for(asyncio.gather(*handlers), 10)
        assert acks == [b"Ack"] * 20
        assert handler.received == [b"m%d" % i for i in range(20)]
    finally:
        sender.shutdown()
        await receiver.shutdown()


@async_test
async def test_simple_sender_reaches_a_peer_that_restarted():
    """A peer crashes (its listener's transports aborted) and comes back on
    the same address: the first frame sent after its return arrives. The
    connection ends when the peer resets it, as ``simple_sender.rs`` ends a
    connection whose read fails, so the frame goes down a new connection
    instead of into the dead one."""
    port = BASE_PORT + 73
    first, second = _Recorder(), _Recorder()
    receiver = await Receiver.spawn(("127.0.0.1", port), first)
    sender = SimpleSender()
    try:
        sender.send(("127.0.0.1", port), b"before")
        for _ in range(100):
            if first.received:
                break
            await asyncio.sleep(0.02)
        assert first.received == [b"before"]
        receiver.abort()
        await asyncio.sleep(0.2)
        receiver = await Receiver.spawn(("127.0.0.1", port), second)
        sender.send(("127.0.0.1", port), b"after")
        for _ in range(100):
            if second.received:
                break
            await asyncio.sleep(0.02)
        assert second.received == [b"after"]
    finally:
        sender.shutdown()
        await receiver.shutdown()
