"""The port's mempool (``hotstuff_tpu_torch/mempool``) on the CPU.

Twins of ``tests/test_mempool.py``'s twelve tests, on the port's actors
(batch sealing by size and by timer, quorum ACK counting, the processor's
hash, store and forward with and without device digests, sync requests and
their retries, batch serving, and client transactions driven through a
whole mempool to the consensus digest channel), plus:

- ``encode_batch``/``encode_batch_request`` byte-identical to the
  reference's, and ``decode`` of either package's frames equal;
- a drain of batches of mixed lengths hashed by the SHA-512 kernel's plain
  version in one call (``device="cpu"``), where the reference's equal-length
  kernel sends the same drain to ``hashlib`` through its fallback; the
  digests are the same;
- a failing digest function raises out of the processor, whose task dies
  with it, and emits no digest (the reference logs and hashes on the host);
- a data-plane batch frame served raw to ``MempoolReceiverHandler`` is
  stored under its digest and reaches neither processor nor helper;
- ``workers > 0`` with worker entries but no signature service is refused
  before anything binds, and device digests without a card fail when the
  processor spawns.

Tolerance: byte-exact frames and digests. Ports 22000-22099.
"""

import asyncio
import hashlib
import logging
import random

import pytest
import torch

import hotstuff_tpu.mempool.messages as j_messages
import hotstuff_tpu.mempool.processor as j_processor
import hotstuff_tpu.store as j_store
from hotstuff_tpu.crypto import Digest as JDigest
from hotstuff_tpu.crypto import PublicKey as JPublicKey
from hotstuff_tpu_torch.crypto import generate_keypair, sha512_digest
from hotstuff_tpu_torch.mempool import Authority, Cleanup, Committee, Mempool, Parameters
from hotstuff_tpu_torch.mempool import Synchronize, WorkerEntry
from hotstuff_tpu_torch.mempool import processor as t_processor
from hotstuff_tpu_torch.mempool import synchronizer as sync_mod
from hotstuff_tpu_torch.mempool.batch_maker import BatchMaker
from hotstuff_tpu_torch.mempool.dataplane.messages import TAG_BATCH as DP_TAG_BATCH
from hotstuff_tpu_torch.mempool.helper import Helper
from hotstuff_tpu_torch.mempool.mempool import MempoolReceiverHandler
from hotstuff_tpu_torch.mempool.messages import decode, encode_batch, encode_batch_request
from hotstuff_tpu_torch.mempool.processor import Processor
from hotstuff_tpu_torch.mempool.quorum_waiter import QuorumWaiter, QuorumWaiterMessage
from hotstuff_tpu_torch.mempool.synchronizer import Synchronizer
from hotstuff_tpu_torch.network.receiver import write_frame
from hotstuff_tpu_torch.ops import sha512 as t_sha512
from hotstuff_tpu_torch.store import Store

from .common import async_test, listener

BASE = 22000


def keys(n: int = 4):
    """The keys of ``tests/common.keys``, made by the port."""
    rng = random.Random(0)
    return [generate_keypair(seed=rng.randbytes(32)) for _ in range(n)]


def mempool_committee(base_port: int, n: int = 4) -> Committee:
    return Committee(
        authorities={
            pk: Authority(
                stake=1,
                transactions_address=("127.0.0.1", base_port + i),
                mempool_address=("127.0.0.1", base_port + 50 + i),
            )
            for i, (pk, _) in enumerate(keys(n))
        }
    )


def tx(sample_id: int | None = None, size: int = 100) -> bytes:
    """A transaction: sample txs start with 0 + u64 BE id (reference
    ``node/src/client.rs:107-121``)."""
    if sample_id is not None:
        return b"\x00" + sample_id.to_bytes(8, "big") + b"\x01" * (size - 9)
    return b"\x01" * size


@pytest.fixture(autouse=True)
def stats():
    t_processor.reset_stats()
    yield
    t_processor.reset_stats()


# -- twins of tests/test_mempool.py ---------------------------------------------


@async_test
async def test_batch_maker_seals_by_size():
    committee = mempool_committee(BASE)
    name = keys()[0][0]
    rx_tx, tx_msg = asyncio.Queue(), asyncio.Queue()
    peers = committee.broadcast_addresses(name)
    listeners = [asyncio.create_task(listener(addr[1])) for _, addr in peers]
    await asyncio.sleep(0.05)
    task = BatchMaker.spawn(200, 10_000, rx_tx, tx_msg, peers)
    await rx_tx.put(tx(size=150))
    await rx_tx.put(tx(size=150))  # 300 B >= 200 B -> seal now, not at timer
    msg: QuorumWaiterMessage = await asyncio.wait_for(tx_msg.get(), 2)
    kind, txs = decode(msg.batch)
    assert kind == "batch" and len(txs) == 2
    assert len(msg.handlers) == 3
    frames = await asyncio.gather(*listeners)
    assert frames == [msg.batch] * 3
    task.cancel()


@async_test
async def test_batch_maker_seals_by_timer():
    committee = mempool_committee(BASE + 4)
    name = keys()[0][0]
    rx_tx, tx_msg = asyncio.Queue(), asyncio.Queue()
    peers = committee.broadcast_addresses(name)
    listeners = [asyncio.create_task(listener(addr[1])) for _, addr in peers]
    await asyncio.sleep(0.05)
    task = BatchMaker.spawn(1_000_000, 50, rx_tx, tx_msg, peers)  # 50 ms delay
    await rx_tx.put(tx(size=10))
    msg = await asyncio.wait_for(tx_msg.get(), 2)
    kind, txs = decode(msg.batch)
    assert kind == "batch" and len(txs) == 1
    await asyncio.gather(*listeners)
    task.cancel()


@async_test
async def test_quorum_waiter_forwards_at_threshold():
    committee = mempool_committee(BASE + 8)
    name = keys()[0][0]
    rx_msg, tx_batch = asyncio.Queue(), asyncio.Queue()
    task = QuorumWaiter.spawn(committee, name, rx_msg, tx_batch)
    loop = asyncio.get_running_loop()
    handlers = [(pk, loop.create_future()) for pk, _ in keys()[1:]]
    await rx_msg.put(QuorumWaiterMessage(b"serialized-batch", handlers))
    await asyncio.sleep(0.05)
    assert tx_batch.empty()  # own stake 1 < threshold 3
    handlers[0][1].set_result(b"Ack")
    await asyncio.sleep(0.05)
    assert tx_batch.empty()  # 2 < 3
    handlers[1][1].set_result(b"Ack")
    batch = await asyncio.wait_for(tx_batch.get(), 2)
    assert batch == b"serialized-batch"
    task.cancel()


@async_test
async def test_processor_hashes_stores_forwards():
    store = Store()
    rx_batch, tx_digest = asyncio.Queue(), asyncio.Queue()
    task = Processor.spawn(store, rx_batch, tx_digest)
    batch = encode_batch([tx(size=20)])
    await rx_batch.put(batch)
    digest = await asyncio.wait_for(tx_digest.get(), 2)
    assert digest == sha512_digest(batch)
    assert await store.read(digest.data) == batch
    assert t_processor.STATS == {"drains": 1, "device_batches": 0, "host_batches": 1}
    task.cancel()


@async_test
async def test_processor_device_digests_drain_queue():
    """device_digests: the batches pending together are hashed in one call
    of the digest kernel's plain version (``device="cpu"``), equal to the
    host's SHA-512/32, and every digest and store write still lands, in
    order. These batches differ in length; the port's kernel takes them in
    one call."""
    store = Store()
    rx_batch, tx_digest = asyncio.Queue(), asyncio.Queue()
    batches = [encode_batch([tx(size=20 + i)]) for i in range(5)]
    for b in batches:
        rx_batch.put_nowait(b)
    task = Processor.spawn(store, rx_batch, tx_digest, device_digests=True, device="cpu")
    got = [await asyncio.wait_for(tx_digest.get(), 10) for _ in batches]
    assert got == [sha512_digest(b) for b in batches]
    for b, d in zip(batches, got):
        assert await store.read(d.data) == b
    assert t_processor.STATS == {"drains": 1, "device_batches": 5, "host_batches": 0}
    task.cancel()


@async_test
async def test_processor_device_digests_single_batch_host_path():
    store = Store()
    rx_batch, tx_digest = asyncio.Queue(), asyncio.Queue()
    task = Processor.spawn(store, rx_batch, tx_digest, device_digests=True, device="cpu")
    batch = encode_batch([tx(size=33)])
    await rx_batch.put(batch)
    digest = await asyncio.wait_for(tx_digest.get(), 5)
    assert digest == sha512_digest(batch)
    assert t_processor.STATS == {"drains": 1, "device_batches": 0, "host_batches": 1}
    task.cancel()


@async_test
async def test_synchronizer_emits_batch_request():
    committee = mempool_committee(BASE + 12)
    (name, _), (target, _) = keys()[0], keys()[1]
    store = Store()
    rx_msg = asyncio.Queue()
    task = Synchronizer.spawn(name, committee, store, 50, 5_000, 3, rx_msg)
    missing = sha512_digest(b"missing-batch")
    target_addr = committee.mempool_address(target)
    lst = asyncio.create_task(listener(target_addr[1]))
    await asyncio.sleep(0.05)
    await rx_msg.put(Synchronize([missing], target))
    frame = await asyncio.wait_for(lst, 3)
    kind, (digests, requestor) = decode(frame)
    assert kind == "batch_request"
    assert digests == [missing] and requestor == name
    task.cancel()


@async_test
async def test_synchronizer_cleanup_cancels_old_waiters():
    committee = mempool_committee(BASE + 16)
    name, target = keys()[0][0], keys()[1][0]
    store = Store()
    rx_msg = asyncio.Queue()
    sync = Synchronizer(name, committee, store, 10, 5_000, 3, rx_msg)
    task = asyncio.create_task(sync._run())
    target_addr = committee.mempool_address(target)
    lst = asyncio.create_task(listener(target_addr[1]))
    await asyncio.sleep(0.05)
    await rx_msg.put(Synchronize([sha512_digest(b"old")], target))
    await lst
    assert len(sync.pending) == 1
    await rx_msg.put(Cleanup(100))  # round 100, gc_depth 10 -> gc everything <= 90
    await asyncio.sleep(0.1)
    assert len(sync.pending) == 0
    task.cancel()


def test_synchronizer_retry_rearms_per_delay():
    """A retried request re-arms for a full sync_retry_delay: later ticks
    inside the window do not re-broadcast."""
    s = Synchronizer.__new__(Synchronizer)
    s.sync_retry_delay = 2.0
    d = sha512_digest(b"missing")
    s.pending = {d: (0, None, 0.0)}
    assert s._expired(1.0) == []  # not expired yet
    assert s._expired(2.5) == [d]  # expired: retry once
    assert s._expired(3.0) == []  # re-armed: ticks inside the window are quiet
    assert s._expired(4.0) == []
    assert s._expired(5.0) == [d]  # a full delay later


@async_test
async def test_synchronizer_idle_tick_does_zero_work(monkeypatch):
    """With no outstanding requests the timer tick touches neither the
    clock nor the network; once a request expires, exactly one retry
    broadcast goes out per retry window."""
    committee = mempool_committee(BASE + 20)
    name = keys()[0][0]
    clock_reads = [0]

    def clock():
        clock_reads[0] += 1
        return 1000.0

    sync = Synchronizer(name, committee, Store(), 50, 1_000, 3, asyncio.Queue(), clock=clock)
    sent = []
    sync.network = type(
        "Net", (), {
            "send": lambda self, a, d: sent.append(("send", a)),
            "lucky_broadcast": lambda self, addrs, d, n: sent.append(("lucky", n)),
        },
    )()
    monkeypatch.setattr(sync_mod, "TIMER_RESOLUTION", 0.02)
    task = asyncio.create_task(sync._run())
    try:
        await asyncio.sleep(0.15)  # several idle ticks
        assert sent == [] and clock_reads[0] == 0
        # One expired request: exactly one re-broadcast per retry window
        # (the clock is frozen, so the re-armed entry never re-expires).
        sync.pending[sha512_digest(b"want")] = (0, None, 0.0)
        await asyncio.sleep(0.15)
        assert sent == [("lucky", 3)], sent
    finally:
        task.cancel()


@async_test
async def test_helper_serves_batches():
    committee = mempool_committee(BASE + 24)
    requestor = keys()[1][0]
    store = Store()
    batch = encode_batch([tx(size=30)])
    digest = sha512_digest(batch)
    await store.write(digest.data, batch)
    rx_req = asyncio.Queue()
    task = Helper.spawn(committee, store, rx_req)
    req_addr = committee.mempool_address(requestor)
    lst = asyncio.create_task(listener(req_addr[1]))
    await asyncio.sleep(0.05)
    await rx_req.put(([digest], requestor))
    assert await asyncio.wait_for(lst, 3) == batch
    task.cancel()


@async_test
async def test_whole_mempool_client_tx_to_digest():
    """Real client transactions through a whole mempool (three fake ACKing
    peers) to the consensus digest channel (reference
    ``mempool_tests.rs:6-46``)."""
    committee = mempool_committee(BASE + 28)
    (name, _) = keys()[0]
    peer_listeners = [
        asyncio.create_task(listener(addr[1]))
        for _, addr in committee.broadcast_addresses(name)
    ]
    await asyncio.sleep(0.05)

    rx_consensus, tx_consensus = asyncio.Queue(), asyncio.Queue()
    params = Parameters(batch_size=100, max_batch_delay=10_000)
    mempool = Mempool(name, committee, params, Store(), rx_consensus, tx_consensus)
    await mempool.spawn()

    tx_addr = committee.transactions_address(name)
    _, writer = await asyncio.open_connection("127.0.0.1", tx_addr[1])
    payload = tx(sample_id=7, size=120)  # > batch_size -> immediate seal
    write_frame(writer, payload)
    await writer.drain()

    digest = await asyncio.wait_for(tx_consensus.get(), 5)
    batches = await asyncio.gather(*peer_listeners)
    assert all(b == batches[0] for b in batches)
    assert digest == sha512_digest(batches[0])
    kind, txs = decode(batches[0])
    assert kind == "batch" and txs == [payload]
    assert not mempool.failed.done()
    writer.close()
    await mempool.shutdown()


# -- against the reference, and what differs by design -----------------------------


@pytest.mark.parametrize("txs", [[], [b""], [tx(size=20), tx(3, size=512)], [b"\x07" * 70_000]])
def test_frames_byte_identical_to_the_reference(txs):
    frame = encode_batch(txs)
    assert frame == j_messages.encode_batch(txs)
    assert decode(frame) == j_messages.decode(frame) == ("batch", txs)
    digests = [sha512_digest(t) for t in txs]
    requestor = keys()[2][0]
    request = encode_batch_request(digests, requestor)
    assert request == j_messages.encode_batch_request(
        [JDigest(d.data) for d in digests], JPublicKey(requestor.data))
    kind, (got, who) = decode(request)
    assert kind == "batch_request" and got == digests and who == requestor


@async_test
async def test_mixed_drain_runs_the_kernel_where_the_reference_hashes_on_the_host(
        monkeypatch, caplog):
    """The same drain of batches of mixed lengths through both processors
    with device digests on: the port's goes through the kernel's plain
    version in one call; the reference's equal-length kernel asserts, and
    its catch-all hashes the drain with ``hashlib``. Same digests."""
    batches = [encode_batch([tx(i, size=20 + 7 * i)]) for i in range(6)]
    calls = []
    real = t_sha512.sha512_plain

    def counted(data, offsets, lengths):
        calls.append(lengths.tolist())
        return real(data, offsets, lengths)

    monkeypatch.setattr(t_sha512, "sha512_plain", counted)

    async def run(processor_cls, store):
        rx_batch, tx_digest = asyncio.Queue(), asyncio.Queue()
        for b in batches:
            rx_batch.put_nowait(b)
        kwargs = {"device": "cpu"} if processor_cls is Processor else {}
        task = processor_cls.spawn(store, rx_batch, tx_digest, device_digests=True, **kwargs)
        got = [await asyncio.wait_for(tx_digest.get(), 30) for _ in batches]
        task.cancel()
        return got

    with caplog.at_level(logging.WARNING, logger="mempool"):
        port = await run(Processor, Store())
        reference = await run(j_processor.Processor, j_store.Store())
    assert [d.data for d in port] == [d.data for d in reference]
    assert port == [sha512_digest(b) for b in batches]
    assert calls == [[len(b) for b in batches]]  # one call, six lengths
    assert t_processor.STATS["device_batches"] == 6 and t_processor.DRAIN_SIZES == {6: 1}
    assert any("falling back to host hashing" in r.getMessage() for r in caplog.records)


@async_test
async def test_a_failing_digest_kernel_raises_out_of_the_processor(monkeypatch):
    def broken(batches, device):
        raise RuntimeError("sha512_launch failed: cudaError 700")

    monkeypatch.setattr(t_processor, "_device_digest_many", broken)
    store = Store()
    rx_batch, tx_digest = asyncio.Queue(), asyncio.Queue()
    batches = [encode_batch([tx(size=40 + i)]) for i in range(3)]
    for b in batches:
        rx_batch.put_nowait(b)
    task = Processor.spawn(store, rx_batch, tx_digest, device_digests=True, device="cpu")
    with pytest.raises(RuntimeError, match="cudaError 700"):
        await asyncio.wait_for(task, 10)
    assert tx_digest.empty()
    for b in batches:
        assert await store.read(sha512_digest(b).data) is None
    assert t_processor.STATS["host_batches"] == 0


@async_test
async def test_a_dead_processor_fails_the_mempool(monkeypatch):
    """The mempool's ``failed`` future carries what killed an actor, which
    ``Node.analyze_block`` raises."""
    def broken(batches, device):
        raise RuntimeError("device lost")

    monkeypatch.setattr(t_processor, "_device_digest_many", broken)
    committee = mempool_committee(BASE + 32)
    name = keys()[0][0]
    params = Parameters(device_batch_digests=True)
    mempool = Mempool(name, committee, params, Store(), asyncio.Queue(), asyncio.Queue(),
                      device="cpu")
    await mempool.spawn()
    _, writer = await asyncio.open_connection(*committee.mempool_address(name))
    for i in range(3):  # three peer batches in one frame burst: one drain
        write_frame(writer, encode_batch([tx(size=30 + i)]))
    await writer.drain()
    with pytest.raises(RuntimeError, match="device lost"):
        await asyncio.wait_for(mempool.failed, 10)
    writer.close()
    await mempool.shutdown()


@async_test
async def test_receiver_stores_a_raw_data_plane_frame():
    store = Store()
    to_processor, to_helper = asyncio.Queue(), asyncio.Queue()
    handler = MempoolReceiverHandler(to_processor, to_helper, store=store)
    acks = []

    class Writer:
        async def send(self, payload):
            acks.append(payload)

    frame = bytes([DP_TAG_BATCH]) + b"opaque data-plane batch body"
    await handler.dispatch(Writer(), frame)
    assert await store.read(hashlib.sha512(frame).digest()[:32]) == frame
    assert acks == [b"Ack"] and to_processor.empty() and to_helper.empty()
    # A legacy batch goes to the processor; garbage is dropped.
    await handler.dispatch(Writer(), encode_batch([tx(size=12)]))
    await handler.dispatch(Writer(), b"\x09garbage")
    assert to_processor.qsize() == 1 and to_helper.empty() and acks == [b"Ack", b"Ack"]


@async_test
async def test_workers_are_refused():
    """Without a signature service the data plane cannot sign its acks."""
    committee = mempool_committee(BASE + 36)
    for i, authority in enumerate(committee.authorities.values()):
        authority.workers = [WorkerEntry(("127.0.0.1", BASE + 90 + i), ("127.0.0.1", BASE + 95 + i))]
    mempool = Mempool(keys()[0][0], committee, Parameters(workers=2), Store(),
                      asyncio.Queue(), asyncio.Queue())
    with pytest.raises(ValueError, match="data plane"):
        await mempool.spawn()
    assert mempool.receivers == [] and mempool.tasks == []


@async_test
async def test_device_digests_without_a_card_fail_at_spawn(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    committee = mempool_committee(BASE + 40)
    mempool = Mempool(keys()[0][0], committee, Parameters(device_batch_digests=True),
                      Store(), asyncio.Queue(), asyncio.Queue())
    with pytest.raises(RuntimeError, match="CUDA"):
        await mempool.spawn()
    assert mempool.receivers == []
    # Off, the processors need no card.
    mempool = Mempool(keys()[0][0], committee, Parameters(), Store(), asyncio.Queue(),
                      asyncio.Queue())
    await mempool.spawn()
    await mempool.shutdown()
