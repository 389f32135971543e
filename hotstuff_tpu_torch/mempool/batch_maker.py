"""BatchMaker: assemble client transactions into batches and disseminate
them (reference ``mempool/src/batch_maker.rs``).

Port copy of ``hotstuff_tpu/mempool/batch_maker.py``, with its telemetry
(the txs-received counter, the queue-depth gauge and the sealed-batch
record). Seals when the batch reaches ``batch_size`` bytes or after
``max_batch_delay`` ms, whichever first; reliable-broadcasts the sealed
batch to all peer mempools and hands the serialized batch plus the ACK
handlers to the QuorumWaiter (reference ``batch_maker.rs:74-155``). With
``benchmark`` on it logs the "Batch ... contains ..." lines that the
harness reads, exactly as the reference does.
"""

from __future__ import annotations

import asyncio
import logging
import time

from hotstuff_tpu_torch import telemetry
from hotstuff_tpu_torch.crypto import PublicKey, sha512_digest
from hotstuff_tpu_torch.network import ReliableSender

from .messages import encode_batch
from .quorum_waiter import QuorumWaiterMessage

log = logging.getLogger("mempool")

Transaction = bytes


class BatchMaker:
    def __init__(
        self,
        batch_size: int,
        max_batch_delay: int,
        rx_transaction: asyncio.Queue,
        tx_message: asyncio.Queue,
        mempool_addresses: list[tuple[PublicKey, tuple[str, int]]],
        benchmark: bool = False,
    ) -> None:
        self.batch_size = batch_size
        self.max_batch_delay = max_batch_delay / 1000.0
        self.rx_transaction = rx_transaction
        self.tx_message = tx_message
        self.mempool_addresses = mempool_addresses
        self.benchmark = benchmark
        self.current_batch: list[Transaction] = []
        self.current_batch_size = 0
        self.network = ReliableSender()
        self._m_txs = telemetry.counter("mempool.txs_received")
        self._g_queue = telemetry.gauge("mempool.tx_queue_depth")

    @classmethod
    def spawn(cls, *args, **kwargs) -> asyncio.Task:
        self = cls(*args, **kwargs)
        task = asyncio.create_task(self._run(), name="batch_maker")
        # Its sender's connections outlive the task unless closed with it:
        # they would go on retransmitting to peers that have moved on.
        task.add_done_callback(lambda _: self.network.shutdown())
        return task

    async def _run(self) -> None:
        deadline = time.monotonic() + self.max_batch_delay
        while True:
            timeout = max(deadline - time.monotonic(), 0)
            try:
                tx = await asyncio.wait_for(self.rx_transaction.get(), timeout)
                self._m_txs.inc()
                self.current_batch.append(tx)
                self.current_batch_size += len(tx)
                if self.current_batch_size >= self.batch_size:
                    await self._seal()
                    deadline = time.monotonic() + self.max_batch_delay
            except asyncio.TimeoutError:
                if self.current_batch:
                    await self._seal()
                deadline = time.monotonic() + self.max_batch_delay

    async def _seal(self) -> None:
        size = self.current_batch_size
        # Sample transactions start with byte 0 followed by a u64 id
        # (reference ``batch_maker.rs:105-115``); used for e2e latency.
        sample_ids = [
            int.from_bytes(tx[1:9], "big")
            for tx in self.current_batch
            if tx[:1] == b"\x00" and len(tx) > 8
        ]

        batch, self.current_batch, self.current_batch_size = self.current_batch, [], 0
        serialized = encode_batch(batch)

        digest = (
            sha512_digest(serialized)
            if self.benchmark or telemetry.enabled()
            else None
        )
        if telemetry.enabled():
            # Queue depth sampled at seal time (the moment of interest:
            # how far intake is running ahead of sealing) and the sealed
            # batch recorded under the same digest key the "Batch d
            # contains N B" regex contract uses.
            self._g_queue.set(self.rx_transaction.qsize())
            telemetry.record_sealed(digest.data, size)
        if self.benchmark:
            for tx_id in sample_ids:
                # NOTE: these exact log formats are the benchmark harness's
                # measurement interface (reference ``batch_maker.rs:129-139``).
                log.info("Batch %s contains sample tx %d", digest, tx_id)
            log.info("Batch %s contains %d B", digest, size)

        handlers = [
            (name, await self.network.send(address, serialized))
            for name, address in self.mempool_addresses
        ]
        await self.tx_message.put(QuorumWaiterMessage(serialized, handlers))
