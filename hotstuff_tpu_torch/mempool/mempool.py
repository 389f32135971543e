"""Mempool root: wires all mempool actors and network receivers (reference
``mempool/src/mempool.rs:58-245``).

Port of ``hotstuff_tpu/mempool/mempool.py``. Two receivers: client
transactions on ``transactions_address`` and peer messages on
``mempool_address`` (both rebound to 0.0.0.0, reference
``mempool.rs:119,166``; the peer one ACKs on frame arrival). Peer ``Batch``
messages are ACKed then routed to a Processor; ``BatchRequest``s go to the
Helper; a data-plane batch frame served raw through the sync path is
stored under its digest. With ``workers > 0`` and worker entries for this
node in the committee, ``spawn`` also starts the data plane
(``dataplane.DataPlane``), which needs the signature service: its acks
are signed. The processors take ``device`` for their digest kernel.
"""

from __future__ import annotations

import asyncio
import logging

from hotstuff_tpu_torch.crypto import PublicKey, sha512_digest
from hotstuff_tpu_torch.network import MessageHandler, Receiver
from hotstuff_tpu_torch.store import Store
from hotstuff_tpu_torch.utils.serde import SerdeError
from hotstuff_tpu_torch.utils.tasks import log_task_death

from . import messages
from .batch_maker import BatchMaker
from .config import Committee, Parameters
from .dataplane import DataPlane
from .dataplane.messages import TAG_BATCH as _DP_TAG_BATCH
from .helper import Helper
from .processor import Processor
from .quorum_waiter import QuorumWaiter
from .synchronizer import Synchronizer

log = logging.getLogger("mempool")

CHANNEL_CAPACITY = 1_000


class TxReceiverHandler(MessageHandler):
    """Client transactions: one-way, no ACK (reference ``mempool.rs:196-214``)."""

    def __init__(self, tx_batch_maker: asyncio.Queue) -> None:
        self.tx_batch_maker = tx_batch_maker

    async def dispatch(self, writer, message: bytes) -> None:
        await self.tx_batch_maker.put(message)


class MempoolReceiverHandler(MessageHandler):
    """Peer messages: ACK batches then route (reference ``mempool.rs:217-245``)."""

    def __init__(
        self,
        tx_processor: asyncio.Queue,
        tx_helper: asyncio.Queue,
        store: Store | None = None,
    ) -> None:
        self.tx_processor = tx_processor
        self.tx_helper = tx_helper
        self.store = store

    async def dispatch(self, writer, message: bytes) -> None:
        if message and message[0] == _DP_TAG_BATCH and self.store is not None:
            # A data-plane batch served raw through the legacy sync path
            # (the helper sends stored frames verbatim): store it under its
            # digest, which fulfils any notify_read obligation on it. No
            # digest goes to consensus: the batch is fetched because it is
            # already ordered.
            await writer.send(b"Ack")
            digest = sha512_digest(message)
            await self.store.write(digest.data, message)
            return
        try:
            kind, payload = messages.decode(message)
        except SerdeError as e:
            log.warning("failed to decode mempool message: %s", e)
            return
        if kind == "batch":
            # ACK first so the sender stops retransmitting, then store the
            # raw serialized message (reference ``mempool.rs:224-237``).
            await writer.send(b"Ack")
            await self.tx_processor.put(message)
        else:  # batch_request
            digests, requestor = payload
            await self.tx_helper.put((digests, requestor))


class Mempool:
    """Composition root (reference ``Mempool::spawn``, ``mempool.rs:58-91``)."""

    def __init__(
        self,
        name: PublicKey,
        committee: Committee,
        parameters: Parameters,
        store: Store,
        rx_consensus: asyncio.Queue,  # Synchronize/Cleanup from consensus
        tx_consensus: asyncio.Queue,  # batch digests out to consensus
        benchmark: bool = False,
        device="cuda",
        signature_service=None,  # required for the data plane
    ) -> None:
        self.name = name
        self.committee = committee
        self.parameters = parameters
        self.store = store
        self.rx_consensus = rx_consensus
        self.tx_consensus = tx_consensus
        self.benchmark = benchmark
        self.device = device
        self.signature_service = signature_service
        self.dataplane = None  # the data plane's worker shards, when spawned
        self.tasks: list[asyncio.Task] = []
        self.receivers: list[Receiver] = []
        # Set to the exception of the first actor task that dies of one
        # (a failed digest kernel), so the node's run can end with it.
        self.failed: asyncio.Future | None = None

    def _watch(self, task: asyncio.Task) -> None:
        def on_done(t: asyncio.Task) -> None:
            if t.cancelled() or t.exception() is None:
                return
            if not self.failed.done():
                self.failed.set_exception(t.exception())

        task.add_done_callback(log_task_death)
        task.add_done_callback(on_done)
        self.tasks.append(task)

    async def spawn(self) -> "Mempool":
        with_dataplane = self.parameters.workers > 0 and bool(self.committee.workers_of(self.name))
        if with_dataplane and self.signature_service is None:
            raise ValueError(
                "the Conveyor data plane needs a signature service (availability acks are signed)"
            )
        self.failed = asyncio.get_running_loop().create_future()
        self.parameters.log()

        tx_batch_maker: asyncio.Queue = asyncio.Queue(CHANNEL_CAPACITY)
        tx_quorum_waiter: asyncio.Queue = asyncio.Queue(CHANNEL_CAPACITY)
        tx_own_processor: asyncio.Queue = asyncio.Queue(CHANNEL_CAPACITY)
        tx_peer_processor: asyncio.Queue = asyncio.Queue(CHANNEL_CAPACITY)
        tx_helper: asyncio.Queue = asyncio.Queue(CHANNEL_CAPACITY)
        device_digests = self.parameters.device_batch_digests

        # Spawned first: without a card a node with device digests fails
        # here, before it binds anything.
        own_processor = Processor.spawn(
            self.store, tx_own_processor, self.tx_consensus,
            device_digests=device_digests, device=self.device,
        )
        peer_processor = Processor.spawn(
            self.store, tx_peer_processor, self.tx_consensus,
            device_digests=device_digests, device=self.device,
        )
        self._watch(own_processor)
        self._watch(peer_processor)

        # Mempool synchronizer answering consensus sync/cleanup commands.
        self._watch(
            Synchronizer.spawn(
                self.name,
                self.committee,
                self.store,
                self.parameters.gc_depth,
                self.parameters.sync_retry_delay,
                self.parameters.sync_retry_nodes,
                self.rx_consensus,
            )
        )

        # Client transaction intake -> batch maker -> quorum waiter -> own
        # processor: hash, store, digest to consensus.
        tx_address = self.committee.transactions_address(self.name)
        assert tx_address is not None, "our key is not in the committee"
        self.receivers.append(
            await Receiver.spawn(
                ("0.0.0.0", tx_address[1]), TxReceiverHandler(tx_batch_maker)
            )
        )
        self._watch(
            BatchMaker.spawn(
                self.parameters.batch_size,
                self.parameters.max_batch_delay,
                tx_batch_maker,
                tx_quorum_waiter,
                self.committee.broadcast_addresses(self.name),
                benchmark=self.benchmark,
            )
        )
        self._watch(
            QuorumWaiter.spawn(
                self.committee, self.name, tx_quorum_waiter, tx_own_processor
            )
        )

        # Peer messages: batches to the peer processor, batch requests to
        # the helper. auto_ack: batch ACKs (the 2f+1 dissemination quorum)
        # go out on frame arrival; batch_request senders use SimpleSender
        # and discard the reply.
        mp_address = self.committee.mempool_address(self.name)
        assert mp_address is not None
        self.receivers.append(
            await Receiver.spawn(
                ("0.0.0.0", mp_address[1]),
                MempoolReceiverHandler(tx_peer_processor, tx_helper, store=self.store),
                auto_ack=True,
            )
        )
        self._watch(Helper.spawn(self.committee, self.store, tx_helper))

        # The data plane: worker shards with availability certificates.
        if with_dataplane:
            self.dataplane = await DataPlane(
                self.name,
                self.committee,
                self.parameters,
                self.store,
                self.signature_service,
                self.tx_consensus,
                benchmark=self.benchmark,
            ).spawn()

        log.info("Mempool successfully booted on %s", mp_address[0])
        return self

    async def shutdown(self) -> None:
        for t in self.tasks:
            t.cancel()
        if self.dataplane is not None:
            await self.dataplane.shutdown()
        for r in self.receivers:
            await r.shutdown()
