"""One Conveyor worker shard: ingest → seal → disseminate → certify.

Port copy of ``hotstuff_tpu/mempool/dataplane/worker.py``. Left out: the
faultline ``batch_withhold`` hook (``_withholding``), the telemetry
counters, gauges and histograms, and the dtrace lifeline events with the
arrival stamp the reference queues beside each bundle for them. The
counts that a run reads are plain ints: ``Worker.batches_sealed``,
``certs_formed``, ``certs_failed``, ``acks_invalid``;
``PeerWorkerHandler.certs_stored`` and ``certs_rejected``; the shed
bundles are ``BoundedIngress.shed``. Unlike the reference,
``Worker.shutdown`` closes the worker's senders (ROADMAP §3 F3).

Each worker owns two listeners (client ingress + peer port) and these
loops:

- the **ingress handler** bounds arrivals (bundles beyond the queue
  capacity are shed with a client-visible ``b"Shed"`` reply); the
  receive loop never blocks on a full queue;
- the **batcher** drains bundles into a batch (seal by size or delay,
  the BatchMaker contract), gated by the store-depth watermark: while
  depth is above HIGH the batcher parks, ingress fills, and the edge
  sheds;
- a **certifier** per sealed batch turns the peers' signed ack replies
  into an :class:`~.certificate.AvailabilityCert` at 2f+1 stake,
  persists it, best-effort-broadcasts it to peer workers, and only THEN
  hands the digest to consensus: the primary orders digests the
  committee provably holds.

The peer handler is the receiving half: store the raw batch frame under
its digest and reply a SIGNED ack (the reply rides the dissemination
connection, pairing FIFO with the ReliableSender's in-flight frames);
verify-then-store incoming certs and feed their digests to our proposer
(any leader may order any certified batch); serve batch requests from
the store.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import OrderedDict

from hotstuff_tpu_torch.crypto import PublicKey, SignatureService, sha512_digest
from hotstuff_tpu_torch.network import MessageHandler, Receiver, ReliableSender, SimpleSender
from hotstuff_tpu_torch.store import Store
from hotstuff_tpu_torch.utils.serde import SerdeError

from ..config import Committee, Parameters
from . import messages
from .backpressure import BoundedIngress, Watermark
from .certificate import AvailabilityCert, CertCollector, CertError, WorkerSeatTable

log = logging.getLogger("mempool")

#: extra dissemination time granted to the f slowest peers after quorum
#: (the QuorumWaiter's linger contract).
LINGER_S = 0.5
#: bound on concurrently-certifying batches per worker.
CERTIFY_QUEUE_MAX = 10_000
#: recent-bundle dedup window (client retransmissions), per worker.
DEDUP_WINDOW = 4096


class IngressHandler(MessageHandler):
    """Client bundles: bound or shed, never block the read loop."""

    def __init__(self, ingress: BoundedIngress) -> None:
        self.ingress = ingress

    async def dispatch(self, writer, message: bytes) -> None:
        if not message or message[0] != messages.TAG_TX_BUNDLE:
            log.warning("non-bundle frame on worker ingress (tag %r)", message[:1])
            return
        if not self.ingress.offer(message):
            # Client-visible shedding: the load generator reads these.
            await writer.send(b"Shed")

    async def dispatch_frames(self, pairs) -> None:
        """Batched ingress (the receiver hands one list of
        ``(writer, bundle)`` per wakeup): one await point for the whole
        wakeup's bundles."""
        shed_writers = []
        for writer, message in pairs:
            if not message or message[0] != messages.TAG_TX_BUNDLE:
                log.warning("non-bundle frame on worker ingress (tag %r)", message[:1])
                continue
            if not self.ingress.offer(message):
                shed_writers.append(writer)
        for writer in shed_writers:
            await writer.send(b"Shed")


class PeerWorkerHandler(MessageHandler):
    """Peer frames on the worker port: batches, certs, batch requests."""

    def __init__(
        self,
        name: PublicKey,
        committee: Committee,
        store: Store,
        signature_service: SignatureService,
        tx_consensus: asyncio.Queue,
    ) -> None:
        self.name = name
        self.committee = committee
        self.store = store
        self.signature_service = signature_service
        self.tx_consensus = tx_consensus
        self.seats = WorkerSeatTable.for_committee(committee)
        self.helper_net = SimpleSender()
        self.certs_stored = 0
        self.certs_rejected = 0

    async def dispatch(self, writer, message: bytes) -> None:
        tag = message[0] if message else -1
        if tag == messages.TAG_BATCH:
            digest = sha512_digest(message)
            await self.store.write(digest.data, message)
            sig = await self.signature_service.request_signature(messages.ack_digest(digest))
            await writer.send(messages.encode_ack(digest, self.name, sig))
        elif tag in (messages.TAG_CERT, messages.TAG_CERT_V2):
            try:
                cert = AvailabilityCert.decode(message, self.seats)
            except SerdeError as e:
                log.warning("bad cert frame: %s", e)
                self.certs_rejected += 1
                return
            key = messages.cert_key(cert.digest.data)
            if await self.store.read(key) is not None:
                return  # known (and verified once already)
            try:
                cert.verify(self.committee)
            except CertError as e:
                log.warning("rejecting availability cert: %s", e)
                self.certs_rejected += 1
                return
            await self.store.write(key, message)
            self.certs_stored += 1
            # A certified digest is orderable by ANY leader: offer it to
            # our proposer too (committed duplicates are cleaned from
            # every proposer buffer on commit).
            await self.tx_consensus.put(cert.digest)
        elif tag == messages.TAG_BATCH_REQUEST:
            try:
                digests, requestor = messages.decode_batch_request(message)
            except SerdeError as e:
                log.warning("bad batch request: %s", e)
                return
            address = self._requestor_address(requestor)
            if address is None:
                log.warning("batch request from unknown node %s", requestor)
                return
            for digest in digests:
                batch = await self.store.read(digest.data)
                if batch is not None:
                    self.helper_net.send(address, batch)
        else:
            log.warning("unknown worker frame tag %d", tag)

    def _requestor_address(self, requestor: PublicKey):
        # Prefer the requestor's worker-0 port; fall back to its legacy
        # mempool port (whose handler recognizes data-plane batch frames).
        addr = self.committee.worker_address(requestor, 0)
        return addr if addr is not None else self.committee.mempool_address(requestor)


class Worker:
    """One worker shard's actors; see module docstring."""

    def __init__(
        self,
        name: PublicKey,
        worker_id: int,
        committee: Committee,
        parameters: Parameters,
        store: Store,
        signature_service: SignatureService,
        tx_consensus: asyncio.Queue,
        watermark: Watermark,
        on_sealed=None,  # callback(digest) -> None: depth bookkeeping
        benchmark: bool = False,
    ) -> None:
        self.name = name
        self.worker_id = worker_id
        self.committee = committee
        self.parameters = parameters
        self.store = store
        self.signature_service = signature_service
        self.tx_consensus = tx_consensus
        self.watermark = watermark
        self.on_sealed = on_sealed
        self.benchmark = benchmark
        self.seats = WorkerSeatTable.for_committee(committee)
        self.ingress = BoundedIngress(parameters.worker_ingress_capacity)
        self.peers = committee.worker_peers(name, worker_id)
        self.network = ReliableSender()
        self.cert_network = SimpleSender()
        self.peer_handler: PeerWorkerHandler | None = None
        self.tasks: list[asyncio.Task] = []
        self.receivers: list[Receiver] = []
        self._certifiers: set[asyncio.Task] = set()
        self._dedup: OrderedDict[int, None] = OrderedDict()
        self.batches_sealed = 0
        self.certs_formed = 0
        self.certs_failed = 0
        self.acks_invalid = 0

    async def spawn(self) -> "Worker":
        entry = self.committee.workers_of(self.name)[self.worker_id]
        self.receivers.append(
            await Receiver.spawn(
                ("0.0.0.0", entry.transactions_address[1]), IngressHandler(self.ingress)
            )
        )
        self.peer_handler = PeerWorkerHandler(
            self.name, self.committee, self.store, self.signature_service, self.tx_consensus
        )
        self.receivers.append(
            await Receiver.spawn(("0.0.0.0", entry.worker_address[1]), self.peer_handler)
        )
        self.tasks.append(
            asyncio.create_task(self._run_batcher(), name=f"worker{self.worker_id}_batcher")
        )
        log.info(
            "Worker %d booted (ingress :%d, peers :%d)",
            self.worker_id,
            entry.transactions_address[1],
            entry.worker_address[1],
        )
        return self

    # -- batching ------------------------------------------------------------

    async def _run_batcher(self) -> None:
        batch_size = self.parameters.batch_size
        max_delay = self.parameters.max_batch_delay / 1000.0
        segments: list[bytes] = []
        n_txs = 0
        samples: list[int] = []
        size = 0
        deadline = time.monotonic() + max_delay
        while True:
            # Back-pressure gate: while store depth is above HIGH, stop
            # consuming; ingress fills and sheds at the edge.
            await self.watermark.wait_ok()
            timeout = max(deadline - time.monotonic(), 0)
            try:
                frame = await asyncio.wait_for(self.ingress.get(), timeout)
            except asyncio.TimeoutError:
                if segments:
                    await self._seal(segments, n_txs, samples, size)
                    segments, n_txs, samples, size = [], 0, [], 0
                deadline = time.monotonic() + max_delay
                continue
            try:
                bundle_txs, bundle_samples, blob = messages.decode_bundle(frame)
            except SerdeError as e:
                log.warning("dropping malformed bundle: %s", e)
                continue
            # Best-effort dedup of client retransmissions, at bundle
            # granularity (clients retry whole bundles).
            key = hash(blob)
            if key in self._dedup:
                continue
            self._dedup[key] = None
            if len(self._dedup) > DEDUP_WINDOW:
                self._dedup.popitem(last=False)
            segments.append(blob)
            n_txs += bundle_txs
            samples.extend(bundle_samples)
            size += messages.batch_tx_bytes(bundle_txs, blob)
            if size >= batch_size:
                await self._seal(segments, n_txs, samples, size)
                segments, n_txs, samples, size = [], 0, [], 0
                deadline = time.monotonic() + max_delay

    async def _seal(self, segments: list[bytes], n_txs: int, samples: list[int], size: int) -> None:
        serialized = messages.encode_worker_batch(
            self.worker_id, n_txs, samples, b"".join(segments)
        )
        digest = sha512_digest(serialized)
        await self.store.write(digest.data, serialized)
        self.batches_sealed += 1
        if self.benchmark:
            for tx_id in samples:
                # NOTE: benchmark measurement interface (the legacy
                # BatchMaker's contract).
                log.info("Batch %s contains sample tx %d", digest, tx_id)
            log.info("Batch %s contains %d B", digest, size)
        if self.on_sealed is not None:
            self.on_sealed(digest)

        own_sig = await self.signature_service.request_signature(messages.ack_digest(digest))
        collector = CertCollector(self.committee, digest, own=(self.name, own_sig))
        handlers = [(pk, await self.network.send(addr, serialized)) for pk, addr in self.peers]
        if len(self._certifiers) >= CERTIFY_QUEUE_MAX:
            log.warning("certifier queue full; dropping batch %s", digest)
            self.certs_failed += 1
            for _, h in handlers:
                h.cancel()
            return
        task = asyncio.create_task(self._certify(digest, collector, handlers))
        self._certifiers.add(task)
        task.add_done_callback(self._certifiers.discard)

    # -- certification -------------------------------------------------------

    async def _certify(self, digest, collector: CertCollector, handlers: list) -> None:
        pending = {h: pk for pk, h in handlers}
        cert: AvailabilityCert | None = (
            AvailabilityCert(digest, list(collector.pairs)) if collector.complete() else None
        )
        while cert is None and pending:
            done, _ = await asyncio.wait(pending, return_when=asyncio.FIRST_COMPLETED)
            for fut in done:
                pending.pop(fut)
                if fut.cancelled():
                    continue
                try:
                    ack_d, signer, sig = messages.decode_ack(fut.result())
                    if ack_d != digest:
                        raise CertError("ack digest mismatch")
                    maybe = collector.add_ack(signer, sig)
                except (SerdeError, CertError, ValueError) as e:
                    log.warning("invalid batch ack: %s", e)
                    self.acks_invalid += 1
                    continue
                if maybe is not None:
                    cert = maybe
        if cert is None:
            log.warning("batch %s failed to reach an ack quorum", digest)
            self.certs_failed += 1
            return
        encoded = cert.encode(self.seats)
        await self.store.write(messages.cert_key(digest.data), encoded)
        self.certs_formed += 1
        # Best-effort cert broadcast: lets peers vote on (and propose)
        # this digest without the batch; anyone who misses it falls back
        # to fetching the batch itself.
        for _pk, addr in self.peers:
            self.cert_network.send(addr, encoded)
        # Only now does the digest reach consensus: ordering is gated on
        # proven availability.
        await self.tx_consensus.put(digest)
        if pending:
            # Give the slow minority a bounded grace period, then stop
            # retransmitting to them (they can sync later).
            try:
                await asyncio.wait_for(
                    asyncio.gather(*pending, return_exceptions=True), LINGER_S
                )
            except asyncio.TimeoutError:
                for h in pending:
                    if not h.done():
                        h.cancel()

    async def shutdown(self) -> None:
        for t in self.tasks:
            t.cancel()
        for t in list(self._certifiers):
            t.cancel()
        for r in self.receivers:
            await r.shutdown()
        # The reference leaves its senders running (ROADMAP §3 F3): a
        # stopped worker's ReliableSender would go on retransmitting its
        # batches to whatever listens on the peers' ports next.
        self.network.shutdown()
        self.cert_network.shutdown()
        if self.peer_handler is not None:
            self.peer_handler.helper_net.shutdown()
