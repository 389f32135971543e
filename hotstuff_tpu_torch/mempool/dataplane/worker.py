"""One Conveyor worker shard: ingest → seal → disseminate → certify.

Port copy of ``hotstuff_tpu/mempool/dataplane/worker.py`` with the
reference's telemetry (``mempool.worker.*`` counters, gauge and
histogram), its dtrace lifeline events with the arrival stamp queued
beside each bundle, and the faultline ``batch_withhold`` hook. Beside the
telemetry the worker keeps the plain integer counts that a run reads
whether telemetry is on or not: ``Worker.batches_sealed``,
``certs_formed``, ``certs_failed``, ``acks_invalid``;
``PeerWorkerHandler.certs_stored`` and ``certs_rejected``; the shed
bundles are ``BoundedIngress.shed``. Unlike the reference,
``Worker.shutdown`` closes the worker's senders (ROADMAP §3 F3).

Each worker owns two listeners (client ingress + peer port) and three
loops:

- the **ingress handler** bounds arrivals (bundles beyond the queue
  capacity are shed with a client-visible ``b"Shed"`` reply) — the
  receive loop never blocks on a full queue;
- the **batcher** drains bundles into a batch (seal by size or delay,
  exactly the BatchMaker contract), gated by the store-depth watermark:
  while depth is above HIGH the batcher parks, ingress fills, and the
  edge sheds — graceful degradation instead of queue collapse;
- the **certifier** turns each sealed batch's signed ack replies into a
  :class:`~.certificate.AvailabilityCert` at 2f+1 stake, persists it,
  best-effort-broadcasts it to peer workers, and only THEN hands the
  digest to consensus — the primary orders digests the committee
  provably holds.

The peer handler is the receiving half: store the raw batch frame under
its digest and reply a SIGNED ack (the reply rides the dissemination
connection, pairing FIFO with the ReliableSender's in-flight frames);
verify-then-store incoming certs and feed their digests to our proposer
(any leader may order any certified batch, mirroring the reference
mempool's everyone-proposes-everything behavior); serve batch requests
from the store. A faultline ``batch_withhold`` byzantine node receives
batches but never acks and never serves — availability must rest on the
cert quorum, not on any individual peer's goodwill.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import OrderedDict

from hotstuff_tpu_torch import telemetry
from hotstuff_tpu_torch.crypto import PublicKey, SignatureService, sha512_digest
from hotstuff_tpu_torch.faultline import hooks as _faultline
from hotstuff_tpu_torch.network import MessageHandler, Receiver, ReliableSender, SimpleSender
from hotstuff_tpu_torch.store import Store
from hotstuff_tpu_torch.utils.serde import SerdeError

from ..config import Committee, Parameters
from . import messages
from .backpressure import BoundedIngress, Watermark
from .certificate import AvailabilityCert, CertCollector, CertError, WorkerSeatTable

log = logging.getLogger("mempool")

#: extra dissemination time granted to the f slowest peers after quorum
#: (mirrors the QuorumWaiter's linger contract).
LINGER_S = 0.5
#: bound on concurrently-certifying batches per worker.
CERTIFY_QUEUE_MAX = 10_000
#: recent-bundle dedup window (client retransmissions), per worker.
DEDUP_WINDOW = 4096


def _withholding() -> bool:
    """True while this node's faultline plane marks it batch-withholding."""
    plane = _faultline.plane
    if plane is None:
        return False
    node = _faultline.current_node()
    return node is not None and plane.behavior_active(node, "batch_withhold")


class IngressHandler(MessageHandler):
    """Client bundles: bound or shed, never block the read loop."""

    def __init__(self, ingress: BoundedIngress) -> None:
        self.ingress = ingress
        self._m_bundles = telemetry.counter("mempool.worker.ingress_bundles")
        self._m_txs = telemetry.counter("mempool.worker.ingress_tx")
        self._m_shed_b = telemetry.counter("mempool.worker.shed_bundles")
        self._m_shed_tx = telemetry.counter("mempool.worker.shed_tx")

    async def dispatch(self, writer, message: bytes) -> None:
        if not message or message[0] != messages.TAG_TX_BUNDLE:
            log.warning("non-bundle frame on worker ingress (tag %r)",
                        message[:1])
            return
        # Header peek only (serde ints are little-endian) — the hot path
        # never parses transactions.
        n_txs = int.from_bytes(message[1:5], "little")
        # Arrival stamp rides with the frame (perf_counter: the trace
        # timebase) so the seal site can back-date the batch's lifeline
        # ``ingress`` event — the hot path pays one clock read, no trace.
        if self.ingress.offer((time.perf_counter(), message)):
            self._m_bundles.inc()
            self._m_txs.inc(n_txs)
        else:
            self._m_shed_b.inc()
            self._m_shed_tx.inc(n_txs)
            # Client-visible shedding: the load generator reads these and
            # can adapt its offered rate.
            await writer.send(b"Shed")

    async def dispatch_frames(self, pairs) -> None:
        """Batched ingress (the receiver hands one list of
        ``(writer, bundle)`` per wakeup): one clock read and one await
        point for the whole wakeup's bundles — the per-frame coroutine
        hop was most of the small-frame ``ingress_wait`` edge."""
        now = time.perf_counter()
        n_ok = tx_ok = n_shed = tx_shed = 0
        shed_writers = []
        for writer, message in pairs:
            if not message or message[0] != messages.TAG_TX_BUNDLE:
                log.warning("non-bundle frame on worker ingress (tag %r)",
                            message[:1])
                continue
            n_txs = int.from_bytes(message[1:5], "little")
            if self.ingress.offer((now, message)):
                n_ok += 1
                tx_ok += n_txs
            else:
                n_shed += 1
                tx_shed += n_txs
                shed_writers.append(writer)
        if n_ok:
            self._m_bundles.inc(n_ok)
            self._m_txs.inc(tx_ok)
        if n_shed:
            self._m_shed_b.inc(n_shed)
            self._m_shed_tx.inc(tx_shed)
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
        self._m_batches = telemetry.counter("mempool.worker.batches_stored")
        self._m_bytes = telemetry.counter("mempool.worker.batch_bytes_in")
        self._m_certs = telemetry.counter("mempool.worker.certs_stored")
        self._m_bad_certs = telemetry.counter("mempool.worker.certs_rejected")
        self._m_withheld = telemetry.counter(
            "faultline.injected.acks_withheld"
        )
        self._node_label = repr(name)
        self.certs_stored = 0
        self.certs_rejected = 0

    async def dispatch(self, writer, message: bytes) -> None:
        tag = message[0] if message else -1
        if tag == messages.TAG_BATCH:
            digest = sha512_digest(message)
            await self.store.write(digest.data, message)
            self._m_batches.inc()
            self._m_bytes.inc(len(message))
            if _withholding():
                # Byzantine availability attack: hold the bytes, withhold
                # the attestation. The sender's cert must come from the
                # honest remainder.
                self._m_withheld.inc()
                return
            sig = await self.signature_service.request_signature(
                messages.ack_digest(digest)
            )
            await writer.send(messages.encode_ack(digest, self.name, sig))
        elif tag in (messages.TAG_CERT, messages.TAG_CERT_V2):
            try:
                cert = AvailabilityCert.decode(message, self.seats)
            except SerdeError as e:
                log.warning("bad cert frame: %s", e)
                self._m_bad_certs.inc()
                self.certs_rejected += 1
                return
            key = messages.cert_key(cert.digest.data)
            if await self.store.read(key) is not None:
                return  # known (and verified once already)
            try:
                cert.verify(self.committee)
            except CertError as e:
                log.warning("rejecting availability cert: %s", e)
                self._m_bad_certs.inc()
                self.certs_rejected += 1
                return
            await self.store.write(key, message)
            self._m_certs.inc()
            self.certs_stored += 1
            # A certified digest is orderable by ANY leader: offer it to
            # our proposer too (committed duplicates are cleaned from
            # every proposer buffer on commit, reference behavior).
            await self.tx_consensus.put(cert.digest)
            if telemetry.dtrace_enabled():
                # Lifeline: a peer cert (wire v1 or v2 — decode handled
                # both above) put this digest into OUR proposer queue.
                telemetry.dtrace_event(
                    self._node_label,
                    telemetry.intern_label(cert.digest.data),
                    "enqueue",
                    detail="peer",
                )
        elif tag == messages.TAG_BATCH_REQUEST:
            try:
                digests, requestor = messages.decode_batch_request(message)
            except SerdeError as e:
                log.warning("bad batch request: %s", e)
                return
            if _withholding():
                self._m_withheld.inc()
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
        # mempool port (whose handler recognizes dataplane batch frames).
        addr = self.committee.worker_address(requestor, 0)
        return addr if addr is not None else self.committee.mempool_address(
            requestor
        )


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
        self._m_sealed = telemetry.counter("mempool.worker.batches_sealed")
        self._m_bytes_out = telemetry.counter("mempool.worker.batch_bytes_out")
        self._m_certs = telemetry.counter("mempool.worker.certs_formed")
        self._m_cert_fail = telemetry.counter("mempool.worker.certs_failed")
        self._m_acks = telemetry.counter("mempool.worker.acks_received")
        self._m_bad_acks = telemetry.counter("mempool.worker.acks_invalid")
        self._m_dedup = telemetry.counter("mempool.worker.dedup_hits")
        self._g_ingress = telemetry.gauge("mempool.worker.ingress_depth")
        self._h_ack = telemetry.histogram("mempool.worker.ack_latency_ms")
        # Lifeline events label their node once (repr is a base64 encode).
        self._node_label = repr(name)
        self.batches_sealed = 0
        self.certs_formed = 0
        self.certs_failed = 0
        self.acks_invalid = 0

    async def spawn(self) -> "Worker":
        entry = self.committee.workers_of(self.name)[self.worker_id]
        self.receivers.append(
            await Receiver.spawn(
                ("0.0.0.0", entry.transactions_address[1]),
                IngressHandler(self.ingress),
            )
        )
        self.peer_handler = PeerWorkerHandler(
            self.name,
            self.committee,
            self.store,
            self.signature_service,
            self.tx_consensus,
        )
        self.receivers.append(
            await Receiver.spawn(
                ("0.0.0.0", entry.worker_address[1]), self.peer_handler
            )
        )
        self.tasks.append(
            asyncio.create_task(
                self._run_batcher(), name=f"worker{self.worker_id}_batcher"
            )
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
        first_arrival: float | None = None
        deadline = time.monotonic() + max_delay
        while True:
            # Back-pressure gate: while store depth is above HIGH, stop
            # consuming — ingress fills and sheds at the edge.
            await self.watermark.wait_ok()
            timeout = max(deadline - time.monotonic(), 0)
            try:
                arrived, frame = await asyncio.wait_for(
                    self.ingress.get(), timeout
                )
            except asyncio.TimeoutError:
                if segments:
                    await self._seal(
                        segments, n_txs, samples, size, first_arrival
                    )
                    segments, n_txs, samples, size = [], 0, [], 0
                    first_arrival = None
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
                self._m_dedup.inc()
                continue
            self._dedup[key] = None
            if len(self._dedup) > DEDUP_WINDOW:
                self._dedup.popitem(last=False)
            if first_arrival is None:
                first_arrival = arrived
            segments.append(blob)
            n_txs += bundle_txs
            samples.extend(bundle_samples)
            size += messages.batch_tx_bytes(bundle_txs, blob)
            if size >= batch_size:
                await self._seal(segments, n_txs, samples, size, first_arrival)
                segments, n_txs, samples, size = [], 0, [], 0
                first_arrival = None
                deadline = time.monotonic() + max_delay

    async def _seal(
        self,
        segments: list[bytes],
        n_txs: int,
        samples: list[int],
        size: int,
        first_arrival: float | None = None,
    ) -> None:
        serialized = messages.encode_worker_batch(
            self.worker_id, n_txs, samples, b"".join(segments)
        )
        digest = sha512_digest(serialized)
        await self.store.write(digest.data, serialized)
        self._m_sealed.inc()
        self.batches_sealed += 1
        self._m_bytes_out.inc(len(serialized) * len(self.peers))
        batch_label = None
        if telemetry.enabled():
            self._g_ingress.set(self.ingress.qsize())
            telemetry.record_sealed(digest.data, size)
        if telemetry.dtrace_enabled():
            # Lifeline: the batch's timeline opens with the earliest
            # contributing bundle's arrival (back-dated — the ingress hot
            # path records nothing) and the seal instant. The seal detail
            # carries the shard, the sizes, and the leading sample ids so
            # the assembler can join client submit timestamps.
            batch_label = telemetry.intern_label(digest.data)
            if first_arrival is not None:
                telemetry.dtrace_event(
                    self._node_label, batch_label, "ingress", t=first_arrival
                )
            detail = f"w{self.worker_id}|{n_txs}tx|{size}B"
            if samples:
                detail += "|s" + ",".join(str(s) for s in samples[:4])
            telemetry.dtrace_event(
                self._node_label, batch_label, "seal", detail=detail
            )
        if self.benchmark:
            for tx_id in samples:
                # NOTE: benchmark measurement interface (same contract as
                # the legacy BatchMaker).
                log.info("Batch %s contains sample tx %d", digest, tx_id)
            log.info("Batch %s contains %d B", digest, size)
        if self.on_sealed is not None:
            self.on_sealed(digest)

        own_sig = await self.signature_service.request_signature(
            messages.ack_digest(digest)
        )
        collector = CertCollector(
            self.committee, digest, own=(self.name, own_sig)
        )
        handlers = [
            (pk, await self.network.send(addr, serialized))
            for pk, addr in self.peers
        ]
        if batch_label is not None:
            # Every dissemination frame is with the ReliableSender now;
            # first-ack minus this mark is the wire+store+sign edge.
            telemetry.dtrace_event(
                self._node_label, batch_label, "disseminate"
            )
        if len(self._certifiers) >= CERTIFY_QUEUE_MAX:
            log.warning("certifier queue full; dropping batch %s", digest)
            self._m_cert_fail.inc()
            self.certs_failed += 1
            for _, h in handlers:
                h.cancel()
            return
        task = asyncio.create_task(
            self._certify(
                digest, collector, handlers, time.monotonic(), batch_label
            )
        )
        self._certifiers.add(task)
        task.add_done_callback(self._certifiers.discard)

    # -- certification -------------------------------------------------------

    async def _certify(
        self,
        digest,
        collector: CertCollector,
        handlers: list,
        t0: float,
        label: str | None = None,
    ) -> None:
        pending = {h: pk for pk, h in handlers}
        traced = label is not None and telemetry.dtrace_enabled()
        first_ack_pending = traced
        cert: AvailabilityCert | None = (
            AvailabilityCert(digest, list(collector.pairs))
            if collector.complete()
            else None
        )
        while cert is None and pending:
            done, _ = await asyncio.wait(
                pending, return_when=asyncio.FIRST_COMPLETED
            )
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
                    self._m_bad_acks.inc()
                    self.acks_invalid += 1
                    continue
                self._m_acks.inc()
                if first_ack_pending:
                    # One lifeline event for the FIRST verified seat ack
                    # only: the assembler's fan-in edge is first-ack →
                    # cert, and keeping the ack hot path to a single
                    # event holds the attached-plane overhead under the
                    # CI budget. The quorum size rides on the cert
                    # event's detail.
                    first_ack_pending = False
                    telemetry.dtrace_event(
                        self._node_label, label, "ack", detail=repr(signer)
                    )
                if maybe is not None:
                    cert = maybe
        if cert is None:
            log.warning("batch %s failed to reach an ack quorum", digest)
            self._m_cert_fail.inc()
            self.certs_failed += 1
            return
        self._h_ack.observe((time.monotonic() - t0) * 1e3)
        if traced:
            telemetry.dtrace_event(
                self._node_label, label, "cert",
                detail=f"a{len(cert.pairs)}",
            )
        encoded = cert.encode(self.seats)
        await self.store.write(messages.cert_key(digest.data), encoded)
        self._m_certs.inc()
        self.certs_formed += 1
        # Best-effort cert broadcast: lets peers vote on (and propose)
        # this digest without the batch; anyone who misses it falls back
        # to fetching the batch itself.
        for _pk, addr in self.peers:
            self.cert_network.send(addr, encoded)
        # Only now does the digest reach consensus: ordering is gated on
        # proven availability.
        await self.tx_consensus.put(digest)
        if traced:
            telemetry.dtrace_event(
                self._node_label, label, "enqueue", detail="own"
            )
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
