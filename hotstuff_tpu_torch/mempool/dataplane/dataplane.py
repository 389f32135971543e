"""Conveyor composition root: spawn worker shards, track store depth,
resolve committed digests back to batches.

Port copy of ``hotstuff_tpu/mempool/dataplane/dataplane.py`` with its
telemetry (``mempool.resolver.*``) and its dtrace ``resolved`` events.
Beside them the resolver keeps the plain ints ``batches_resolved``,
``batches_fetched`` and ``unresolved``.

``DataPlane`` owns the per-node worker set plus the shared store-depth
:class:`~.backpressure.Watermark`: every sealed batch raises the depth,
every committed (or evicted) digest lowers it, and the watermark gates
every worker's batcher: one signal, all shards.

``CommitResolver`` sits between the consensus commit stream and the
application: consensus ordered DIGESTS it could prove available, so the
commit path must materialize the bytes. Batches already local resolve
from the store; missing ones go through the mempool synchronizer's fetch
path (``Synchronize``) and the block is held until the store's
``notify_read`` obligation fires. Blocks always flow downstream in
commit order.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import OrderedDict

from hotstuff_tpu_torch import telemetry
from hotstuff_tpu_torch.crypto import PublicKey, SignatureService
from hotstuff_tpu_torch.store import Store

from ..config import Committee, Parameters
from ..synchronizer import Synchronize
from .backpressure import Watermark
from .worker import Worker

log = logging.getLogger("mempool")

#: outstanding (sealed, uncommitted) digests tracked for depth; beyond
#: this the oldest is evicted (its depth contribution released) so a
#: digest that never commits cannot pin the watermark forever.
OUTSTANDING_CAP = 8192

#: how long the resolver waits for a missing batch before forwarding the
#: block anyway (counted: with <= f faults it should never fire).
RESOLVE_TIMEOUT_S = 60.0


class DataPlane:
    """Per-node worker-shard set (see module docstring)."""

    def __init__(
        self,
        name: PublicKey,
        committee: Committee,
        parameters: Parameters,
        store: Store,
        signature_service: SignatureService,
        tx_consensus: asyncio.Queue,
        benchmark: bool = False,
    ) -> None:
        self.name = name
        self.committee = committee
        self.parameters = parameters
        self.store = store
        self.signature_service = signature_service
        self.tx_consensus = tx_consensus
        self.benchmark = benchmark
        self.watermark = Watermark(
            parameters.store_high_watermark, parameters.store_low_watermark
        )
        self.workers: list[Worker] = []
        # Sealed-but-uncommitted digests, insertion-ordered for eviction.
        self._outstanding: OrderedDict = OrderedDict()

    @property
    def n_workers(self) -> int:
        declared = len(self.committee.workers_of(self.name))
        return min(self.parameters.workers, declared)

    async def spawn(self) -> "DataPlane":
        for wid in range(self.n_workers):
            worker = Worker(
                self.name,
                wid,
                self.committee,
                self.parameters,
                self.store,
                self.signature_service,
                self.tx_consensus,
                self.watermark,
                on_sealed=self._note_sealed,
                benchmark=self.benchmark,
            )
            self.workers.append(await worker.spawn())
        log.info("Conveyor data plane booted with %d worker(s)", len(self.workers))
        return self

    # -- depth bookkeeping ---------------------------------------------------

    def _note_sealed(self, digest) -> None:
        if digest in self._outstanding:
            return
        # A non-None sentinel: note_committed tells a hit from a miss
        # with pop(d, None).
        self._outstanding[digest] = True
        self.watermark.adjust(1)
        if len(self._outstanding) > OUTSTANDING_CAP:
            self._outstanding.popitem(last=False)
            self.watermark.adjust(-1)

    def note_committed(self, digests) -> None:
        """Commit feedback from the resolver: committed digests release
        their depth contribution."""
        for d in digests:
            if self._outstanding.pop(d, None) is not None:
                self.watermark.adjust(-1)

    async def shutdown(self) -> None:
        for w in self.workers:
            await w.shutdown()


class CommitResolver:
    """Digest → batch resolution on the commit path (module docstring)."""

    def __init__(
        self,
        store: Store,
        rx_commit: asyncio.Queue,
        tx_out: asyncio.Queue,
        tx_mempool: asyncio.Queue,
        dataplane: DataPlane | None = None,
    ) -> None:
        self.store = store
        self.rx_commit = rx_commit
        self.tx_out = tx_out
        self.tx_mempool = tx_mempool
        self.dataplane = dataplane
        self._m_resolved = telemetry.counter("mempool.resolver.batches_resolved")
        self._m_fetched = telemetry.counter("mempool.resolver.batches_fetched")
        self._m_unresolved = telemetry.counter("mempool.resolver.unresolved")
        self._h_wait = telemetry.histogram("mempool.resolver.fetch_wait_ms")
        # Lifeline node label: the dataplane knows whose commit stream
        # this is; a standalone resolver (tests) traces as "".
        self._node_label = repr(dataplane.name) if dataplane is not None else ""
        self.batches_resolved = 0  # found in the local store
        self.batches_fetched = 0  # pulled through the synchronizer
        self.unresolved = 0  # timed out

    @classmethod
    def spawn(cls, *args, **kwargs) -> asyncio.Task:
        return cls(*args, **kwargs).start()

    def start(self) -> asyncio.Task:
        return asyncio.create_task(self._run(), name="commit_resolver")

    async def _run(self) -> None:
        while True:
            block = await self.rx_commit.get()
            if block.payload:
                await self._resolve(block)
                if self.dataplane is not None:
                    self.dataplane.note_committed(block.payload)
            await self.tx_out.put(block)

    def _trace_resolved(self, digests, detail: str) -> None:
        if not telemetry.dtrace_enabled():
            return
        for d in digests:
            # Lifeline terminal mark: the batch bytes are materialized on
            # this node's commit path (timeline closes here; a committed-
            # but-never-resolved batch leaves this edge open).
            telemetry.dtrace_event(
                self._node_label,
                telemetry.intern_label(d.data),
                "resolved",
                detail=detail,
            )

    async def _resolve(self, block) -> None:
        missing = [d for d in block.payload if await self.store.read(d.data) is None]
        self._m_resolved.inc(len(block.payload) - len(missing))
        self.batches_resolved += len(block.payload) - len(missing)
        if not missing:
            self._trace_resolved(block.payload, "local")
            return
        # The certified quorum held the batch when it was ordered; pull it
        # through the mempool synchronizer's fetch/retry machinery.
        t0 = time.monotonic()
        await self.tx_mempool.put(Synchronize(missing, block.author))
        try:
            await asyncio.wait_for(
                asyncio.gather(*[self.store.notify_read(d.data) for d in missing]),
                RESOLVE_TIMEOUT_S,
            )
        except asyncio.TimeoutError:
            # Impossible with <= f faults; surfaced rather than wedging the
            # commit stream.
            self._m_unresolved.inc(len(missing))
            self.unresolved += len(missing)
            log.error(
                "commit-path resolution timed out for %d batch(es) of %r",
                len(missing),
                block,
            )
            # The locally-present subset still resolved; the timed-out
            # digests leave their lifeline open (the attribution reports
            # the open edge, never invents a close).
            unresolved = set(missing)
            self._trace_resolved(
                [d for d in block.payload if d not in unresolved], "local"
            )
            return
        self._m_fetched.inc(len(missing))
        self.batches_fetched += len(missing)
        self._h_wait.observe((time.monotonic() - t0) * 1e3)
        missing_set = set(missing)
        self._trace_resolved(
            [d for d in block.payload if d not in missing_set], "local"
        )
        self._trace_resolved(missing, "fetched")
