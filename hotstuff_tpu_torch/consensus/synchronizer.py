"""Consensus block-ancestry synchronizer (reference
``consensus/src/synchronizer.rs``).

Port copy of ``hotstuff_tpu/consensus/synchronizer.py``, whole, with its
``consensus.sync_requests`` counter.

``get_parent_block`` reads the store or fires a ``SyncRequest`` to the block
author and suspends processing; an inner task waits on store ``notify_read``
and loops delivered blocks back to the Core. A coarse timer re-broadcasts
expired requests to all peers ("perfect point-to-point link",
``synchronizer.rs:84-105``).
"""

from __future__ import annotations

import asyncio
import logging
import time

from hotstuff_tpu_torch import telemetry
from hotstuff_tpu_torch.crypto import Digest, PublicKey
from hotstuff_tpu_torch.network import SimpleSender
from hotstuff_tpu_torch.store import Store

from .config import Committee
from .messages import Block, QC, encode_sync_request

log = logging.getLogger("consensus")

TIMER_ACCURACY = 5.0  # s (reference ``synchronizer.rs:22``)


class Synchronizer:
    def __init__(
        self,
        name: PublicKey,
        committee: Committee,
        store: Store,
        tx_loopback: asyncio.Queue,
        sync_retry_delay: int,
        clock=time.monotonic,
    ) -> None:
        self.name = name
        self.committee = committee
        self.store = store
        self.tx_loopback = tx_loopback
        self.sync_retry_delay = sync_retry_delay / 1000.0
        # Injectable clock (default untouched): request timestamps must
        # come from the same clock the simulation plane advances, or
        # sim runs would judge expiry against wall time.
        self._clock = clock
        # The sender it made closes when it stops (the reference's stays
        # open); a stand-in put in its place is its putter's.
        self._sender = self.network = SimpleSender()
        self._pending: set[Digest] = set()  # block digests being waited on
        self._requests: dict[Digest, float] = {}  # parent digest -> first-request ts
        # parent digest -> last (re)send ts: a retried request re-arms at
        # sync_retry_delay cadence instead of being re-broadcast on every
        # poll tick once expired (the committee-wide duplicate storm).
        self._last_sent: dict[Digest, float] = {}
        self._ancestor_cache: dict[bytes, Block] = {}  # digest -> Block
        # Truncation floor (Lazarus): digest of the snapshot frontier
        # block F. Below it the chain is truncated everywhere — walks
        # stop at F instead of suspending on an unservable parent.
        self._floor: Digest | None = None
        self._floor_round = 0
        # digest -> waiter task for DIRECT pulls (request_block), so a
        # caller can cancel one that will never resolve (see
        # cancel_request) without leaking the store obligation.
        self._direct: dict[Digest, asyncio.Task] = {}
        self._tasks: set[asyncio.Task] = set()
        self._main = asyncio.create_task(self._run(), name="consensus_synchronizer")

    async def _waiter(self, wait_on: Digest, deliver: Block) -> None:
        await self.store.notify_read(wait_on.data)
        self._pending.discard(deliver.digest())
        self._requests.pop(deliver.parent(), None)
        self._last_sent.pop(deliver.parent(), None)
        await self.tx_loopback.put(("loopback", deliver))

    def _suspend(self, block: Block) -> None:
        """Register the waiter + sync request for ``block``'s missing
        parent. Runs SYNCHRONOUSLY inside ``get_parent_block`` (i.e. in
        the Core's processing step): the solicited-block rule
        (``requested``) must observe the registration before the Core
        dequeues the next network frame, and on the inline-verification
        CPU path there is no yield point between frames — a registration
        deferred to a background task would race and misclassify helper
        chain ancestors as unsolicited."""
        digest = block.digest()
        if digest in self._pending:
            return
        self._pending.add(digest)
        parent = block.parent()
        task = asyncio.create_task(self._waiter(parent, block))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        if parent not in self._requests:
            log.debug("requesting sync for block %s", parent)
            telemetry.counter("consensus.sync_requests").inc()
            now = self._clock()
            self._requests[parent] = now
            self._last_sent[parent] = now
            author = block.author
            if author == self.name:
                # A block of our own whose parent we lack: our store was
                # lost (a wiped replica rejoining; the reference asks
                # itself here, and the request waits for the retry). A
                # peer that voted for the parent holds it.
                author = next((pk for pk, _ in block.qc.votes if pk != self.name), author)
            address = self.committee.address(author)
            if address is not None:
                self.network.send(
                    address, encode_sync_request(parent, self.name)
                )

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(TIMER_ACCURACY)
            # Idle fast path: with no outstanding requests (the steady
            # state) the tick does no work at all — the old loop built
            # the broadcast address list and sorted an empty view every
            # TIMER_ACCURACY, forever, on every engine in the process.
            if not self._requests:
                continue
            now = self._clock()
            retries = self._expired_frontiers(now)
            if not retries:
                continue
            addresses = [
                a for _, a in self.committee.broadcast_addresses(self.name)
            ]
            for frontier in retries:
                log.debug("requesting sync for block %s (retry)", frontier)
                self.network.broadcast(
                    addresses, encode_sync_request(frontier, self.name)
                )

    #: how many expired frontiers to re-request per tick (see
    #: _expired_frontiers).
    RETRY_FRONTIERS = 3

    def _expired_frontiers(self, now: float) -> list[Digest]:
        """Expired requests worth re-broadcasting now, newest-first.

        Retry only the walk FRONTIERS (the newest few expired requests =
        the deepest missing ancestors): their chain replies (helpers
        serve ancestors in bulk) plus the notify_read unwind heal
        everything shallower. Rebroadcasting every outstanding request —
        one per missed round — floods the committee with O(gap)
        redeliveries per tick, which is exactly the storm that kept a
        straggler from ever catching up. A small K (not 1) covers
        independent missing chains (e.g. a fork from a view change) so
        none starves behind another's walk.

        Expiry judges the LAST send, not the first request: once a
        request aged past sync_retry_delay the old loop re-broadcast it
        on EVERY tick until it resolved — duplicate sync traffic the
        helpers then answered with duplicate chains. Each retry now
        re-arms the request for a full sync_retry_delay.
        """
        expired = sorted(
            (
                (self._requests[digest], digest)
                for digest, sent in self._last_sent.items()
                if sent + self.sync_retry_delay < now
            ),
            key=lambda e: e[0],
            reverse=True,
        )
        retries = [digest for _, digest in expired[: self.RETRY_FRONTIERS]]
        for digest in retries:
            self._last_sent[digest] = now
        return retries

    def note_floor(self, frontier: Block) -> None:
        """Adopt ``frontier`` as the truncation floor (restored from our
        own snapshot record, set by the compactor, or installed from a
        verified peer snapshot). Any outstanding request for its truncated
        parent can never be served — cancel it, and release ``frontier``
        itself from pending (the installer just materialized it)."""
        self._floor = frontier.digest()
        self._floor_round = frontier.round
        parent = frontier.parent()
        self._requests.pop(parent, None)
        self._last_sent.pop(parent, None)
        self._pending.discard(frontier.digest())
        # Cached ancestors strictly below the floor may no longer be in
        # the store — drop them so cache and store agree on what a walk
        # can reach (a cached block whose stored parent was truncated
        # would otherwise suspend on an unservable digest).
        for key in [
            k
            for k, b in self._ancestor_cache.items()
            if b.round < frontier.round
        ]:
            del self._ancestor_cache[key]

    def request_block(self, digest: Digest, address) -> None:
        """Directly solicit ``digest`` from the peer at ``address`` (the
        state-sync frontier pull). Registers it as requested — so the
        lenient-leader solicited-block rule admits the reply chain and the
        retry timer re-broadcasts on loss — and self-cleans once the block
        lands in the store."""
        if digest in self._requests:
            return
        log.debug("requesting state-sync frontier block %s", digest)
        telemetry.counter("consensus.sync_requests").inc()
        now = self._clock()
        self._requests[digest] = now
        self._last_sent[digest] = now
        if address is not None:
            self.network.send(address, encode_sync_request(digest, self.name))
        task = asyncio.create_task(self._request_waiter(digest))
        self._direct[digest] = task
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _request_waiter(self, digest: Digest) -> None:
        try:
            await self.store.notify_read(digest.data)
        finally:
            # Runs on fulfilment AND on cancel_request: either way the
            # request entries must not outlive the waiter (a cancelled
            # notify_read drops its store obligation in its own finally).
            self._direct.pop(digest, None)
            self._requests.pop(digest, None)
            self._last_sent.pop(digest, None)

    def cancel_request(self, digest: Digest) -> None:
        """Withdraw a direct pull that will never be served (e.g. a
        forged frontier digest from an unauthenticated state_response):
        releases the retry entries, the waiter task, and — through the
        waiter's cancellation — the store's notify_read obligation."""
        task = self._direct.pop(digest, None)
        if task is not None:
            task.cancel()
        self._requests.pop(digest, None)
        self._last_sent.pop(digest, None)

    def is_pending(self, digest: Digest) -> bool:
        """True if ``digest`` is a block already suspended awaiting its
        ancestors (chain-reply redeliveries skip re-verification)."""
        return digest in self._pending

    def requested(self, digest: Digest) -> bool:
        """True if ``digest`` is a block this node has actively asked a
        peer for (an outstanding sync request). Used by the lenient
        leader path: only solicited blocks may be stored from an
        unexpected author — they are certified-chain members by
        construction (we requested them as some received block's
        ancestor), so a byzantine member cannot grow the store with
        unsolicited fabrications."""
        return digest in self._requests

    # Recently-deserialized blocks, keyed by digest. Content-addressed
    # and immutable, so the cache can never go stale; it exists because
    # the steady-state commit path re-reads the SAME two ancestors it
    # processed one round ago (b1 of round r is block of round r-1) and
    # re-deserializing a 67-vote QC per read was a top-five CPU line of
    # the N=100 protocol bench.
    _ANCESTOR_CACHE_CAP = 128

    def cache_block(self, block: Block) -> None:
        """Offer a just-stored block to the ancestor cache (it is the
        parent the next round's commit walk will ask for)."""
        if len(self._ancestor_cache) >= self._ANCESTOR_CACHE_CAP:
            self._ancestor_cache.clear()
        self._ancestor_cache[block.digest().data] = block

    async def get_parent_block(self, block: Block) -> Block | None:
        """The parent if stored; None after scheduling a sync (reference
        ``synchronizer.rs:120-134``)."""
        if block.qc == QC.genesis():
            return Block.genesis()
        if self._floor is not None and block.digest() == self._floor:
            # ``block`` IS the truncation frontier: its ancestry is
            # truncated (here and at every peer past the horizon). Serve a
            # genesis placeholder — round 0 can never satisfy the 2-chain
            # commit rule, and the commit walk stops at
            # last_committed_round (>= the floor round) before reaching
            # it, so the placeholder is never committed.
            return Block.genesis()
        if self._floor_round and block.round <= self._floor_round:
            # Stale delivery at or below the horizon (a reordered or
            # byzantine replay of a long-committed round, or a fork
            # abandoned before the floor): its ancestry is truncated at
            # every honest peer, so suspending would park a request no
            # one can serve. Same placeholder argument as above — a
            # round this old can neither commit nor earn a vote.
            return Block.genesis()
        parent_digest = block.parent().data
        cached = self._ancestor_cache.get(parent_digest)
        if cached is not None:
            return cached
        data = await self.store.read(parent_digest)
        if data is not None:
            parent = Block.deserialize(data)
            if len(self._ancestor_cache) >= self._ANCESTOR_CACHE_CAP:
                self._ancestor_cache.clear()  # tiny working set; coarse GC
            self._ancestor_cache[parent_digest] = parent
            return parent
        self._suspend(block)
        return None

    async def get_ancestors(self, block: Block) -> tuple[Block, Block] | None:
        """(b0, b1) where b0 <- |qc0; b1| <- |qc1; block|, or None if the
        chain is incomplete (reference ``synchronizer.rs:136-149``)."""
        b1 = await self.get_parent_block(block)
        if b1 is None:
            return None
        b0 = await self.get_parent_block(b1)
        assert b0 is not None, "we should have all ancestors of delivered blocks"
        return (b0, b1)

    def shutdown(self) -> None:
        self._main.cancel()
        for t in self._tasks:
            t.cancel()
        self._sender.shutdown()
