"""Sans-io consensus state machine: ``(event, now) -> [effects]``.

Port copy of ``hotstuff_tpu/sim/machine.py``, whole, over the port's
``Core`` (``consensus/core.py``: ``HANDLERS``, ``bound_handlers``, the
``_call_later`` seam, the ``network=``/``timer=``/``statesync=`` seams).
The port's core keeps the reference's telemetry and faultline sites; they
run here as in the reference (telemetry off unless enabled, no fault plane
installed globally).

``CoreStateMachine`` wraps the REAL :class:`~hotstuff_tpu_torch.consensus.core.Core`
handlers — the same dispatch table (``Core.HANDLERS``), the same voting
rules, the same certificate paths — behind deterministic IO adapters:

- the network seam is an :class:`Outbox` that records sends instead of
  opening sockets;
- the timer is the real :class:`~hotstuff_tpu_torch.consensus.timer.Timer`
  over an injected :class:`~hotstuff_tpu_torch.sim.clock.VirtualClock` (the
  scheduler reads ``timer.deadline`` and fires expiries as events);
- the QC-retry backoff (``Core._call_later``) becomes a ``sched``
  effect instead of a sleeping task;
- the synchronizer and proposer actors are replayed synchronously
  (:class:`SimSynchronizer` mirrors ``consensus/synchronizer.py``'s
  suspend/request/unwind algorithm; the proposer drains ``tx_proposer``
  in-step), because the sim plane has no task scheduler to run them on.

The sans-io contract: every handler invocation must RUN TO COMPLETION
without suspending — all awaits inside resolve synchronously (in-memory
store, inline crypto below ``INLINE_SIG_LIMIT`` on a backend whose name
holds no ``cuda``, non-full queues). The
trampoline (:func:`run_sync`) enforces this: a handler that actually
suspends raises :class:`SimSuspended`, which is a sim-plane bug, never
silently different behavior.

Effects are plain tuples (kept allocation-light — the sweep budget is
tens of microseconds per event):

- ``("send", address, data)`` — one unframed wire message to ``address``
  (exactly the bytes the real ``SimpleSender`` would frame and write);
- ``("sched", delay_s, event)`` — deliver ``event`` back to THIS node
  after ``delay_s`` of virtual time (loopback blocks, QC retries, sync
  re-request ticks);
- ``("commit", block)`` — a block left the core on ``tx_commit``.
"""

from __future__ import annotations

import logging
import os

from hotstuff_tpu_torch import telemetry
from hotstuff_tpu_torch.consensus.config import Committee
from hotstuff_tpu_torch.consensus.core import Core
from hotstuff_tpu_torch.consensus.helper import CHAIN_DEPTH
from hotstuff_tpu_torch.consensus.leader import make_elector
from hotstuff_tpu_torch.consensus.mempool_driver import MempoolDriver
from hotstuff_tpu_torch.consensus.messages import (
    QC,
    Block,
    SeatTable,
    encode_propose,
    encode_state_response,
    encode_sync_request,
    sha512_digest,
)
from hotstuff_tpu_torch.consensus.statesync import (
    SNAPSHOT_KEY,
    Compactor,
    SnapshotError,
    StateSync,
    peek_frontier,
)
from hotstuff_tpu_torch.consensus.proposer import Cleanup as ProposerCleanup
from hotstuff_tpu_torch.consensus.proposer import Make as ProposerMake
from hotstuff_tpu_torch.consensus.timer import Timer
from hotstuff_tpu_torch.crypto import PublicKey, SecretKey, SignatureService
from hotstuff_tpu_torch.store import Store

log = logging.getLogger("sim")

__all__ = ["CoreStateMachine", "Outbox", "SimSuspended", "run_sync"]


class SimSuspended(RuntimeError):
    """A handler suspended on real IO inside the simulation — the sans-io
    contract is broken (e.g. a crypto batch above ``INLINE_SIG_LIMIT``
    went to the worker pool). Fix the seam; do not catch this."""


def run_sync(coro):
    """Drive ``coro`` to completion without an event loop, requiring that
    it never suspends on a pending awaitable."""
    try:
        coro.send(None)
    except StopIteration as e:
        return e.value
    coro.close()
    raise SimSuspended(f"coroutine suspended in simulation: {coro!r}")


class Outbox:
    """``SimpleSender``-shaped effect collector: the Core's network seam.

    ``send``/``broadcast`` append ``("send", address, data)`` effects to
    the machine's effect list; nothing is framed, queued, or written.
    """

    def __init__(self, effects: list) -> None:
        self._effects = effects

    def send(self, address, data: bytes) -> None:
        self._effects.append(("send", address, data))

    def broadcast(self, addresses, data: bytes) -> None:
        for address in addresses:
            self._effects.append(("send", address, data))

    def lucky_broadcast(self, addresses, data: bytes, nodes: int) -> None:
        # Deterministic superset of the real gossip primitive (random
        # sample): the sim favors reproducibility over send-count parity,
        # and no consensus-core path uses this today.
        self.broadcast(addresses, data)

    def shutdown(self) -> None:
        pass


class _SimChannel:
    """Minimal stand-in for the ``asyncio.Queue`` channels between the
    Core and its sibling actors: ``await put`` appends (never suspends),
    and the machine drains by list swap — no loop binding, no
    ``QueueEmpty`` exception per drained-empty check (four of those per
    step added up at sweep rates)."""

    __slots__ = ("_items",)

    def __init__(self) -> None:
        self._items: list = []

    async def put(self, item) -> None:
        self._items.append(item)

    def put_nowait(self, item) -> None:
        self._items.append(item)

    def drain(self):
        if not self._items:
            return ()
        items = self._items
        self._items = []
        return items


class _NotifyingStore(Store):
    """In-memory store that reports writes to the machine — the sim's
    replacement for ``Store.notify_read`` task obligations. The engine
    object survives crash/restart (it is the node's disk)."""

    def __init__(self, engine=None) -> None:
        super().__init__(engine=engine)
        self.on_write = None

    async def write(self, key: bytes, value: bytes) -> None:
        await super().write(key, value)
        if self.on_write is not None:
            self.on_write(key)


class _SimCore(Core):
    """The thin sim driver over the Core handlers: self-scheduling
    becomes an effect instead of a sleeping asyncio task."""

    sim_effects: list  # attached by CoreStateMachine right after init

    def _call_later(self, delay_s: float, item) -> None:
        self.sim_effects.append(("sched", delay_s, item))


class _SimMempoolDriver(MempoolDriver):
    """Payload gate without the PayloadWaiter task: the sim plane has no
    mempool, so blocks carry empty payloads and missing payloads (only
    fabricatable by byzantine traffic) simply fail availability instead
    of parking a waiter.

    ``twin_salts`` (installed by a ``SimWorld(twin_proposal_salt=True)``
    world) lists every instance's salt; a payload digest that matches
    the deterministic per-(instance, round) salt digest is treated as
    available without a store read. Twins runs model clients feeding
    DIFFERENT batches to the two copies of a seat — availability is
    universal by assumption there, digest divergence is the point — so
    the gate must not veto what the safety checker exists to judge."""

    twin_salts: tuple[bytes, ...] = ()

    async def verify(self, block) -> bool:
        for d in block.payload:
            if await self.store.read(d.data) is None and not self._twin_salt_ok(
                d, block.round
            ):
                return False
        return True

    def _twin_salt_ok(self, digest, round_) -> bool:
        if not self.twin_salts:
            return False
        rb = round_.to_bytes(8, "little")
        return any(
            digest == sha512_digest(b"twins-proposal-salt", salt, rb)
            for salt in self.twin_salts
        )


class SimSynchronizer:
    """Effect-based port of ``consensus.Synchronizer``: same suspend /
    solicited-request / chain-unwind algorithm, no tasks. Retries ride
    ``("sched", retry_delay, ("sync_retry", parent))`` effects and the
    ``notify_read`` unwind becomes a store write callback re-injecting
    the suspended blocks as loopback events."""

    _ANCESTOR_CACHE_CAP = 128

    def __init__(
        self,
        name: PublicKey,
        committee: Committee,
        store: Store,
        effects: list,
        sync_retry_delay_s: float,
        clock,
    ) -> None:
        self.name = name
        self.committee = committee
        self.store = store
        self._effects = effects
        self.sync_retry_delay = sync_retry_delay_s
        self._clock = clock
        self._pending = set()  # suspended block digests
        self._requests = {}  # parent Digest -> first-request virtual ts
        self._waiting: dict[bytes, list[Block]] = {}  # parent bytes -> blocks
        self._ancestor_cache: dict[bytes, Block] = {}
        self._floor = None  # truncation floor digest (Lazarus)
        self._floor_round = 0

    # -- Core-facing interface (mirrors consensus.Synchronizer) ----------

    def is_pending(self, digest) -> bool:
        return digest in self._pending

    def requested(self, digest) -> bool:
        return digest in self._requests

    def cache_block(self, block: Block) -> None:
        if len(self._ancestor_cache) >= self._ANCESTOR_CACHE_CAP:
            self._ancestor_cache.clear()
        self._ancestor_cache[block.digest().data] = block

    def note_floor(self, frontier: Block) -> None:
        """Mirror of ``Synchronizer.note_floor``: adopt the truncation
        floor and cancel any suspend/request aimed below it."""
        self._floor = frontier.digest()
        self._floor_round = frontier.round
        parent = frontier.parent()
        self._requests.pop(parent, None)
        self._waiting.pop(parent.data, None)
        self._pending.discard(frontier.digest())
        # Drop cached ancestors below the floor: compaction may have
        # truncated their stored parents (see consensus/synchronizer.py).
        for key in [
            k
            for k, b in self._ancestor_cache.items()
            if b.round < frontier.round
        ]:
            del self._ancestor_cache[key]

    def request_block(self, digest, address) -> None:
        """Mirror of ``Synchronizer.request_block`` (the state-sync
        frontier pull): solicited registration + retry tick; fulfillment
        is cleared by ``on_store_write``."""
        if digest in self._requests:
            return
        telemetry.counter("consensus.sync_requests").inc()
        self._requests[digest] = self._clock()
        if address is not None:
            self._effects.append(
                ("send", address, encode_sync_request(digest, self.name))
            )
        self._effects.append(
            ("sched", self.sync_retry_delay, ("sync_retry", digest))
        )

    def cancel_request(self, digest) -> None:
        """Mirror of ``Synchronizer.cancel_request``: withdraw a direct
        pull that will never be served. The pending ``sync_retry`` effect
        self-cancels (``retry`` checks ``_requests`` membership); blocks
        suspended on the digest (if any) stay registered — only the
        request driving the network retries is withdrawn."""
        self._requests.pop(digest, None)

    async def get_parent_block(self, block: Block):
        if block.qc == QC.genesis():
            return Block.genesis()
        if self._floor is not None and block.digest() == self._floor:
            # Truncation frontier: ancestry is truncated everywhere (see
            # consensus/synchronizer.py for the safety argument).
            return Block.genesis()
        if self._floor_round and block.round <= self._floor_round:
            # Stale delivery at or below the horizon — unservable
            # ancestry, placeholder (see consensus/synchronizer.py).
            return Block.genesis()
        parent_digest = block.parent().data
        cached = self._ancestor_cache.get(parent_digest)
        if cached is not None:
            return cached
        data = await self.store.read(parent_digest)
        if data is not None:
            parent = Block.deserialize(data)
            if len(self._ancestor_cache) >= self._ANCESTOR_CACHE_CAP:
                self._ancestor_cache.clear()
            self._ancestor_cache[parent_digest] = parent
            return parent
        self._suspend(block)
        return None

    async def get_ancestors(self, block: Block):
        b1 = await self.get_parent_block(block)
        if b1 is None:
            return None
        b0 = await self.get_parent_block(b1)
        assert b0 is not None, "we should have all ancestors of delivered blocks"
        return (b0, b1)

    def shutdown(self) -> None:
        pass

    # -- sim plumbing -----------------------------------------------------

    def _suspend(self, block: Block) -> None:
        digest = block.digest()
        if digest in self._pending:
            return
        self._pending.add(digest)
        parent = block.parent()
        self._waiting.setdefault(parent.data, []).append(block)
        if parent not in self._requests:
            telemetry.counter("consensus.sync_requests").inc()
            self._requests[parent] = self._clock()
            address = self.committee.address(block.author)
            if address is not None:
                self._effects.append(
                    ("send", address, encode_sync_request(parent, self.name))
                )
            self._effects.append(
                ("sched", self.sync_retry_delay, ("sync_retry", parent))
            )

    def on_store_write(self, key: bytes) -> None:
        blocks = self._waiting.pop(key, None)
        if blocks:
            for block in blocks:
                self._pending.discard(block.digest())
                self._effects.append(("sched", 0.0, ("loopback", block)))
        # The request (keyed by Digest) is fulfilled. Direct state-sync
        # frontier requests have no suspended waiter, so this runs even
        # when nothing was waiting.
        for parent in list(self._requests):
            if parent.data == key:
                del self._requests[parent]

    def retry(self, parent) -> None:
        """A ``sync_retry`` tick fired: if the request is still open,
        re-broadcast it to the whole committee (the real synchronizer's
        frontier retry) and re-arm."""
        if parent not in self._requests:
            return
        addresses = [a for _, a in self.committee.broadcast_addresses(self.name)]
        for address in addresses:
            self._effects.append(
                ("send", address, encode_sync_request(parent, self.name))
            )
        self._effects.append(
            ("sched", self.sync_retry_delay, ("sync_retry", parent))
        )


class CoreStateMachine:
    """One validator as a deterministic state machine.

    Inputs are ``step(event, now)`` calls — ``event`` is a tagged tuple
    exactly as the Core's merged queue carries them (``("propose",
    Block)``, ``("vote", Vote)``, ``("timer", round)``, ...) plus the
    sim-plane extras ``("sync_request", (digest, origin))`` (served by
    the helper logic inline) and ``("sync_retry", digest)``. Outputs are
    the effect tuples documented in the module docstring.

    ``store`` survives restart — passing the previous incarnation's
    store exercises the real ``_restore_state`` recovery path.
    """

    def __init__(
        self,
        name: PublicKey,
        secret: SecretKey,
        committee: Committee,
        *,
        clock,
        timeout_delay: int = 1_000,
        sync_retry_delay: int = 10_000,
        leader_elector: str = "",
        batch_vote_verification: bool = True,
        wire_v2: bool = True,
        store: _NotifyingStore | None = None,
        retention_rounds: int = 0,
        statesync_active: bool = False,
    ) -> None:
        self.clock = clock
        self.store = store if store is not None else _NotifyingStore()
        self._effects: list = []
        self.outbox = Outbox(self._effects)

        seats = SeatTable.for_committee(committee)
        # Same emission gate as Consensus.spawn: decode always accepts
        # both formats; only what we emit is selected here.
        wire_seats = (
            seats
            if wire_v2 and os.environ.get("HOTSTUFF_WIRE_V2", "1") != "0"
            else None
        )
        self.seats = seats
        self._wire_seats = wire_seats

        self.rx_message = _SimChannel()
        self.tx_proposer = _SimChannel()
        self.tx_commit = _SimChannel()
        self.tx_mempool = _SimChannel()

        elector = make_elector(committee, leader_elector)
        self.synchronizer = SimSynchronizer(
            name,
            committee,
            self.store,
            self._effects,
            sync_retry_delay / 1000.0,
            clock,
        )
        self.store.on_write = self.synchronizer.on_store_write
        mempool_driver = _SimMempoolDriver(
            self.store, self.tx_mempool, self.rx_message
        )
        # Handle for SimWorld: twin-salt worlds install the committee's
        # salt list on it (see _SimMempoolDriver.twin_salts).
        self.mempool_driver = mempool_driver
        self.core = _SimCore(
            name,
            committee,
            SignatureService(secret),
            self.store,
            elector,
            mempool_driver,
            self.synchronizer,
            timeout_delay,
            self.rx_message,
            self.rx_message,
            self.tx_proposer,
            self.tx_commit,
            batch_vote_verification=batch_vote_verification,
            wire_seats=wire_seats,
            network=self.outbox,
            timer=Timer(timeout_delay, clock=clock),
            # Lazarus parity: every sim node answers state probes and can
            # install verified snapshots; the ACTIVE probe loop is opt-in
            # (statesync_active) so committed sweep seeds keep their
            # byte-identical event streams; the compactor arms with a
            # retention depth exactly as on the real plane.
            statesync=StateSync(
                name,
                committee,
                sync_retry_delay,
                active=statesync_active,
            ),
            compactor=(
                Compactor(self.store, retention_rounds)
                if retention_rounds > 0
                else None
            ),
        )
        self.core.sim_effects = self._effects
        self._handlers = self.core.bound_handlers()
        self._payload_buffer: set = set()
        self._signature_service = self.core.signature_service
        # Oracle/Twins hooks, set post-construction by the world: a
        # virtual-clock trace sink (sim.streams.SimRoundTrace) and a
        # per-instance payload salt so a twin pair's same-round blocks
        # differ by digest (real twins act on different client payloads;
        # the sim has no clients, so the salt stands in).
        self.trace = None
        self.proposal_salt: bytes | None = None

    # -- scheduler-facing surface -----------------------------------------

    @property
    def timer_deadline(self) -> float:
        return self.core.timer.deadline

    @property
    def round(self) -> int:
        return self.core.round

    def init(self, now: float) -> list:
        """The ``Core.run()`` preamble: restore persisted voting state,
        arm the timer, and propose if this node leads its (restored)
        round."""
        self.clock.advance_to(now)
        run_sync(self.core._restore_state())
        # Same preamble order as Core.run(): floor restoration + probe
        # arming between state restore and the timer.
        run_sync(self.core._statesync.start(self.core))
        self.core.timer.reset()
        if self.core.name == self.core.leader_elector.get_leader(self.core.round):
            run_sync(self.core.generate_proposal(None))
        self._drain_queues()
        return self._take_effects()

    def step(self, event, now: float) -> list:
        self.clock.advance_to(now)
        kind, payload = event
        if kind == "timer":
            # Stale expiry guard, exactly as in Core.run(): the event
            # carries the round the timer fired in.
            if payload == self.core.round:
                run_sync(self.core._guarded(self.core.local_timeout_round()))
        elif kind == "sync_request":
            self._serve_sync_request(payload)
        elif kind == "sync_retry":
            self.synchronizer.retry(payload)
        else:
            handler = self._handlers.get(kind)
            if handler is None:
                log.error("unexpected protocol message kind %s", kind)
            else:
                run_sync(self.core._guarded(handler(payload)))
        self._drain_queues()
        return self._take_effects()

    # -- internals ---------------------------------------------------------

    def _take_effects(self) -> list:
        effects, self._effects[:] = list(self._effects), []
        return effects

    def _drain_queues(self) -> None:
        # Proposer actor, replayed synchronously: Make builds and signs
        # the block, broadcasts it, and loops it back (the loopback is an
        # event, not an inline call — same ordering as the real queue).
        for msg in self.tx_proposer.drain():
            if isinstance(msg, ProposerMake):
                self._make_block(msg)
            elif isinstance(msg, ProposerCleanup):
                for d in msg.digests:
                    self._payload_buffer.discard(d)
        for block in self.tx_commit.drain():
            self._effects.append(("commit", block))
        self.tx_mempool.drain()  # mempool Synchronize/Cleanup: no mempool here
        for item in self.rx_message.drain():  # self-queued: ride the heap
            self._effects.append(("sched", 0.0, item))

    def _make_block(self, make: ProposerMake) -> None:
        payload = sorted(self._payload_buffer, key=lambda d: d.data)
        self._payload_buffer.clear()
        if self.proposal_salt is not None:
            payload.append(
                sha512_digest(
                    b"twins-proposal-salt",
                    self.proposal_salt,
                    make.round.to_bytes(8, "little"),
                )
            )
        block = run_sync(
            Block.new(
                make.qc,
                make.tc,
                self.core.name,
                make.round,
                payload,
                self._signature_service,
            )
        )
        addresses = [
            a for _, a in self.core.committee.broadcast_addresses(self.core.name)
        ]
        if self.trace is not None:
            # The real plane's leader-side broadcast mark (Proposer emits
            # it via telemetry.trace_event): author + digest so stream
            # analyzers attribute the proposal and spot conflicts.
            self.trace.propose_send(
                make.round, f"{self.core.name!r}|{block.digest()!r}"
            )
        self.outbox.broadcast(addresses, encode_propose(block, self._wire_seats))
        self._effects.append(("sched", 0.0, ("loopback", block)))

    def _serve_sync_request(self, payload) -> None:
        """The Helper actor inline: answer with the requested block plus
        up to ``CHAIN_DEPTH - 1`` ancestors, newest first (see
        ``consensus/helper.py`` for why that order heals range gaps)."""
        digest, origin = payload
        address = self.core.committee.address(origin)
        if address is None:
            log.warning("received sync request from unknown node %s", origin)
            return
        try:
            data = run_sync(self.store.read(digest.data))
            if data is None:
                # Truncated-or-unknown digest: answer with the snapshot
                # record so the requester can establish a floor (mirror
                # of the real Helper's NACK path).
                snap = run_sync(self.store.read_meta(SNAPSHOT_KEY))
                if snap is not None:
                    try:
                        round_, frontier = peek_frontier(snap)
                    except SnapshotError as e:
                        log.error("corrupt snapshot record: %s", e)
                    else:
                        self.outbox.send(
                            address,
                            encode_state_response(round_, frontier, snap),
                        )
                return
            block = Block.deserialize(data)
            self.outbox.send(address, encode_propose(block))
            sent = 1
            while sent < CHAIN_DEPTH:
                pdata = run_sync(self.store.read(block.parent().data))
                if pdata is None:
                    break
                block = Block.deserialize(pdata)
                self.outbox.send(address, encode_propose(block))
                sent += 1
        except Exception as e:  # parity with Helper's guard
            log.error("failed to serve sync request for %s: %s", digest, e)
