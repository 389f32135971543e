"""Replica state sync and snapshot/truncate log compaction.

Port copy of ``hotstuff_tpu/consensus/statesync.py``, whole, with the
reference's telemetry gauges and counters (``statesync.*``,
``store.compactions``, ``store.compaction_bytes_freed``,
``store.snapshot_round``) and the same counts as int attributes. Two
cooperating pieces, both driven by the Core's event loop (no new tasks, so
the simulation plane, ``hotstuff_tpu_torch/sim``, runs them unmodified):

**StateSync**: anti-entropy catch-up for cold-joining or lagging replicas.
A node whose commit frontier stops advancing probes peers (one per tick,
rotating, at ``sync_retry_delay`` cadence) with a ``state_request`` carrying
its own committed round. Peers answer with their commit frontier and, when
the requester is below their truncation horizon, their snapshot record.
The joiner verifies the snapshot's 2-chain commit proof through the normal
batch crypto path (on the card under the ``cuda`` backends) BEFORE adopting
anything, installs the frontier as a verified floor, then pulls the
remaining suffix through the ordinary Synchronizer/Helper chain machinery.
Once commits flow, the probe loop goes dormant.

**Compactor**: snapshot + truncate. Every ``retention_rounds`` of commit
progress it selects a frontier block ``F`` about ``retention_rounds`` behind
the commit head such that the committed chain holds ``c1`` with
``c1.round == F.round + 1`` (the 2-chain commit pattern), writes a snapshot
record ``(F, c1, cert)`` (``c1.qc`` certifies ``F``, ``cert`` certifies
``c1``) durably to the MetaLog, then rewrites ``store.log`` without every
block strictly below ``F`` and its payload keys. Store growth is bounded by
the retention depth, not uptime.

The proof is sound against byzantine servers: ``c1.qc`` certifies ``F`` at
``F``'s round and ``cert`` certifies ``c1`` at the next round, exactly the
consecutive-round 2-chain that commits ``F``; no certified-but-abandoned
fork block ever collects that child certificate. The record carries nothing
outside the certified content: every field a joiner adopts (commit floor,
high QC, last-voted floor) derives from the two blocks and two QCs.

Crash discipline: the snapshot record is fsynced BEFORE the log rewrite,
and the rewrite is tmp + fsync + ``os.replace`` (``LogEngine.compact_*``),
so a crash at any point leaves the floor known and one complete log.
"""

from __future__ import annotations

import asyncio
import logging

from hotstuff_tpu_torch import telemetry
from hotstuff_tpu_torch.crypto import Digest, PublicKey
from hotstuff_tpu_torch.store import StoreError
from hotstuff_tpu_torch.utils.serde import Decoder, Encoder, SerdeError

from .config import Committee
from .crypto_bridge import verify_off_loop
from .errors import ConsensusError
from .messages import QC, Block, encode_state_request, encode_state_response

log = logging.getLogger("consensus")

#: MetaLog key of the snapshot record (overwrite semantics, never in the
#: data log — so truncation can never drop its own floor record).
SNAPSHOT_KEY = b"__store_snapshot__"

# v2 dropped the trailing ``last_voted_round`` hint: it was certified by
# neither QC, so adopting it let a byzantine record mute an honest joiner.
_SNAPSHOT_VERSION = 2


class SnapshotError(ConsensusError):
    """Malformed or unproven snapshot record (byzantine or corrupt)."""


class Snapshot:
    """Decoded snapshot record: frontier ``F``, its consecutive-round child
    ``c1`` (whose ``qc`` certifies ``F``), and ``cert``, the QC certifying
    ``c1``."""

    __slots__ = ("frontier", "child", "cert")

    def __init__(self, frontier: Block, child: Block, cert: QC) -> None:
        self.frontier = frontier
        self.child = child
        self.cert = cert

    def __repr__(self) -> str:
        return f"Snapshot(F=r{self.frontier.round}, c1=r{self.child.round})"


def encode_snapshot(frontier: Block, child: Block, cert: QC) -> bytes:
    # The frontier (round, digest) leads the record so servers can answer
    # probes from it without deserializing two blocks (see peek_frontier).
    enc = Encoder()
    enc.u8(_SNAPSHOT_VERSION)
    enc.u64(frontier.round).raw(frontier.digest().data)
    enc.bytes(frontier.serialize()).bytes(child.serialize())
    cert.encode(enc)
    return enc.finish()


def peek_frontier(data: bytes) -> tuple[int, Digest]:
    """Frontier (round, digest) from a snapshot record's fixed header —
    the cheap read the Helper/probe-serving paths use."""
    dec = Decoder(data)
    if dec.u8() != _SNAPSHOT_VERSION:
        raise SnapshotError("unknown snapshot version")
    return dec.u64(), Digest(dec.raw(32))


def decode_snapshot(data: bytes) -> Snapshot:
    """Decode + structural validation (topology, no crypto). Raises
    ``SnapshotError`` on any inconsistency; the record is untrusted until
    ``verify_snapshot`` also checks both certificates."""
    try:
        dec = Decoder(data)
        if dec.u8() != _SNAPSHOT_VERSION:
            raise SnapshotError("unknown snapshot version")
        frontier_round = dec.u64()
        frontier_digest = Digest(dec.raw(32))
        frontier = Block.deserialize(dec.bytes())
        child = Block.deserialize(dec.bytes())
        cert = QC.decode(dec)
        dec.finish()
    except (SerdeError, ValueError) as e:
        raise SnapshotError(f"malformed snapshot record: {e}") from e
    if frontier.round < 1:
        raise SnapshotError("snapshot frontier at genesis")
    if frontier.round != frontier_round or frontier.digest() != frontier_digest:
        raise SnapshotError("snapshot header does not match frontier block")
    if child.qc.hash != frontier.digest() or child.qc.round != frontier.round:
        raise SnapshotError("child certificate does not certify frontier")
    if child.round != frontier.round + 1:
        raise SnapshotError("child is not the frontier's consecutive round")
    if cert.hash != child.digest() or cert.round != child.round:
        raise SnapshotError("cert does not certify child")
    return Snapshot(frontier, child, cert)


async def verify_snapshot(snap: Snapshot, committee: Committee, cache=None) -> None:
    """Verify the 2-chain commit proof's certificates (2 x (2f+1)
    signatures, batched off the loop through the path the hot path's QCs
    take). Raises ``ConsensusError`` if either is invalid, and
    ``BackendUnavailable`` if the backend could not judge them."""
    for qc in (snap.child.qc, snap.cert):
        await verify_off_loop(qc.verify, committee, cache, n_sigs=qc.n_votes())


class StateSync:
    """Anti-entropy protocol driver. Bound to a Core at ``start`` and fed
    by its event loop (``state_request`` / ``state_response`` /
    ``statesync_tick`` events); all scheduling goes through the Core's
    ``_call_later`` seam, so the simulation plane drives this class on the
    virtual clock without modification."""

    #: Ticks before an unresolved direct frontier pull is presumed bogus
    #: and cancelled (a servable block resolves far sooner).
    PULL_TTL_TICKS = 3

    def __init__(
        self, name: PublicKey, committee: Committee, sync_retry_delay: int, active: bool = True
    ) -> None:
        self.name = name
        self.committee = committee
        self.tick_delay_s = sync_retry_delay / 1000.0
        #: probe loop armed (real nodes: yes; opt-in in simulation so that
        #: committed sweep seeds keep byte-identical event streams).
        self.active = active
        self._core = None
        self._peers = [pk for pk, _ in committee.broadcast_addresses(name)]
        self._next_peer = 0
        self._last_seen_commit = -1
        # At most ONE direct frontier pull in flight (see _request_frontier):
        # frontier claims in state_responses are unauthenticated, so each
        # must be bounded in what it can allocate.
        self._pull: Digest | None = None
        self._pull_ticks = 0
        # Per-origin tick index of the last snapshot reply (server side):
        # snapshot records are heavy, so replies are rate-limited to the
        # probe cadence per origin.
        self._snap_served: dict[PublicKey, int] = {}
        self._tick_no = 0
        # Counters (the reference's ``statesync.*`` telemetry).
        self.probing = 0  # 1 while commits are stalled and the loop probes
        self.frontier_gap = 0  # rounds behind the last peer frontier heard
        self.probes_sent = 0
        self.snapshots_installed = 0
        self._g_active = telemetry.gauge("statesync.active")
        self._g_gap = telemetry.gauge("statesync.frontier_gap")
        self._m_probes = telemetry.counter("statesync.probes_sent")
        self._m_installed = telemetry.counter("statesync.snapshots_installed")

    # -- lifecycle ----------------------------------------------------------

    async def start(self, core) -> None:
        """Called from the Core's run preamble (after ``_restore_state``):
        restore the truncation floor from our own snapshot record, then arm
        the probe loop."""
        self._core = core
        data = await core.store.read_meta(SNAPSHOT_KEY)
        if data is not None:
            try:
                snap = decode_snapshot(data)
            except SnapshotError as e:
                # A torn MetaLog tail was truncated on replay, so this is
                # disk corruption: run without a floor.
                log.error("ignoring corrupt local snapshot record: %s", e)
            else:
                core.synchronizer.note_floor(snap.frontier)
                # A restart on a truncated store may hold a consensus-state
                # record older than the snapshot: adopt the floor.
                if snap.frontier.round > core.last_committed_round:
                    core.last_committed_round = snap.frontier.round
                    core._last_committed_digest = snap.frontier.digest()
                core.increase_last_voted_round(snap.child.round)
                core.update_high_qc(snap.cert)
                if core.round <= snap.cert.round:
                    core.round = snap.cert.round + 1
        if self.active:
            self._schedule_tick()

    def _schedule_tick(self) -> None:
        self._core._call_later(self.tick_delay_s, ("statesync_tick", None))

    # -- probe loop (requester side) -----------------------------------------

    async def handle_tick(self, _payload=None) -> None:
        core = self._core
        self._tick_no += 1
        if self._pull is not None:
            if not core.synchronizer.requested(self._pull):
                self._pull = None  # resolved: the slot frees
            else:
                self._pull_ticks += 1
                if self._pull_ticks >= self.PULL_TTL_TICKS:
                    # An unauthenticated frontier claim pointed at a digest
                    # no peer serves: evict it (releasing the request
                    # entries, the store obligation and the waiter task).
                    core.synchronizer.cancel_request(self._pull)
                    self._pull = None
        if core.last_committed_round > self._last_seen_commit:
            # Commits progressed since the last tick: dormant. (An idle
            # committee still commits empty blocks.)
            self._last_seen_commit = core.last_committed_round
            self.probing = 0
            self._g_active.set(0)
        else:
            self.probing = 1
            self._g_active.set(1)
            self._probe()
        self._schedule_tick()

    def _probe(self) -> None:
        """One frontier probe per tick, rotating through peers so a single
        slow or dead peer cannot stall catch-up."""
        if not self._peers:
            return
        pk = self._peers[self._next_peer % len(self._peers)]
        self._next_peer += 1
        address = self.committee.address(pk)
        if address is None:
            return
        self.probes_sent += 1
        self._m_probes.inc()
        log.debug("statesync probe -> %s (committed r%d)", pk, self._core.last_committed_round)
        self._core.network.send(
            address, encode_state_request(self._core.last_committed_round, self.name)
        )

    # -- server side ---------------------------------------------------------

    async def handle_state_request(self, payload) -> None:
        since_round, origin = payload
        core = self._core
        address = self.committee.address(origin)
        if address is None:
            log.warning("state request from unknown node %s", origin)
            return
        digest = core._last_committed_digest
        if digest is None:
            return  # nothing committed yet: nothing to serve
        snapshot = None
        # The origin field is unsigned and spoofable and the record heavy:
        # attach it at most once per claimed origin per tick, so forged
        # requests cannot amplify traffic at a victim. Honest joiners probe
        # each peer at most once per rotation, so catch-up is never
        # throttled. The map is bounded by the committee's size.
        if self._snap_served.get(origin) != self._tick_no:
            data = await core.store.read_meta(SNAPSHOT_KEY)
            if data is not None:
                try:
                    snap_round, _ = peek_frontier(data)
                except SnapshotError:
                    snap_round = None
                # Below our truncation horizon the requester can never heal
                # by chain replay from us: attach the snapshot. At or above
                # it the chain machinery serves everything.
                if snap_round is not None and since_round < snap_round:
                    snapshot = data
                    self._snap_served[origin] = self._tick_no
        core.network.send(
            address, encode_state_response(core.last_committed_round, digest, snapshot)
        )

    # -- requester side -------------------------------------------------------

    async def handle_state_response(self, payload) -> None:
        frontier_round, frontier_digest, snapshot = payload
        core = self._core
        gap = frontier_round - core.last_committed_round
        self.frontier_gap = max(0, gap)
        self._g_gap.set(max(0, gap))
        if gap <= 0:
            return  # we are at or past this peer's frontier
        if snapshot is not None:
            try:
                snap = decode_snapshot(snapshot)
            except SnapshotError as e:
                log.warning("rejecting snapshot from peer: %s", e)
                return
            if snap.frontier.round > core.last_committed_round:
                # Raises into the Core's _guarded on a byzantine proof (or
                # an unjudged BackendUnavailable): NOTHING is adopted
                # before both certificates verify.
                await verify_snapshot(snap, self.committee, core._cert_cache)
                await self._install(snap, snapshot)
        # Pull the suffix between our (possibly just-raised) frontier and
        # the peer's through the normal sync machinery.
        if frontier_round > core.last_committed_round:
            self._request_frontier(frontier_digest)

    def _request_frontier(self, digest: Digest) -> None:
        """Solicit the claimed frontier block, at most ONE such direct pull
        in flight: the claim is unauthenticated, so one slot, freed on
        resolution or evicted after ``PULL_TTL_TICKS``, bounds what a
        byzantine peer can make this node allocate."""
        sync = self._core.synchronizer
        if self._pull is not None and sync.requested(self._pull):
            return  # slot busy: the retry timer is still driving it
        pk = self._peers[self._next_peer % len(self._peers)] if self._peers else None
        address = self.committee.address(pk) if pk is not None else None
        self._pull = digest
        self._pull_ticks = 0
        sync.request_block(digest, address)

    async def _install(self, snap: Snapshot, raw: bytes) -> None:
        """Adopt a VERIFIED snapshot: persist the floor record first (fsync:
        a crash right after must restart knowing the floor), then
        materialize F and c1 so suspended chain walks unwind onto them."""
        core = self._core
        log.info(
            "installing snapshot: frontier r%d (was r%d)",
            snap.frontier.round,
            core.last_committed_round,
        )
        self.snapshots_installed += 1
        self._m_installed.inc()
        await core.store.write_meta(SNAPSHOT_KEY, raw, sync=True)
        core.synchronizer.note_floor(snap.frontier)
        core.last_committed_round = max(core.last_committed_round, snap.frontier.round)
        core._last_committed_digest = snap.frontier.digest()
        # Never vote at or below the adopted window, but raise the floor
        # ONLY to what the certificates prove (c1's round).
        core.increase_last_voted_round(snap.child.round)
        await core.process_qc(snap.cert)  # adopt high_qc, enter cert.round+1
        await core._persist_state()
        # Writing F releases notify_read waiters of blocks suspended on it:
        # do it AFTER the consensus state above is consistent.
        await core.store.write(snap.frontier.digest().data, snap.frontier.serialize())
        await core.store.write(snap.child.digest().data, snap.child.serialize())
        core.synchronizer.cache_block(snap.frontier)
        core.synchronizer.cache_block(snap.child)


class Compactor:
    """Snapshot + truncate driver. ``note_commit`` tracks the commit head;
    ``maybe_compact`` fires once the head is ``2 x retention_rounds`` past
    the previous snapshot (each rewrite copies the whole log, so truncate in
    retention-sized steps, not per round)."""

    def __init__(self, store, retention_rounds: int) -> None:
        self.store = store
        self.retention = retention_rounds
        self._head: Block | None = None
        self._rewrite_task = None  # in-flight background log rewrite
        # Counters (the reference's ``store.*`` telemetry).
        self.snapshot_round = 0
        self.compactions = 0
        self.bytes_freed = 0
        self.keys_dropped = 0
        self._m_compactions = telemetry.counter("store.compactions")
        self._m_freed = telemetry.counter("store.compaction_bytes_freed")
        self._g_snapshot_round = telemetry.gauge("store.snapshot_round")

    def note_commit(self, block: Block) -> None:
        if self._head is None or block.round > self._head.round:
            self._head = block

    async def _read_parent(self, block: Block) -> Block | None:
        if block.qc == QC.genesis():
            return None
        data = await self.store.read(block.parent().data)
        if data is None:
            return None  # previous truncation floor (or genesis)
        return Block.deserialize(data)

    async def maybe_compact(self, core) -> None:
        if self.retention <= 0 or self._head is None:
            return
        if self._rewrite_task is not None and not self._rewrite_task.done():
            return  # previous rewrite still running off the loop
        if core.last_committed_round - self.snapshot_round < 2 * self.retention:
            return
        target = core.last_committed_round - self.retention
        # Walk the committed chain head -> tail for the newest proof pair
        # (F, c1) of consecutive rounds at or below the target. ``above`` is
        # c1's chain child: its qc is the certificate committing c1.
        above: Block | None = None
        child = self._head
        parent = await self._read_parent(child)
        while parent is not None:
            if parent.round <= target and above is not None and child.round == parent.round + 1:
                break
            above, child, parent = child, parent, await self._read_parent(parent)
        else:
            return  # no consecutive-round pair in reach: retry next commit
        frontier, c1, cert = parent, child, above.qc
        snapshot = encode_snapshot(frontier, c1, cert)
        # Floor record FIRST, durably: a crash between this write and the
        # log rewrite restarts with the floor known and the old log whole.
        await self.store.write_meta(SNAPSHOT_KEY, snapshot, sync=True)
        # Drop set: every block strictly below F back to the previous floor,
        # with its payload batch keys (peers below the horizon catch up by
        # snapshot, not by batch replay).
        drop: list[bytes] = []
        cur = await self._read_parent(frontier)
        while cur is not None:
            drop.append(cur.digest().data)
            drop.extend(d.data for d in cur.payload)
            cur = await self._read_parent(cur)
        # The floor is durable and the drop set walked: adopt the snapshot
        # now. The rewrite only reclaims space, so it runs in the background
        # on a phased engine and this node keeps voting meanwhile.
        self.snapshot_round = frontier.round
        core.synchronizer.note_floor(frontier)
        self._g_snapshot_round.set(frontier.round)

        async def _rewrite() -> None:
            try:
                freed = await self.store.compact(drop)
            except (StoreError, OSError) as e:
                # The old log stays live; space is reclaimed next time.
                log.error("log compaction failed (will retry): %s", e)
                return
            self.compactions += 1
            self.bytes_freed += freed
            self._m_compactions.inc()
            self._m_freed.inc(freed)
            self.keys_dropped += len(drop)
            log.info(
                "snapshot at r%d: dropped %d keys below the floor, freed %d bytes",
                frontier.round,
                len(drop),
                freed,
            )

        if self.store.compaction_offloaded():
            self._rewrite_task = asyncio.create_task(_rewrite(), name="store_compaction")
        else:
            await _rewrite()

    async def drain(self) -> None:
        """Wait for an in-flight background rewrite (shutdown: the store
        must not be closed under a live rewrite thread)."""
        if self._rewrite_task is not None:
            await self._rewrite_task
            self._rewrite_task = None
