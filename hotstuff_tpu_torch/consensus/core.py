"""The 2-chain HotStuff protocol state machine (reference
``consensus/src/core.rs``).

State: round, last_voted_round, last_committed_round, high_qc, timer,
aggregator. Voting safety rules (``core.rs:99-116``):

- rule 1: ``block.round > last_voted_round``
- rule 2: ``block.qc.round + 1 == block.round`` OR the block extends a TC
  (``tc.round + 1 == block.round`` and ``block.qc.round >= max(tc.high_qc_rounds)``)

2-chain commit rule (``core.rs:331-336``): when ``b0.round + 1 == b1.round``
for the chain ``b0 <- |qc0; b1| <- |qc1; block|``, commit ``b0`` and all its
uncommitted ancestors.

Crash-safety improvement over the reference: the voting state
(``last_voted_round``, ``round``, ``high_qc``) is persisted (bounded
atomic-replace record, no log growth) before each vote/timeout signature,
fixing the reference's acknowledged unsafe-recovery TODO (``core.rs:114``,
an open upstream issue) for process crashes. Power/kernel-crash durability additionally
requires ``Parameters.persist_sync`` (fsync per state update — slower).

Port copy of ``hotstuff_tpu/consensus/core.py`` with all its handlers, the
batched vote path (QC retry and vote ejection), timeout amplification and
the persisted voting state, whose record is the reference's byte for byte.
The telemetry is the reference's: the ``consensus.*`` counters and
gauges, the round tracer, ``record_commit`` and the commit dtrace event,
the profiler's stage tags (``STAGE_SEEDS``) and, with ``profile=True``,
the ``consensus.stage.<kind>.{ns,calls}`` counters, and so is the
faultline audit line (``FaultlineCommit r=… d=…``), and so is the native
vote pre-stage hook (``on_round_advance``). Beside the telemetry, the core keeps the plain
integer counters that its callers read whether telemetry is on or not
(``qcs_formed``, ``blocks_committed``, ``timeouts_fired``,
``backend_failures``).

One difference from the reference follows from the crypto plane: in front
of ``CudaBackend`` (which, like the reference's TPU backend, has no fused
``verify_cert``), ``BatchingBackend`` keeps a device failure on a v2
certificate ``BackendUnavailable``, where the reference's turns it into a
``CryptoError``. So a v2 QC hit by a device failure is retried here
(``_schedule_qc_retry``) and taken apart for byzantine votes there
(``_eject_invalid_votes``).
"""

from __future__ import annotations

import asyncio
import logging

from hotstuff_tpu_torch import telemetry
from hotstuff_tpu_torch.crypto import BackendUnavailable, CryptoError, PublicKey, SignatureService
from hotstuff_tpu_torch.faultline import hooks as _faultline
from hotstuff_tpu_torch.network import SimpleSender
from hotstuff_tpu_torch.store import Store, StoreError
from hotstuff_tpu_torch.utils.serde import Decoder, Encoder, SerdeError
from hotstuff_tpu_torch.telemetry import profiler as pyprof
from hotstuff_tpu_torch.utils.tasks import log_task_death

from .aggregator import Aggregator
from .config import Committee, Round
from .crypto_bridge import verify_off_loop
from .errors import ConsensusError, UnknownAuthority, WrongLeader
from .leader import LeaderElector
from .mempool_driver import MempoolDriver
from .messages import (
    QC,
    TC,
    Block,
    CertificateCache,
    Timeout,
    Vote,
    encode_tc,
    encode_timeout,
    encode_vote,
)
from .proposer import Cleanup as ProposerCleanup
from .proposer import Make as ProposerMake
from .synchronizer import Synchronizer
from .timer import Timer

log = logging.getLogger("consensus")

_STATE_KEY = b"__consensus_state__"


class Core:
    # Class-level no-op defaults: state-only instances (tests build Core
    # via ``__new__`` to exercise single handlers) and fully-wired cores
    # with telemetry disabled share the same do-nothing metric objects;
    # ``__init__`` overrides them with live ones when telemetry is on.
    _m_proposals = _m_votes = _m_timeouts_rx = _m_timeouts = telemetry.NULL_COUNTER
    _m_qcs = _m_tcs = _m_rounds = _m_blocks = telemetry.NULL_COUNTER
    _g_round = _g_committed_round = telemetry.NULL_GAUGE
    _trace = None
    # Plain protocol counters, class-level zeros so that state-only
    # instances count too; each increment makes an instance attribute.
    qcs_formed = blocks_committed = timeouts_fired = 0
    # Verifications that the backend could not judge (``BackendUnavailable``).
    backend_failures = 0
    _wire_seats = None  # state-only instances broadcast legacy v1
    # Replica-lifecycle collaborators (state sync, compaction): None on
    # state-only instances, whose handlers below then do nothing for them.
    _statesync = None
    _compactor = None
    _last_committed_digest = None  # newest committed block's digest

    def __init__(
        self,
        name: PublicKey,
        committee: Committee,
        signature_service: SignatureService,
        store: Store,
        leader_elector: LeaderElector,
        mempool_driver: MempoolDriver,
        synchronizer: Synchronizer,
        timeout_delay: int,
        rx_message: asyncio.Queue,
        rx_loopback: asyncio.Queue,
        tx_proposer: asyncio.Queue,
        tx_commit: asyncio.Queue,
        benchmark: bool = False,
        persist_sync: bool = False,
        batch_vote_verification: bool = False,
        on_round_advance=None,
        wire_seats=None,
        network=None,
        timer=None,
        statesync=None,
        compactor=None,
        profile: bool = False,
    ) -> None:
        self.name = name
        self.committee = committee
        self.signature_service = signature_service
        self.store = store
        self.leader_elector = leader_elector
        self.mempool_driver = mempool_driver
        self.synchronizer = synchronizer
        self.rx_message = rx_message
        self.rx_loopback = rx_loopback
        self.tx_proposer = tx_proposer
        self.tx_commit = tx_commit
        self.benchmark = benchmark
        self.persist_sync = persist_sync
        self.batch_vote_verification = batch_vote_verification
        self.round: Round = 1
        self.last_voted_round: Round = 0
        self.last_committed_round: Round = 0
        self.high_qc = QC.genesis()
        # IO seams: the asyncio stack uses the defaults (real timer, real
        # best-effort sender); a test (or the simulation plane, sim/machine.py)
        # injects a virtual-clock timer and an effect-collecting outbox so
        # the SAME handlers run sans-io.
        self.timer = timer if timer is not None else Timer(timeout_delay)
        self.aggregator = Aggregator(committee)
        # A sender made here closes when the core's task ends (the
        # reference's stays open); one passed in stays its owner's.
        self._sender = SimpleSender() if network is None else None
        self.network = network if network is not None else self._sender
        # round -> set of known-byzantine vote keys (author||sig||hash);
        # GC'd with the aggregator on round advance.
        self._bad_sigs: dict[Round, set[bytes]] = {}
        # round -> authors whose seat already holds an INDIVIDUALLY
        # VERIFIED vote: further conflicting votes from them (replays, or
        # genuine equivocation by a proven-byzantine author) drop without
        # paying another signature verification — closes the replay-DoS on
        # the reseat path. GC'd with _bad_sigs.
        self._verified_seats: dict[Round, set] = {}
        # Strong references to in-flight qc_retry timer tasks.
        self._retry_tasks: set[asyncio.Task] = set()
        # Rounds this node already amplified a timeout for (one own
        # timeout per future round, however many peers retransmit).
        self._amplified: set[Round] = set()
        # Native-transport hook: pushes each round advance down to the
        # C++ vote pre-stage so its stale-round cutoff tracks the core's.
        # None on the asyncio transport.
        self._on_round_advance = on_round_advance
        # Wire-format v2 seat table for outgoing timeout/TC broadcasts
        # (None = emit legacy v1). Decode-side acceptance is unconditional.
        self._wire_seats = wire_seats
        # Optional per-stage profiling (benchmark --profile): one
        # perf_counter_ns pair per handled event, accumulated into the
        # telemetry registry as ``consensus.stage.<kind>.{ns,calls}``
        # counters (benchmarks diff registry snapshots around their
        # measured window). One truthiness check per event when off.
        self._profile = bool(profile)
        # Telemetry plane. The metric objects are no-op singletons when
        # telemetry is disabled, so each record below costs one cheap
        # method call; the round tracer is None when disabled (its marks
        # take timestamps, which we skip entirely).
        self._m_proposals = telemetry.counter("consensus.proposals_received")
        self._m_votes = telemetry.counter("consensus.votes_received")
        self._m_timeouts_rx = telemetry.counter("consensus.timeouts_received")
        self._m_timeouts = telemetry.counter("consensus.timeouts_fired")
        self._m_qcs = telemetry.counter("consensus.qcs_formed")
        self._m_tcs = telemetry.counter("consensus.tcs_formed")
        self._m_rounds = telemetry.counter("consensus.rounds_advanced")
        self._m_blocks = telemetry.counter("consensus.blocks_committed")
        self._g_round = telemetry.gauge("consensus.round")
        self._g_committed_round = telemetry.gauge("consensus.last_committed_round")
        # The node label keys this engine's events in the cross-node
        # trace stream (in-process committees share one ring buffer);
        # the 16-char base64 prefix is unique within any real committee.
        self._trace = telemetry.round_trace(node=repr(name))
        # Peer-label cache for trace-event details (vote_rx/propose carry
        # "<author>|<digest>" so stream analyzers can score per-peer
        # behavior); repr(PublicKey) base64-encodes on every call, so the
        # hot vote path interns the label once per peer instead. The
        # one-entry digest memo exists because all 2f+1 votes of a round
        # carry the SAME block hash — one encode per round, not per vote.
        self._peer_labels: dict = {}
        self._vote_digest_memo: tuple[bytes, str] | None = None
        # Replica lifecycle: anti-entropy state sync and snapshot/truncate
        # compaction, both driven by this event loop.
        self._statesync = statesync
        self._compactor = compactor
        # This node's verified-certificate memory: rebroadcast QCs/TCs
        # (every view-change timeout carries the same high_qc; every
        # TC-former broadcasts the TC; timers retransmit) verify once
        # instead of once per arrival — without it, timeout waves at
        # committee scale saturate the core in redundant batch verifies
        # and view changes stretch from one timer period to many.
        self._cert_cache = CertificateCache()

    @classmethod
    def spawn(cls, *args, **kwargs) -> asyncio.Task:
        return cls(*args, **kwargs).start()

    def start(self) -> asyncio.Task:
        """Run as a task; the sender this core made closes when it ends."""
        task = asyncio.create_task(self.run(), name="consensus_core")
        task.add_done_callback(log_task_death)
        if self._sender is not None:
            task.add_done_callback(lambda _: self._sender.shutdown())
        return task

    # -- persistence of voting state (the upstream recovery TODO) -----------

    async def _persist_state(self) -> None:
        enc = Encoder()
        enc.u64(self.round).u64(self.last_voted_round).u64(self.last_committed_round)
        self.high_qc.encode(enc)
        await self.store.write_meta(_STATE_KEY, enc.finish(), sync=self.persist_sync)

    async def _restore_state(self) -> None:
        data = await self.store.read_meta(_STATE_KEY)
        if data is None:
            return
        try:
            dec = Decoder(data)
            self.round = dec.u64()
            self.last_voted_round = dec.u64()
            self.last_committed_round = dec.u64()
            self.high_qc = QC.decode(dec)
            dec.finish()
            log.info(
                "Restored consensus state: round %d, last_voted %d",
                self.round,
                self.last_voted_round,
            )
        except Exception as e:  # corrupt state: safer to halt than equivocate
            raise ConsensusError(f"corrupt persisted consensus state: {e}") from e

    # -- helpers ------------------------------------------------------------

    async def store_block(self, block: Block) -> None:
        await self.store.write(block.digest().data, block.serialize())
        # This block is next round's parent: seed the synchronizer's
        # ancestor cache so the commit path doesn't re-deserialize it.
        self.synchronizer.cache_block(block)

    def increase_last_voted_round(self, target: Round) -> None:
        self.last_voted_round = max(self.last_voted_round, target)

    async def make_vote(self, block: Block) -> Vote | None:
        safety_rule_1 = block.round > self.last_voted_round
        safety_rule_2 = block.qc.round + 1 == block.round
        if block.tc is not None:
            can_extend = block.tc.round + 1 == block.round
            can_extend &= block.qc.round >= max(block.tc.high_qc_rounds())
            safety_rule_2 |= can_extend
        if not (safety_rule_1 and safety_rule_2):
            return None
        # Ensure we won't vote for contradicting blocks: persist BEFORE the
        # vote leaves this process.
        self.increase_last_voted_round(block.round)
        await self._persist_state()
        return await Vote.new(block, self.name, self.signature_service)

    async def commit(self, block: Block) -> None:
        if self.last_committed_round >= block.round:
            return
        # Commit the entire chain (needed after view-changes).
        to_commit = [block]
        parent = block
        while self.last_committed_round + 1 < parent.round:
            ancestor = await self.synchronizer.get_parent_block(parent)
            assert ancestor is not None, "committed block should have all ancestors"
            if ancestor.round <= self.last_committed_round:
                # Round GAP (view change abandoned the rounds between):
                # the fetched ancestor is already committed. Appending it
                # again would emit a duplicate commit downstream (double-
                # counted by the benchmark log parser) and feed a
                # duplicate entry into the reputation elector's window —
                # whose content then depends on each node's individual
                # commit batching, silently breaking the
                # identical-prefix => identical-window agreement
                # invariant (observed live as a permanent election
                # disagreement: the "timeout grind").
                break
            to_commit.append(ancestor)
            parent = ancestor
        self.last_committed_round = block.round
        # Commit frontier: what state_request probes are answered with.
        self._last_committed_digest = block.digest()

        for blk in reversed(to_commit):
            self.blocks_committed += 1
            self._m_blocks.inc()
            self._g_committed_round.set(blk.round)
            if self._trace is not None:
                self._trace.mark_commit(
                    blk.round, f"h{self.last_committed_round}"
                )
            if blk.payload:
                log.info("Committed %s", blk)
                if self.benchmark:
                    for d in blk.payload:
                        # NOTE: benchmark measurement interface (reference
                        # ``core.rs:145-149``).
                        log.info("Committed %s -> %s", blk, d)
                for d in blk.payload:
                    # Telemetry mirror of the "Committed B -> d" contract
                    # (no-op unless telemetry is enabled).
                    telemetry.record_commit(d.data)
                if telemetry.dtrace_enabled():
                    # Lifeline ordering-edge close: every node marks the
                    # commit per payload digest (the assembler keeps the
                    # earliest — the round-trace first-commit semantics).
                    name_label = repr(self.name)
                    for d in blk.payload:
                        telemetry.dtrace_event(
                            name_label,
                            telemetry.intern_label(d.data),
                            "committed",
                            detail=f"r{blk.round}",
                        )
            log.debug("Committed %r", blk)
            if _faultline.plane is not None:
                # Chaos-run audit line (INFO so it survives the default
                # verbosity): the multi-process checker reconstructs each
                # node's (round, digest) commit stream from these. One
                # module-global load when faultline is off.
                log.info(
                    "FaultlineCommit r=%d d=%s",
                    blk.round,
                    blk.digest().data.hex(),
                )
            # Committed blocks (in commit order) feed the elector's
            # participation window (no-op for round-robin).
            self.leader_elector.update(blk)
            if self._compactor is not None:
                self._compactor.note_commit(blk)
            await self.tx_commit.put(blk)
        if self._compactor is not None:
            await self._compactor.maybe_compact(self)

    def update_high_qc(self, qc: QC) -> None:
        if qc.round > self.high_qc.round:
            self.high_qc = qc

    async def local_timeout_round(self) -> None:
        log.warning("Timeout reached for round %d", self.round)
        self.timeouts_fired += 1
        self._m_timeouts.inc()
        if self._trace is not None:
            self._trace.mark_timeout(self.round)
        self.increase_last_voted_round(self.round)
        await self._persist_state()
        timeout = await Timeout.new(
            self.high_qc, self.round, self.name, self.signature_service
        )
        log.debug("Created %r", timeout)
        self.timer.reset()
        addresses = [a for _, a in self.committee.broadcast_addresses(self.name)]
        self.network.broadcast(
            addresses, encode_timeout(timeout, self._wire_seats)
        )
        await self.handle_timeout(timeout)

    # -- handlers -----------------------------------------------------------

    # Votes beyond this many rounds ahead are dropped: bounds the state an
    # attacker can allocate for fabricated future rounds.
    MAX_ROUND_LOOKAHEAD = 1_000

    def _effective_sigs(self, cert, n: int) -> int:
        """``n`` if the certificate must actually be verified, 0 when a
        byte-identical copy is already in this node's cache — so the
        verify-offload policy (``INLINE_SIG_LIMIT``) prices the REAL work:
        a rebroadcast certificate must not pay an executor hop just to
        hit the cache inside the worker."""
        if cert is None:
            return 0
        if self._cert_cache.hit(CertificateCache.key_of(cert)):
            return 0
        return n

    async def handle_vote_batch(self, votes: list[Vote]) -> None:
        """Aggregated fan-in from the native pre-stage: one dequeue for a
        whole poll cycle's admitted votes. Each vote runs the exact
        per-vote pipeline (cheap checks, aggregation, verification,
        byzantine ejection) under its own error guard, so one byzantine
        vote never poisons the rest of its batch."""
        for vote in votes:
            await self._guarded(self.handle_vote(vote))

    def _peer_label(self, pk) -> str:
        label = self._peer_labels.get(pk)
        if label is None:
            label = self._peer_labels[pk] = repr(pk)
        return label

    async def handle_vote(self, vote: Vote) -> None:
        log.debug("Processing %r", vote)
        self._m_votes.inc()
        if vote.round < self.round:
            return
        if self._trace is not None:
            self._trace.mark_vote(vote.round)
            # Per-peer accountability evidence: WHO voted, for WHAT — the
            # watchtower's vote-participation and conflicting-vote
            # (equivocation) scorers read these off the trace stream.
            memo = self._vote_digest_memo
            if memo is None or memo[0] != vote.hash.data:
                memo = self._vote_digest_memo = (
                    vote.hash.data, repr(vote.hash)
                )
            self._trace.mark_vote_rx(
                vote.round, self._peer_label(vote.author) + "|" + memo[1]
            )
        if vote.round > self.round + self.MAX_ROUND_LOOKAHEAD:
            log.warning("dropping vote %d rounds ahead", vote.round - self.round)
            return
        if self.batch_vote_verification:
            qc = await self._handle_vote_batched(vote)
        else:
            await verify_off_loop(vote.verify, self.committee)
            qc = self.aggregator.add_vote(vote)
        if qc is not None:
            await self._complete_qc(qc)

    async def _complete_qc(self, qc: QC) -> None:
        log.debug("Assembled %r", qc)
        self.qcs_formed += 1
        self._m_qcs.inc()
        if self._trace is not None:
            self._trace.mark_qc(qc.round)
        await self.process_qc(qc)
        if self.name == self.leader_elector.get_leader(self.round):
            await self.generate_proposal(None)

    async def _handle_vote_batched(self, vote: Vote) -> QC | None:
        """Committee-scale path: only cheap checks per vote; the 2f+1
        signatures of the assembled QC are verified in ONE batch call (one
        device dispatch per QC instead of per vote)."""
        if self.committee.stake(vote.author) == 0:
            raise UnknownAuthority(str(vote.author))
        if self._vote_key(vote) in self._bad_sigs.get(vote.round, set()):
            return None  # known-byzantine signature resent: drop cheaply
        try:
            qc = self.aggregator.add_vote(vote)
        except ConsensusError:
            # The author's slot is taken — same bucket or (since the
            # one-bucket-per-author bound) a different digest's bucket —
            # possibly by a spoofed vote that would otherwise displace the
            # honest one. Identical resends drop free; a DIFFERENT
            # signature is verified individually and re-seated if genuine,
            # preserving liveness under spoofing.
            stored = self.aggregator.stored_signature(
                vote.round, vote.digest(), vote.author
            )
            if stored == vote.signature:
                return None
            if vote.author in self._verified_seats.get(vote.round, set()):
                return None  # seat already verified: replay/equivocation
            try:
                await verify_off_loop(vote.verify, self.committee)
            except ConsensusError:
                self._record_bad(vote.round, self._vote_key(vote))
                return None
            self._verified_seats.setdefault(vote.round, set()).add(vote.author)
            qc = self.aggregator.reseat_vote(vote)
        if qc is None:
            return None
        try:
            await verify_off_loop(
                qc.verify, self.committee, self._cert_cache, n_sigs=qc.n_votes()
            )
            return qc
        except BackendUnavailable as e:
            # The assembled QC was NOT judged (device/tunnel failure). Its
            # weight is already consumed in the aggregator, so retry the
            # verification later instead of losing the QC until view change.
            log.error("backend unavailable verifying %r (will retry): %s", qc, e)
            self.backend_failures += 1
            self._schedule_qc_retry(qc, attempt=1)
            return None
        except ConsensusError:
            try:
                return await self._eject_invalid_votes(qc)
            except BackendUnavailable as e:
                # Backend died mid-ejection: the QC is still unjudged.
                log.error("backend died during ejection (will retry): %s", e)
                self.backend_failures += 1
                self._schedule_qc_retry(qc, attempt=1)
                return None

    QC_RETRY_MAX = 6
    QC_RETRY_BASE_S = 0.25

    def _schedule_qc_retry(self, qc: QC, attempt: int) -> None:
        """Bounded backoff retry of an unjudged QC; if the backend stays
        down past the last attempt, the round's timeout/view-change is the
        fallback recovery (as for any liveness failure)."""
        if attempt > self.QC_RETRY_MAX:
            log.error("giving up QC verification retries for %r", qc)
            return
        self._call_later(self.QC_RETRY_BASE_S * attempt, ("qc_retry", (qc, attempt)))

    def _call_later(self, delay_s: float, item) -> None:
        """Re-inject ``item`` onto the merged event queue after
        ``delay_s``. This is the Core's only self-scheduling primitive
        (QC-retry backoff) — a driver without a loop (the simulation plane,
        sim/machine.py) overrides it to push a virtual-time event instead
        of sleeping."""

        async def later() -> None:
            await asyncio.sleep(delay_s)
            await self.rx_message.put(item)

        task = asyncio.create_task(later(), name="qc_retry")
        # Strong reference: a sleeping fire-and-forget task may otherwise
        # be garbage-collected before it runs.
        self._retry_tasks.add(task)
        task.add_done_callback(self._retry_tasks.discard)
        task.add_done_callback(log_task_death)

    async def _handle_qc_retry(self, payload) -> None:
        qc, attempt = payload
        if qc.round < self.round:
            return  # the protocol moved on
        try:
            await verify_off_loop(
                qc.verify, self.committee, self._cert_cache, n_sigs=qc.n_votes()
            )
        except BackendUnavailable:
            self.backend_failures += 1
            self._schedule_qc_retry(qc, attempt + 1)
            return
        except ConsensusError:
            try:
                qc = await self._eject_invalid_votes(qc)
            except BackendUnavailable:
                self.backend_failures += 1
                self._schedule_qc_retry(qc, attempt + 1)
                return
            if qc is None:
                return
        await self._complete_qc(qc)

    async def _eject_invalid_votes(self, qc: QC) -> QC | None:
        """A batch-verified QC failed: identify the byzantine signatures
        (off the event loop — this is 2f+1 serial verifies), record them so
        resends drop cheaply, and keep the good votes aggregating. Returns
        a QC if the surviving votes already meet the quorum threshold.

        Loops because ejection operates on the aggregator's CURRENT maker:
        votes seated after the failing QC was assembled may be unverified
        (batched mode), so a re-emitted QC is split again until every
        signature in it verified individually. Each iteration with bad
        signatures removes at least one vote, so the loop is bounded by
        committee size."""
        current = qc
        for _ in range(len(self.committee.authorities) + 1):
            digest = current.digest()

            def split(votes=current.votes, digest=digest):
                good, bad = [], []
                for pk, sig in votes:
                    try:
                        sig.verify(digest, pk)
                        good.append((pk, sig))
                    except BackendUnavailable:
                        raise  # NOT judged: never classify as byzantine
                    except CryptoError:
                        bad.append((pk, sig))
                return good, bad

            _, bad = await verify_off_loop(split, n_sigs=len(current.votes))
            if not bad:
                # Every signature verified individually (a stricter check
                # than the failed cofactored batch): the QC stands.
                return current
            for pk, sig in bad:
                log.warning("ejecting invalid vote signature from %s", pk)
                self._record_bad(
                    current.round, bytes(pk.data) + sig.data + current.hash.data
                )
            next_qc, ejected = self.aggregator.eject_votes(
                current.round, digest, bad, current.hash
            )
            # An ejected author's seat no longer holds a verified vote;
            # forgetting the seat lets their genuine resend be verified
            # and re-seated instead of being dropped as a replay.
            seats = self._verified_seats.get(current.round)
            if seats is not None:
                seats.difference_update(ejected)
            if next_qc is None:
                return None
            current = next_qc
        return None

    @staticmethod
    def _vote_key(vote: Vote) -> bytes:
        return vote.author.data + vote.signature.data + vote.hash.data

    def _record_bad(self, round_: Round, key: bytes) -> None:
        self._bad_sigs.setdefault(round_, set()).add(key)

    async def handle_timeout(self, timeout: Timeout) -> None:
        log.debug("Processing %r", timeout)
        self._m_timeouts_rx.inc()
        if timeout.round < self.round:
            return
        if timeout.round > self.round + self.MAX_ROUND_LOOKAHEAD:
            # Same state-allocation bound as votes: otherwise one
            # byzantine member seats a TCMaker (and pays us a full
            # verification) per arbitrary future round.
            log.warning(
                "dropping timeout %d rounds ahead", timeout.round - self.round
            )
            return
        maker = self.aggregator.timeouts_aggregators.get(timeout.round)
        if maker is not None and timeout.author in maker.used:
            # Duplicate seat: timers retransmit timeouts every
            # timeout_delay, so during a long view change each node
            # receives each peer's timeout many times. Drop BEFORE the
            # signature verification — the post-verify AuthorityReuse
            # rejection priced every retransmission at a full high_qc
            # batch verify, which is exactly the load that stalls
            # committee-scale view changes. An equivocating second
            # timeout from the same author was rejected for reuse
            # anyway — EXCEPT that the old path first adopted its
            # high_qc; keep that convergence channel by letting a
            # retransmission carrying a NEWER high_qc through to the
            # verified path.
            if timeout.high_qc.round <= self.high_qc.round:
                return
        hq = timeout.high_qc
        n_sigs = 1 + (
            0 if hq == QC.genesis() else self._effective_sigs(hq, hq.n_votes())
        )
        await verify_off_loop(
            timeout.verify, self.committee, self._cert_cache, n_sigs=n_sigs
        )
        await self.process_qc(timeout.high_qc)
        tc = self.aggregator.add_timeout(timeout)
        if tc is not None:
            log.debug("Assembled %r", tc)
            self._m_tcs.inc()
            await self.advance_round(tc.round, via_tc=True)
            addresses = [a for _, a in self.committee.broadcast_addresses(self.name)]
            self.network.broadcast(addresses, encode_tc(tc, self._wire_seats))
            if self.name == self.leader_elector.get_leader(self.round):
                await self.generate_proposal(tc)
        elif timeout.round > self.round:
            await self._maybe_amplify_timeout(timeout.round)

    async def _maybe_amplify_timeout(self, round_: Round) -> None:
        """Timeout amplification (the DiemBFT/Jolteon timeout-sync rule):
        once f+1 DISTINCT authorities are seen timing out at a round
        ahead of ours, join that view change by issuing our own timeout
        for it — f+1 guarantees at least one honest node timed out there.

        Why this is load-bearing (found by faultline chaos seed 11): the
        TC is broadcast exactly once, best-effort. If that broadcast is
        lost to a partition/lossy window, the committee splits across two
        adjacent rounds — e.g. two nodes at r (their timeouts sign round
        r) and two at r+1 (their timeouts sign r+1) — and NO round can
        ever accumulate 2f+1 same-round timeouts again: a permanent
        liveness wedge the timers cannot heal, observed as a total
        post-heal commit stall. Amplification re-synchronizes the laggards
        onto the newer round's view change, so the TC forms and the
        committee converges within one timeout period."""
        if round_ in self._amplified:
            return
        maker = self.aggregator.timeouts_aggregators.get(round_)
        if maker is None:
            return
        weight = sum(self.committee.stake(a) for a in maker.used)
        if weight < self.committee.validity_threshold():
            return
        self._amplified.add(round_)
        log.warning(
            "amplifying timeout to round %d (f+1 peers are there)", round_
        )
        telemetry.counter("consensus.timeouts_amplified").inc()
        self.increase_last_voted_round(round_)
        await self._persist_state()
        timeout = await Timeout.new(
            self.high_qc, round_, self.name, self.signature_service
        )
        self.timer.reset()
        addresses = [a for _, a in self.committee.broadcast_addresses(self.name)]
        self.network.broadcast(
            addresses, encode_timeout(timeout, self._wire_seats)
        )
        await self.handle_timeout(timeout)

    async def advance_round(self, round_: Round, via_tc: bool = False) -> None:
        if round_ < self.round:
            return
        self.timer.reset()
        self.round = round_ + 1
        # Entry-cause feed: a TC-entered round elects by round-robin in
        # the reputation elector (the timeout-grind escape hatch — see
        # leader.ReputationLeaderElector.note_round_entry). No-op for
        # round-robin.
        self.leader_elector.note_round_entry(self.round, via_tc)
        self._m_rounds.inc()
        self._g_round.set(self.round)
        if self._on_round_advance is not None:
            self._on_round_advance(self.round)
        log.debug("Moved to round %d", self.round)
        self.aggregator.cleanup(self.round)
        self._bad_sigs = {r: s for r, s in self._bad_sigs.items() if r >= self.round}
        self._verified_seats = {
            r: s for r, s in self._verified_seats.items() if r >= self.round
        }
        self._amplified = {r for r in self._amplified if r >= self.round}

    async def generate_proposal(self, tc: TC | None) -> None:
        await self.tx_proposer.put(ProposerMake(self.round, self.high_qc, tc))

    async def cleanup_proposer(self, b0: Block, b1: Block, block: Block) -> None:
        digests = [*b0.payload, *b1.payload, *block.payload]
        await self.tx_proposer.put(ProposerCleanup(digests))

    async def process_qc(self, qc: QC) -> None:
        await self.advance_round(qc.round)
        self.update_high_qc(qc)

    async def process_block(self, block: Block) -> None:
        log.debug("Processing %r", block)
        if self._trace is not None:
            # Loopback (our own proposal) reaches here without
            # handle_proposal; first mark wins, so the double call on the
            # network path is harmless.
            self._trace.mark_propose(block.round)
        # We need the two ancestors b0 <- |qc0; b1| <- |qc1; block|; if any is
        # missing the synchronizer fetches them and re-injects this block.
        ancestors = await self.synchronizer.get_ancestors(block)
        if ancestors is None:
            log.debug("Processing of %r suspended: missing parent", block.digest())
            return
        b0, b1 = ancestors

        # Store only blocks whose full ancestry we have processed.
        await self.store_block(block)
        await self.cleanup_proposer(b0, b1, block)

        # 2-chain commit rule.
        if b0.round + 1 == b1.round:
            await self.mempool_driver.cleanup(b0.round)
            await self.commit(b0)

        # Round guard: prevents bad leaders from dragging us far into the
        # future (reference ``core.rs:345-349``).
        if block.round != self.round:
            return

        # Leadership gate on the VOTE (the round-robin elector already
        # rejected mismatches in handle_proposal; a lenient elector
        # processes certificates above but never endorses an author its
        # window says is not the leader).
        if block.author != self.leader_elector.get_leader(block.round):
            log.debug(
                "Withholding vote for %r: author is not our expected leader",
                block,
            )
            return

        vote = await self.make_vote(block)
        if vote is not None:
            log.debug("Created %r", vote)
            if self._trace is not None:
                self._trace.mark_vote_send(block.round)
            next_leader = self.leader_elector.get_leader(self.round + 1)
            if next_leader == self.name:
                await self.handle_vote(vote)
            else:
                address = self.committee.address(next_leader)
                assert address is not None, "next leader not in committee"
                self.network.send(address, encode_vote(vote))

    async def handle_proposal(self, block: Block) -> None:
        digest = block.digest()
        self._m_proposals.inc()
        if self._trace is not None:
            self._trace.mark_propose(
                block.round,
                self._peer_label(block.author) + "|" + repr(digest),
            )
        # Redelivery short-circuit: helpers answer sync requests with
        # ancestor CHAINS, so bursts can re-include blocks already fully
        # processed (stored => verified, certificates applied, ancestry
        # complete) or already SUSPENDED awaiting their parents.
        # Re-verifying either is pure waste — at catch-up rates it was
        # most of a straggler's CPU.
        if await self.store.read(digest.data) is not None:
            return
        if self.synchronizer.is_pending(digest):
            return
        author_mismatch = block.author != self.leader_elector.get_leader(
            block.round
        )
        if author_mismatch:
            # Strict electors (round-robin) reject outright — all honest
            # nodes share the same (stateless) leader function, so a
            # mismatch is always a bad proposal. A LENIENT elector's
            # leader opinion derives from the local committed window and
            # can transiently diverge between honest nodes: still verify
            # and process the certificates (QCs advance rounds and
            # high_qc, healing the divergence) but store/vote only under
            # the solicited-block rule below.
            if not self.leader_elector.lenient:
                raise WrongLeader(
                    f"block {digest} from {block.author} at round {block.round}"
                )
        n_sigs = 1
        if block.qc != QC.genesis():
            n_sigs += self._effective_sigs(block.qc, block.qc.n_votes())
        if block.tc is not None:
            n_sigs += self._effective_sigs(block.tc, block.tc.n_votes())
        await verify_off_loop(
            block.verify, self.committee, self._cert_cache, n_sigs=n_sigs
        )
        if self._trace is not None:
            # receive→verified is the crypto-plane edge of the cross-node
            # timeline; the assembler attributes it separately from the
            # decode/queue edge (propose_send→propose) and the vote edge
            # (verified→vote_send).
            self._trace.mark_verified(block.round)
        await self.process_qc(block.qc)
        if block.tc is not None:
            await self.advance_round(block.tc.round, via_tc=True)
        if (
            # Recomputed (not the early ``author_mismatch``): processing
            # the block's TC above may have marked its round TC-entered,
            # flipping a lenient elector to the round-robin fallback —
            # the gate must judge the proposal against that same
            # (post-certificate) leader opinion.
            block.author != self.leader_elector.get_leader(block.round)
            and self.leader_elector.gate_active(block.round)
            and not self.synchronizer.requested(digest)
        ):
            # Lenient mode, unsolicited mismatched author: certificates
            # were applied above, but the block itself is NOT processed
            # or stored. Solicited blocks (our own sync requests) are
            # certified-chain ancestors and flow through — that is the
            # divergence-healing path — while a byzantine member's
            # fabricated blocks (valid signature, reused QC) can never
            # grow the store. The gate lifts while the elector's window
            # is EMPTY (boot/restart): such a node elects round-robin,
            # disagrees with running peers by construction, and must
            # commit their proposals to rebuild its window.
            log.debug(
                "Skipping unsolicited block %s from unexpected author %s",
                digest,
                block.author,
            )
            return
        if not await self.mempool_driver.verify(block):
            log.debug("Processing of %r suspended: missing payload", digest)
            return
        await self.process_block(block)

    # -- state sync (thin delegates: the protocol driver lives in
    # consensus/statesync.py; events reach it through the merged queue) ----

    async def handle_state_request(self, payload) -> None:
        if self._statesync is not None:
            await self._statesync.handle_state_request(payload)

    async def handle_state_response(self, payload) -> None:
        if self._statesync is not None:
            await self._statesync.handle_state_response(payload)

    async def handle_statesync_tick(self, payload) -> None:
        if self._statesync is not None:
            await self._statesync.handle_tick(payload)

    async def handle_tc(self, tc: TC) -> None:
        # Round check BEFORE the 2f+1-signature verification: every node
        # that forms the TC broadcasts it, so all but the first arrival
        # are stale by the time they dequeue — discarding them unverified
        # removes most of a view change's redundant crypto. (A stale TC
        # is never used, so skipping its verification changes nothing.)
        if tc.round < self.round:
            return
        await verify_off_loop(
            tc.verify,
            self.committee,
            self._cert_cache,
            n_sigs=self._effective_sigs(tc, tc.n_votes()),
        )
        if tc.round < self.round:
            return
        await self.advance_round(tc.round, via_tc=True)
        if self.name == self.leader_elector.get_leader(self.round):
            await self.generate_proposal(tc)

    # -- main loop ----------------------------------------------------------

    # Tagged-event dispatch table (kind -> handler method name): the
    # sans-io seam. run() binds it for the asyncio loop below; a driver
    # without a loop binds the SAME table, so both dispatch identical
    # events to identical handlers.
    HANDLERS = {
        "propose": "handle_proposal",
        "vote": "handle_vote",
        "votes": "handle_vote_batch",  # native pre-stage batches
        "timeout": "handle_timeout",
        "tc": "handle_tc",
        "qc_retry": "_handle_qc_retry",  # internal loopback
        "loopback": "process_block",
        "state_request": "handle_state_request",
        "state_response": "handle_state_response",
        "statesync_tick": "handle_statesync_tick",  # internal loopback
    }

    # Sampling-profiler stage seeds: each dequeued event opens under the
    # trace edge its handler starts in; the RoundTrace marks then refine
    # the tag as the handler crosses edge boundaries (e.g. a "propose"
    # event opens as ingress work — dedup lookups, leader checks — until
    # mark_propose flips it to verify).
    STAGE_SEEDS = {
        "propose": "ingress",
        "vote": "fanin",
        "votes": "fanin",
        "timeout": "view_change",
        "tc": "view_change",
        "qc_retry": "verify",
        "loopback": "vote",
        "state_request": "ingress",
        "state_response": "ingress",
        "statesync_tick": "ingress",
    }

    def bound_handlers(self) -> dict:
        return {kind: getattr(self, name) for kind, name in self.HANDLERS.items()}

    async def _timer_pump(self) -> None:
        """Forward timer expiries into the merged event queue. Handshakes
        with the run loop (``_timer_handled``) so an expired-but-unhandled
        timer is queued exactly once."""
        while True:
            await self.timer.wait()
            self._timer_handled.clear()
            # Tag the expiry with the round it fired in: under backlog the
            # event can be dequeued long after the round advanced (and
            # advancing reset the timer), and acting on it then would call
            # increase_last_voted_round for the NEW round — suppressing
            # this node's vote there for no reason.
            await self.rx_message.put(("timer", self.round))
            await self._timer_handled.wait()

    async def run(self) -> None:
        await self._restore_state()
        if self._statesync is not None:
            # Restore the truncation floor from our own snapshot record
            # and arm the anti-entropy probe loop (dormant while commits
            # flow).
            await self._statesync.start(self)
        self.timer.reset()
        if self.name == self.leader_elector.get_leader(self.round):
            await self.generate_proposal(None)

        # ONE merged event queue: network messages, loopback blocks, and
        # timer expiries all arrive as tagged items on ``rx_message`` (the
        # spawn wiring passes the same queue object for both channels), so
        # each event costs a single ``Queue.get`` instead of the
        # select-style three-task ``asyncio.wait`` — the old loop's task
        # churn (3 done-callback registrations + a create_task per event)
        # was a measurable slice of single-core round latency.
        handlers = self.bound_handlers()
        # One module attribute read per event when no profiler session is
        # live (see STAGE_SEEDS).
        stage_seeds = self.STAGE_SEEDS
        self._timer_handled = asyncio.Event()
        timer_task = asyncio.create_task(self._timer_pump(), name="consensus_timer")
        if self._on_round_advance is not None:
            # Seed the pre-stage cutoff with the (possibly restored) round.
            self._on_round_advance(self.round)
        profile = self._profile
        if profile:
            import time as _time

            # Stage counters live in the process telemetry registry:
            # ``consensus.stage.<kind>.{ns,calls}`` — an in-process
            # committee's engines all add into the same counters, giving
            # the whole committee's per-round handler bill in one place
            # (benchmarks diff registry snapshots around their window).
            registry = telemetry.get_registry()
            stage_counters: dict[str, tuple] = {}
        try:
            while True:
                kind, payload = await self.rx_message.get()
                if kind == "timer":
                    # Stale expiry (the round advanced while the event sat
                    # in the queue): drop it — the reset timer covers the
                    # current round.
                    if payload == self.round:
                        await self._guarded(self.local_timeout_round())
                    self._timer_handled.set()
                    continue
                handler = handlers.get(kind)
                if pyprof.TAGGING:
                    pyprof.set_thread_stage(stage_seeds.get(kind, "other"))
                if handler is None:
                    log.error("unexpected protocol message kind %s", kind)
                elif not profile:
                    await self._guarded(handler(payload))
                else:
                    pair = stage_counters.get(kind)
                    if pair is None:
                        pair = stage_counters[kind] = (
                            registry.counter(f"consensus.stage.{kind}.ns"),
                            registry.counter(f"consensus.stage.{kind}.calls"),
                        )
                    t0 = _time.perf_counter_ns()
                    await self._guarded(handler(payload))
                    pair[0].inc(_time.perf_counter_ns() - t0)
                    pair[1].inc()
                if pyprof.TAGGING:
                    # Back to the queue wait: samples here are event-loop
                    # idle/dispatch cost, not the last handler's edge.
                    pyprof.set_thread_stage("idle")
        finally:
            timer_task.cancel()

    async def _guarded(self, coro) -> None:
        """Protocol errors (byzantine input) are logged, never fatal —
        as are store/serialization errors from locally-stored data, which
        the reference run loop likewise logs and survives (reference
        ``core.rs:434-440``: SerializationError/StoreError arms).
        Invariant violations (AssertionError) stay FATAL — safer to halt
        than run on corrupt state — but die loudly via the task
        done-callback, never silently."""
        try:
            await coro
        except ConsensusError as e:
            log.warning("%s: %s", type(e).__name__, e)
        except BackendUnavailable as e:
            # Transient infrastructure failure: the message was not judged;
            # peers will resend. Nothing is cached as byzantine.
            log.error("crypto backend unavailable: %s", e)
            self.backend_failures += 1
        except (SerdeError, StoreError) as e:
            log.error("consensus handler error: %s: %s", type(e).__name__, e)
