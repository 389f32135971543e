"""Consensus root: wires the consensus actors and the network receiver
(reference ``consensus/src/consensus.rs:45-162``).

Port copy of ``hotstuff_tpu/consensus/consensus.py``. Routing:
``SyncRequest`` -> Helper; ``Propose`` is ACKed then sent to the Core;
``Vote``/``Timeout``/``TC`` and the state-sync frames go straight to the
Core. Every engine runs a ``StateSync``, and a ``Compactor`` when
``retention_rounds > 0``. Left out: the native transport's vote pre-stage,
and the profiler and per-stage telemetry hooks.
"""

from __future__ import annotations

import asyncio
import logging
import os

from hotstuff_tpu_torch.crypto import PublicKey, SignatureService
from hotstuff_tpu_torch.network import MessageHandler, Receiver
from hotstuff_tpu_torch.store import Store
from hotstuff_tpu_torch.utils.serde import SerdeError

from .config import Committee, Parameters
from .core import Core
from .decode_arena import decode_shared
from .errors import MalformedMessage
from .helper import Helper
from .leader import make_elector
from .mempool_driver import MempoolDriver
from .messages import SeatTable
from .proposer import Proposer
from .statesync import Compactor, StateSync
from .synchronizer import Synchronizer

log = logging.getLogger("consensus")

CHANNEL_CAPACITY = 1_000


class ConsensusReceiverHandler(MessageHandler):
    def __init__(
        self,
        tx_consensus: asyncio.Queue,
        tx_helper: asyncio.Queue,
        seats: SeatTable | None = None,
    ) -> None:
        self.tx_consensus = tx_consensus
        self.tx_helper = tx_helper
        # Seat table for wire-format v2 certificate sections. Decoding
        # accepts BOTH formats whenever the table is known — acceptance is
        # not what the wire_v2 parameter gates (that only selects what we
        # emit), so a mixed v1/v2 committee interoperates.
        self.seats = seats

    async def dispatch(self, writer, serialized: bytes) -> None:
        try:
            # Shared decode arena: a broadcast frame fanned to N in-process
            # engines parses once process-wide; every other arrival is a
            # content-addressed hit handing back the same decoded view.
            kind, payload = decode_shared(serialized, self.seats)
        except (SerdeError, MalformedMessage, ValueError) as e:
            log.warning("failed to decode consensus message: %s", e)
            return
        if kind == "sync_request":
            await self.tx_helper.put(payload)
        elif kind == "propose":
            # ACK proposals — the leader's back-pressure signal (reference
            # ``consensus.rs:144-153``).
            await writer.send(b"Ack")
            await self.tx_consensus.put((kind, payload))
        else:
            await self.tx_consensus.put((kind, payload))


class Consensus:
    def __init__(self) -> None:
        self.tasks: list[asyncio.Task] = []
        self.receivers: list[Receiver] = []
        self.synchronizer: Synchronizer | None = None
        self.mempool_driver: MempoolDriver | None = None
        # The engine's protocol state machine (its counters are read by
        # harnesses; the reference keeps it local to ``spawn``).
        self.core: Core | None = None
        self.compactor: Compactor | None = None

    @classmethod
    async def spawn(
        cls,
        name: PublicKey,
        committee: Committee,
        parameters: Parameters,
        signature_service: SignatureService,
        store: Store,
        rx_mempool: asyncio.Queue,  # batch digests from mempool
        tx_mempool: asyncio.Queue,  # Synchronize/Cleanup to mempool
        tx_commit: asyncio.Queue,  # committed blocks out
        benchmark: bool = False,
    ) -> "Consensus":
        self = cls()
        parameters.log()

        tx_consensus: asyncio.Queue = asyncio.Queue(CHANNEL_CAPACITY)
        # Loopback blocks ride the SAME merged queue as network messages
        # (tagged ("loopback", block)) — the core consumes one queue.
        tx_loopback: asyncio.Queue = tx_consensus
        tx_proposer: asyncio.Queue = asyncio.Queue(CHANNEL_CAPACITY)
        tx_helper: asyncio.Queue = asyncio.Queue(CHANNEL_CAPACITY)

        seats = SeatTable.for_committee(committee)
        # wire_v2 selects what WE emit; decode always accepts both (the
        # seat table above), so flipping this per node cannot split a
        # committee.
        wire_seats = (
            seats
            if parameters.wire_v2 and os.environ.get("HOTSTUFF_WIRE_V2", "1") != "0"
            else None
        )

        address = committee.address(name)
        assert address is not None, "our public key is not in the committee"
        # auto_ack: the transport ACKs on frame arrival — the leader's
        # back-pressure signal means "received". Non-proposal messages
        # arrive via SimpleSender, which discards replies, so the extra ACK
        # frames are harmless.
        receiver = await Receiver.spawn(
            ("0.0.0.0", address[1]),
            ConsensusReceiverHandler(tx_consensus, tx_helper, seats),
            auto_ack=True,
        )
        self.receivers.append(receiver)
        log.info("Node %s listening to consensus messages on %s", name, address)

        leader_elector = make_elector(committee, parameters.leader_elector)
        self.mempool_driver = MempoolDriver(store, tx_mempool, tx_loopback)
        self.synchronizer = Synchronizer(
            name, committee, store, tx_loopback, parameters.sync_retry_delay
        )
        # Replica lifecycle: every node answers state probes and runs the
        # (dormant while healthy) anti-entropy tick; the compactor arms
        # only when a retention depth is configured.
        statesync = StateSync(name, committee, parameters.sync_retry_delay)
        self.compactor = (
            Compactor(store, parameters.retention_rounds)
            if parameters.retention_rounds > 0
            else None
        )
        self.core = Core(
            name,
            committee,
            signature_service,
            store,
            leader_elector,
            self.mempool_driver,
            self.synchronizer,
            parameters.timeout_delay,
            tx_consensus,
            tx_loopback,
            tx_proposer,
            tx_commit,
            benchmark=benchmark,
            persist_sync=parameters.persist_sync,
            batch_vote_verification=parameters.batch_vote_verification,
            wire_seats=wire_seats,
            statesync=statesync,
            compactor=self.compactor,
        )
        self.tasks.append(self.core.start())
        self.tasks.append(
            Proposer.spawn(
                name,
                committee,
                signature_service,
                rx_mempool,
                tx_proposer,
                tx_loopback,
                benchmark=benchmark,
                wire_seats=wire_seats,
            )
        )
        self.tasks.append(Helper.spawn(committee, store, tx_helper, parameters.sync_retry_delay))
        return self

    def crash(self) -> None:
        """Stop the engine the unclean way, as a process crash would: cancel
        the actor tasks and abort the listeners, with no drain. The store
        stays open, and a background log rewrite runs on to its end."""
        for t in self.tasks:
            t.cancel()
        self.synchronizer.shutdown()
        self.mempool_driver.shutdown()
        for r in self.receivers:
            r.abort()

    async def shutdown(self) -> None:
        # Let an in-flight background log rewrite finish before the store
        # is closed underneath its executor thread.
        if self.compactor is not None:
            await self.compactor.drain()
        for t in self.tasks:
            t.cancel()
        if self.synchronizer is not None:
            self.synchronizer.shutdown()
        if self.mempool_driver is not None:
            self.mempool_driver.shutdown()
        for r in self.receivers:
            await r.shutdown()
