"""Block proposer (reference ``consensus/src/proposer.rs``).

Port copy of ``hotstuff_tpu/consensus/proposer.py``, with its telemetry
(the proposer gauges, ``record_created``, the ``proposed`` dtrace event and
the ``propose_send`` trace anchor).

Owns the payload buffer fed by mempool digests. On ``Make(round, qc, tc)``
builds and signs a block draining the buffer, reliable-broadcasts it, loops
it back to the Core, then blocks until 2f+1 stake has ACKed — the leader's
back-pressure control system (``proposer.rs:105-121``).
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass

from hotstuff_tpu_torch import telemetry
from hotstuff_tpu_torch.crypto import Digest, PublicKey, SignatureService
from hotstuff_tpu_torch.network import ReliableSender
from hotstuff_tpu_torch.utils.quorum import cancel_remaining, wait_for_ack_quorum

from .config import Committee, Round
from .messages import Block, QC, TC, encode_propose

log = logging.getLogger("consensus")


@dataclass
class Make:
    round: Round
    qc: QC
    tc: TC | None


@dataclass
class Cleanup:
    digests: list[Digest]


class Proposer:
    def __init__(
        self,
        name: PublicKey,
        committee: Committee,
        signature_service: SignatureService,
        rx_mempool: asyncio.Queue,
        rx_message: asyncio.Queue,
        tx_loopback: asyncio.Queue,
        benchmark: bool = False,
        wire_seats=None,
    ) -> None:
        self.name = name
        self.committee = committee
        self.signature_service = signature_service
        self.rx_mempool = rx_mempool
        self.rx_message = rx_message
        self.tx_loopback = tx_loopback
        self.benchmark = benchmark
        # Wire-format v2 seat table for outgoing proposals (None = v1).
        self.wire_seats = wire_seats
        self.buffer: set[Digest] = set()
        self.network = ReliableSender()

    @classmethod
    def spawn(cls, *args, **kwargs) -> asyncio.Task:
        self = cls(*args, **kwargs)
        task = asyncio.create_task(self._run(), name="proposer")
        # Its sender's connections outlive the task unless closed with it:
        # they would go on retransmitting to peers that have moved on.
        task.add_done_callback(lambda _: self.network.shutdown())
        return task

    async def _run(self) -> None:
        get_digest = asyncio.create_task(self.rx_mempool.get())
        get_message = asyncio.create_task(self.rx_message.get())
        while True:
            done, _ = await asyncio.wait(
                {get_digest, get_message}, return_when=asyncio.FIRST_COMPLETED
            )
            if get_digest in done:
                self.buffer.add(get_digest.result())
                # Greedy drain: on a CPU-saturated loop this task is
                # scheduled far less often than digests arrive (ingest
                # tasks are always runnable), and one-digest-per-turn
                # let the queue backlog while proposals went out nearly
                # empty — ordering starving behind ingest inside the
                # event loop, the exact inversion the data plane exists
                # to prevent. Take everything ready.
                while True:
                    try:
                        self.buffer.add(self.rx_mempool.get_nowait())
                    except asyncio.QueueEmpty:
                        break
                get_digest = asyncio.create_task(self.rx_mempool.get())
            if get_message in done:
                message = get_message.result()
                get_message = asyncio.create_task(self.rx_message.get())
                if isinstance(message, Make):
                    await self._make_block(message.round, message.qc, message.tc)
                elif isinstance(message, Cleanup):
                    for d in message.digests:
                        self.buffer.discard(d)

    async def _make_block(self, round_: Round, qc: QC, tc: TC | None) -> None:
        payload = list(self.buffer)
        self.buffer.clear()
        if telemetry.enabled():
            # How much certified work each proposal drains, and how much
            # is still queued upstream — the first diagnostic when
            # ingest outruns ordering.
            telemetry.gauge("consensus.proposer.payload_drained").set(
                len(payload)
            )
            telemetry.gauge("consensus.proposer.digest_queue_depth").set(
                self.rx_mempool.qsize()
            )
        block = await Block.new(
            qc, tc, self.name, round_, payload, self.signature_service
        )
        if block.payload:
            log.info("Created %s", block)
            for d in block.payload:
                # Telemetry mirror of the "Created B -> d" measurement
                # contract (no-op unless telemetry is enabled).
                telemetry.record_created(d.data)
            if telemetry.dtrace_enabled():
                # Lifeline join point: each payload digest leaves the
                # queue-wait edge here, and the ``r<round>`` detail keys
                # the batch timeline onto the round trace's ordering
                # breakdown for this round.
                name_label = repr(self.name)
                for d in block.payload:
                    telemetry.dtrace_event(
                        name_label,
                        telemetry.intern_label(d.data),
                        "proposed",
                        detail=f"r{round_}",
                    )
            if self.benchmark:
                for d in block.payload:
                    # NOTE: benchmark measurement interface (reference
                    # ``proposer.rs:76-80``).
                    log.info("Created %s -> %s", block, d)
        log.debug("Broadcasting %r", block)
        # Cross-node trace anchor: the leader's broadcast instant is t=0
        # of the round's causal timeline (the propose_send→propose edge
        # at each replica is wire + receiver decode + core queue wait).
        # The detail names the author + block digest so stream analyzers
        # can attribute the round's proposal and spot conflicting blocks
        # (one extra digest hash per broadcast, leader-side only — and
        # only when telemetry is enabled).
        telemetry.trace_event(
            repr(self.name),
            round_,
            "propose_send",
            detail=(
                f"{self.name!r}|{block.digest()!r}"
                if telemetry.enabled()
                else None
            ),
        )
        serialized = encode_propose(block, self.wire_seats)
        names_addresses = self.committee.broadcast_addresses(self.name)
        handlers = [
            (name, await self.network.send(addr, serialized))
            for name, addr in names_addresses
        ]
        await self.tx_loopback.put(("loopback", block))

        # Control system: wait for 2f+1 stake to ACK before proposing again.
        _, remaining = await wait_for_ack_quorum(
            handlers,
            self.committee.stake,
            self.committee.stake(self.name),
            self.committee.quorum_threshold(),
        )
        # The reference drops the remaining handlers here, cancelling their
        # retransmission — slow nodes catch up via the synchronizer instead.
        cancel_remaining(remaining)
