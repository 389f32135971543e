"""Consensus helper: serve peers' ``SyncRequest``s — read the block from the
store and reply with a full ``Propose`` message so it flows the requester's
normal proposal path (reference ``consensus/src/helper.rs:26-68``).

Port copy of ``hotstuff_tpu/consensus/helper.py``, whole."""

from __future__ import annotations

import asyncio
import logging
import time

from hotstuff_tpu_torch.network import SimpleSender
from hotstuff_tpu_torch.store import Store
from hotstuff_tpu_torch.utils.tasks import log_task_death

from .config import Committee
from .messages import Block, encode_propose, encode_state_response
from .statesync import SNAPSHOT_KEY, SnapshotError, peek_frontier

log = logging.getLogger("consensus")


#: How many blocks a single SyncRequest reply may carry (the requested
#: block + ancestors, NEWEST first — see the send loop for why). A
#: straggler that missed a RANGE of blocks would otherwise walk backward
#: one block per round trip (request parent -> reply -> discover
#: grandparent missing -> request ...) — slower than a fast committee
#: extends the chain, i.e. it never catches up. With chain replies each
#: delivered ancestor suspends-and-requests the next synchronously, and
#: once the deepest lands on stored ground the notify_read unwind
#: re-delivers the whole suspended range: ~CHAIN_DEPTH rounds heal per
#: RTT. Sized as a compromise: the common request is ONE lost block (the
#: extra ancestors are redundant wire traffic, discarded by the
#: requester's redelivery short-circuit), while a deep catch-up iterates
#: frontier requests at one chain per RTT.
CHAIN_DEPTH = 16


class Helper:
    @classmethod
    def spawn(
        cls,
        committee: Committee,
        store: Store,
        rx_request: asyncio.Queue,
        sync_retry_delay: int = 5_000,
    ) -> asyncio.Task:
        network = SimpleSender()
        # Snapshot replies are heavy (two blocks + a 2f+1-signature QC)
        # and the request's origin field is unsigned and spoofable: an
        # attacker spraying unknown digests with a victim's origin would
        # otherwise have every helper amplify traffic at the victim. One
        # snapshot reply per origin per half retry window caps the
        # amplification at a trickle while never throttling an honest
        # straggler (its synchronizer re-asks at sync_retry cadence). The
        # map is bounded by committee size (unknown origins are rejected).
        snap_interval_s = sync_retry_delay / 2_000.0
        snap_last_sent: dict = {}

        async def run():
            while True:
                digest, origin = await rx_request.get()
                try:
                    address = committee.address(origin)
                    if address is None:
                        log.warning(
                            "received sync request from unknown node %s", origin
                        )
                        continue
                    data = await store.read(digest.data)
                    if data is not None:
                        block = Block.deserialize(data)
                        # Send the requested block plus up to
                        # CHAIN_DEPTH-1 ancestors, NEWEST FIRST: when
                        # the requester processes the requested block it
                        # suspends on the (missing) parent and registers
                        # a sync request for it synchronously — before
                        # the next reply frame is dequeued — so each
                        # successive ancestor arrives already solicited
                        # (the lenient leader path stores solicited
                        # blocks only). The deepest delivered ancestor
                        # lands on stored ground and the notify_read
                        # unwind then re-delivers the whole suspended
                        # range in order.
                        network.send(address, encode_propose(block))
                        cur = block
                        sent = 1
                        while sent < CHAIN_DEPTH:
                            pdata = await store.read(cur.parent().data)
                            if pdata is None:
                                break
                            cur = Block.deserialize(pdata)
                            network.send(address, encode_propose(cur))
                            sent += 1
                    else:
                        # Unservable digest — most likely truncated below
                        # our snapshot horizon. Answer with the snapshot
                        # record (frontier + 2-chain commit proof) so a
                        # cold joiner establishes a verified floor instead
                        # of re-requesting an unservable block forever.
                        # Rate-limited per origin (and checked BEFORE the
                        # meta read) so forged requests cost the server
                        # and the accused origin almost nothing.
                        now = time.monotonic()
                        last = snap_last_sent.get(origin)
                        if last is not None and now - last < snap_interval_s:
                            continue
                        snap = await store.read_meta(SNAPSHOT_KEY)
                        if snap is not None:
                            try:
                                round_, frontier = peek_frontier(snap)
                            except SnapshotError as e:
                                log.error("corrupt snapshot record: %s", e)
                            else:
                                snap_last_sent[origin] = now
                                network.send(
                                    address,
                                    encode_state_response(
                                        round_, frontier, snap
                                    ),
                                )
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    # One corrupt stored block (or store error) must not
                    # permanently kill the helper for all future requests.
                    log.error(
                        "failed to serve sync request for %s: %s", digest, e
                    )

        task = asyncio.create_task(run(), name="consensus_helper")
        task.add_done_callback(log_task_death)
        # Its sender's connections close with the task (the reference's
        # stay open).
        task.add_done_callback(lambda _: network.shutdown())
        return task
