"""Shared stake-weighted ACK-quorum waiting.

Port copy of ``hotstuff_tpu/utils/quorum.py``, whole.

Both back-pressure points — the mempool QuorumWaiter (batch dissemination,
reference ``mempool/src/quorum_waiter.rs:80-102``) and the consensus
Proposer (block dissemination, reference ``consensus/src/proposer.rs:105-121``)
— wait until ReliableSender ACK handlers representing 2f+1 stake resolve.
"""

from __future__ import annotations

import asyncio


async def _waiter(handler: asyncio.Future, stake: int) -> int:
    """Resolve to the handler's stake once ACKed; 0 if cancelled."""
    try:
        await handler
        return stake
    except asyncio.CancelledError:
        return 0


async def wait_for_ack_quorum(
    handlers: list[tuple[object, asyncio.Future]],
    stake_of,
    own_stake: int,
    threshold: int,
) -> tuple[bool, dict[asyncio.Task, asyncio.Future]]:
    """Wait until ACKed stake (plus ``own_stake``) reaches ``threshold``.

    ``handlers``: (name, CancelHandler) pairs; ``stake_of(name)`` -> stake.
    Returns (reached, remaining) where ``remaining`` maps still-pending
    waiter tasks to their underlying handler futures — the caller decides
    whether to cancel them or grant extra dissemination time.
    """
    waiters = {
        asyncio.ensure_future(_waiter(h, stake_of(name))): h for name, h in handlers
    }
    total = own_stake
    pending = set(waiters)
    while total < threshold and pending:
        done, pending = await asyncio.wait(
            pending, return_when=asyncio.FIRST_COMPLETED
        )
        for t in done:
            total += t.result()
    return total >= threshold, {t: waiters[t] for t in pending}


def cancel_remaining(remaining: dict[asyncio.Task, asyncio.Future]) -> None:
    """Cancel both the waiter tasks and their handlers (stops the
    ReliableSender replaying those messages)."""
    for task, handler in remaining.items():
        handler.cancel()
        task.cancel()
