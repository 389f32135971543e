"""Consensus configuration (port of ``hotstuff_tpu/consensus/config.py``,
whole; reference ``consensus/src/config.rs``).

One consensus address per node; stake-weighted quorums of 2f+1.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

from hotstuff_tpu_torch.crypto import PublicKey

log = logging.getLogger("consensus")

Stake = int
Round = int


@dataclass
class Parameters:
    """Defaults match the reference (``consensus/src/config.rs:16-23``)."""

    timeout_delay: int = 5_000  # ms
    sync_retry_delay: int = 10_000  # ms
    # fsync the persisted voting state on every update: survives power
    # loss, at ~ms extra latency per vote. Off by default (process-crash
    # safety only).
    persist_sync: bool = False
    # Committee-scale vote handling: accumulate unverified votes and
    # batch-verify the assembled QC's 2f+1 signatures in one crypto call
    # (byzantine signatures are identified and ejected on failure). Pairs
    # with the CUDA backend; worthwhile from ~100 validators.
    batch_vote_verification: bool = False
    # "round-robin" (reference behavior) or "reputation" (active-set
    # election from the committed window, see consensus/leader.py).
    leader_elector: str = "round-robin"
    # Wire-format v2: certificates ship as a seat bitmap + concatenated
    # signatures. Decoders ALWAYS accept both formats; this flag only
    # selects what this node emits. HOTSTUFF_WIRE_V2=0 force-disables.
    wire_v2: bool = True
    # Snapshot/truncate retention depth in committed rounds. 0 disables
    # compaction; the port's ``Consensus.spawn`` accepts only 0 until state
    # sync is ported.
    retention_rounds: int = 0

    def log(self) -> None:
        # Picked up by the benchmark log parser (reference ``config.rs:25-31``).
        log.info("Timeout delay set to %d ms", self.timeout_delay)
        log.info("Sync retry delay set to %d ms", self.sync_retry_delay)
        if self.retention_rounds > 0:
            log.info("Store retention set to %d rounds", self.retention_rounds)


@dataclass
class Authority:
    stake: Stake
    address: tuple[str, int]


@dataclass
class Committee:
    authorities: dict[PublicKey, Authority]
    epoch: int = 1

    def size(self) -> int:
        return len(self.authorities)

    def stake(self, name: PublicKey) -> Stake:
        a = self.authorities.get(name)
        return a.stake if a else 0

    def total_stake(self) -> Stake:
        return sum(a.stake for a in self.authorities.values())

    def quorum_threshold(self) -> Stake:
        # 2f+1 out of N=3f+1 by stake (reference ``config.rs:67-72``).
        return 2 * self.total_stake() // 3 + 1

    def validity_threshold(self) -> Stake:
        # f+1 by stake: any set this heavy holds at least one honest authority.
        return (self.total_stake() - 1) // 3 + 1

    def address(self, name: PublicKey) -> tuple[str, int] | None:
        a = self.authorities.get(name)
        return a.address if a else None

    def broadcast_addresses(self, name: PublicKey) -> list[tuple[PublicKey, tuple[str, int]]]:
        """(name, address) of every node except ``name`` (reference
        ``config.rs:78-84``)."""
        return [(pk, a.address) for pk, a in self.authorities.items() if pk != name]

    def sorted_keys(self) -> list[PublicKey]:
        return sorted(self.authorities.keys())
