"""Committee configuration (port of ``hotstuff_tpu/consensus/config.py``).

One consensus address per node; stake-weighted quorums of 2f+1.
"""

from __future__ import annotations

from dataclasses import dataclass

from hotstuff_tpu_torch.crypto import PublicKey

Stake = int
Round = int


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

    def sorted_keys(self) -> list[PublicKey]:
        return sorted(self.authorities.keys())
