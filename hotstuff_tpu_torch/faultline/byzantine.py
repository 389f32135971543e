"""Active byzantine behaviors driven by the scenario runner.

Three behaviors (``policy.BYZANTINE_BEHAVIORS``):

- ``silent_leader`` needs no actor: the FaultPlane suppresses the node's
  outbound proposals at the link filter, so the node keeps voting and
  timing out but never proposes — the committee burns a timeout every
  time it elects the silent seat (the regime the reputation elector
  exists for).
- ``equivocate`` and ``stale_vote_flood`` are ACTOR behaviors: a task
  holding the byzantine seat's genuine key injects adversarial traffic
  through a real sender (so link faults apply to the attacker too). The
  honest committee must drop all of it at verification/round gates while
  continuing to commit — safety rests on quorum intersection, never on
  these frames being filtered early.

Actors observe only what a network adversary could (a round estimate
sampled from the runner), and every randomized choice draws from a
seed-derived stream so the attack sequence replays with the scenario.

Port copy of ``hotstuff_tpu/faultline/byzantine.py`` over the port's
``consensus.messages``, ``crypto.sha512_digest`` and
``network.SimpleSender``: the same frames from the same seed.
"""

from __future__ import annotations

import asyncio
import logging

from hotstuff_tpu_torch.consensus.messages import (
    QC,
    Block,
    Vote,
    encode_propose,
    encode_vote,
)
from hotstuff_tpu_torch.crypto import sha512_digest
from hotstuff_tpu_torch.network import SimpleSender

from .policy import _seed_stream

log = logging.getLogger("faultline")

__all__ = ["ByzantineActor"]

_PERIOD_S = 0.05  # injection cadence; fast enough to pressure every round


class ByzantineActor:
    """One byzantine seat's attack task. ``round_source`` returns the
    adversary's current round estimate (the runner samples an honest
    core; a real attacker would read it off the wire)."""

    def __init__(
        self,
        committee,
        name,
        secret,
        behavior: str,
        seed: int,
        round_source,
    ) -> None:
        self.committee = committee
        self.name = name
        self.secret = secret
        self.behavior = behavior
        self.rng = _seed_stream(seed, "byzantine", behavior, str(name))
        self.round_source = round_source
        self.network = SimpleSender()
        self.sent = 0
        self._task: asyncio.Task | None = None

    def spawn(self) -> "ByzantineActor":
        runner = {
            "equivocate": self._equivocate,
            "stale_vote_flood": self._stale_vote_flood,
        }.get(self.behavior)
        if runner is None:
            raise ValueError(f"behavior {self.behavior!r} needs no actor")
        self._task = asyncio.create_task(
            runner(), name=f"byzantine_{self.behavior}"
        )
        return self

    async def shutdown(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
        self.network.shutdown()

    def _peers(self):
        return [a for _, a in self.committee.broadcast_addresses(self.name)]

    async def _equivocate(self) -> None:
        """Equivocating proposer: two conflicting signed blocks for the
        same round, each half of the committee receiving a different one
        first (plus both broadcast, so everyone eventually sees the
        conflict). Honest cores must never commit either unless it earns
        a genuine quorum — which conflicting proposals cannot both do."""
        while True:
            round_ = self.round_source() + 1
            parent = sha512_digest(
                b"equivocation-parent", self.rng.randbytes(8)
            )
            fake_qc = QC(hash=parent, round=round_ - 1, votes=[])
            peers = self._peers()
            half = len(peers) // 2
            for salt, targets in (
                (b"a", peers[:half]),
                (b"b", peers[half:]),
            ):
                block = Block.new_from_key(
                    fake_qc,
                    None,
                    self.name,
                    round_,
                    [sha512_digest(b"equiv-payload-" + salt)],
                    self.secret,
                )
                self.network.broadcast(targets or peers, encode_propose(block))
                self.sent += 1
            await asyncio.sleep(_PERIOD_S)

    async def _stale_vote_flood(self) -> None:
        """Stale-vote flooder: bursts of genuine-key votes for rounds far
        behind the committee's progress — the traffic class the native
        pre-stage's round gate and the core's cheap round check must
        shed without paying signature verifications."""
        while True:
            current = self.round_source()
            peers = self._peers()
            for _ in range(8):
                stale_round = max(1, current - self.rng.randrange(1, 50))
                vote = Vote.new_from_key(
                    sha512_digest(b"stale", self.rng.randbytes(8)),
                    stale_round,
                    self.name,
                    self.secret,
                )
                self.network.broadcast(peers, encode_vote(vote))
                self.sent += 1
            await asyncio.sleep(_PERIOD_S)
