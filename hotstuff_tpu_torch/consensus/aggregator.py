"""Vote aggregation into QCs (port of the vote half of
``hotstuff_tpu/consensus/aggregator.py``).

``QCMaker`` dedups authors, sums stake and emits the QC exactly once at
2f+1. ``Aggregator.add_vote`` keys makers by round and vote digest, and
binds each author to one digest bucket per round.
"""

from __future__ import annotations

from .config import Committee, Round
from .errors import AuthorityReuse
from .messages import QC, Vote


class QCMaker:
    def __init__(self) -> None:
        self.weight = 0
        self.votes = []
        self.used = set()

    def append(self, vote: Vote, committee: Committee) -> QC | None:
        if vote.author in self.used:
            raise AuthorityReuse(str(vote.author))
        self.used.add(vote.author)
        self.votes.append((vote.author, vote.signature))
        self.weight += committee.stake(vote.author)
        if self.weight >= committee.quorum_threshold():
            self.weight = 0  # QC is made exactly once
            return QC(hash=vote.hash, round=vote.round, votes=list(self.votes))
        return None


class Aggregator:
    def __init__(self, committee: Committee) -> None:
        self.committee = committee
        self.votes_aggregators: dict[Round, dict] = {}
        # Per-round author -> digest-bucket binding: each authority occupies
        # at most one digest bucket per round.
        self.author_bucket: dict[Round, dict] = {}

    def add_vote(self, vote: Vote) -> QC | None:
        per_round = self.votes_aggregators.setdefault(vote.round, {})
        buckets = self.author_bucket.setdefault(vote.round, {})
        key = vote.digest()
        prev = buckets.get(vote.author)
        if prev is not None and prev != key:
            raise AuthorityReuse(str(vote.author))
        qc = per_round.setdefault(key, QCMaker()).append(vote, self.committee)
        buckets[vote.author] = key
        return qc

    def cleanup(self, round_: Round) -> None:
        self.votes_aggregators = {k: v for k, v in self.votes_aggregators.items() if k >= round_}
        self.author_bucket = {k: v for k, v in self.author_bucket.items() if k >= round_}
