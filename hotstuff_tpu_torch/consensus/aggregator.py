"""Vote and timeout aggregation into QCs and TCs.

Port copy of ``hotstuff_tpu/consensus/aggregator.py`` (reference
``consensus/src/aggregator.rs``). ``QCMaker`` dedups authors, sums stake
and emits the QC exactly once at 2f+1; ``TCMaker`` does the same for
timeouts. ``Aggregator`` keys vote makers by round and vote digest, binds
each author to one digest bucket per round, keys timeout makers by round,
and ``cleanup`` keeps only rounds >= the current one.
"""

from __future__ import annotations

from .config import Committee, Round
from .errors import AuthorityReuse
from .messages import QC, TC, Timeout, Vote


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


class TCMaker:
    def __init__(self) -> None:
        self.weight = 0
        self.votes = []
        self.used = set()

    def append(self, timeout: Timeout, committee: Committee) -> TC | None:
        if timeout.author in self.used:
            raise AuthorityReuse(str(timeout.author))
        self.used.add(timeout.author)
        self.votes.append((timeout.author, timeout.signature, timeout.high_qc.round))
        self.weight += committee.stake(timeout.author)
        if self.weight >= committee.quorum_threshold():
            self.weight = 0  # TC is made exactly once
            return TC(round=timeout.round, votes=list(self.votes))
        return None


class Aggregator:
    def __init__(self, committee: Committee) -> None:
        self.committee = committee
        self.votes_aggregators: dict[Round, dict] = {}
        self.timeouts_aggregators: dict[Round, TCMaker] = {}
        # Per-round author -> digest-bucket binding: each authority occupies
        # at most one digest bucket per round, so byzantine members cannot
        # displace honest votes by fabricating digests.
        self.author_bucket: dict[Round, dict] = {}

    def add_vote(self, vote: Vote) -> QC | None:
        per_round = self.votes_aggregators.setdefault(vote.round, {})
        buckets = self.author_bucket.setdefault(vote.round, {})
        key = vote.digest()
        prev = buckets.get(vote.author)
        if prev is not None and prev != key:
            # The author already voted for another digest this round.
            raise AuthorityReuse(str(vote.author))
        qc = per_round.setdefault(key, QCMaker()).append(vote, self.committee)
        buckets[vote.author] = key
        return qc

    def reseat_vote(self, vote: Vote) -> QC | None:
        """Place an INDIVIDUALLY VERIFIED vote whose author's slot was taken.

        Same bucket: the stored (possibly spoofed) signature is swapped for
        the genuine one. Another bucket: the author's old entry is evicted
        and the vote added normally (it may complete a quorum, so its
        return value is handled like ``add_vote``'s)."""
        buckets = self.author_bucket.get(vote.round, {})
        prev = buckets.get(vote.author)
        key = vote.digest()
        if prev == key:
            self.replace_vote(vote)
            return None
        if prev is not None:
            makers = self.votes_aggregators.get(vote.round, {})
            maker = makers.get(prev)
            if maker is not None and vote.author in maker.used:
                maker.votes = [(pk, sig) for pk, sig in maker.votes if pk != vote.author]
                maker.used.discard(vote.author)
                maker.weight = max(0, maker.weight - self.committee.stake(vote.author))
                if not maker.used:
                    del makers[prev]
            del buckets[vote.author]
        return self.add_vote(vote)

    def stored_signature(self, round_: Round, digest, author):
        """The signature currently held for (round, digest, author), if any."""
        maker = self.votes_aggregators.get(round_, {}).get(digest)
        if maker is None:
            return None
        for pk, sig in maker.votes:
            if pk == author:
                return sig
        return None

    def add_timeout(self, timeout: Timeout) -> TC | None:
        return self.timeouts_aggregators.setdefault(timeout.round, TCMaker()).append(
            timeout, self.committee
        )

    def eject_votes(self, round_: Round, digest, bad, hash_):
        """After a batch-verified QC failed: remove the given bad
        ``(author, signature)`` pairs from the maker for (round, block
        digest) and free those authors' buckets. Keyed by the exact pair, so
        an author whose seat was since re-filled by a verified signature
        keeps it.

        Returns ``(qc, ejected_authors)``: with unequal stakes the survivors
        may still meet the quorum, and the caller re-verifies such a QC."""
        maker = self.votes_aggregators.get(round_, {}).get(digest)
        if maker is None:
            return None, set()
        bad_keys = {(bytes(pk.data), bytes(sig.data)) for pk, sig in bad}
        survivors = [
            (pk, sig) for pk, sig in maker.votes if (bytes(pk.data), bytes(sig.data)) not in bad_keys
        ]
        ejected = {pk for pk, _ in maker.votes} - {pk for pk, _ in survivors}
        maker.votes = survivors
        maker.used = {pk for pk, _ in survivors}
        maker.weight = sum(self.committee.stake(pk) for pk, _ in survivors)
        buckets = self.author_bucket.get(round_, {})
        for pk in ejected:
            buckets.pop(pk, None)
        if maker.weight >= self.committee.quorum_threshold():
            maker.weight = 0  # QC emitted exactly once
            return QC(hash=hash_, round=round_, votes=list(maker.votes)), ejected
        return None, ejected

    def replace_vote(self, vote: Vote) -> None:
        """Swap an author's stored (unverified) vote for a newly verified one."""
        makers = self.votes_aggregators.get(vote.round, {})
        maker = makers.get(vote.digest())
        if maker is None or vote.author not in maker.used:
            return
        maker.votes = [(pk, sig) if pk != vote.author else (pk, vote.signature) for pk, sig in maker.votes]

    def cleanup(self, round_: Round) -> None:
        self.votes_aggregators = {k: v for k, v in self.votes_aggregators.items() if k >= round_}
        self.timeouts_aggregators = {k: v for k, v in self.timeouts_aggregators.items() if k >= round_}
        self.author_bucket = {k: v for k, v in self.author_bucket.items() if k >= round_}
