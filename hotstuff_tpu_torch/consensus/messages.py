"""Consensus messages: Vote and QC (port of the vote/QC part of
``hotstuff_tpu/consensus/messages.py``).

Digests mirror the reference (SHA-512 truncated to 32 bytes):
``Vote``/``QC`` sign H(block_hash || round_le) (``messages.rs:150-162,200-212``).
``QC.verify`` batches all 2f+1 vote signatures into one
``Signature.verify_batch`` call, which the ``CudaBackend`` runs on the card.
The wire codec, the lazily decoded v2 votes and the certificate caches
belong to later slices.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from hotstuff_tpu_torch.crypto import (
    BackendUnavailable,
    CryptoError,
    Digest,
    PublicKey,
    Signature,
    sha512_digest,
)

from . import errors
from .config import Committee, Round

_U64 = struct.Struct("<Q")


@dataclass
class QC:
    hash: Digest
    round: Round
    votes: list[tuple[PublicKey, Signature]]

    @classmethod
    def genesis(cls) -> "QC":
        return cls(hash=Digest.default(), round=0, votes=[])

    def digest(self) -> Digest:
        return sha512_digest(self.hash.data, _U64.pack(self.round))

    def __eq__(self, other) -> bool:
        # Vote-set-independent equality (reference ``messages.rs:214-218``).
        return isinstance(other, QC) and self.hash == other.hash and self.round == other.round

    def n_votes(self) -> int:
        return len(self.votes)

    def verify(self, committee: Committee) -> None:
        """Stake/duplicate accounting, then batch-verify all vote signatures
        (reference ``messages.rs:180-198``)."""
        weight = 0
        used = set()
        for name, _ in self.votes:
            if name in used:
                raise errors.AuthorityReuse(str(name))
            stake = committee.stake(name)
            if stake == 0:
                raise errors.UnknownAuthority(str(name))
            used.add(name)
            weight += stake
        if weight < committee.quorum_threshold():
            raise errors.QCRequiresQuorum("QC requires a quorum")
        try:
            Signature.verify_batch(self.digest(), self.votes)
        except BackendUnavailable:
            raise  # infrastructure failure, NOT a byzantine signature
        except CryptoError as e:
            raise errors.InvalidSignature(str(e)) from e

    def __repr__(self) -> str:
        return f"QC({self.hash!r}, {self.round})"


@dataclass
class Vote:
    hash: Digest
    round: Round
    author: PublicKey
    signature: Signature

    @classmethod
    def new_from_key(cls, hash_: Digest, round_: Round, author, secret) -> "Vote":
        vote = cls(hash_, round_, author, Signature.default())
        vote.signature = Signature.new(vote.digest(), secret)
        return vote

    def digest(self) -> Digest:
        return sha512_digest(self.hash.data, _U64.pack(self.round))

    def verify(self, committee: Committee) -> None:
        if committee.stake(self.author) == 0:
            raise errors.UnknownAuthority(str(self.author))
        try:
            self.signature.verify(self.digest(), self.author)
        except BackendUnavailable:
            raise  # infrastructure failure, NOT a byzantine signature
        except CryptoError as e:
            raise errors.InvalidSignature(str(e)) from e

    def __repr__(self) -> str:
        return f"V({self.author!r}, {self.round}, {self.hash!r})"
