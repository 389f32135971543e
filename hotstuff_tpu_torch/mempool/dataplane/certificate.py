"""Batch availability certificates: 2f+1 signed acks bound to a digest.

Port copy of ``hotstuff_tpu/mempool/dataplane/certificate.py``, whole.

Once 2f+1 stake has SIGNED that it holds a batch, quorum intersection
guarantees at least f+1 HONEST nodes hold it, so consensus may order the
digest (and every replica may vote) without possessing the bytes.

Two wire formats, mirroring the consensus plane's wire v2:

- **v1** (``TAG_CERT``): ``digest | u32 n | n * (pk 32B, sig 64B)``,
  self-contained and committee-agnostic.
- **v2** (``TAG_CERT_V2``): ``digest | u32 n | seat-bitmap | n * sig``,
  signers named as a bitmap over the mempool committee's sorted key
  order (:class:`WorkerSeatTable`). Decode requires the seat table; both
  formats are always accepted.

Every ack and every certificate signature is checked one at a time with
the strict single ``Signature.verify`` on the host, as the reference
does: the strict check rejects a torsioned R that the cofactored batch
check of the certificate path accepts, so routing these signatures to
``Signature.verify_batch`` would change which acks are accepted.
``AvailabilityCert.verify`` checks signer uniqueness, committee
membership, the stake quorum, and every signature over the
domain-separated ack digest. Certificates off the wire are verified
BEFORE they are stored; the consensus availability gate then only tests
presence.
"""

from __future__ import annotations

from hotstuff_tpu_torch.crypto import CryptoError, Digest, PublicKey, Signature
from hotstuff_tpu_torch.utils.serde import Decoder, Encoder, SerdeError

from ..config import Committee
from .messages import TAG_CERT, TAG_CERT_V2, ack_digest

__all__ = ["AvailabilityCert", "CertCollector", "WorkerSeatTable", "CertError"]


class CertError(Exception):
    pass


class WorkerSeatTable:
    """Canonical seat numbering of the MEMPOOL committee: seat ``i`` is
    the ``i``-th public key in sorted order (the same order on every node,
    so v2 certs name signers by bitmap)."""

    __slots__ = ("keys", "index", "nbytes")

    def __init__(self, keys) -> None:
        self.keys: list[PublicKey] = sorted(keys)
        self.index: dict[PublicKey, int] = {pk: i for i, pk in enumerate(self.keys)}
        self.nbytes = (len(self.keys) + 7) // 8

    def __len__(self) -> int:
        return len(self.keys)

    @classmethod
    def for_committee(cls, committee: Committee) -> "WorkerSeatTable":
        table = committee.__dict__.get("_worker_seat_table")
        if table is None:
            table = cls(committee.authorities.keys())
            committee.__dict__["_worker_seat_table"] = table
        return table


def _bitmap_seats(bitmap: bytes, n_seats: int) -> list[int]:
    seats = []
    for byte_i, byte in enumerate(bitmap):
        base = byte_i * 8
        while byte:
            low = byte & -byte
            seat = base + low.bit_length() - 1
            if seat >= n_seats:
                raise SerdeError(f"cert bitmap names unknown seat {seat}")
            seats.append(seat)
            byte ^= low
    return seats


def _seats_bitmap(seat_indices, nbytes: int) -> bytes:
    bits = bytearray(nbytes)
    for seat in seat_indices:
        bits[seat // 8] |= 1 << (seat % 8)
    return bytes(bits)


class AvailabilityCert:
    """An immutable (digest, signer→signature) binding."""

    __slots__ = ("digest", "pairs")

    def __init__(self, digest: Digest, pairs: list[tuple[PublicKey, Signature]]):
        self.digest = digest
        self.pairs = pairs

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, AvailabilityCert)
            and self.digest == other.digest
            and self.pairs == other.pairs
        )

    def signers(self) -> list[PublicKey]:
        return [pk for pk, _ in self.pairs]

    def verify(self, committee: Committee) -> None:
        """Raise CertError unless this is a valid 2f+1 availability
        certificate for ``committee``."""
        seen: set[PublicKey] = set()
        stake = 0
        for pk, _sig in self.pairs:
            if pk in seen:
                raise CertError(f"duplicate cert signer {pk}")
            seen.add(pk)
            s = committee.stake(pk)
            if s == 0:
                raise CertError(f"cert signer {pk} not in committee")
            stake += s
        if stake < committee.quorum_threshold():
            raise CertError(
                f"cert stake {stake} below quorum {committee.quorum_threshold()}"
            )
        signed = ack_digest(self.digest)
        for pk, sig in self.pairs:
            try:
                sig.verify(signed, pk)
            except CryptoError as e:
                raise CertError(f"bad cert signature from {pk}: {e}") from e

    # -- wire --------------------------------------------------------------

    def encode(self, seats: WorkerSeatTable | None = None) -> bytes:
        """v1 without ``seats``; v2 (seat bitmap + concatenated sigs)
        with. A signer missing from the table falls back to v1; decode
        accepts both, so the fallback can never split a committee."""
        if seats is not None and all(pk in seats.index for pk, _ in self.pairs):
            ordered = sorted((seats.index[pk], sig) for pk, sig in self.pairs)
            enc = (
                Encoder()
                .u8(TAG_CERT_V2)
                .raw(self.digest.data)
                .u32(len(ordered))
                .raw(_seats_bitmap([s for s, _ in ordered], seats.nbytes))
            )
            for _, sig in ordered:
                enc.raw(sig.data)
            return enc.finish()
        enc = Encoder().u8(TAG_CERT).raw(self.digest.data).u32(len(self.pairs))
        for pk, sig in self.pairs:
            enc.raw(pk.data)
            enc.raw(sig.data)
        return enc.finish()

    @classmethod
    def decode(
        cls, data: bytes, seats: WorkerSeatTable | None = None
    ) -> "AvailabilityCert":
        dec = Decoder(data)
        tag = dec.u8()
        if tag == TAG_CERT:
            digest = Digest(dec.raw(32))
            n = dec.u32()
            pairs = [(PublicKey(dec.raw(32)), Signature(dec.raw(64))) for _ in range(n)]
            dec.finish()
            return cls(digest, pairs)
        if tag == TAG_CERT_V2:
            if seats is None:
                raise SerdeError("v2 cert without a seat table")
            digest = Digest(dec.raw(32))
            n = dec.u32()
            seat_list = _bitmap_seats(dec.raw(seats.nbytes), len(seats))
            if len(seat_list) != n:
                raise SerdeError(f"cert bitmap popcount {len(seat_list)} != count {n}")
            pairs = [(seats.keys[s], Signature(dec.raw(64))) for s in seat_list]
            dec.finish()
            return cls(digest, pairs)
        raise SerdeError(f"unknown cert tag {tag}")


class CertCollector:
    """Accumulates verified acks for ONE batch until the stake quorum.

    The disseminating worker seeds it with its own signed ack (own stake
    counts, like the QuorumWaiter), then feeds peer acks as their reply
    frames resolve; ``add_ack`` verifies signature + membership + digest
    binding and returns the finished certificate the moment accumulated
    stake reaches 2f+1."""

    def __init__(
        self,
        committee: Committee,
        digest: Digest,
        own: tuple[PublicKey, Signature] | None = None,
    ) -> None:
        self.committee = committee
        self.digest = digest
        self._signed = ack_digest(digest)
        self.pairs: list[tuple[PublicKey, Signature]] = []
        self.stake = 0
        self._seen: set[PublicKey] = set()
        self._done = False
        if own is not None:
            self.add_ack(*own)

    def add_ack(
        self, signer: PublicKey, signature: Signature
    ) -> AvailabilityCert | None:
        """Returns the certificate exactly once, at the ack that crosses
        the quorum; raises CertError on an invalid ack."""
        if self._done or signer in self._seen:
            return None  # post-quorum straggler / retransmit: harmless
        stake = self.committee.stake(signer)
        if stake == 0:
            raise CertError(f"ack signer {signer} not in committee")
        try:
            signature.verify(self._signed, signer)
        except CryptoError as e:
            raise CertError(f"bad ack signature from {signer}: {e}") from e
        self._seen.add(signer)
        self.pairs.append((signer, signature))
        self.stake += stake
        if self.stake >= self.committee.quorum_threshold():
            self._done = True
            return AvailabilityCert(self.digest, list(self.pairs))
        return None

    def complete(self) -> bool:
        return self.stake >= self.committee.quorum_threshold()
