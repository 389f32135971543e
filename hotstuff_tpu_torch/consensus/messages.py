"""Consensus messages: Block, Vote, QC, Timeout, TC, and their wire codec.

Port copy of ``hotstuff_tpu/consensus/messages.py`` (reference
``consensus/src/messages.rs``), less its telemetry counter. Byte formats
and verdicts are the reference's: a frame one package encodes decodes in
the other, and an encoding of the same object is byte-identical.

Digests (SHA-512 truncated to 32 bytes):

- ``Block``: H(author ‖ round_le ‖ payload... ‖ qc.hash)  (``messages.rs:79-90``)
- ``Vote``/``QC``: H(block_hash ‖ round_le)               (``messages.rs:150-162,200-212``)
- ``Timeout``: H(round_le ‖ high_qc.round_le)             (``messages.rs:267-279``)
- ``TC`` per-voter digest: H(tc.round_le ‖ high_qc_round_le) (``messages.rs:303-314``)

A materialized ``QC`` verifies through ``Signature.verify_batch`` and a
``TC`` through ``Signature.verify_batch_multi``; a wire-v2 certificate
(seat bitmap + packed signature buffer) decodes lazily and verifies from
the raw slices through ``backend_verify_cert``. ``CertificateCache`` (one
per node) and the process-wide ``cert_arena`` skip certificates that
already verified.
"""

from __future__ import annotations

import struct
import threading
from collections import OrderedDict
from dataclasses import dataclass

from hotstuff_tpu_torch.crypto import (
    BackendUnavailable,
    CryptoError,
    Digest,
    PublicKey,
    SecretKey,
    Signature,
    backend_verify_cert,
    sha512_digest,
)
from hotstuff_tpu_torch.utils.serde import MAX_LEN, Decoder, Encoder, SerdeError

from . import cert_arena, errors
from .config import Committee, Round

_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")

# Decoded public keys interned by raw bytes: the same N committee keys
# appear in every QC, TC and vote a process decodes, and one shared object
# per key saves the construction and makes dict lookups hit the identity
# fast path. A bounded LRU: a key spray evicts only the coldest entries,
# and committee keys, touched on every decode, never age out. Evictions
# are counted in ``intern_evictions``.
_PK_INTERN_CAP = 4096
_PK_INTERN: "OrderedDict[bytes, PublicKey]" = OrderedDict()
intern_evictions = 0


def _intern_pk(raw: bytes) -> PublicKey:
    pk = _PK_INTERN.get(raw)
    if pk is None:
        if len(_PK_INTERN) >= _PK_INTERN_CAP:
            global intern_evictions
            _PK_INTERN.popitem(last=False)
            intern_evictions += 1
        pk = _PK_INTERN[raw] = PublicKey(raw)
    else:
        _PK_INTERN.move_to_end(raw)
    return pk


# ---------------------------------------------------------------------------
# Seat table: canonical committee numbering for wire-format v2.
# ---------------------------------------------------------------------------


class SeatTable:
    """Canonical seat numbering of a committee: seat ``i`` is the ``i``-th
    public key in sorted order, the same on every node, so a certificate
    names its signers as a BITMAP of seats instead of repeating each
    32-byte key (wire-format v2). Keys are interned, so a seat maps back
    to its PublicKey by a list index."""

    __slots__ = ("keys", "index", "nbytes", "fingerprint")

    def __init__(self, keys) -> None:
        self.keys: list[PublicKey] = [_intern_pk(bytes(pk)) for pk in keys]
        self.index: dict[PublicKey, int] = {pk: i for i, pk in enumerate(self.keys)}
        self.nbytes = (len(self.keys) + 7) // 8  # bitmap width
        self.fingerprint = sha512_digest(*[pk.data for pk in self.keys]).data

    def __len__(self) -> int:
        return len(self.keys)

    @classmethod
    def for_committee(cls, committee: Committee) -> "SeatTable":
        """Memoized on the committee object (an epoch change builds a new
        Committee and so a new table)."""
        table = committee.__dict__.get("_seat_table")
        if table is None:
            table = cls(committee.sorted_keys())
            committee.__dict__["_seat_table"] = table
        return table


# Wire-format v2 marker on the vote-count u32 of a QC/TC vote section. v1
# counts are bounded by MAX_LEN (< 2^26), so the bit is unambiguous. After
# a flagged count, in ascending seat order:
#   QC: bitmap[seats.nbytes] | count * 64B signature
#   TC: bitmap[seats.nbytes] | count * (64B signature + u64 high_qc_round)
_V2_FLAG = 0x8000_0000


def _bitmap_seats(bitmap: bytes, n_seats: int) -> list[int]:
    """Ascending seat indices set in ``bitmap``; rejects bits >= n_seats."""
    seats: list[int] = []
    for byte_i, byte in enumerate(bitmap):
        if not byte:
            continue
        base = byte_i * 8
        for bit in range(8):
            if byte & (1 << bit):
                seat = base + bit
                if seat >= n_seats:
                    raise SerdeError(f"v2 bitmap names unknown seat {seat}")
                seats.append(seat)
    return seats


def _seats_bitmap(seat_indices, nbytes: int) -> bytes:
    out = bytearray(nbytes)
    for s in seat_indices:
        out[s >> 3] |= 1 << (s & 7)
    return bytes(out)


class CertificateCache:
    """Byte-identical certificates that already verified skip
    re-verification.

    Certificates are rebroadcast: every Timeout of a view change carries
    the same high QC, every TC-former broadcasts the TC, and timers
    retransmit. One instance per NODE, never module-level. Keyed by the
    certificate's canonical (v1) encoding, so a tampered variant misses and
    a v1 and a v2 copy of one certificate hit the same entry. Failures are
    never cached.
    """

    __slots__ = ("cap", "_seen", "_lock")

    def __init__(self, cap: int = 512) -> None:
        self.cap = cap
        self._seen: "OrderedDict[bytes, None]" = OrderedDict()
        # hit()/add() run on several threads; check-then-move is not atomic.
        self._lock = threading.Lock()

    @staticmethod
    def key_of(cert) -> bytes:
        # Memoized on the certificate (never mutated after construction).
        # Always the canonical v1 encoding, whatever the wire format; a
        # lazy v2 certificate assembles it from its raw slices.
        key = cert.__dict__.get("_cache_key")
        if key is None:
            key = cert._canonical_key()
            cert._cache_key = key
        return key

    def hit(self, key: bytes) -> bool:
        with self._lock:
            if key in self._seen:
                self._seen.move_to_end(key)
                return True
            return False

    def add(self, key: bytes) -> None:
        with self._lock:
            self._seen[key] = None
            if len(self._seen) > self.cap:
                self._seen.popitem(last=False)


def _raw_votes(cert):
    """A lazy v2 certificate's ``(seat_indices, buf, seats)``, or None once
    its votes are materialized (or it never had raw votes)."""
    if "votes" in cert.__dict__:
        return None
    return cert.__dict__.get("_raw_votes")


def _skip_verified(cert, committee: Committee, cache):
    """The cache and arena lookups in front of a certificate verify: None
    when the certificate already verified (a hit), else the (cache key,
    arena, arena key) to record a success under."""
    key = None
    if cache is not None:
        key = CertificateCache.key_of(cert)
        if cache.hit(key):
            return None
    arena = cert_arena.get_arena()
    akey = None
    if arena is not None:
        akey = (cert_arena.committee_fp(committee), key if key is not None else CertificateCache.key_of(cert))
        if arena.hit(akey):
            if cache is not None:
                cache.add(key)
            return None
    return key, arena, akey


def _record_verified(cache, key, arena, akey) -> None:
    if arena is not None:
        arena.add(akey)
    if cache is not None:
        cache.add(key)


def _seat_weight(committee: Committee, keys, seat_list) -> int:
    """Stake of a v2 certificate's seats (distinct by construction of the
    bitmap, so AuthorityReuse cannot arise)."""
    weight = 0
    for s in seat_list:
        stake = committee.stake(keys[s])
        if stake == 0:
            raise errors.UnknownAuthority(str(keys[s]))
        weight += stake
    return weight


def _author_weight(committee: Committee, authors) -> int:
    weight = 0
    used = set()
    for name in authors:
        if name in used:
            raise errors.AuthorityReuse(str(name))
        stake = committee.stake(name)
        if stake == 0:
            raise errors.UnknownAuthority(str(name))
        used.add(name)
        weight += stake
    return weight


def _decode_v2_section(dec: Decoder, seats, count_word: int, rec: int):
    """(seat_list, buf) of a flagged v2 vote section, ``rec`` bytes a vote."""
    if seats is None:
        raise SerdeError("v2 certificate without a seat table")
    count = count_word & ~_V2_FLAG
    if count > len(seats):
        raise SerdeError(f"v2 vote count {count} exceeds committee")
    seat_list = _bitmap_seats(dec.raw(seats.nbytes), len(seats))
    if len(seat_list) != count:
        raise SerdeError(f"v2 bitmap popcount {len(seat_list)} != count {count}")
    return seat_list, dec.raw(rec * count)


# ---------------------------------------------------------------------------
# QC
# ---------------------------------------------------------------------------


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

    # Lazy votes (wire-format v2 decode): a v2-decoded QC holds
    # ``_raw_votes = (seat_indices, sig_buf, seats)`` instead of ``votes``;
    # the verify path reads 64-byte slices of ``sig_buf`` and a cache hit
    # never builds a Signature. ``votes`` materializes on first access.

    def __getattr__(self, name):
        if name == "votes":
            raw = self.__dict__.get("_raw_votes")
            if raw is not None:
                seat_list, sig_buf, seats = raw
                keys = seats.keys
                votes = [
                    (keys[s], Signature(sig_buf[i * 64 : i * 64 + 64]))
                    for i, s in enumerate(seat_list)
                ]
                self.__dict__["votes"] = votes
                return votes
        raise AttributeError(name)

    def n_votes(self) -> int:
        """Vote count without materializing lazy votes."""
        votes = self.__dict__.get("votes")
        if votes is not None:
            return len(votes)
        raw = self.__dict__.get("_raw_votes")
        return len(raw[0]) if raw is not None else len(self.votes)

    def _canonical_key(self) -> bytes:
        raw = _raw_votes(self)
        if raw is not None:
            # v1-canonical bytes straight from the raw slices.
            seat_list, sig_buf, seats = raw
            keys = seats.keys
            return b"".join((
                self.hash.data,
                _U64.pack(self.round),
                _U32.pack(len(seat_list)),
                *(keys[s].data + sig_buf[i * 64 : i * 64 + 64] for i, s in enumerate(seat_list)),
            ))
        enc = Encoder()
        self.encode(enc)
        return enc.finish()

    def verify(self, committee: Committee, cache: "CertificateCache | None" = None) -> None:
        """Stake/duplicate accounting, then batch-verify all vote signatures
        (reference ``messages.rs:180-198``). With ``cache``, a byte-identical
        QC that already verified is accepted without re-verification."""
        todo = _skip_verified(self, committee, cache)
        if todo is None:
            return
        raw = _raw_votes(self)
        if raw is not None:
            self._verify_raw(committee, raw)
        else:
            weight = _author_weight(committee, (name for name, _ in self.votes))
            if weight < committee.quorum_threshold():
                raise errors.QCRequiresQuorum("QC requires a quorum")
            try:
                Signature.verify_batch(self.digest(), self.votes)
            except BackendUnavailable:
                raise  # infrastructure failure, NOT a byzantine signature
            except CryptoError as e:
                raise errors.InvalidSignature(str(e)) from e
        _record_verified(cache, *todo)

    def _verify_raw(self, committee: Committee, raw) -> None:
        """Raw-slice verification of a lazy v2 QC: the acceptance of the
        materialized path, with ONE fused job per cert (the packed buffer
        and its stride) and the canonical key for the super-batch dedup."""
        seat_list, sig_buf, seats = raw
        keys = seats.keys
        if _seat_weight(committee, keys, seat_list) < committee.quorum_threshold():
            raise errors.QCRequiresQuorum("QC requires a quorum")
        try:
            backend_verify_cert(
                self.digest().data,
                [keys[s].data for s in seat_list],
                sig_buf,
                64,
                key=CertificateCache.key_of(self),
            )
        except BackendUnavailable:
            raise  # infrastructure failure, NOT a byzantine signature
        except CryptoError as e:
            raise errors.InvalidSignature(str(e)) from e

    def encode(self, enc: Encoder, seats: "SeatTable | None" = None) -> None:
        enc.raw(self.hash.data).u64(self.round)
        if seats is not None and self._encode_votes_v2(enc, seats):
            return
        enc.seq(self.votes, lambda e, v: e.raw(v[0].data).raw(v[1].data))

    def _encode_votes_v2(self, enc: Encoder, seats: "SeatTable") -> bool:
        raw = _raw_votes(self)
        if raw is not None and raw[2] is seats:
            # Re-encode of an unmaterialized view for the same committee.
            seat_list, sig_buf, _ = raw
            enc.u32(_V2_FLAG | len(seat_list))
            enc.raw(_seats_bitmap(seat_list, seats.nbytes))
            enc.raw(sig_buf)
            return True
        votes = self.votes
        if not votes:
            return False  # genesis stays v1 (no bitmap bytes for nothing)
        index = seats.index
        try:
            pairs = sorted(((index[pk], sig) for pk, sig in votes), key=lambda p: p[0])
        except KeyError:
            return False  # a signer outside the table: fall back to v1
        enc.u32(_V2_FLAG | len(pairs))
        enc.raw(_seats_bitmap([s for s, _ in pairs], seats.nbytes))
        for _, sig in pairs:
            enc.raw(sig.data)
        return True

    @classmethod
    def decode(cls, dec: Decoder, seats: "SeatTable | None" = None) -> "QC":
        h = Digest(dec.raw(32))
        rnd = dec.u64()
        n = dec.u32()
        if n & _V2_FLAG:
            qc = cls.__new__(cls)
            qc.hash = h
            qc.round = rnd
            seat_list, sig_buf = _decode_v2_section(dec, seats, n, 64)
            qc.__dict__["_raw_votes"] = (seat_list, sig_buf, seats)
            return qc
        if n > MAX_LEN:
            raise SerdeError(f"sequence count {n} exceeds MAX_LEN")
        votes = [(_intern_pk(dec.raw(32)), Signature(dec.raw(64))) for _ in range(n)]
        return cls(h, rnd, votes)

    def __repr__(self) -> str:
        return f"QC({self.hash!r}, {self.round})"


# ---------------------------------------------------------------------------
# TC
# ---------------------------------------------------------------------------


def _tc_digest(round_le: bytes, hqc_round_le: bytes) -> Digest:
    return sha512_digest(round_le, hqc_round_le)


@dataclass
class TC:
    round: Round
    votes: list[tuple[PublicKey, Signature, Round]]  # (author, sig, high_qc_round)

    # Lazy votes, as QC's: ``_raw_votes = (seat_indices, buf, seats)`` where
    # ``buf`` packs ``count * (64B signature + u64 LE high_qc_round)``.
    _REC = 72  # bytes per packed v2 vote record

    def __getattr__(self, name):
        if name == "votes":
            raw = self.__dict__.get("_raw_votes")
            if raw is not None:
                seat_list, buf, seats = raw
                keys = seats.keys
                rec = self._REC
                votes = [
                    (
                        keys[s],
                        Signature(buf[i * rec : i * rec + 64]),
                        _U64.unpack_from(buf, i * rec + 64)[0],
                    )
                    for i, s in enumerate(seat_list)
                ]
                self.__dict__["votes"] = votes
                return votes
        raise AttributeError(name)

    def n_votes(self) -> int:
        votes = self.__dict__.get("votes")
        if votes is not None:
            return len(votes)
        raw = self.__dict__.get("_raw_votes")
        return len(raw[0]) if raw is not None else len(self.votes)

    def high_qc_rounds(self) -> list[Round]:
        raw = _raw_votes(self)
        if raw is not None:
            buf, rec = raw[1], self._REC
            return [_U64.unpack_from(buf, i * rec + 64)[0] for i in range(len(raw[0]))]
        return [r for _, _, r in self.votes]

    def _canonical_key(self) -> bytes:
        raw = _raw_votes(self)
        if raw is not None:
            seat_list, buf, seats = raw
            keys = seats.keys
            rec = self._REC
            return b"".join((
                _U64.pack(self.round),
                _U32.pack(len(seat_list)),
                *(keys[s].data + buf[i * rec : i * rec + rec] for i, s in enumerate(seat_list)),
            ))
        enc = Encoder()
        self.encode(enc)
        return enc.finish()

    def verify(self, committee: Committee, cache: "CertificateCache | None" = None) -> None:
        """Stake accounting, then verify the per-voter digests in one batch
        (reference ``messages.rs:283-320`` verifies sig by sig; the
        acceptance is the same). With ``cache``, a byte-identical TC that
        already verified is accepted without re-verification."""
        todo = _skip_verified(self, committee, cache)
        if todo is None:
            return
        raw = _raw_votes(self)
        if raw is not None:
            self._verify_raw(committee, raw)
        else:
            weight = _author_weight(committee, (name for name, _, _ in self.votes))
            if weight < committee.quorum_threshold():
                raise errors.TCRequiresQuorum("TC requires a quorum")
            round_le = _U64.pack(self.round)
            try:
                Signature.verify_batch_multi(
                    [(_tc_digest(round_le, _U64.pack(hqc)), author, sig) for author, sig, hqc in self.votes]
                )
            except BackendUnavailable:
                raise  # infrastructure failure, NOT a byzantine signature
            except CryptoError as e:
                raise errors.InvalidSignature(str(e)) from e
        _record_verified(cache, *todo)

    def _verify_raw(self, committee: Committee, raw) -> None:
        """Raw-slice verification of a lazy v2 TC: per-seat statements (each
        voter signs its own high_qc_round), one fused job over the packed
        72-byte records."""
        seat_list, buf, seats = raw
        keys = seats.keys
        rec = self._REC
        if _seat_weight(committee, keys, seat_list) < committee.quorum_threshold():
            raise errors.TCRequiresQuorum("TC requires a quorum")
        round_le = _U64.pack(self.round)
        try:
            backend_verify_cert(
                [_tc_digest(round_le, buf[i * rec + 64 : i * rec + 72]).data for i in range(len(seat_list))],
                [keys[s].data for s in seat_list],
                buf,
                rec,
                key=CertificateCache.key_of(self),
            )
        except BackendUnavailable:
            raise  # infrastructure failure, NOT a byzantine signature
        except CryptoError as e:
            raise errors.InvalidSignature(str(e)) from e

    def encode(self, enc: Encoder, seats: "SeatTable | None" = None) -> None:
        enc.u64(self.round)
        if seats is not None and self._encode_votes_v2(enc, seats):
            return
        enc.seq(self.votes, lambda e, v: e.raw(v[0].data).raw(v[1].data).u64(v[2]))

    def _encode_votes_v2(self, enc: Encoder, seats: "SeatTable") -> bool:
        raw = _raw_votes(self)
        if raw is not None and raw[2] is seats:
            seat_list, buf, _ = raw
            enc.u32(_V2_FLAG | len(seat_list))
            enc.raw(_seats_bitmap(seat_list, seats.nbytes))
            enc.raw(buf)
            return True
        votes = self.votes
        if not votes:
            return False
        index = seats.index
        try:
            triples = sorted(((index[pk], sig, r) for pk, sig, r in votes), key=lambda t: t[0])
        except KeyError:
            return False  # a signer outside the table: fall back to v1
        enc.u32(_V2_FLAG | len(triples))
        enc.raw(_seats_bitmap([s for s, _, _ in triples], seats.nbytes))
        for _, sig, hqc_round in triples:
            enc.raw(sig.data).u64(hqc_round)
        return True

    @classmethod
    def decode(cls, dec: Decoder, seats: "SeatTable | None" = None) -> "TC":
        rnd = dec.u64()
        n = dec.u32()
        if n & _V2_FLAG:
            tc = cls.__new__(cls)
            tc.round = rnd
            seat_list, buf = _decode_v2_section(dec, seats, n, cls._REC)
            tc.__dict__["_raw_votes"] = (seat_list, buf, seats)
            return tc
        if n > MAX_LEN:
            raise SerdeError(f"sequence count {n} exceeds MAX_LEN")
        votes = [(_intern_pk(dec.raw(32)), Signature(dec.raw(64)), dec.u64()) for _ in range(n)]
        return cls(rnd, votes)

    def __repr__(self) -> str:
        return f"TC({self.round}, {self.high_qc_rounds()})"


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------


@dataclass
class Block:
    qc: QC
    tc: TC | None
    author: PublicKey
    round: Round
    payload: list[Digest]
    signature: Signature

    @classmethod
    def genesis(cls) -> "Block":
        return cls(
            qc=QC.genesis(),
            tc=None,
            author=PublicKey(bytes(32)),
            round=0,
            payload=[],
            signature=Signature.default(),
        )

    @classmethod
    async def new(cls, qc, tc, author, round_, payload, signature_service) -> "Block":
        block = cls(qc, tc, author, round_, payload, Signature.default())
        block.signature = await signature_service.request_signature(block.digest())
        return block

    @classmethod
    def new_from_key(cls, qc, tc, author, round_, payload, secret: SecretKey) -> "Block":
        """Synchronous constructor (reference ``consensus/src/tests/common.rs:48-114``)."""
        block = cls(qc, tc, author, round_, payload, Signature.default())
        block.signature = Signature.new(block.digest(), secret)
        return block

    def parent(self) -> Digest:
        return self.qc.hash

    def digest(self) -> Digest:
        # Memoized in the instance dict (identity fields are immutable once
        # built; the signature is not part of the digest), so the dataclass
        # __eq__/__repr__ stay on the declared fields.
        d = self.__dict__.get("_digest")
        if d is None:
            d = self.__dict__["_digest"] = sha512_digest(
                self.author.data,
                _U64.pack(self.round),
                *[d.data for d in self.payload],
                self.qc.hash.data,
            )
        return d

    def verify(self, committee: Committee, cache: "CertificateCache | None" = None) -> None:
        """Author stake + signature + embedded QC/TC (reference
        ``messages.rs:55-76``). ``cache`` skips embedded certificates this
        node already verified."""
        if committee.stake(self.author) == 0:
            raise errors.UnknownAuthority(str(self.author))
        try:
            self.signature.verify(self.digest(), self.author)
        except BackendUnavailable:
            raise  # infrastructure failure, NOT a byzantine signature
        except CryptoError as e:
            raise errors.InvalidSignature(str(e)) from e
        if self.qc != QC.genesis():
            self.qc.verify(committee, cache)
        if self.tc is not None:
            self.tc.verify(committee, cache)

    def encode(self, enc: Encoder, seats: "SeatTable | None" = None) -> None:
        self.qc.encode(enc, seats)
        enc.option(self.tc, lambda e, tc: tc.encode(e, seats))
        enc.raw(self.author.data).u64(self.round)
        enc.seq(self.payload, lambda e, d: e.raw(d.data))
        enc.raw(self.signature.data)

    @classmethod
    def decode(cls, dec: Decoder, seats: "SeatTable | None" = None) -> "Block":
        qc = QC.decode(dec, seats)
        tc = dec.option(lambda d: TC.decode(d, seats))
        author = _intern_pk(dec.raw(32))
        rnd = dec.u64()
        payload = dec.seq(lambda d: Digest(d.raw(32)))
        sig = Signature(dec.raw(64))
        return cls(qc, tc, author, rnd, payload, sig)

    def serialize(self) -> bytes:
        """Standalone v1 encoding, the store format (reference
        ``core.rs:89-93``). Memoized: a block decoded from a v1 frame carries
        its exact wire bytes (the encoding is canonical)."""
        wire = self.__dict__.get("_wire")
        if wire is None:
            enc = Encoder()
            self.encode(enc)
            wire = enc.finish()
            self._wire = wire
        return wire

    @classmethod
    def deserialize(cls, data: bytes) -> "Block":
        dec = Decoder(data)
        block = cls.decode(dec)
        dec.finish()
        block._wire = bytes(data)
        return block

    def __str__(self) -> str:
        return f"B{self.round}"

    def __repr__(self) -> str:
        return f"{self.digest()!r}: B({self.author!r}, {self.round}, {self.qc!r}, {len(self.payload) * 32})"


# ---------------------------------------------------------------------------
# Vote
# ---------------------------------------------------------------------------


@dataclass
class Vote:
    hash: Digest
    round: Round
    author: PublicKey
    signature: Signature

    @classmethod
    async def new(cls, block: Block, author, signature_service) -> "Vote":
        vote = cls(block.digest(), block.round, author, Signature.default())
        vote.signature = await signature_service.request_signature(vote.digest())
        return vote

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

    def encode(self, enc: Encoder) -> None:
        enc.raw(self.hash.data).u64(self.round).raw(self.author.data).raw(self.signature.data)

    @classmethod
    def decode(cls, dec: Decoder) -> "Vote":
        return cls(Digest(dec.raw(32)), dec.u64(), PublicKey(dec.raw(32)), Signature(dec.raw(64)))

    def __repr__(self) -> str:
        return f"V({self.author!r}, {self.round}, {self.hash!r})"


# ---------------------------------------------------------------------------
# Timeout
# ---------------------------------------------------------------------------


@dataclass
class Timeout:
    high_qc: QC
    round: Round
    author: PublicKey
    signature: Signature

    @classmethod
    async def new(cls, high_qc, round_, author, signature_service) -> "Timeout":
        t = cls(high_qc, round_, author, Signature.default())
        t.signature = await signature_service.request_signature(t.digest())
        return t

    @classmethod
    def new_from_key(cls, high_qc, round_, author, secret) -> "Timeout":
        t = cls(high_qc, round_, author, Signature.default())
        t.signature = Signature.new(t.digest(), secret)
        return t

    def digest(self) -> Digest:
        return sha512_digest(_U64.pack(self.round), _U64.pack(self.high_qc.round))

    def verify(self, committee: Committee, cache: "CertificateCache | None" = None) -> None:
        if committee.stake(self.author) == 0:
            raise errors.UnknownAuthority(str(self.author))
        try:
            self.signature.verify(self.digest(), self.author)
        except BackendUnavailable:
            raise  # infrastructure failure, NOT a byzantine signature
        except CryptoError as e:
            raise errors.InvalidSignature(str(e)) from e
        if self.high_qc != QC.genesis():
            # Every timeout of a view change carries the same high QC: the
            # cache collapses the N copies to one batch verification.
            self.high_qc.verify(committee, cache)

    def encode(self, enc: Encoder, seats: "SeatTable | None" = None) -> None:
        self.high_qc.encode(enc, seats)
        enc.u64(self.round).raw(self.author.data).raw(self.signature.data)

    @classmethod
    def decode(cls, dec: Decoder, seats: "SeatTable | None" = None) -> "Timeout":
        return cls(QC.decode(dec, seats), dec.u64(), PublicKey(dec.raw(32)), Signature(dec.raw(64)))

    def __repr__(self) -> str:
        return f"TV({self.author!r}, {self.round}, {self.high_qc!r})"


# ---------------------------------------------------------------------------
# Wire envelope: ConsensusMessage (reference ``consensus.rs:32-39``).
# ---------------------------------------------------------------------------

TAG_PROPOSE = 0
TAG_VOTE = 1
TAG_TIMEOUT = 2
TAG_TC = 3
TAG_SYNC_REQUEST = 4
TAG_STATE_REQUEST = 5
TAG_STATE_RESPONSE = 6


def encode_propose(block: Block, seats: "SeatTable | None" = None) -> bytes:
    # v1 rides the block's memoized store bytes; with ``seats`` the frame
    # carries the v2 (seat-bitmap) certificates instead, memoized apart.
    if seats is None:
        return bytes([TAG_PROPOSE]) + block.serialize()
    memo = block.__dict__.get("_wire_v2")
    if memo is None or memo[0] is not seats:
        enc = Encoder()
        block.encode(enc, seats)
        memo = (seats, enc.finish())
        block._wire_v2 = memo
    return bytes([TAG_PROPOSE]) + memo[1]


def encode_vote(vote: Vote) -> bytes:
    enc = Encoder().u8(TAG_VOTE)
    vote.encode(enc)
    return enc.finish()


def encode_timeout(timeout: Timeout, seats: "SeatTable | None" = None) -> bytes:
    enc = Encoder().u8(TAG_TIMEOUT)
    timeout.encode(enc, seats)
    return enc.finish()


def encode_tc(tc: TC, seats: "SeatTable | None" = None) -> bytes:
    enc = Encoder().u8(TAG_TC)
    tc.encode(enc, seats)
    return enc.finish()


def encode_sync_request(missing: Digest, origin: PublicKey) -> bytes:
    return Encoder().u8(TAG_SYNC_REQUEST).raw(missing.data).raw(origin.data).finish()


def encode_state_request(since_round: int, origin: PublicKey) -> bytes:
    """Anti-entropy frontier probe: ``origin`` asks a peer where the quorum
    commit frontier is, declaring its own committed round."""
    return Encoder().u8(TAG_STATE_REQUEST).u64(since_round).raw(origin.data).finish()


def encode_state_response(frontier_round: int, frontier: Digest, snapshot: bytes | None) -> bytes:
    """Reply to a state request: the peer's committed frontier, optionally
    with its snapshot record."""
    enc = Encoder().u8(TAG_STATE_RESPONSE)
    enc.u8(1 if snapshot is not None else 0)
    enc.u64(frontier_round).raw(frontier.data)
    if snapshot is not None:
        enc.raw(snapshot)
    return enc.finish()


# Fixed Vote wire layout (TAG_VOTE + Vote.encode):
#   u8 tag | 32B hash | u64 LE round | 32B author | 64B signature
VOTE_WIRE_LEN = 137


def decode_vote_frame(data: bytes) -> Vote:
    """Decode one fixed-layout vote frame by direct slicing. Accepts exactly
    what ``decode_message`` returns ``("vote", ...)`` for."""
    if len(data) != VOTE_WIRE_LEN or data[0] != TAG_VOTE:
        raise errors.MalformedMessage("not a fixed-layout vote frame")
    return Vote(
        Digest(data[1:33]),
        _U64.unpack_from(data, 33)[0],
        _intern_pk(data[41:73]),
        Signature(data[73:137]),
    )


def decode_message(data: bytes, seats: "SeatTable | None" = None):
    """Returns (kind, payload). Raises on malformed or byzantine input.

    With ``seats``, wire-format v2 certificate sections are accepted beside
    v1; without it a v2 frame is rejected as malformed (a v1-only peer)."""
    dec = Decoder(data)
    tag = dec.u8()
    if tag == TAG_PROPOSE:
        block = Block.decode(dec, seats)
        dec.finish()
        # A v1 frame's tail IS the block's store encoding; a v2 frame is not
        # (stores stay v1-canonical), so serialize() re-encodes that once.
        if "_raw_votes" not in block.qc.__dict__ and (
            block.tc is None or "_raw_votes" not in block.tc.__dict__
        ):
            block._wire = bytes(data[1:])
        return ("propose", block)
    elif tag == TAG_VOTE:
        out = ("vote", Vote(Digest(dec.raw(32)), dec.u64(), _intern_pk(dec.raw(32)), Signature(dec.raw(64))))
    elif tag == TAG_TIMEOUT:
        out = ("timeout", Timeout.decode(dec, seats))
    elif tag == TAG_TC:
        out = ("tc", TC.decode(dec, seats))
    elif tag == TAG_SYNC_REQUEST:
        out = ("sync_request", (Digest(dec.raw(32)), PublicKey(dec.raw(32))))
    elif tag == TAG_STATE_REQUEST:
        out = ("state_request", (dec.u64(), PublicKey(dec.raw(32))))
    elif tag == TAG_STATE_RESPONSE:
        has_snapshot = dec.u8()
        if has_snapshot not in (0, 1):
            raise errors.MalformedMessage("state_response snapshot flag")
        round_ = dec.u64()
        digest = Digest(dec.raw(32))
        # tag(1) + flag(1) + round(8) + digest(32) = 42 bytes consumed; the
        # snapshot record is the whole remaining tail.
        snapshot = bytes(dec.raw(len(data) - 42)) if has_snapshot else None
        dec.finish()
        return ("state_response", (round_, digest, snapshot))
    else:
        raise errors.MalformedMessage(f"unknown consensus tag {tag}")
    dec.finish()
    return out
