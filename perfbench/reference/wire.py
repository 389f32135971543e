"""Plain decoder of a consensus proposal frame, written from the wire format
and not from the program's decoder.

Integers are fixed-width little-endian; a sequence is a ``u32`` count and
its items; an option is a ``u8`` 0 or 1 and its value. A proposal frame is
``u8`` tag 0 and a block:

    QC        32 B block hash | u64 round | vote section (64 B a vote)
    TC option u64 round | vote section (64 B signature + u64 high-QC round a vote)
    author    32 B | u64 round | payload: u32 count, 32 B digests | 64 B signature

A vote section begins with a ``u32`` count. With bit 31 set (format 2) the
count is followed by a bitmap of ``ceil(N / 8)`` bytes naming the signers as
seats (seat ``i`` is the ``i``-th key in byte order, bit ``i % 8`` of byte
``i // 8``; its population count equals the count, and no bit names a seat
``>= N``) and by the records in ascending seat order. Without it (format
1) each record carries its signer's 32-byte key first.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
_V2 = 0x8000_0000
MAX_LEN = 64 * 1024 * 1024
TAG_PROPOSE = 0


class WireError(ValueError):
    """The frame is not a well-formed proposal."""


@dataclass
class Cert:
    """A decoded certificate: the signers' keys, their signature records
    (64 bytes, then for a TC the u64 high-QC round) and the exact bytes of
    its vote section, which identify it."""

    round: int
    hash: bytes | None  # the certified block (QC only)
    signers: list[bytes]
    records: list[bytes]
    seats: list[int] | None  # format 2 only
    raw: bytes


@dataclass
class Proposal:
    qc: Cert
    tc: Cert | None
    author: bytes
    round: int
    payload: list[bytes]
    signature: bytes


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes) -> None:
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.buf):
            raise WireError(f"short frame: {n} bytes wanted at {self.pos}")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u32(self) -> int:
        return _U32.unpack(self.take(4))[0]

    def u64(self) -> int:
        return _U64.unpack(self.take(8))[0]


def _votes(rd: _Reader, keys: list[bytes], rec: int):
    start = rd.pos
    count = rd.u32()
    if count & _V2:
        count &= ~_V2
        if count > len(keys):
            raise WireError(f"vote count {count} exceeds the committee")
        bitmap = rd.take((len(keys) + 7) // 8)
        seats = [i for i in range(len(bitmap) * 8) if bitmap[i >> 3] >> (i & 7) & 1]
        if seats and seats[-1] >= len(keys):
            raise WireError(f"bitmap names seat {seats[-1]}")
        if len(seats) != count:
            raise WireError("bitmap population differs from the count")
        records = [rd.take(rec) for _ in range(count)]
        signers = [keys[s] for s in seats]
    else:
        if count > MAX_LEN:
            raise WireError("vote count over the length limit")
        seats = None
        signers, records = [], []
        for _ in range(count):
            signers.append(rd.take(32))
            records.append(rd.take(rec))
    return signers, records, seats, rd.buf[start : rd.pos]


def decode_proposal(frame: bytes, keys: list[bytes]) -> Proposal:
    """The proposal a frame carries; ``keys`` are the committee's keys in
    byte order (the seats). Raises ``WireError``."""
    rd = _Reader(frame)
    if rd.u8() != TAG_PROPOSE:
        raise WireError("not a proposal")
    qc_hash = rd.take(32)
    qc_round = rd.u64()
    qc = Cert(qc_round, qc_hash, *_votes(rd, keys, 64))
    tag = rd.u8()
    if tag not in (0, 1):
        raise WireError(f"bad option tag {tag}")
    tc = None
    if tag:
        tc_round = rd.u64()
        tc = Cert(tc_round, None, *_votes(rd, keys, 72))
    author = rd.take(32)
    rnd = rd.u64()
    n = rd.u32()
    if n > MAX_LEN:
        raise WireError("payload count over the length limit")
    payload = [rd.take(32) for _ in range(n)]
    signature = rd.take(64)
    if rd.pos != len(frame):
        raise WireError("trailing bytes")
    return Proposal(qc, tc, author, rnd, payload, signature)
