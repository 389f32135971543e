"""The plain verdict of each proposal, worked out from its frame alone.

The rules, in the order a validator applies them to a received proposal:

1. the frame decodes (``wire.decode_proposal``), else ``malformed``;
2. the author holds stake, else ``UnknownAuthority``;
3. the author's signature over the block digest passes the strict single
   check, else ``InvalidSignature``; the block digest is the first 32 bytes
   of SHA-512(author | u64 round | payload digests | QC block hash);
4. unless the QC is the genesis QC (zero hash, round 0): its signers are
   distinct members, else ``AuthorityReuse`` / ``UnknownAuthority``; their
   stake reaches the quorum 2S/3 + 1 of the total stake S, else
   ``QCRequiresQuorum``; the votes pass the cofactored batch check over
   the QC digest SHA-512(block hash | u64 round)[:32], else
   ``InvalidSignature``;
5. a TC, when present, as the QC, with ``TCRequiresQuorum``, each vote over
   SHA-512(u64 TC round | u64 its high-QC round)[:32];
6. else ``accept``.

Each distinct certificate is judged once (its verdict is a function of its
bytes and the committee), the authors' signatures together
(``ed25519.verify_strict_many``). ``sigs_sent`` counts the certificate
signatures that rules 4-5 hand to a batch check before the first failure:
what a validator's batch backend is asked to verify.
"""

from __future__ import annotations

import hashlib
import random
import struct
from dataclasses import dataclass

from . import ed25519
from .wire import WireError, decode_proposal

_U64 = struct.Struct("<Q")
ACCEPT = "accept"
MALFORMED = "malformed"


def digest32(*chunks: bytes) -> bytes:
    h = hashlib.sha512()
    for c in chunks:
        h.update(c)
    return h.digest()[:32]


def block_digest(author: bytes, rnd: int, payload, qc_hash: bytes) -> bytes:
    return digest32(author, _U64.pack(rnd), *payload, qc_hash)


def qc_digest(block_hash: bytes, rnd: int) -> bytes:
    return digest32(block_hash, _U64.pack(rnd))


def tc_vote_digest(tc_round: int, high_qc_round: int) -> bytes:
    return digest32(_U64.pack(tc_round), _U64.pack(high_qc_round))


@dataclass
class Committee:
    """Keys in byte order (the seats) and their stakes."""

    keys: list[bytes]
    stakes: dict[bytes, int]

    @property
    def quorum(self) -> int:
        return 2 * sum(self.stakes.values()) // 3 + 1


@dataclass
class Verdict:
    verdict: str
    sigs_sent: int
    digest: bytes | None  # the block digest, when the frame decoded
    fields: tuple | None  # (qc round, qc votes, tc round or None, tc votes)


class Judge:
    """Judges frames against one committee; ``seed`` draws the batch
    checks' coefficients."""

    def __init__(self, committee: Committee, seed: int) -> None:
        self.committee = committee
        self.rng = random.Random(f"perfbench-reference:{seed}")
        self.keys = ed25519.KeyTable()
        self._certs: dict[tuple, bool] = {}

    def _cert_stake(self, cert, reason_quorum: str) -> str | None:
        stakes = self.committee.stakes
        used = set()
        weight = 0
        for pk in cert.signers:
            if pk in used:
                return "AuthorityReuse"
            used.add(pk)
            stake = stakes.get(pk, 0)
            if stake == 0:
                return "UnknownAuthority"
            weight += stake
        return None if weight >= self.committee.quorum else reason_quorum

    def _cert_ok(self, kind: str, cert) -> bool:
        key = (kind, cert.round, cert.hash, cert.raw)
        ok = self._certs.get(key)
        if ok is None:
            if kind == "qc":
                msgs = [qc_digest(cert.hash, cert.round)] * len(cert.records)
            else:
                msgs = [tc_vote_digest(cert.round, _U64.unpack_from(r, 64)[0]) for r in cert.records]
            sigs = [r[:64] for r in cert.records]
            ok = ed25519.verify_batch_cofactored(msgs, cert.signers, sigs, self.rng, self.keys)
            self._certs[key] = ok
        return ok

    def judge(self, frames) -> list[Verdict]:
        """The verdict of each frame, in order."""
        decoded = []
        for frame in frames:
            try:
                decoded.append(decode_proposal(frame, self.committee.keys))
            except WireError:
                decoded.append(None)
        # Authors first, all together: only a member's signature is checked.
        stakes = self.committee.stakes
        items, where = [], []
        for i, p in enumerate(decoded):
            if p is not None and stakes.get(p.author, 0) > 0:
                items.append((p.author, block_digest(p.author, p.round, p.payload, p.qc.hash), p.signature))
                where.append(i)
        author_ok = dict(zip(where, ed25519.verify_strict_many(items, self.rng, self.keys)))
        digests = dict(zip(where, (msg for _, msg, _ in items)))
        out = []
        for i, p in enumerate(decoded):
            if p is None:
                out.append(Verdict(MALFORMED, 0, None, None))
                continue
            digest = digests.get(i) or block_digest(p.author, p.round, p.payload, p.qc.hash)
            fields = (
                p.qc.round, len(p.qc.records),
                p.tc.round if p.tc is not None else None,
                len(p.tc.records) if p.tc is not None else 0,
            )
            verdict, sent = self._rules(p, author_ok.get(i))
            out.append(Verdict(verdict, sent, digest, fields))
        return out

    def _rules(self, p, author_ok) -> tuple[str, int]:
        if author_ok is None:
            return "UnknownAuthority", 0
        if not author_ok:
            return "InvalidSignature", 0
        sent = 0
        if not (p.qc.hash == bytes(32) and p.qc.round == 0):
            bad = self._cert_stake(p.qc, "QCRequiresQuorum")
            if bad:
                return bad, sent
            sent += len(p.qc.records)
            if not self._cert_ok("qc", p.qc):
                return "InvalidSignature", sent
        if p.tc is not None:
            bad = self._cert_stake(p.tc, "TCRequiresQuorum")
            if bad:
                return bad, sent
            sent += len(p.tc.records)
            if not self._cert_ok("tc", p.tc):
                return "InvalidSignature", sent
        return ACCEPT, sent
