"""The port's wire codec against the JAX package's, on the CPU.

The same objects, built in each package from the same key seeds (Ed25519
signing is deterministic, so the signatures are the same bytes), must
encode to the same bytes in v1 and v2; a frame that one package encodes
must decode in the other and re-encode to itself; the malformed frames of
``tests/test_wire_v2.py`` must raise the same error class in both; and the
seat tables must agree. Tolerance: the same bytes, the same error class.

``PKGS``, ``World`` and the frame makers are shared with ``test_torch_certs.py``.
"""

import random
import struct
from types import SimpleNamespace

import pytest

import hotstuff_tpu.consensus.aggregator as j_aggregator
import hotstuff_tpu.consensus.cert_arena as j_cert_arena
import hotstuff_tpu.consensus.config as j_config
import hotstuff_tpu.consensus.decode_arena as j_decode_arena
import hotstuff_tpu.consensus.errors as j_errors
import hotstuff_tpu.consensus.messages as j_messages
import hotstuff_tpu.crypto as j_crypto
import hotstuff_tpu.crypto.batching as j_batching
import hotstuff_tpu.utils.serde as j_serde
import hotstuff_tpu_torch.consensus.aggregator as t_aggregator
import hotstuff_tpu_torch.consensus.cert_arena as t_cert_arena
import hotstuff_tpu_torch.consensus.config as t_config
import hotstuff_tpu_torch.consensus.decode_arena as t_decode_arena
import hotstuff_tpu_torch.consensus.errors as t_errors
import hotstuff_tpu_torch.consensus.messages as t_messages
import hotstuff_tpu_torch.crypto as t_crypto
import hotstuff_tpu_torch.crypto.batching as t_batching
import hotstuff_tpu_torch.utils.serde as t_serde

_U64 = struct.Struct("<Q")

PKGS = {
    "port": SimpleNamespace(
        name="port", crypto=t_crypto, messages=t_messages, config=t_config, errors=t_errors,
        serde=t_serde, cert_arena=t_cert_arena, decode_arena=t_decode_arena,
        aggregator=t_aggregator, batching=t_batching,
    ),
    "reference": SimpleNamespace(
        name="reference", crypto=j_crypto, messages=j_messages, config=j_config, errors=j_errors,
        serde=j_serde, cert_arena=j_cert_arena, decode_arena=j_decode_arena,
        aggregator=j_aggregator, batching=j_batching,
    ),
}


class World:
    """One committee of ``n`` seeded keys in one package, and makers of
    its messages. Signers are given by key index, in the order given (the
    aggregation order a v1 encoding keeps)."""

    def __init__(self, pkg, n: int = 7, seed: int = 0, stake: int = 1) -> None:
        rng = random.Random(seed)
        self.pkg = pkg
        self.seeds = [rng.randbytes(32) for _ in range(n)]
        self.keys = [pkg.crypto.generate_keypair(seed=s) for s in self.seeds]
        cfg = pkg.config
        self.committee = cfg.Committee(
            {pk: cfg.Authority(stake, ("127.0.0.1", 0)) for pk, _ in self.keys}
        )
        self.seats = pkg.messages.SeatTable.for_committee(self.committee)
        self.quorum = self.committee.quorum_threshold()

    def seat_ordered(self, signers) -> list[int]:
        """Key indices sorted by seat: the order of a v2 decode, in which a
        v1 copy shares the v2 copy's canonical key."""
        return sorted(signers, key=lambda i: self.seats.index[self.keys[i][0]])

    def digest(self, *chunks: bytes):
        return self.pkg.crypto.sha512_digest(*chunks)

    def qc(self, round_: int = 3, signers=None, block_hash: bytes = b"block"):
        m = self.pkg.messages
        signers = list(range(self.quorum)) if signers is None else signers
        qc = m.QC(hash=self.digest(block_hash, _U64.pack(round_)), round=round_, votes=[])
        qc.votes = [
            (self.keys[i][0], self.pkg.crypto.Signature.new(qc.digest(), self.keys[i][1]))
            for i in signers
        ]
        return qc

    def tc(self, round_: int = 5, signers=None, hqc_rounds=None):
        """A TC whose voter ``i`` carries ``hqc_rounds[i]`` (default: rounds
        spread over 1..3)."""
        signers = list(range(self.quorum)) if signers is None else signers
        if hqc_rounds is None:
            hqc_rounds = [1 + j % 3 for j in range(len(signers))]
        sig = self.pkg.crypto.Signature
        votes = [
            (self.keys[i][0], sig.new(self.digest(_U64.pack(round_), _U64.pack(r)), self.keys[i][1]), r)
            for i, r in zip(signers, hqc_rounds)
        ]
        return self.pkg.messages.TC(round=round_, votes=votes)

    def block(self, qc=None, tc=None, round_: int = 4, author: int = 1, payload=(b"p0", b"p1")):
        m = self.pkg.messages
        qc = self.qc(round_ - 1) if qc is None else qc
        pk, sk = self.keys[author]
        return m.Block.new_from_key(qc, tc, pk, round_, [self.digest(p) for p in payload], sk)

    def timeout(self, high_qc=None, round_: int = 5, author: int = 2):
        high_qc = self.qc(2) if high_qc is None else high_qc
        pk, sk = self.keys[author]
        return self.pkg.messages.Timeout.new_from_key(high_qc, round_, pk, sk)

    def vote(self, round_: int = 3, author: int = 0):
        pk, sk = self.keys[author]
        return self.pkg.messages.Vote.new_from_key(self.digest(b"block", _U64.pack(round_)), round_, pk, sk)


def build_frame(world: World, name: str) -> bytes:
    """The frame ``name`` of ``world``'s package (see ``FRAMES``)."""
    m = world.pkg.messages
    shuffled = [4, 0, 6, 2, 5]  # arrival order differs from seat order
    if name == "propose_v1":
        return m.encode_propose(world.block(qc=world.qc(3, signers=shuffled)))
    if name == "propose_v2":
        return m.encode_propose(world.block(qc=world.qc(3, signers=shuffled)), world.seats)
    if name == "propose_v2_with_tc":
        return m.encode_propose(world.block(tc=world.tc(3, signers=shuffled)), world.seats)
    if name == "propose_genesis_qc_v2":
        return m.encode_propose(world.block(qc=m.QC.genesis(), round_=1), world.seats)
    if name == "timeout_v1":
        return m.encode_timeout(world.timeout())
    if name == "timeout_v2":
        return m.encode_timeout(world.timeout(), world.seats)
    if name == "tc_v1":
        return m.encode_tc(world.tc(signers=shuffled))
    if name == "tc_v2":
        return m.encode_tc(world.tc(signers=shuffled), world.seats)
    if name == "vote":
        return m.encode_vote(world.vote())
    if name == "sync_request":
        return m.encode_sync_request(world.digest(b"missing"), world.keys[3][0])
    if name == "state_request":
        return m.encode_state_request(17, world.keys[3][0])
    if name == "state_response":
        return m.encode_state_response(9, world.digest(b"frontier"), b"snapshot-record")
    if name == "state_response_empty":
        return m.encode_state_response(9, world.digest(b"frontier"), None)
    raise ValueError(name)


FRAMES = [
    "propose_v1", "propose_v2", "propose_v2_with_tc", "propose_genesis_qc_v2", "timeout_v1",
    "timeout_v2", "tc_v1", "tc_v2", "vote", "sync_request", "state_request", "state_response",
    "state_response_empty",
]


def reencode(pkg, kind: str, payload, seats, v2: bool) -> bytes:
    """Encode a decoded ``(kind, payload)`` again, in the frame's format."""
    m = pkg.messages
    seats = seats if v2 else None
    if kind == "propose":
        return m.encode_propose(payload, seats)
    if kind == "timeout":
        return m.encode_timeout(payload, seats)
    if kind == "tc":
        return m.encode_tc(payload, seats)
    if kind == "vote":
        return m.encode_vote(payload)
    if kind == "sync_request":
        return m.encode_sync_request(*payload)
    if kind == "state_request":
        return m.encode_state_request(*payload)
    return m.encode_state_response(*payload)


def outcome(fn) -> str:
    try:
        fn()
    except Exception as e:  # the class name is the verdict compared
        return type(e).__name__
    return "accepted"


@pytest.fixture(scope="module")
def worlds():
    return World(PKGS["port"]), World(PKGS["reference"])


@pytest.mark.parametrize("name", FRAMES)
def test_encoding_byte_identical(worlds, name):
    port, ref = worlds
    assert build_frame(port, name) == build_frame(ref, name)


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
@pytest.mark.parametrize("name", FRAMES)
def test_frames_decode_across_packages_and_back(worlds, name, direction):
    port, ref = worlds
    src, dst = (ref, port) if direction == "reference_to_port" else (port, ref)
    frame = build_frame(src, name)
    kind, payload = dst.pkg.messages.decode_message(frame, dst.seats)
    assert reencode(dst.pkg, kind, payload, dst.seats, v2="v2" in name) == frame


@pytest.mark.parametrize("pkg", list(PKGS))
def test_v2_is_lazy_and_keys_like_v1(pkg):
    """A v2-decoded QC and TC expose their vote count and their cache key
    (the canonical v1 encoding, in seat order) without materializing a
    Signature; the key is the same bytes in both packages."""
    world = World(PKGS[pkg], seed=3)
    m = world.pkg.messages
    block = world.block(qc=world.qc(3, signers=[4, 0, 6, 2, 5]), tc=world.tc(3, signers=[1, 3, 0, 5, 6]))
    _, b2 = m.decode_message(m.encode_propose(block, world.seats), world.seats)
    for cert, seat_sorted in ((b2.qc, world.qc(3, signers=world.seat_ordered([4, 0, 6, 2, 5]))),
                              (b2.tc, None)):
        assert "_raw_votes" in cert.__dict__ and cert.n_votes() == 5
        key = m.CertificateCache.key_of(cert)
        assert "votes" not in cert.__dict__
        enc = world.pkg.serde.Encoder()
        cert.encode(enc)  # materializes: v1 in seat order
        assert key == enc.finish()
        if seat_sorted is not None:
            assert key == m.CertificateCache.key_of(seat_sorted)
    other = World(PKGS["port" if pkg == "reference" else "reference"], seed=3)
    om = other.pkg.messages
    oblock = other.block(qc=other.qc(3, signers=[4, 0, 6, 2, 5]))
    _, ob2 = om.decode_message(om.encode_propose(oblock, other.seats), other.seats)
    assert om.CertificateCache.key_of(ob2.qc) == m.CertificateCache.key_of(b2.qc)


@pytest.mark.parametrize("n", [1, 4, 7, 13, 33, 1000])
def test_seat_table_equal(n):
    tables = []
    for pkg in PKGS.values():
        rng = random.Random(n)
        keys = [pkg.crypto.generate_keypair(seed=rng.randbytes(32))[0] for _ in range(min(n, 40))]
        keys += [pkg.crypto.PublicKey(rng.randbytes(32)) for _ in range(n - len(keys))]
        tables.append(pkg.messages.SeatTable(sorted(keys)))
    port, ref = tables
    assert port.fingerprint == ref.fingerprint
    assert port.nbytes == ref.nbytes == (n + 7) // 8
    assert [k.data for k in port.keys] == [k.data for k in ref.keys]


# The malformed v2 frames of tests/test_wire_v2.py:159-190, and others.
_COUNT_OFF = 1 + 32 + 8  # tag, hash, round
_BITMAP_OFF = _COUNT_OFF + 4


def malformed(world: World, name: str) -> tuple[bytes, object]:
    """(frame, seats) of a malformed case."""
    m = world.pkg.messages
    w2 = bytearray(m.encode_propose(world.block(qc=world.qc(3, signers=[0, 1, 2, 3, 4])), world.seats))
    if name == "popcount_differs_from_count":
        w2[_COUNT_OFF:_COUNT_OFF + 4] = struct.pack("<I", 0x80000000 | 6)
    elif name == "bit_beyond_committee":
        w2[_BITMAP_OFF] = 0x80  # seat 7 of a 7-seat committee
    elif name == "count_beyond_committee":
        w2[_COUNT_OFF:_COUNT_OFF + 4] = struct.pack("<I", 0x80000000 | 9999)
    elif name == "truncated_signatures":
        w2 = w2[: _BITMAP_OFF + 1 + 64 * 3]
    elif name == "v2_without_seat_table":
        return bytes(w2), None
    elif name == "trailing_garbage":
        w2 += b"\x00"
    elif name == "unknown_tag":
        w2[0] = 9
    elif name == "bad_option_tag":
        w2[_BITMAP_OFF + 1 + 64 * 5] = 2  # the block's Option<TC> tag
    elif name == "v1_count_beyond_max_len":
        frame = bytearray(m.encode_tc(world.tc()))
        frame[9:13] = struct.pack("<I", 0x7FFFFFFF)
        return bytes(frame), world.seats
    elif name == "bad_snapshot_flag":
        frame = bytearray(m.encode_state_response(9, world.digest(b"f"), None))
        frame[1] = 2
        return bytes(frame), world.seats
    elif name == "empty":
        return b"", world.seats
    return bytes(w2), world.seats


MALFORMED = {
    "popcount_differs_from_count": "SerdeError",
    "bit_beyond_committee": "SerdeError",
    "count_beyond_committee": "SerdeError",
    "truncated_signatures": "SerdeError",
    "v2_without_seat_table": "SerdeError",
    "trailing_garbage": "SerdeError",
    "unknown_tag": "MalformedMessage",
    "bad_option_tag": "SerdeError",
    "v1_count_beyond_max_len": "SerdeError",
    "bad_snapshot_flag": "MalformedMessage",
    "empty": "SerdeError",
}


@pytest.mark.parametrize("name", list(MALFORMED))
def test_malformed_frames_raise_the_same_error_class(worlds, name):
    got = []
    for world in worlds:
        frame, seats = malformed(world, name)
        got.append(outcome(lambda: world.pkg.messages.decode_message(frame, seats)))
    assert got == [MALFORMED[name]] * 2


@pytest.mark.parametrize("pkg", list(PKGS))
def test_vote_frame_fast_path(pkg):
    world = World(PKGS[pkg])
    m = world.pkg.messages
    frame = m.encode_vote(world.vote())
    assert len(frame) == m.VOTE_WIRE_LEN
    fast, (_, slow) = m.decode_vote_frame(frame), m.decode_message(frame)
    assert (fast.digest(), fast.author, fast.signature) == (slow.digest(), slow.author, slow.signature)
    for bad in (frame[:-1], bytes([m.TAG_TIMEOUT]) + frame[1:]):
        with pytest.raises(world.pkg.errors.MalformedMessage):
            m.decode_vote_frame(bad)


def test_store_format_and_v1_fallback_match_reference(worlds):
    """``serialize()`` of a v2-decoded block is the v1 store encoding, and a
    QC with a signer outside the seat table falls back to v1 — the same
    bytes in both packages."""
    out = []
    for world in worlds:
        m = world.pkg.messages
        block = world.block(qc=world.qc(3, signers=[4, 0, 6, 2, 5]))
        _, b2 = m.decode_message(m.encode_propose(block, world.seats), world.seats)
        restored = m.Block.deserialize(b2.serialize())
        assert restored.digest() == block.digest()
        qc = world.qc(3, signers=[0, 1, 2])
        stranger, sk = world.pkg.crypto.generate_keypair(seed=b"\x55" * 32)
        qc.votes.append((stranger, world.pkg.crypto.Signature.new(qc.digest(), sk)))
        enc = world.pkg.serde.Encoder()
        qc.encode(enc, world.seats)
        out.append((b2.serialize(), enc.finish()))
    assert out[0] == out[1]
    enc = PKGS["port"].serde.Encoder()
    PKGS["port"].messages.QC.genesis().encode(enc, worlds[0].seats)
    assert enc.finish() == bytes(32) + bytes(8) + bytes(4)  # genesis stays v1


def test_decode_shared_returns_one_object(monkeypatch):
    world = World(PKGS["port"])
    da = world.pkg.decode_arena
    monkeypatch.setattr(da, "_ARENA", da.DecodeArena())
    frame = build_frame(world, "propose_v2")
    kind, first = da.decode_shared(frame, world.seats)
    again = da.decode_shared(frame, world.seats)[1]
    assert kind == "propose" and again is first
    assert da.arena().stats()["hits"] == 1
    bad, seats = malformed(world, "truncated_signatures")
    for _ in range(2):  # a failed parse is not cached: it raises every time
        with pytest.raises(world.pkg.serde.SerdeError):
            da.decode_shared(bad, seats)
    vote = build_frame(world, "vote")
    assert da.decode_shared(vote)[1] is not da.decode_shared(vote)[1]  # votes are not cached
    monkeypatch.setattr(da, "_ENABLED", False)
    assert da.decode_shared(frame, world.seats)[1] is not first


def test_intern_table_is_a_bounded_lru():
    m = PKGS["port"].messages
    m._PK_INTERN.clear()
    before = m.intern_evictions
    hot = m._intern_pk(b"\x01" * 32)
    for i in range(m._PK_INTERN_CAP + 100):
        m._intern_pk(i.to_bytes(32, "big"))
        if i % 97 == 0:
            assert m._intern_pk(b"\x01" * 32) is hot
    assert len(m._PK_INTERN) <= m._PK_INTERN_CAP
    assert m.intern_evictions > before
    assert m._intern_pk(b"\x01" * 32) is hot
    m._PK_INTERN.clear()
