"""Certificate verdicts of the port against the JAX package's, on the CPU.

The verdict matrices of ``tests/test_consensus_messages.py``,
``tests/test_wire_v2.py:192-241`` and ``tests/test_agg_qc.py:229-260,
463-530`` run on both packages with the same keys: QCs and TCs (bare, in a
Block, in a Timeout), materialized, decoded from a v1 frame and decoded
lazily from a v2 frame; valid, bad signature, below quorum, unknown
authority, authority reuse and a foreign committee; the certificate cache,
the cert arena and their kill switches. Each package runs its serial CPU
backend, except the end-to-end cases, where a v2 QC and a TC at N = 10 go
through the port's ``CudaBackend(device="cpu")`` (the kernels' plain
versions). Tolerance: the same outcome and the same error class.
"""

import pytest

from hotstuff_tpu_torch.crypto.cuda_backend import CudaBackend

from .test_torch_wire import PKGS, World, outcome


@pytest.fixture(autouse=True)
def isolate(monkeypatch):
    """Default switches, fresh arenas and each package's CPU backend around
    every test."""
    monkeypatch.delenv("HOTSTUFF_AGG_QC", raising=False)
    monkeypatch.delenv("HOTSTUFF_CERT_ARENA", raising=False)
    for pkg in PKGS.values():
        monkeypatch.setattr(pkg.crypto, "_BACKEND", None)
        pkg.cert_arena.reset()
    PKGS["port"].crypto.set_backend(PKGS["port"].crypto.CpuBackend())
    PKGS["reference"].crypto.set_backend("cpu")
    yield
    for pkg in PKGS.values():
        pkg.cert_arena.reset()


def _flip(data: bytes, pos: int) -> bytes:
    b = bytearray(data)
    b[pos] ^= 0x10
    return bytes(b)


def certificate(world: World, kind: str, variant: str, signers=(4, 0, 6, 2, 5)):
    """A QC or TC of ``world`` with ``variant`` applied to its votes."""
    signers = list(signers)
    cert = world.qc(3, signers=signers) if kind == "qc" else world.tc(5, signers=signers)
    sig_cls = world.pkg.crypto.Signature
    votes = list(cert.votes)
    if variant == "bad_signature":
        v = votes[2]
        votes[2] = (v[0], sig_cls(_flip(v[1].data, 40)), *v[2:])
    elif variant == "below_quorum":
        votes = votes[:-1]
    elif variant == "authority_reuse":
        votes[-1] = votes[0]
    elif variant == "unknown_authority":
        stranger, sk = world.pkg.crypto.generate_keypair(seed=b"\x99" * 32)
        if kind == "qc":
            digest = cert.digest()
        else:
            digest = world.digest(cert.round.to_bytes(8, "little"), votes[-1][2].to_bytes(8, "little"))
        votes[-1] = (stranger, sig_cls.new(digest, sk), *votes[-1][2:])
    cert.votes = votes
    return cert


def wrap(world: World, container: str, cert):
    """(object to verify, its frame kind): the certificate bare, in a Block
    or in a Timeout."""
    if container == "block":
        qc = cert if type(cert).__name__ == "QC" else world.qc(4)
        tc = cert if type(cert).__name__ == "TC" else None
        return world.block(qc=qc, tc=tc, round_=5 if tc is None else 6), "propose"
    if container == "timeout":
        return world.timeout(high_qc=cert, round_=6), "timeout"
    return cert, "tc" if type(cert).__name__ == "TC" else None


def verdict(world: World, kind: str, variant: str, container: str, form: str) -> str:
    m = world.pkg.messages
    obj, frame_kind = wrap(world, container, certificate(world, kind, variant))
    committee = World(world.pkg, seed=99).committee if variant == "foreign_committee" else world.committee

    def run():
        target = obj
        if form != "materialized":
            seats = world.seats if form == "v2" else None
            if frame_kind is None:  # a bare QC travels inside a Block
                block = world.block(qc=obj)
                target = m.decode_message(m.encode_propose(block, seats), world.seats)[1].qc
            else:
                encode = {"propose": m.encode_propose, "timeout": m.encode_timeout, "tc": m.encode_tc}
                target = m.decode_message(encode[frame_kind](obj, seats), world.seats)[1]
        target.verify(committee)

    return outcome(run)


EXPECTED = {
    "valid": "accepted",
    "bad_signature": "InvalidSignature",
    "below_quorum": "{kind}RequiresQuorum",
    "authority_reuse": "AuthorityReuse",
    "unknown_authority": "UnknownAuthority",
    "foreign_committee": "UnknownAuthority",
}


# A Block carries a QC and may carry a TC; a Timeout carries a QC.
HOLDERS = [("qc", "bare"), ("qc", "block"), ("qc", "timeout"), ("tc", "bare"), ("tc", "block")]


@pytest.mark.parametrize("form", ["materialized", "v1", "v2"])
@pytest.mark.parametrize("variant", list(EXPECTED))
@pytest.mark.parametrize("kind,container", HOLDERS)
def test_verdict_matrix_equals_reference(kind, container, variant, form):
    got = [verdict(World(pkg), kind, variant, container, form) for pkg in PKGS.values()]
    want = EXPECTED[variant].format(kind=kind.upper())
    if variant == "authority_reuse" and form == "v2":
        want = "SerdeError"  # a seat bitmap cannot name a seat twice: the count disagrees
    assert got == [want, want]


@pytest.mark.parametrize("pkg", list(PKGS))
def test_block_and_timeout_signatures(pkg):
    world = World(PKGS[pkg])
    sig_cls = world.pkg.crypto.Signature
    block = world.block()
    block.signature = sig_cls(bytes(64))
    timeout = world.timeout()
    timeout.round += 1  # the signature no longer covers it
    stranger, sk = world.pkg.crypto.generate_keypair(seed=b"\x42" * 32)
    foreign = world.pkg.messages.Timeout.new_from_key(world.qc(2), 5, stranger, sk)
    got = [outcome(lambda: x.verify(world.committee)) for x in (block, timeout, foreign)]
    assert got == ["InvalidSignature", "InvalidSignature", "UnknownAuthority"]
    genesis = world.pkg.messages.Timeout.new_from_key(world.pkg.messages.QC.genesis(), 3, *world.keys[0])
    genesis.verify(world.committee)  # a genesis high QC is not verified


def recording(pkg, fused: bool = True):
    """A CPU backend of ``pkg`` that counts its batch and fused-cert calls,
    and fails the test on any call once ``closed``."""

    class Recording(pkg.crypto.CpuBackend):
        def __init__(self):
            super().__init__()
            self.batch_calls = self.cert_calls = 0
            self.closed = False

        def verify_batch(self, msgs, pubs, sigs):
            assert not self.closed, "verified again"
            self.batch_calls += 1
            super().verify_batch(msgs, pubs, sigs)

        def verify_cert(self, msgs, pubs, sig_buf, stride=64, key=None):
            assert not self.closed, "verified again"
            self.cert_calls += 1
            super().verify_cert(msgs, pubs, sig_buf, stride, key=key)

    if not fused:
        Recording.verify_cert = None
    backend = Recording()
    pkg.crypto.set_backend(backend)
    return backend


def decoded(world: World, cert, v2: bool):
    m = world.pkg.messages
    seats = world.seats if v2 else None
    if type(cert).__name__ == "TC":
        return m.decode_message(m.encode_tc(cert, seats), world.seats)[1]
    return m.decode_message(m.encode_propose(world.block(qc=cert), seats), world.seats)[1].qc


@pytest.mark.parametrize("kind", ["qc", "tc"])
@pytest.mark.parametrize("pkg", list(PKGS))
def test_certificate_cache_hits_and_never_caches_failures(pkg, kind, monkeypatch):
    """With the arena off: a cert that verified is a cache hit for its v2
    and its v1 copy (one canonical key when the v1 votes are in seat
    order); a failed cert is never cached."""
    monkeypatch.setenv("HOTSTUFF_CERT_ARENA", "0")
    world = World(PKGS[pkg])
    m = world.pkg.messages
    cert = certificate(world, kind, "valid", signers=world.seat_ordered(range(5)))
    bad = decoded(world, certificate(world, kind, "bad_signature"), v2=True)
    cache = m.CertificateCache()
    for _ in range(2):
        with pytest.raises(world.pkg.errors.InvalidSignature):
            bad.verify(world.committee, cache)
    assert not cache.hit(m.CertificateCache.key_of(bad))
    backend = recording(world.pkg)
    decoded(world, cert, v2=True).verify(world.committee, cache)
    assert backend.batch_calls + backend.cert_calls == 1
    backend.closed = True
    decoded(world, cert, v2=True).verify(world.committee, cache)
    decoded(world, cert, v2=False).verify(world.committee, cache)
    cert.verify(world.committee, cache)


@pytest.mark.parametrize("pkg", list(PKGS))
def test_v1_and_v2_share_arena_identity(pkg):
    world = World(PKGS[pkg], n=4, seed=112)
    qc = world.qc(3, signers=world.seat_ordered(range(world.quorum)))
    b1, b2 = decoded(world, qc, v2=False), decoded(world, qc, v2=True)
    m = world.pkg.messages
    assert m.CertificateCache.key_of(b1) == m.CertificateCache.key_of(b2)
    backend = recording(world.pkg)
    b2.verify(world.committee)  # miss: pays the verify
    b1.verify(world.committee)  # arena hit through the shared canonical key
    arena = world.pkg.cert_arena.get_arena()
    assert (arena.hits, arena.misses) == (1, 1)
    assert backend.cert_calls + backend.batch_calls == 1


@pytest.mark.parametrize("pkg", list(PKGS))
def test_arena_kill_switch(pkg, monkeypatch):
    monkeypatch.setenv("HOTSTUFF_CERT_ARENA", "0")
    PKGS[pkg].cert_arena.reset()
    assert PKGS[pkg].cert_arena.get_arena() is None


@pytest.mark.parametrize("pkg", list(PKGS))
def test_arena_never_caches_failures(pkg):
    world = World(PKGS[pkg], n=4, seed=113)
    bad = decoded(world, certificate(world, "qc", "bad_signature", signers=[3, 1, 0]), v2=True)
    for _ in range(2):
        with pytest.raises(world.pkg.errors.InvalidSignature):
            bad.verify(world.committee)
    arena = world.pkg.cert_arena.get_arena()
    assert (arena.hits, arena.misses) == (0, 2)


@pytest.mark.parametrize("pkg", list(PKGS))
def test_arena_isolates_committees(pkg):
    world = World(PKGS[pkg], n=4, seed=114)
    heavier = World(PKGS[pkg], n=4, seed=114, stake=2)
    fp = world.pkg.cert_arena.committee_fp
    assert fp(world.committee) != fp(heavier.committee)
    qc = decoded(world, world.qc(3), v2=True)
    backend = recording(world.pkg)
    qc.verify(world.committee)
    qc.verify(heavier.committee)  # another committee pays its own verify
    assert backend.cert_calls + backend.batch_calls == 2


def test_cert_arena_fingerprint_equal():
    port, ref = World(PKGS["port"], seed=5), World(PKGS["reference"], seed=5)
    assert port.pkg.cert_arena.committee_fp(port.committee) == ref.pkg.cert_arena.committee_fp(
        ref.committee
    )


@pytest.mark.parametrize("path", ["fused", "agg_qc_off", "no_fused_entry"])
@pytest.mark.parametrize("pkg", list(PKGS))
def test_backend_verify_cert_dispatch(pkg, path, monkeypatch):
    """``backend_verify_cert`` takes the backend's fused entry by default and
    explodes the cert into ``verify_batch`` with ``HOTSTUFF_AGG_QC=0`` or
    without a fused entry; a corrupted record is rejected either way."""
    world = World(PKGS[pkg], n=4, seed=106)
    crypto = world.pkg.crypto
    if path == "agg_qc_off":
        monkeypatch.setenv("HOTSTUFF_AGG_QC", "0")
    backend = recording(world.pkg, fused=path != "no_fused_entry")
    tc = world.tc(5, signers=[0, 1, 2])
    msgs = [world.digest(b"\x05" + bytes(7), r.to_bytes(8, "little")).data for _, _, r in tc.votes]
    pubs = [pk.data for pk, _, _ in tc.votes]
    buf = b"".join(s.data + r.to_bytes(8, "little") for _, s, r in tc.votes)
    crypto.backend_verify_cert(msgs, pubs, buf, 72)
    assert (backend.cert_calls, backend.batch_calls) == ((1, 0) if path == "fused" else (0, 1))
    with pytest.raises(crypto.CryptoError):
        crypto.backend_verify_cert(msgs, pubs, _flip(buf, 72 + 10), 72)


@pytest.mark.parametrize("pkg", list(PKGS))
def test_timeouts_with_a_shared_cache_verify_their_high_qc_once(pkg, monkeypatch):
    monkeypatch.setenv("HOTSTUFF_CERT_ARENA", "0")
    world = World(PKGS[pkg])
    m = world.pkg.messages
    backend = recording(world.pkg)
    high_qc = world.qc(2)
    cache = m.CertificateCache()
    for author in range(world.quorum):
        frame = m.encode_timeout(world.timeout(high_qc=high_qc, author=author), world.seats)
        m.decode_message(frame, world.seats)[1].verify(world.committee, cache)
    assert backend.cert_calls + backend.batch_calls == 1


@pytest.mark.parametrize("pkg", list(PKGS))
def test_aggregator_timeouts_make_one_tc(pkg):
    """``add_timeout`` emits the TC once, at the quorum, with each voter's
    high QC round; authority reuse raises; ``cleanup`` drops old rounds."""
    world = World(PKGS[pkg])
    agg = world.pkg.aggregator.Aggregator(world.committee)
    qcs = {r: world.qc(r) for r in (1, 2, 3)}
    out = [agg.add_timeout(world.timeout(high_qc=qcs[1 + i % 3], author=i)) for i in range(7)]
    assert [o is not None for o in out] == [False] * 4 + [True, False, False]
    tc = out[4]
    assert tc.round == 5 and tc.high_qc_rounds() == [1, 2, 3, 1, 2]
    tc.verify(world.committee)
    with pytest.raises(world.pkg.errors.AuthorityReuse):
        agg.add_timeout(world.timeout(high_qc=qcs[1], author=0))
    agg.add_vote(world.vote(round_=5))
    agg.cleanup(6)
    assert not agg.timeouts_aggregators and not agg.votes_aggregators


def test_aggregator_vote_repair_equals_reference():
    """``reseat_vote``, ``replace_vote``, ``stored_signature`` and
    ``eject_votes`` leave the same makers in both packages."""
    states = []
    for pkg in PKGS.values():
        world = World(pkg)
        agg = pkg.aggregator.Aggregator(world.committee)
        votes = [world.vote(author=i) for i in range(4)]
        for v in votes:
            assert agg.add_vote(v) is None
        digest = votes[0].digest()
        spoof = pkg.messages.Vote(votes[1].hash, 3, votes[1].author, pkg.crypto.Signature(bytes(64)))
        agg.replace_vote(spoof)
        stored = agg.stored_signature(3, digest, votes[1].author)
        qc, ejected = agg.eject_votes(3, digest, [(spoof.author, spoof.signature)], votes[0].hash)
        assert qc is None and ejected == {spoof.author}
        assert agg.reseat_vote(votes[1]) is None
        qc = agg.reseat_vote(world.vote(author=4))
        states.append((stored.data, [(pk.data, s.data) for pk, s in qc.votes]))
    assert states[0] == states[1]


def _end_to_end(world: World, kind: str, tampered: bool) -> str:
    m = world.pkg.messages
    if kind == "qc":
        frame = m.encode_propose(world.block(qc=world.qc(3)), world.seats)
        buf, rec = 1 + 32 + 8 + 4 + world.seats.nbytes, 64  # tag, hash, round, count, bitmap
    else:
        frame = m.encode_tc(world.tc(5), world.seats)
        buf, rec = 1 + 8 + 4 + world.seats.nbytes, 72  # tag, round, count, bitmap
    if tampered:  # inside the R of the second signature of the packed buffer
        frame = _flip(frame, buf + rec + 5)
    decoded_msg = m.decode_message(frame, world.seats)[1]
    target = decoded_msg if kind == "tc" else decoded_msg.qc
    assert "_raw_votes" in target.__dict__
    return outcome(lambda: target.verify(world.committee))


@pytest.mark.parametrize("tampered", [False, True])
@pytest.mark.parametrize("kind", ["qc", "tc"])
def test_v2_certificate_end_to_end_through_the_cuda_backend_on_cpu(kind, tampered, monkeypatch):
    """N = 10: a v2 QC and a TC whose voters carry high QC rounds 1..3,
    decoded lazily and verified by the port's ``CudaBackend`` on the CPU
    (plain kernels) and by the reference's CPU backend."""
    port, ref = World(PKGS["port"], n=10, seed=7), World(PKGS["reference"], n=10, seed=7)
    backend = CudaBackend(device="cpu")
    port.pkg.crypto.set_backend(backend)
    got = [_end_to_end(port, kind, tampered), _end_to_end(ref, kind, tampered)]
    assert got == ["InvalidSignature" if tampered else "accepted"] * 2
    assert (backend.dispatches, backend.sigs) == (1, 7)
