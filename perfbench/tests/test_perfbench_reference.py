"""The frozen reference: RFC 8032's test vectors, the batch checks, the
frame decoder and the acceptance rules."""

import random
import struct

from perfbench.reference import ed25519, judge, wire

# RFC 8032 section 7.1: secret key, public key, message, signature.
VECTORS = [
    ("9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
     "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a", "",
     "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e065224901555fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"),
    ("4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb",
     "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c", "72",
     "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00"),
    ("c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7",
     "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025", "af82",
     "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac18ff9b538d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a"),
    ("833fe62409237b9d62ec77587520911e9a759cec1d19755b7da901b96dca3d42",
     "ec172b93ad5e563bf4932c70e1245034c35467ef2efd4d64ebf819683467e2bf",
     "ddaf35a193617abacc417349ae20413112e6fa4e89a97ea20a9eeee64b55d39a2192992a274fc1a836ba3c23a3feebbd454d4423643ce80e2a9ac94fa54ca49f",
     "dc2a4459e7369633a52b1bf277839a00201009a3efbf3ecb69bea2186c26b58909351fc9ac90b3ecfdfbc7c66431e0303dca179c138ac17ad9bef1177331a704"),
]


def _vectors():
    return [tuple(bytes.fromhex(x) for x in v) for v in VECTORS]


def test_rfc8032_sign_and_strict_verify():
    for sk, pk, msg, sig in _vectors():
        a, prefix, pub = ed25519.expand(sk)
        assert pub == pk
        assert ed25519.sign(a, prefix, pub, msg) == sig
        assert ed25519.verify_strict(pk, msg, sig)
        for pos in (3, 40):  # a byte of R, a byte of s
            bad = bytearray(sig)
            bad[pos] ^= 0x10
            assert not ed25519.verify_strict(pk, msg, bytes(bad))
        assert not ed25519.verify_strict(pk, msg + b"x", sig)


def test_strict_rejects_noncanonical_s_and_small_order_r():
    sk, pk, msg, sig = _vectors()[1]
    s = int.from_bytes(sig[32:], "little") + ed25519.L  # same point, s >= L
    assert not ed25519.verify_strict(pk, msg, sig[:32] + s.to_bytes(32, "little"))
    identity = (1).to_bytes(32, "little")
    assert not ed25519.verify_strict(pk, msg, identity + sig[32:])


def test_strict_many_matches_one_by_one():
    vecs = _vectors()
    items = [(pk, msg, sig) for _, pk, msg, sig in vecs]
    bad = bytearray(items[2][2])
    bad[50] ^= 1
    items.append((items[2][0], items[2][1], bytes(bad)))
    items.append((items[0][0], b"other", items[0][2]))
    got = ed25519.verify_strict_many(items, random.Random(1))
    assert got == [ed25519.verify_strict(*i) for i in items] == [True] * 4 + [False] * 2


def test_cofactored_batch_accepts_honest_and_rejects_one_altered_vote():
    rng = random.Random(7)
    keys = [ed25519.expand(rng.randbytes(32)) for _ in range(9)]
    msg = rng.randbytes(32)
    sigs = ed25519.sign_many([(a, p, pub, msg) for a, p, pub in keys])
    pubs = [pub for _, _, pub in keys]
    assert ed25519.verify_batch_cofactored([msg] * 9, pubs, sigs, random.Random(1))
    for pos in (5, 45):
        bad = list(sigs)
        b = bytearray(bad[4])
        b[pos] ^= 0x22
        bad[4] = bytes(b)
        assert not ed25519.verify_batch_cofactored([msg] * 9, pubs, bad, random.Random(1))
    assert not ed25519.verify_batch_cofactored([msg] * 9, pubs[::-1], sigs, random.Random(1))


def test_batch_is_cofactored():
    # A signature whose R carries a torsion component fails the strict
    # check and passes the cofactored batch check, as the port states.
    sk, pk, msg, _ = _vectors()[0]
    a, prefix, _ = ed25519.expand(sk)
    t = ed25519.decompress(bytes.fromhex("26e8958fc2b227b045c3f489f2ef98f0d5dfac05d3c63339b13802886d53fc05"))
    assert t is not None and ed25519.small_order(t)
    r = 12345
    big_r = ed25519.add(ed25519.base_comb().mul(r), t)
    r_enc = ed25519.compress(big_r)
    k = ed25519.sha512_int(r_enc, pk, msg) % ed25519.L
    sig = r_enc + ((r + k * a) % ed25519.L).to_bytes(32, "little")
    assert not ed25519.verify_strict(pk, msg, sig)
    assert ed25519.verify_batch_cofactored([msg], [pk], [sig], random.Random(3))


def _frame(keys, qc_seats, qc_sigs, tc=None, author=b"", rnd=9, payload=(), sig=b"\0" * 64):
    n = len(keys)
    def section(seats, recs):
        bitmap = bytearray((n + 7) // 8)
        for s in seats:
            bitmap[s >> 3] |= 1 << (s & 7)
        return struct.pack("<I", 0x8000_0000 | len(seats)) + bytes(bitmap) + b"".join(recs)
    out = bytes([0]) + b"\x11" * 32 + struct.pack("<Q", 5) + section(qc_seats, qc_sigs)
    if tc is None:
        out += b"\0"
    else:
        out += b"\1" + struct.pack("<Q", 6) + section(*tc)
    out += author + struct.pack("<Q", rnd) + struct.pack("<I", len(payload)) + b"".join(payload) + sig
    return out


def test_wire_decoder_reads_a_hand_built_frame_and_refuses_bad_ones():
    keys = [bytes([i]) * 32 for i in range(10)]
    sigs = [bytes([0xA0 + i]) * 64 for i in range(3)]
    frame = _frame(keys, [1, 4, 9], sigs, tc=([0, 2], [b"\x05" * 72, b"\x06" * 72]),
                   author=keys[3], payload=[b"\x33" * 32])
    p = wire.decode_proposal(frame, keys)
    assert p.qc.hash == b"\x11" * 32 and p.qc.round == 5
    assert p.qc.signers == [keys[1], keys[4], keys[9]] and p.qc.records == sigs
    assert p.tc.round == 6 and p.tc.signers == [keys[0], keys[2]]
    assert p.author == keys[3] and p.round == 9 and p.payload == [b"\x33" * 32]
    for bad in (frame + b"\0", frame[:-1], bytes([1]) + frame[1:]):
        try:
            wire.decode_proposal(bad, keys)
        except wire.WireError:
            continue
        raise AssertionError("a bad frame decoded")
    # A bitmap naming a seat past the committee.
    try:
        wire.decode_proposal(_frame(keys[:9], [1, 4, 9], sigs), keys[:9])
    except wire.WireError:
        pass
    else:
        raise AssertionError("seat 9 of 9 accepted")


def test_judge_applies_the_rules_in_order():
    rng = random.Random(11)
    ex = sorted((ed25519.expand(rng.randbytes(32)) for _ in range(4)), key=lambda e: e[2])
    keys = [e[2] for e in ex]
    committee = judge.Committee(keys, {k: 1 for k in keys})
    assert committee.quorum == 3
    block_hash, qround = rng.randbytes(32), 5
    qmsg = judge.qc_digest(block_hash, qround)
    votes = {s: ed25519.sign(ex[s][0], ex[s][1], keys[s], qmsg) for s in range(4)}

    def frame(seats, author=1, alter=None):
        recs = [votes[s] for s in seats]
        if alter is not None:
            b = bytearray(recs[alter])
            b[2] ^= 1
            recs[alter] = bytes(b)
        digest = judge.block_digest(keys[author], 9, [], block_hash)
        sig = ed25519.sign(ex[author][0], ex[author][1], keys[author], digest)
        f = _frame(keys, seats, recs, author=keys[author], sig=sig)
        return f[:1] + block_hash + f[33:]

    cases = [
        (frame([0, 1, 2]), "accept", 3),
        (frame([0, 1, 3], alter=2), "InvalidSignature", 3),
        (frame([0, 2]), "QCRequiresQuorum", 0),
        (frame([0, 1, 2])[:-1] + bytes([frame([0, 1, 2])[-1] ^ 1]), "InvalidSignature", 0),
        (b"\0\1", "malformed", 0),
    ]
    got = judge.Judge(committee, 1).judge([c[0] for c in cases])
    assert [(v.verdict, v.sigs_sent) for v in got] == [(c[1], c[2]) for c in cases]
