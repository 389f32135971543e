"""The port's CPU batch verifier and the ``CpuBackend`` it serves, held
against the reference.

- The ``cpu_batch`` and native cases of ``tests/test_agg_qc.py``, twinned:
  the fused certificate check (``verify_cert_rlc``, ``verify_cert_native``)
  and its deterministic coefficients (``cert_rlc_coefficients``) give the
  reference's coefficients and verdicts on the same packed certificates.
- ``CpuBackend``'s RLC engine: a batch of 40 signatures with torsioned R
  (cofactored-valid, strictly invalid) is accepted by the port's
  ``CpuBackend()`` as by the reference's once its engine is built; under
  ``use_rlc=False`` both reject it once the re-check bucket is empty. A
  packed certificate goes through one fused RLC.
- Without ``cryptography``: signing and the strict single check on the
  native engine (``_scalarmult_base``, ``_verify_single_gated`` and its
  fuser) give the reference's signatures and verdicts.

Tolerance: exact (equal coefficients, bytes and verdicts).
"""

import random
import shutil

import pytest

import hotstuff_tpu.crypto as j_crypto
import hotstuff_tpu_torch.crypto as t_crypto
from hotstuff_tpu.crypto import cpu_batch as j_cpu_batch
from hotstuff_tpu.crypto import ed25519_ref as ref
from hotstuff_tpu.crypto import native_ed25519 as j_native
from hotstuff_tpu_torch.crypto import cpu_batch as t_cpu_batch
from hotstuff_tpu_torch.crypto import native_ed25519 as t_native

PKGS = {"port": (t_crypto, t_cpu_batch, t_native), "reference": (j_crypto, j_cpu_batch, j_native)}


@pytest.fixture(autouse=True)
def built():
    if shutil.which("g++") is None:
        pytest.skip("g++ toolchain unavailable")
    assert t_native.native_available() and j_native.native_available()


def packed_cert(n, rng, stride=64, shared=True):
    """A valid packed cert (``tests/test_agg_qc.py``'s ``_packed_cert``):
    n keys, a signature per record at ``stride``; ``shared`` signs one
    statement (a QC), else per-seat statements bind each record's tail."""
    seeds = [rng.randbytes(32) for _ in range(n)]
    pubs = [ref.secret_to_public(s) for s in seeds]
    if shared:
        msg = rng.randbytes(32)
        return msg, pubs, b"".join(ref.sign(s, msg) + rng.randbytes(stride - 64) for s in seeds)
    msgs, recs = [], []
    for s in seeds:
        extra = rng.randbytes(stride - 64)
        m = t_crypto.sha512_digest(rng.randbytes(8), extra).data
        msgs.append(m)
        recs.append(ref.sign(s, m) + extra)
    return msgs, pubs, b"".join(recs)


def corrupt(buf, pos):
    b = bytearray(buf)
    b[pos] ^= 0x01
    return bytes(b)


@pytest.mark.parametrize("stride,shared", [(64, True), (72, False)])
def test_rlc_reference_accepts_valid_cert(stride, shared):
    rng = random.Random(101)
    for n in (1, 4, 7):
        msgs, pubs, buf = packed_cert(n, rng, stride=stride, shared=shared)
        assert t_cpu_batch.verify_cert_rlc(msgs, pubs, buf, stride=stride)
        assert j_cpu_batch.verify_cert_rlc(msgs, pubs, buf, stride=stride)


@pytest.mark.parametrize("stride,shared", [(64, True), (72, False)])
def test_rlc_reference_rejects_any_corrupted_slice(stride, shared):
    rng = random.Random(102)
    n = 5
    msgs, pubs, buf = packed_cert(n, rng, stride=stride, shared=shared)
    for seat in range(n):
        bad = corrupt(buf, seat * stride + rng.randrange(64))
        assert not t_cpu_batch.verify_cert_rlc(msgs, pubs, bad, stride=stride)
        assert not j_cpu_batch.verify_cert_rlc(msgs, pubs, bad, stride=stride)


def test_rlc_coefficients_deterministic_content_bound_and_the_references():
    rng = random.Random(103)
    msg, pubs, buf = packed_cert(4, rng)
    a = t_cpu_batch.cert_rlc_coefficients(msg, pubs, buf, 64, 4)
    assert a == t_cpu_batch.cert_rlc_coefficients(msg, pubs, buf, 64, 4)
    assert a == j_cpu_batch.cert_rlc_coefficients(msg, pubs, buf, 64, 4)
    assert all(z >> 127 == 1 for z in a)
    assert a != t_cpu_batch.cert_rlc_coefficients(msg, pubs, corrupt(buf, 0), 64, 4)
    assert a != t_cpu_batch.cert_rlc_coefficients(corrupt(msg, 0), pubs, buf, 64, 4)
    msgs, pubs, buf = packed_cert(3, rng, stride=72, shared=False)
    assert (t_cpu_batch.cert_rlc_coefficients(msgs, pubs, buf, 72, 3)
            == j_cpu_batch.cert_rlc_coefficients(msgs, pubs, buf, 72, 3))


@pytest.mark.parametrize("stride,shared", [(64, True), (72, False)])
def test_native_fused_matches_pure_reference(stride, shared):
    """The verdict matrix (valid, one corrupted byte anywhere, a short
    buffer, a non-canonical s) is the same for the port's and the
    reference's native and pure-Python fused checks."""
    rng = random.Random(104)
    for n in (1, 3, 8):
        msgs, pubs, buf = packed_cert(n, rng, stride=stride, shared=shared)
        seat = rng.randrange(n)
        s = int.from_bytes(buf[seat * stride + 32:seat * stride + 64], "little") + ref.L
        high_s = bytearray(buf)
        high_s[seat * stride + 32:seat * stride + 64] = s.to_bytes(32, "little")
        matrix = [(buf, True), (corrupt(buf, seat * stride + rng.randrange(64)), False),
                  (buf[:-1 - (stride - 64)], False), (bytes(high_s), False)]
        for cert, want in matrix:
            got = [t_native.verify_cert_native(msgs, pubs, cert, stride=stride),
                   j_native.verify_cert_native(msgs, pubs, cert, stride=stride),
                   t_cpu_batch.verify_cert_rlc(msgs, pubs, cert, stride=stride),
                   j_cpu_batch.verify_cert_rlc(msgs, pubs, cert, stride=stride)]
            assert got == [want] * 4, (n, want)


def test_native_challenge_hashing_matches_hashlib():
    import ctypes
    import hashlib

    lib = t_native._load()
    rng = random.Random(105)
    for n, stride in ((1, 64), (5, 64), (3, 72)):
        msg = rng.randbytes(32)
        pubs = rng.randbytes(32 * n)
        sigs = rng.randbytes(stride * n)
        out = ctypes.create_string_buffer(64 * n)
        assert lib.hs_ed25519_cert_challenges(msg, len(msg), pubs, sigs, stride, n, out) == 1
        for i in range(n):
            want = hashlib.sha512(sigs[i * stride:i * stride + 32]
                                  + pubs[i * 32:(i + 1) * 32] + msg).digest()
            assert out.raw[i * 64:(i + 1) * 64] == want


def test_best_verify_batch_is_the_native_engine():
    assert t_cpu_batch.best_verify_batch() is t_native.verify_batch_native
    assert j_cpu_batch.best_verify_batch() is j_native.verify_batch_native


# -- CpuBackend: the RLC engine (F8) -------------------------------------------


def torsioned_batch(n=40):
    """``n`` cofactored-valid signatures with a torsioned R (the
    construction of ``tests/test_torch_verify.py``'s
    ``torsioned_signature``), from seeds 1000 to 1000 + n - 1."""
    msgs, pubs, sigs = [], [], []
    for seed in range(1000, 1000 + n):
        rng = random.Random(seed)
        a, _ = ref.secret_expand(rng.randbytes(32))
        pub = ref.point_compress(ref.point_mul(a, ref.G))
        msg = rng.randbytes(32)
        r = rng.getrandbits(250) % ref.L
        r_enc = ref.point_compress(ref.point_add(ref.point_mul(r, ref.G), ref.torsion_generator()))
        s = (r + ref.compute_challenge(r_enc, pub, msg) * a) % ref.L
        msgs.append(msg)
        pubs.append(pub)
        sigs.append(r_enc + s.to_bytes(32, "little"))
    return msgs, pubs, sigs


def test_cpu_backend_accepts_a_torsioned_batch_as_the_references_engine_does():
    """F8: the port's default ``CpuBackend`` took the serial loop, whose
    re-check bucket rejects cofactored-valid signatures unchecked once 32
    are spent. With the RLC engine it accepts the batch, as the reference's
    does; both serial paths reject it, each with its bucket's message."""
    msgs, pubs, sigs = torsioned_batch()
    assert all(ref.verify(p, m, s, strict=False) and not ref.verify(p, m, s, strict=True)
               for m, p, s in zip(msgs, pubs, sigs))
    for name, (crypto, _, _) in PKGS.items():
        backend = crypto.CpuBackend()
        assert backend._rlc is not None, name
        backend.verify_batch(msgs, pubs, sigs)
        serial = crypto.CpuBackend(use_rlc=False)
        with pytest.raises(crypto.CryptoError, match="rate-limited"):
            serial.verify_batch(msgs, pubs, sigs)
    assert t_crypto.CpuBackend().engine == "native-rlc"


@pytest.mark.parametrize("pkg", list(PKGS))
def test_cpu_backend_verify_cert_runs_one_fused_rlc(pkg, monkeypatch):
    """A packed certificate reaches the native engine's fused check once,
    never the exploded batch path; a corrupted one raises."""
    crypto, _, native = PKGS[pkg]
    calls = []
    real = native.verify_cert_native

    def counted(*args, **kwargs):
        calls.append(len(args[1]))
        return real(*args, **kwargs)

    monkeypatch.setattr(native, "verify_cert_native", counted)
    backend = crypto.CpuBackend()
    monkeypatch.setattr(backend, "verify_batch", lambda *a: pytest.fail("exploded"))
    msg, pubs, buf = packed_cert(6, random.Random(106))
    backend.verify_cert(msg, pubs, buf, 64)
    with pytest.raises(crypto.CryptoError):
        backend.verify_cert(msg, pubs, corrupt(buf, 70), 64)
    assert calls == [6, 6]


def test_serial_cpu_backend_explodes_a_certificate_into_its_batch_path(monkeypatch):
    backend = t_crypto.CpuBackend(use_rlc=False)
    seen = []
    monkeypatch.setattr(backend, "verify_batch", lambda m, p, s: seen.append((m, p, s)))
    msgs, pubs, buf = packed_cert(3, random.Random(107), stride=72, shared=False)
    backend.verify_cert(msgs, pubs, buf, 72)
    assert seen == [(msgs, pubs, [buf[72 * i:72 * i + 64] for i in range(3)])]


# -- without cryptography: the gated signer and the strict single check ------


@pytest.fixture
def gated(monkeypatch):
    """Both packages as on a host without ``cryptography``: lazily resolved
    native pieces reset, so each test resolves them anew."""
    for crypto in (t_crypto, j_crypto):
        monkeypatch.setattr(crypto, "_HAVE_PYCA", False)
        monkeypatch.setattr(crypto, "_NATIVE_SCALARMULT", None)
        monkeypatch.setattr(crypto, "_STRICT_FUSER", None)
    monkeypatch.setattr(j_crypto, "_SIGNER_CACHE", {})
    t_crypto._expanded.cache_clear()
    yield
    t_crypto._expanded.cache_clear()


def test_gated_signing_is_the_references_and_runs_on_the_engine(gated):
    rng = random.Random(108)
    for _ in range(4):
        seed = rng.randbytes(32)
        digest = t_crypto.sha512_digest(rng.randbytes(16))
        pub = t_crypto.SecretKey(seed).public_key()
        sig = t_crypto.Signature.new(digest, t_crypto.SecretKey(seed))
        assert pub.data == j_crypto.SecretKey(seed).public_key().data == ref.secret_to_public(seed)
        assert sig.data == j_crypto.Signature.new(j_crypto.Digest(digest.data),
                                                  j_crypto.SecretKey(seed)).data
        assert sig.data == ref.sign(seed, digest.data)
    assert t_crypto._NATIVE_SCALARMULT is t_native.scalarmult_base_native


def strict_matrix():
    """(name, msg, pub, sig): the strict single check's verdict matrix."""
    rng = random.Random(109)
    seed = rng.randbytes(32)
    msg = rng.randbytes(32)
    pub, sig = ref.secret_to_public(seed), ref.sign(seed, msg)
    tors = ref.point_compress(ref.torsion_generator())
    high_s = sig[:32] + (int.from_bytes(sig[32:], "little") + ref.L).to_bytes(32, "little")
    t_rng = random.Random(1000)
    a, _ = ref.secret_expand(t_rng.randbytes(32))
    t_pub = ref.point_compress(ref.point_mul(a, ref.G))
    t_msg = t_rng.randbytes(32)
    r = t_rng.getrandbits(250) % ref.L
    r_enc = ref.point_compress(ref.point_add(ref.point_mul(r, ref.G), ref.torsion_generator()))
    t_sig = r_enc + ((r + ref.compute_challenge(r_enc, t_pub, t_msg) * a) % ref.L).to_bytes(32, "little")
    return [
        ("valid", msg, pub, sig),
        ("wrong message", b"\x55" * 32, pub, sig),
        ("flipped s", msg, pub, sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]),
        ("flipped R", msg, pub, bytes([sig[0] ^ 1]) + sig[1:]),
        ("non-canonical s", msg, pub, high_s),
        ("small-order R", msg, pub, tors + sig[32:]),
        ("small-order A", msg, tors, sig),
        ("non-canonical A", msg, (ref.P + 1).to_bytes(32, "little"), sig),
        ("torsioned R", t_msg, t_pub, t_sig),
    ]


def outcome(crypto, msg, pub, sig):
    try:
        crypto.Signature(sig).verify(crypto.Digest(msg), crypto.PublicKey(pub))
        return "ok"
    except crypto.CryptoError:
        return "rejected"


def test_gated_strict_single_check_is_the_references(gated):
    """Every case of the matrix gets the reference's verdict and the strict
    oracle's, through the native fuser in both packages."""
    for name, msg, pub, sig in strict_matrix():
        want = "ok" if ref.verify(pub, msg, sig, strict=True) else "rejected"
        assert outcome(t_crypto, msg, pub, sig) == outcome(j_crypto, msg, pub, sig) == want, name
    assert isinstance(t_crypto._STRICT_FUSER.inner, t_crypto._StrictSingleBackend)
    assert [name for name, *case in strict_matrix()
            if outcome(t_crypto, *case) == "ok"] == ["valid"]


def test_gated_strict_fuser_gives_concurrent_callers_exact_verdicts(gated, monkeypatch):
    """Identical requests from many threads at once (one proposal fanned to
    in-process validators) pool in the fuser beside a bad one; every caller
    gets its own exact verdict, and only these triples reach the engine."""
    import threading

    good, bad = strict_matrix()[0][1:], strict_matrix()[2][1:]
    calls = []
    real = t_native.verify_single_strict_native

    def counted(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(t_native, "verify_single_strict_native", counted)
    results = [None] * 16

    def one(i):
        results[i] = t_crypto._verify_single_gated(*(good if i % 2 == 0 else bad))

    threads = [threading.Thread(target=one, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert results == [True, False] * 8
    assert set(calls) == {good, bad}
