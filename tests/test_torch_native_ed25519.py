"""The port's native Ed25519 engine (``hotstuff_tpu_torch/crypto/
native_ed25519.py`` over its copy of ``crypto/native/ed25519.cpp``) and its
``cpu_batch``, held against the RFC 8032 oracle and the reference's engine.

The twins of the 9 tests of ``tests/test_native_ed25519.py``: each verdict
of the port equals the oracle's and the reference engine's on the same
inputs (the same ``rng`` seeds give the same RLC coefficients). Beside
them, the host prep is the reference's byte for byte: the buffers each
package hands its engine's MSM are equal. Tolerance: exact.
"""

import random
import shutil

import pytest

from hotstuff_tpu.crypto import CpuBackend as JCpuBackend
from hotstuff_tpu.crypto import CryptoError as JCryptoError
from hotstuff_tpu.crypto import cpu_batch as j_cpu_batch
from hotstuff_tpu.crypto import ed25519_ref as ref
from hotstuff_tpu.crypto import native_ed25519 as j_native
from hotstuff_tpu_torch.crypto import CpuBackend, CryptoError
from hotstuff_tpu_torch.crypto import cpu_batch as t_cpu_batch
from hotstuff_tpu_torch.crypto import native_ed25519 as t_native

ENGINES = {"port": t_native, "reference": j_native}


@pytest.fixture(autouse=True)
def built():
    """Both engines built (the reference's only when asked, with
    ``build=True``); skipped where g++ is missing."""
    if shutil.which("g++") is None:
        pytest.skip("g++ toolchain unavailable")
    assert t_native.native_available() and j_native.native_available()


def _batch(n, rng):
    msgs, pubs, sigs = [], [], []
    for _ in range(n):
        seed = rng.randbytes(32)
        pubs.append(ref.secret_to_public(seed))
        msgs.append(rng.randbytes(32))
        sigs.append(ref.sign(seed, msgs[-1]))
    return msgs, pubs, sigs


def test_decompress_agrees_with_oracle_on_random_encodings():
    rng = random.Random(31)
    for _ in range(200):
        enc = rng.randbytes(32)
        want = ref.point_decompress(enc) is not None
        assert t_native.decompress_check(enc) == want == j_native.decompress_check(enc)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_decompress_accepts_known_points_rejects_noncanonical(engine):
    native = ENGINES[engine]
    assert native.decompress_check(ref.point_compress(ref.G))
    assert native.decompress_check(ref.point_compress(ref.point_mul(987654321, ref.G)))
    # y = p is a non-canonical encoding of 0.
    assert not native.decompress_check(ref.P.to_bytes(32, "little"))
    # x = 0 with the sign bit set.
    assert not native.decompress_check((1 | 1 << 255).to_bytes(32, "little"))


@pytest.mark.parametrize("engine", list(ENGINES))
def test_valid_batch_accepts(engine):
    rng = random.Random(32)
    msgs, pubs, sigs = _batch(16, rng)
    assert ENGINES[engine].verify_batch_native(msgs, pubs, sigs, rng=rng)


@pytest.mark.parametrize("which", ["sig_s", "sig_r", "msg", "pub"])
def test_tampered_batch_rejects(which):
    rng = random.Random(33)
    msgs, pubs, sigs = _batch(8, rng)
    i = 3
    if which == "sig_s":
        s = int.from_bytes(sigs[i][32:], "little") ^ 2
        sigs[i] = sigs[i][:32] + s.to_bytes(32, "little")
    elif which == "sig_r":
        sigs[i] = ref.point_compress(ref.point_mul(7, ref.G)) + sigs[i][32:]
    elif which == "msg":
        msgs[i] = b"\x99" * 32
    else:
        pubs[i] = ref.secret_to_public(rng.randbytes(32))
    assert not ref.verify(pubs[i], msgs[i], sigs[i], strict=False)
    for native in ENGINES.values():
        assert not native.verify_batch_native(msgs, pubs, sigs, rng=random.Random(3))


def test_noncanonical_s_rejected():
    rng = random.Random(34)
    msgs, pubs, sigs = _batch(4, rng)
    s = int.from_bytes(sigs[0][32:], "little") + ref.L
    sigs[0] = sigs[0][:32] + s.to_bytes(32, "little")
    for native in ENGINES.values():
        assert not native.verify_batch_native(msgs, pubs, sigs, rng=random.Random(4))


def torsioned(seed: bytes, msg: bytes):
    """(pub, sig) whose equation holds cofactored but not strictly: R
    carries an 8-torsion component and s is signed around it."""
    pub = ref.secret_to_public(seed)
    a, prefix = ref.secret_expand(seed)
    r = int.from_bytes(ref._sha512(prefix + msg), "little") % ref.L
    r_enc = ref.point_compress(ref.point_add(ref.point_mul(r, ref.G), ref.torsion_generator()))
    s = (r + ref.compute_challenge(r_enc, pub, msg) * a) % ref.L
    return pub, r_enc + s.to_bytes(32, "little")


def test_cofactored_semantics_match_python_batch_verifiers():
    """A torsioned R verifies under the cofactored equation and not the
    strict one; every batch verifier of both packages accepts it."""
    msg = random.Random(35).randbytes(32)
    pub, sig = torsioned(b"\x42" * 32, msg)
    assert not ref.verify(pub, msg, sig, strict=True)
    assert ref.verify(pub, msg, sig, strict=False)
    items = ([msg], [pub], [sig])
    for verify in (t_native.verify_batch_native, j_native.verify_batch_native,
                   t_cpu_batch.verify_batch_rlc_pippenger, j_cpu_batch.verify_batch_rlc_pippenger):
        assert verify(*items, rng=random.Random(1))


def test_python_pippenger_agrees_with_native():
    rng = random.Random(36)
    msgs, pubs, sigs = _batch(6, rng)
    verifiers = (t_cpu_batch.verify_batch_rlc_pippenger, t_native.verify_batch_native,
                 j_cpu_batch.verify_batch_rlc_pippenger, j_native.verify_batch_native)
    assert all(v(msgs, pubs, sigs, rng=random.Random(2)) for v in verifiers)
    msgs[2] = b"\x01" * 32
    assert not any(v(msgs, pubs, sigs, rng=random.Random(2)) for v in verifiers)


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_cpu_backend_uses_rlc_and_rejects_bad_batches(pkg):
    backend_cls, error = (CpuBackend, CryptoError) if pkg == "port" else (JCpuBackend, JCryptoError)
    rng = random.Random(37)
    msgs, pubs, sigs = _batch(5, rng)
    backend = backend_cls()
    assert backend._rlc is not None  # native engine picked up
    if pkg == "port":
        assert backend.engine == "native-rlc"
        assert CpuBackend(use_rlc=False).engine == "serial"
    backend.verify_batch(msgs, pubs, sigs)  # no raise
    msgs[1] = b"\x00" * 32
    with pytest.raises(error):
        backend.verify_batch(msgs, pubs, sigs)


def test_window_choice_is_sane():
    assert 1 <= t_native._pippenger_window(3) <= 4
    assert 4 <= t_native._pippenger_window(201) <= 6
    assert 6 <= t_native._pippenger_window(2687) <= 9
    for m in range(1, 20_000, 7):
        assert t_native._pippenger_window(m) == j_native._pippenger_window(m)
        assert t_native._signed_window(m) == j_native._signed_window(m)


class Recorder:
    """An engine stand-in that records what the host prep hands its MSM,
    and answers ``verdict``; the other entry points are the real engine's."""

    def __init__(self, real, verdict: int = 1):
        self.real, self.verdict, self.calls = real, verdict, []

    def hs_ed25519_msm_signed(self, *args):
        self.calls.append(tuple(args))
        return self.verdict

    def __getattr__(self, name):
        return getattr(self.real, name)


def _cert(n, stride, shared, rng):
    seeds = [rng.randbytes(32) for _ in range(n)]
    pubs = [ref.secret_to_public(s) for s in seeds]
    msgs = rng.randbytes(32) if shared else [rng.randbytes(40) for _ in range(n)]
    recs = [ref.sign(s, msgs if shared else msgs[i]) + rng.randbytes(stride - 64)
            for i, s in enumerate(seeds)]
    return msgs, pubs, b"".join(recs)


@pytest.mark.parametrize("entry", ["batch", "cert_shared", "cert_per_seat", "single_strict"])
def test_host_prep_is_the_reference_byte_for_byte(entry, monkeypatch):
    """Encodings, decompressed keys, flags, scalars, lane count, window and
    the cofactor switch handed to the MSM are equal in both packages."""
    rng = random.Random(38)
    if entry == "batch":
        args = _batch(7, rng)

        def call(native):
            return native.verify_batch_native(*args, rng=random.Random(9))
    elif entry == "single_strict":
        msgs, pubs, sigs = _batch(1, rng)

        def call(native):
            return native.verify_single_strict_native(msgs[0], pubs[0], sigs[0])
    else:
        cert = _cert(5, 72, entry == "cert_shared", rng)

        def call(native):
            return native.verify_cert_native(*cert, stride=72)

    seen = {}
    for name, native in ENGINES.items():
        recorder = Recorder(native._load())
        monkeypatch.setattr(native, "_lib", recorder)
        assert call(native)
        seen[name] = recorder.calls
    assert len(seen["port"]) == 1 and seen["port"] == seen["reference"]


def test_scalarmult_base_native_matches_the_oracle():
    rng = random.Random(39)
    for scalar in [0, 1, ref.L - 1] + [rng.randrange(ref.L) for _ in range(20)]:
        want = ref.point_compress(ref.point_mul(scalar, ref.G))
        assert t_native.scalarmult_base_native(scalar) == want
        assert j_native.scalarmult_base_native(scalar) == want
