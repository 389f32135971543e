"""Crypto layer: digests, Ed25519 keys and signatures, the batch backend.

Port of ``hotstuff_tpu/crypto/__init__.py`` (reference
``crypto/src/lib.rs:20-250``): ``Digest``, ``PublicKey``, ``SecretKey``,
``generate_keypair``, ``Signature`` (``new``/``verify``/``verify_batch``/
``verify_batch_multi``), ``SignatureService``, the dispatch layer
(``backend_verify_batch``, ``backend_verify_cert``, ``agg_qc_enabled``) and
``CpuBackend`` with its native RLC engine. Protocol digests are SHA-512
truncated to 32 bytes and signatures sign the 32-byte digest.

Signing and single verification use the ``cryptography`` package (OpenSSL)
when it is importable. Without it, as in the reference, signing runs on
``ed25519_ref`` with the fixed-base multiplications on the native engine
(``native_ed25519``), and a strict single verify is the native engine's
cofactorless 3-point MSM behind a fuser that dedups identical concurrent
requests; the pure-Python oracle is the last resort. Batch verification —
the QC and TC path — goes to the active backend: ``"cuda"``
(``crypto/cuda_backend.py``, the default), ``"cpu"``, their super-batching
variants ``"cuda-batched"``/``"cpu-batched"`` (``crypto/batching.py``), or
a backend object; unless one is set, the first ``get_backend()`` takes the
name from ``HOTSTUFF_CRYPTO_BACKEND``. ``CpuBackend`` counts its dispatches
into the reference's ``crypto.dispatch.cpu*`` telemetry counters.

The reference's opt-in process-wide verdict memo (``enable_verify_memo``,
``crypto.verify_memo.hits``) and the signer memo beside it are here, for the
simulation plane (``hotstuff_tpu_torch/sim``), which turns them on. One
difference, by design: a ``BackendUnavailable`` is never memoised (the
reference's ``except CryptoError`` would cache one as a failure verdict,
since it is a ``CryptoError``); it stays unjudged and raises again.
With the stage spans armed (``telemetry/stages.py``) a strict single
verification is a ``crypto.single`` span.
"""

from __future__ import annotations

import base64
import functools
import hashlib
import os
import secrets
import time

try:
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey,
        Ed25519PublicKey,
    )

    _HAVE_PYCA = True
except ImportError:  # the card's host may ship no OpenSSL binding
    InvalidSignature = Ed25519PrivateKey = Ed25519PublicKey = None
    _HAVE_PYCA = False

from hotstuff_tpu_torch import telemetry
from hotstuff_tpu_torch.telemetry import stages

from . import ed25519_ref, native_ed25519


class CryptoError(Exception):
    """Signature or encoding verification failure."""


class BackendUnavailable(CryptoError):
    """The verification BACKEND failed (device or runtime error): the
    signatures were NOT judged. Callers treat this as a transient
    infrastructure failure, never as a byzantine signature."""


class Digest:
    """32-byte hash value; base64 display (reference ``crypto/src/lib.rs:20-62``)."""

    SIZE = 32
    __slots__ = ("data",)

    def __init__(self, data: bytes) -> None:
        if len(data) != self.SIZE:
            raise ValueError(f"digest must be {self.SIZE} bytes, got {len(data)}")
        self.data = data if type(data) is bytes else bytes(data)

    @classmethod
    def default(cls) -> "Digest":
        return cls(bytes(cls.SIZE))

    def __bytes__(self) -> bytes:
        return self.data

    def __eq__(self, other) -> bool:
        return isinstance(other, Digest) and self.data == other.data

    def __lt__(self, other: "Digest") -> bool:
        return self.data < other.data

    def __hash__(self) -> int:
        return hash(self.data)

    def __repr__(self) -> str:
        return base64.standard_b64encode(self.data).decode()[:16]

    def __str__(self) -> str:
        return base64.standard_b64encode(self.data).decode()


def sha512_digest(*chunks: bytes) -> Digest:
    """SHA-512 truncated to 32 bytes over the concatenated chunks."""
    h = hashlib.sha512()
    for c in chunks:
        h.update(c)
    return Digest(h.digest()[:32])


class PublicKey:
    """Compressed Edwards point, 32 bytes; base64 serde; ordered (leader
    election sorts keys, reference ``consensus/src/leader.rs:16-20``)."""

    SIZE = 32
    __slots__ = ("data",)

    def __init__(self, data: bytes) -> None:
        if len(data) != self.SIZE:
            raise ValueError("public key must be 32 bytes")
        self.data = data if type(data) is bytes else bytes(data)

    @classmethod
    def decode_base64(cls, s: str) -> "PublicKey":
        return cls(base64.standard_b64decode(s))

    def encode_base64(self) -> str:
        return base64.standard_b64encode(self.data).decode()

    def __bytes__(self) -> bytes:
        return self.data

    def __eq__(self, other) -> bool:
        return isinstance(other, PublicKey) and self.data == other.data

    def __lt__(self, other: "PublicKey") -> bool:
        return self.data < other.data

    def __hash__(self) -> int:
        return hash(self.data)

    def __repr__(self) -> str:
        return self.encode_base64()[:16]

    def __str__(self) -> str:
        return self.encode_base64()


_NATIVE_SCALARMULT = None  # resolved at first use: a callable, or False


def _scalarmult_base(scalar: int) -> bytes:
    """Compressed ``scalar * B`` for signing without OpenSSL: on the native
    engine when it builds, else on the oracle (reference
    ``crypto/__init__.py:110-124``)."""
    global _NATIVE_SCALARMULT
    if _NATIVE_SCALARMULT is None:
        _NATIVE_SCALARMULT = (native_ed25519.scalarmult_base_native
                              if native_ed25519.native_available() else False)
    if _NATIVE_SCALARMULT:
        return _NATIVE_SCALARMULT(scalar)
    return ed25519_ref.point_compress(ed25519_ref.point_mul(scalar, ed25519_ref.G))


@functools.lru_cache(maxsize=4096)  # committees are far smaller
def _expanded(seed: bytes) -> tuple[int, bytes, bytes]:
    """(clamped scalar, hash prefix, public key) of a seed, for signing
    without OpenSSL (key expansion costs one scalar multiplication)."""
    a, prefix = ed25519_ref.secret_expand(seed)
    return a, prefix, _scalarmult_base(a)


def _sign_ref(seed: bytes, msg: bytes) -> bytes:
    """RFC 8032 signing without OpenSSL; byte-identical to OpenSSL's.

    Signing is deterministic in (key, msg): under the opt-in memo (the
    simulation plane) a repeated signing of identical bytes (a sweep's
    seeds share their fault-free prefixes) skips the scalar multiplication
    (reference ``crypto/__init__.py:140-152``)."""
    memo = _VERIFY_MEMO
    if memo is None:
        return _sign_now(seed, msg)
    key = (b"sign", _expanded(seed)[1], msg)
    sig = memo.get(key)
    if sig is None:
        sig = _sign_now(seed, msg)
        _memo_put(memo, key, sig)
    return sig


def _sign_now(seed: bytes, msg: bytes) -> bytes:
    a, prefix, pub = _expanded(seed)
    r = int.from_bytes(hashlib.sha512(prefix + msg).digest(), "little") % ed25519_ref.L
    big_r = _scalarmult_base(r)
    k = ed25519_ref.compute_challenge(big_r, pub, msg)
    s = (r + k * a) % ed25519_ref.L
    return big_r + s.to_bytes(32, "little")


class SecretKey:
    """Ed25519 seed (32 bytes), from which the expanded key is derived."""

    SIZE = 32
    __slots__ = ("seed",)

    def __init__(self, seed: bytes) -> None:
        if len(seed) != self.SIZE:
            raise ValueError("secret key seed must be 32 bytes")
        self.seed = bytes(seed)

    @classmethod
    def decode_base64(cls, s: str) -> "SecretKey":
        return cls(base64.standard_b64decode(s))

    def encode_base64(self) -> str:
        return base64.standard_b64encode(self.seed).decode()

    def public_key(self) -> PublicKey:
        if _HAVE_PYCA:
            sk = Ed25519PrivateKey.from_private_bytes(self.seed)
            return PublicKey(sk.public_key().public_bytes_raw())
        return PublicKey(_expanded(self.seed)[2])


def generate_keypair(rng=None, *, seed: bytes | None = None):
    """Generate an Ed25519 keypair. ``seed`` pins determinism for tests
    (reference ``consensus/src/tests/common.rs:17-20``); ``rng`` is a
    ``random.Random``-like source of the seed."""
    if seed is None:
        seed = rng.randbytes(32) if rng is not None else secrets.token_bytes(32)
    sk = SecretKey(seed)
    return sk.public_key(), sk


@functools.cache
def _small_order_encodings() -> frozenset[bytes]:
    """Canonical encodings of the eight 8-torsion points."""
    t = ed25519_ref.torsion_generator()
    encs = set()
    acc = ed25519_ref.IDENTITY
    for _ in range(8):
        encs.add(ed25519_ref.point_compress(acc))
        acc = ed25519_ref.point_add(acc, t)
    return frozenset(encs)


def _canonical_y(enc: bytes) -> bool:
    return (int.from_bytes(enc, "little") & ((1 << 255) - 1)) < ed25519_ref.P


def _strict_point_checks(pub: bytes, sig: bytes) -> bool:
    """Reject non-canonical or small-order A/R (dalek verify_strict)."""
    r_enc = sig[:32]
    if not (_canonical_y(pub) and _canonical_y(r_enc)):
        return False
    small = _small_order_encodings()
    return pub not in small and r_enc not in small


class Signature:
    """Detached Ed25519 signature (64 bytes, R || s)."""

    SIZE = 64
    __slots__ = ("data",)

    def __init__(self, data: bytes) -> None:
        if len(data) != self.SIZE:
            raise ValueError("signature must be 64 bytes")
        self.data = data if type(data) is bytes else bytes(data)

    @classmethod
    def default(cls) -> "Signature":
        return cls(bytes(cls.SIZE))

    @classmethod
    def new(cls, digest: Digest, secret: SecretKey) -> "Signature":
        """Sign a 32-byte digest (reference ``Signature::new``)."""
        if _HAVE_PYCA:
            sk = Ed25519PrivateKey.from_private_bytes(secret.seed)
            return cls(sk.sign(digest.data))
        return cls(_sign_ref(secret.seed, digest.data))

    def __bytes__(self) -> bytes:
        return self.data

    def __eq__(self, other) -> bool:
        return isinstance(other, Signature) and self.data == other.data

    def __hash__(self) -> int:
        return hash(self.data)

    def verify(self, digest: Digest, public_key: PublicKey) -> None:
        """Strict single verification (dalek ``verify_strict``: canonical
        encodings, no small-order A or R, cofactorless equation). Raises
        CryptoError. Through the opt-in memo when it is on (reference
        ``crypto/__init__.py:505-521``)."""
        memo = _VERIFY_MEMO
        if memo is None:
            return self._verify_now(digest, public_key)
        key = (digest.data, public_key.data, self.data)
        hit = memo.get(key)
        if hit is not None:
            if hit is True:
                return
            raise CryptoError(hit)
        try:
            self._verify_now(digest, public_key)
        except BackendUnavailable:
            raise
        except CryptoError as e:
            _memo_put(memo, key, str(e))
            raise
        _memo_put(memo, key, True)

    def _verify_now(self, digest: Digest, public_key: PublicKey) -> None:
        t = stages.begin() if stages.ARMED else None
        try:
            if not _strict_point_checks(public_key.data, self.data):
                raise CryptoError("small-order or non-canonical point in signature")
            if _HAVE_PYCA:
                try:
                    Ed25519PublicKey.from_public_bytes(public_key.data).verify(
                        self.data, digest.data
                    )
                except (InvalidSignature, ValueError) as e:
                    raise CryptoError(f"invalid signature: {e}") from e
            elif not _verify_single_gated(digest.data, public_key.data, self.data):
                raise CryptoError("invalid signature")
        finally:
            if t is not None:
                stages.end("crypto.single", t)

    @staticmethod
    def verify_batch(digest: Digest, votes) -> None:
        """Verify many signatures over the SAME digest — the QC path
        (reference ``crypto/src/lib.rs:206-219``). ``votes``: iterable of
        ``(PublicKey, Signature)``. Raises CryptoError if any is invalid."""
        votes = list(votes)
        backend_verify_batch(
            [digest.data] * len(votes),
            [pk.data for pk, _ in votes],
            [sig.data for _, sig in votes],
        )

    @staticmethod
    def verify_batch_multi(items) -> None:
        """Batch verification over per-item digests. ``items``: iterable of
        ``(Digest, PublicKey, Signature)``."""
        items = list(items)
        backend_verify_batch(
            [d.data for d, _, _ in items],
            [pk.data for _, pk, _ in items],
            [sig.data for _, _, sig in items],
        )


class _StrictSingleBackend:
    """Inner backend of the strict-single fuser (reference
    ``crypto/__init__.py:185-205``): verifies each DISTINCT (msg, pub, sig)
    triple with the native cofactorless 3-point MSM. Strictness is per
    triple (a random linear combination without cofactor clearing could
    cancel torsion components), so the fuser's win is the identical-triple
    dedup: a proposal verified by N in-process validators costs one MSM."""

    name = "cpu-strict-single"

    def verify_batch(self, msgs, pubs, sigs) -> None:
        for msg, pub, sig in zip(msgs, pubs, sigs):
            if not native_ed25519.verify_single_strict_native(msg, pub, sig):
                raise CryptoError("invalid signature")


_STRICT_FUSER = None  # BatchingBackend over _StrictSingleBackend, or False


def _verify_single_gated(msg: bytes, pub: bytes, sig: bytes) -> bool:
    """Strict single verification without OpenSSL (reference
    ``crypto/__init__.py:211-250``): the cofactorless equation on the
    native engine, through a fuser that dedups identical concurrent
    requests (each verdict stays exact: the fuser re-verifies one by one
    when a fused flush rejects), else the pure-Python strict oracle. Under
    the memo (the simulation plane) the caller already dedups identical
    verifies across time, so the fuser's cross-thread handoff would only
    cost: one direct MSM. The small-order and canonicality rejections run
    in the caller."""
    global _STRICT_FUSER
    if _STRICT_FUSER is None:
        if native_ed25519.native_available():
            from .batching import BatchingBackend

            _STRICT_FUSER = BatchingBackend(_StrictSingleBackend())
        else:
            _STRICT_FUSER = False
    if _STRICT_FUSER is False:
        return ed25519_ref.verify(pub, msg, sig, strict=True)
    if _VERIFY_MEMO is not None:
        return native_ed25519.verify_single_strict_native(msg, pub, sig)
    try:
        _STRICT_FUSER.verify_batch([msg], [pub], [sig])
        return True
    except BackendUnavailable:
        raise
    except CryptoError:
        return False


# ---------------------------------------------------------------------------
# Dispatch to the active backend.
# ---------------------------------------------------------------------------


# Opt-in process-wide verification-verdict memo (reference
# ``crypto/__init__.py:253-290``). Verification is a pure function of the
# (message, key, signature) bytes, so a memoised verdict is semantically
# invisible; it is still opt-in, since when one process models a whole
# committee a hit skips work every real node would do itself, which would
# falsify the committee benchmarks. The simulation plane turns it on:
# there the object of study is the protocol under fault schedules, and
# identical re-verifies across simulated nodes and seeds are waste. Failure
# verdicts are cached too (byzantine resends stay cheap);
# ``BackendUnavailable`` never is.

_VERIFY_MEMO: dict | None = None
_VERIFY_MEMO_CAP = 1 << 16


def enable_verify_memo(enabled: bool = True) -> None:
    """Turn the process-wide verification memo on (idempotent: an existing
    memo is kept warm) or off (drops it)."""
    global _VERIFY_MEMO
    if enabled:
        if _VERIFY_MEMO is None:
            _VERIFY_MEMO = {}
    else:
        _VERIFY_MEMO = None


def verify_memo_enabled() -> bool:
    return _VERIFY_MEMO is not None


def _memo_put(memo: dict, key, verdict) -> None:
    if len(memo) >= _VERIFY_MEMO_CAP:
        memo.clear()  # coarse bound; sim working sets rarely get here
    memo[key] = verdict


def backend_verify_batch(msgs, pubs, sigs) -> None:
    """Dispatch a batch verification to the active backend, through the
    opt-in verdict memo when it is on. All structured certificate paths
    (``Signature.verify_batch``/``verify_batch_multi`` and the wire-v2
    raw-slice path of ``consensus/messages.py``) route here (reference
    ``crypto/__init__.py:292-318``)."""
    memo = _VERIFY_MEMO
    if memo is None:
        return get_backend().verify_batch(msgs, pubs, sigs)
    # Order-independent key: a QC's signature set is verified by the
    # assembling leader in arrival order and again off the wire in seat
    # order; one set, one verdict, one memo entry.
    key = tuple(sorted(zip(msgs, pubs, sigs)))
    hit = memo.get(key)
    if hit is not None:
        telemetry.counter("crypto.verify_memo.hits").inc()
        if hit is True:
            return
        raise CryptoError(hit)
    try:
        get_backend().verify_batch(msgs, pubs, sigs)
    except BackendUnavailable:
        raise
    except CryptoError as e:
        _memo_put(memo, key, str(e))
        raise
    _memo_put(memo, key, True)


# A wire-v2 certificate is a seat bitmap plus one packed signature buffer;
# the fused path hands the crypto plane ONE job per cert (buffer + stride,
# never 2f+1 sliced Signature objects). ``HOTSTUFF_AGG_QC=0`` is the
# kill switch: certs then explode into the per-signature batch path.


def agg_qc_enabled() -> bool:
    """True unless ``HOTSTUFF_AGG_QC=0`` disables fused cert verification
    (read per call so tests and operators can flip it live)."""
    return os.environ.get("HOTSTUFF_AGG_QC", "1") != "0"


def _explode_cert(msgs, pubs, sig_buf, stride, n):
    """Per-signature (msgs, pubs, sigs) lists for a packed cert — the shape
    for backends and paths without a fused entry point."""
    sig_buf = bytes(sig_buf)
    if isinstance(msgs, (bytes, bytearray, memoryview)):
        msg_list = [bytes(msgs)] * n
    else:
        msg_list = [bytes(m) for m in msgs]
    pub_list = [bytes(p) for p in pubs]
    sig_list = [sig_buf[stride * i : stride * i + 64] for i in range(n)]
    return msg_list, pub_list, sig_list


def backend_verify_cert(msgs, pubs, sig_buf, stride: int = 64, key=None) -> None:
    """Dispatch one fused certificate verification to the active backend.

    ``pubs``: the cert's n public keys (bytes each); ``sig_buf``: its
    packed signature buffer at ``stride`` bytes per record (signature in
    the first 64); ``msgs``: one shared statement (QC) or a per-seat list
    (TC). ``key`` is an optional canonical cert identity that the
    super-batching layer uses to dedup concurrent verifies of one cert.
    Raises CryptoError on an invalid cert. Explodes the cert into
    ``backend_verify_batch`` when the verdict memo is on (the simulation
    plane: exploded triples keep ONE memo keyspace with the structured
    paths), when ``HOTSTUFF_AGG_QC=0``, or when the active backend has no
    fused entry point (``CudaBackend`` has none, as the reference's
    ``TpuBackend``)."""
    n = len(pubs)
    if n == 0:
        return
    if _VERIFY_MEMO is not None or not agg_qc_enabled():
        return backend_verify_batch(*_explode_cert(msgs, pubs, sig_buf, stride, n))
    backend = get_backend()
    fused = getattr(backend, "verify_cert", None)
    if fused is None:
        return backend.verify_batch(*_explode_cert(msgs, pubs, sig_buf, stride, n))
    return fused(msgs, pubs, sig_buf, stride, key=key)


# ---------------------------------------------------------------------------
# The CPU backend: the native RLC engine, or the serial yardstick.
# ---------------------------------------------------------------------------


class CpuBackend:
    """CPU batch verification (reference ``crypto/__init__.py:608-716``):
    dalek's CPU ``verify_batch``, the bar the card is held against.

    Acceptance is COFACTORED (8sB == 8R + 8hA), the ``CudaBackend``'s set.
    With ``use_rlc`` (the default) a batch of two or more signatures, or
    any batch without OpenSSL, goes to the native C++ RLC engine
    (``native_ed25519.verify_batch_native``, dalek's algorithm), and a
    packed certificate to its fused check (``verify_cert_native``, one RLC
    MSM with deterministic coefficients). The engine is built when the
    backend is constructed, never inside a verify; where g++ cannot build
    it, the backend stays serial, as the reference's does without its
    library. ``use_rlc=False`` is the serial path, the bench's serial
    baseline: OpenSSL's cofactorless check per signature (a subset of the
    cofactored set), with a cofactored re-check on ``ed25519_ref`` for what
    OpenSSL rejects. ``engine`` names the path taken: ``"native-rlc"`` or
    ``"serial"``.
    """

    name = "cpu"

    # The pure-Python cofactored re-check costs milliseconds; it only runs
    # on signatures OpenSSL rejected, which honest RFC 8032 signers never
    # produce in the divergence region. A token bucket bounds the CPU a
    # byzantine member could extract; once it is empty, OpenSSL's verdict
    # is final (it can only reject crafted torsioned signatures).
    SLOW_CHECK_BUDGET = 32
    SLOW_CHECK_REFILL_S = 10.0

    def __init__(self, use_rlc: bool = True) -> None:
        self._slow_tokens = float(self.SLOW_CHECK_BUDGET)
        self._last_refill = time.monotonic()
        self._rlc = None
        if use_rlc and native_ed25519.native_available():
            self._rlc = native_ed25519.verify_batch_native
        self.engine = "serial" if self._rlc is None else "native-rlc"

    def _take_slow_token(self) -> bool:
        now = time.monotonic()
        self._slow_tokens = min(
            float(self.SLOW_CHECK_BUDGET),
            self._slow_tokens
            + (now - self._last_refill) * self.SLOW_CHECK_BUDGET / self.SLOW_CHECK_REFILL_S,
        )
        self._last_refill = now
        if self._slow_tokens >= 1.0:
            self._slow_tokens -= 1.0
            return True
        return False

    def verify_batch(self, msgs, pubs, sigs) -> None:
        if not len(msgs) == len(pubs) == len(sigs):
            raise CryptoError("batch length mismatch")
        telemetry.counter("crypto.dispatch.cpu").inc()
        telemetry.counter("crypto.dispatch.cpu_sigs").inc(len(msgs))
        # Without OpenSSL even a batch of one goes to the engine: the
        # pure-Python loop below costs milliseconds a signature.
        if self._rlc is not None and (len(msgs) >= 2 or not _HAVE_PYCA):
            if not self._rlc(msgs, pubs, sigs):
                raise CryptoError("invalid signature in batch")
            return
        for msg, pub, sig in zip(msgs, pubs, sigs):
            if not _HAVE_PYCA:
                if not ed25519_ref.verify(pub, msg, sig, strict=False):
                    raise CryptoError("invalid signature in batch")
                continue
            try:
                Ed25519PublicKey.from_public_bytes(pub).verify(sig, msg)
            except (InvalidSignature, ValueError):
                if not self._take_slow_token():
                    raise CryptoError(
                        "invalid signature in batch (cofactored re-check "
                        "rate-limited; rejecting conservatively)"
                    ) from None
                if not ed25519_ref.verify(pub, msg, sig, strict=False):
                    raise CryptoError("invalid signature in batch") from None

    def verify_cert(self, msgs, pubs, sig_buf, stride: int = 64, key=None) -> None:
        """Fused certificate verification: one RLC MSM over the cert's
        packed signature buffer on the native engine, with the acceptance
        set of its exploded slices; serial, the exploded batch."""
        telemetry.counter("crypto.dispatch.cpu_cert").inc()
        telemetry.counter("crypto.dispatch.cpu_cert_sigs").inc(len(pubs))
        if self._rlc is not None:
            if not native_ed25519.verify_cert_native(msgs, pubs, sig_buf, stride):
                raise CryptoError("invalid signature in certificate")
            return
        self.verify_batch(*_explode_cert(msgs, pubs, sig_buf, stride, len(pubs)))


_BACKEND = None


def get_backend():
    """The active batch backend. At first use it is the one that
    ``HOTSTUFF_CRYPTO_BACKEND`` names (``cuda``, ``cuda-batched``, ``cpu``
    or ``cpu-batched``), as the reference's ``get_backend`` reads it; unset,
    a ``CudaBackend`` on the card. Any other value raises ``ValueError``."""
    if _BACKEND is None:
        set_backend(os.environ.get("HOTSTUFF_CRYPTO_BACKEND", "cuda"))
    return _BACKEND


def set_backend(name_or_backend) -> None:
    """Select the batch-verify backend: ``"cuda"``, ``"cpu"``, their
    super-batching variants ``"cuda-batched"``/``"cpu-batched"`` (fuse
    concurrent verification requests into one call, see
    ``crypto/batching.py``), or a backend object (anything with
    ``verify_batch(msgs, pubs, sigs)``). The name is validated and the
    backend built before the active one is replaced, so a failed call
    leaves it unchanged."""
    global _BACKEND
    if not isinstance(name_or_backend, str):
        _BACKEND = name_or_backend
        return
    name = name_or_backend
    base, sep, variant = name.partition("-")
    if base not in ("cpu", "cuda"):
        raise ValueError(f"unknown crypto backend {name!r}")
    if sep and variant != "batched":
        raise ValueError(f"unknown crypto backend variant {name!r}")
    if base == "cpu":
        backend = CpuBackend()
    else:
        from .cuda_backend import CudaBackend

        backend = CudaBackend()
    if variant == "batched":
        from .batching import BatchingBackend

        backend = BatchingBackend(backend)
    _BACKEND = backend


class SignatureService:
    """Holds the secret key and signs digests on request (reference
    ``crypto/src/lib.rs:222-250``, an actor there). Signing takes
    microseconds, so it runs inline in the awaiting task; the async API is
    kept so that callers are the reference's. As the reference's
    (``hotstuff_tpu/crypto/__init__.py:761-781``), it keeps OpenSSL's key
    object, whose construction costs more than a signature."""

    def __init__(self, secret: SecretKey) -> None:
        self._secret = secret
        self._sk = Ed25519PrivateKey.from_private_bytes(secret.seed) if _HAVE_PYCA else None

    async def request_signature(self, digest: Digest) -> Signature:
        if self._sk is not None:
            return Signature(self._sk.sign(digest.data))
        return Signature(_sign_ref(self._secret.seed, digest.data))


__all__ = [
    "BackendUnavailable",
    "CpuBackend",
    "CryptoError",
    "Digest",
    "sha512_digest",
    "PublicKey",
    "SecretKey",
    "generate_keypair",
    "Signature",
    "SignatureService",
    "agg_qc_enabled",
    "backend_verify_batch",
    "backend_verify_cert",
    "enable_verify_memo",
    "get_backend",
    "set_backend",
    "verify_memo_enabled",
]
