"""Crypto layer: digests, Ed25519 keys and signatures, the batch backend.

Port of ``hotstuff_tpu/crypto/__init__.py`` (reference
``crypto/src/lib.rs:20-250``): ``Digest``, ``PublicKey``, ``SecretKey``,
``generate_keypair``, ``Signature`` (``new``/``verify``/``verify_batch``/
``verify_batch_multi``), ``SignatureService``, the dispatch layer
(``backend_verify_batch``, ``backend_verify_cert``, ``agg_qc_enabled``) and
the serial ``CpuBackend``. Protocol digests are SHA-512 truncated to 32
bytes and signatures sign the 32-byte digest.

Signing and single verification use the ``cryptography`` package (OpenSSL)
when it is importable, else the pure-Python oracle ``ed25519_ref``. Batch
verification — the QC and TC path — goes to the active backend:
``"cuda"`` (``crypto/cuda_backend.py``, the default), ``"cpu"``, their
super-batching variants ``"cuda-batched"``/``"cpu-batched"``
(``crypto/batching.py``), or a backend object. Left in the reference: the
opt-in verdict memo and the native C++ RLC engine of its ``CpuBackend``.
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

from . import ed25519_ref


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


@functools.lru_cache(maxsize=4096)  # committees are far smaller
def _expanded(seed: bytes) -> tuple[int, bytes, bytes]:
    """(clamped scalar, hash prefix, public key) of a seed, for signing
    without OpenSSL (key expansion costs one scalar multiplication)."""
    a, prefix = ed25519_ref.secret_expand(seed)
    return a, prefix, ed25519_ref.point_compress(ed25519_ref.point_mul(a, ed25519_ref.G))


def _sign_ref(seed: bytes, msg: bytes) -> bytes:
    """RFC 8032 signing on the oracle; byte-identical to OpenSSL's."""
    a, prefix, pub = _expanded(seed)
    r = int.from_bytes(hashlib.sha512(prefix + msg).digest(), "little") % ed25519_ref.L
    big_r = ed25519_ref.point_compress(ed25519_ref.point_mul(r, ed25519_ref.G))
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
        CryptoError."""
        if not _strict_point_checks(public_key.data, self.data):
            raise CryptoError("small-order or non-canonical point in signature")
        if _HAVE_PYCA:
            try:
                Ed25519PublicKey.from_public_bytes(public_key.data).verify(
                    self.data, digest.data
                )
            except (InvalidSignature, ValueError) as e:
                raise CryptoError(f"invalid signature: {e}") from e
        elif not ed25519_ref.verify(public_key.data, digest.data, self.data, strict=True):
            raise CryptoError("invalid signature")

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


# ---------------------------------------------------------------------------
# Dispatch to the active backend.
# ---------------------------------------------------------------------------


def backend_verify_batch(msgs, pubs, sigs) -> None:
    """Dispatch a batch verification to the active backend. All structured
    certificate paths (``Signature.verify_batch``/``verify_batch_multi``
    and the wire-v2 raw-slice path of ``consensus/messages.py``) route
    here (reference ``crypto/__init__.py:292``, without its opt-in memo)."""
    get_backend().verify_batch(msgs, pubs, sigs)


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
    ``backend_verify_batch`` when ``HOTSTUFF_AGG_QC=0`` or when the active
    backend has no fused entry point (``CudaBackend`` has none, as the
    reference's ``TpuBackend``)."""
    n = len(pubs)
    if n == 0:
        return
    if not agg_qc_enabled():
        return backend_verify_batch(*_explode_cert(msgs, pubs, sig_buf, stride, n))
    backend = get_backend()
    fused = getattr(backend, "verify_cert", None)
    if fused is None:
        return backend.verify_batch(*_explode_cert(msgs, pubs, sig_buf, stride, n))
    return fused(msgs, pubs, sig_buf, stride, key=key)


# ---------------------------------------------------------------------------
# The CPU backend: the serial yardstick.
# ---------------------------------------------------------------------------


class CpuBackend:
    """CPU batch verification, serial: OpenSSL per signature, with a
    cofactored re-check on ``ed25519_ref`` for the signatures OpenSSL
    rejects (reference ``crypto/__init__.py:608-716``, its serial path).

    Acceptance is COFACTORED (8sB == 8R + 8hA), the ``CudaBackend``'s set:
    OpenSSL's cofactorless check accepts a subset of it, and only what
    OpenSSL rejects pays the slow re-check. ``use_rlc`` does nothing: it is
    accepted for the reference's signature, and the native RLC engine it
    selects there stays in the reference.
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
        self._verify_serial(msgs, pubs, sigs)

    def verify_cert(self, msgs, pubs, sig_buf, stride: int = 64, key=None) -> None:
        """A packed cert, exploded: the acceptance set of its slices."""
        self._verify_serial(*_explode_cert(msgs, pubs, sig_buf, stride, len(pubs)))

    def _verify_serial(self, msgs, pubs, sigs) -> None:
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


_BACKEND = None


def get_backend():
    """The active batch backend; a ``CudaBackend`` on the card by default."""
    if _BACKEND is None:
        set_backend("cuda")
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
    kept so that callers are the reference's."""

    def __init__(self, secret: SecretKey) -> None:
        self._secret = secret

    async def request_signature(self, digest: Digest) -> Signature:
        return Signature.new(digest, self._secret)


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
    "get_backend",
    "set_backend",
]
