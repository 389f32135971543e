"""Crypto layer: digests, Ed25519 keys and signatures, the batch backend.

Port of ``hotstuff_tpu/crypto/__init__.py`` (reference
``crypto/src/lib.rs:20-250``): ``Digest``, ``PublicKey``, ``SecretKey``,
``generate_keypair``, ``Signature`` (``new``/``verify``/``verify_batch``/
``verify_batch_multi``). Protocol digests are SHA-512 truncated to 32 bytes
and signatures sign the 32-byte digest.

Signing and single verification use the ``cryptography`` package (OpenSSL)
when it is importable, else the pure-Python oracle ``ed25519_ref``. Batch
verification — the QC path — goes to the active backend, the
``CudaBackend`` of ``crypto/cuda_backend.py`` (``set_backend("cuda")`` or a
backend object).
"""

from __future__ import annotations

import base64
import functools
import hashlib
import secrets

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
        get_backend().verify_batch(
            [digest.data] * len(votes),
            [pk.data for pk, _ in votes],
            [sig.data for _, sig in votes],
        )

    @staticmethod
    def verify_batch_multi(items) -> None:
        """Batch verification over per-item digests. ``items``: iterable of
        ``(Digest, PublicKey, Signature)``."""
        items = list(items)
        get_backend().verify_batch(
            [d.data for d, _, _ in items],
            [pk.data for _, pk, _ in items],
            [sig.data for _, _, sig in items],
        )


_BACKEND = None


def get_backend():
    """The active batch backend; a ``CudaBackend`` on the card by default."""
    if _BACKEND is None:
        set_backend("cuda")
    return _BACKEND


def set_backend(name_or_backend) -> None:
    """Select the batch-verify backend: ``"cuda"`` or a backend object
    (anything with ``verify_batch(msgs, pubs, sigs)``)."""
    global _BACKEND
    if not isinstance(name_or_backend, str):
        _BACKEND = name_or_backend
        return
    if name_or_backend != "cuda":
        raise ValueError(f"unknown crypto backend {name_or_backend!r}")
    from .cuda_backend import CudaBackend

    _BACKEND = CudaBackend()


__all__ = [
    "BackendUnavailable",
    "CryptoError",
    "Digest",
    "sha512_digest",
    "PublicKey",
    "SecretKey",
    "generate_keypair",
    "Signature",
    "get_backend",
    "set_backend",
]
