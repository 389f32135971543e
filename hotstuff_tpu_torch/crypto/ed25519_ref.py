"""Pure-Python Ed25519 (RFC 8032) — the correctness oracle.

Port copy of ``hotstuff_tpu/crypto/ed25519_ref.py`` (the port imports
nothing of the JAX package). It is the bit-exact reference the CUDA kernels
(``hotstuff_tpu_torch.ops``) are held against, and the signer when the
``cryptography`` package is absent. Written from the RFC 8032
specification: field GF(2^255-19), twisted Edwards curve
-x^2 + y^2 = 1 + d x^2 y^2, extended homogeneous coordinates (X, Y, Z, T)
with x = X/Z, y = Y/Z, x*y = T/Z. Sign/verify over 32-byte digests, as the
reference's ed25519-dalek usage (``crypto/src/lib.rs:177-220``).
"""

from __future__ import annotations

import hashlib
import secrets

P = 2**255 - 19
# Group order L = 2^252 + delta.
L = 2**252 + 27742317777372353535851937790883648493
# Curve constant d = -121665/121666 mod p.
D = (-121665 * pow(121666, P - 2, P)) % P
# sqrt(-1) mod p, used in decompression.
SQRT_M1 = pow(2, (P - 1) // 4, P)


def _sha512(data: bytes) -> bytes:
    return hashlib.sha512(data).digest()


def inv(x: int) -> int:
    return pow(x, P - 2, P)


# ---------------------------------------------------------------------------
# Point arithmetic in extended homogeneous coordinates.
# A point is a tuple (X, Y, Z, T). Neutral element: (0, 1, 1, 0).
# ---------------------------------------------------------------------------

IDENTITY = (0, 1, 1, 0)


def point_add(p, q):
    """Unified addition (RFC 8032 section 5.1.4)."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = 2 * t1 * t2 * D % P
    dd = 2 * z1 * z2 % P
    e, f, g, h = b - a, dd - c, dd + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def point_double(p):
    """Dedicated doubling (dbl-2008-hwcd); valid for a = -1 curves."""
    x1, y1, z1, _ = p
    a = x1 * x1 % P
    b = y1 * y1 % P
    c = 2 * z1 * z1 % P
    h = (a + b) % P
    e = (h - (x1 + y1) * (x1 + y1)) % P
    g = (a - b) % P
    f = (c + g) % P
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def point_mul(s: int, p):
    """Scalar multiplication by double-and-add (LSB-first)."""
    q = IDENTITY
    while s > 0:
        if s & 1:
            q = point_add(q, p)
        p = point_double(p)
        s >>= 1
    return q


def point_equal(p, q) -> bool:
    x1, y1, z1, _ = p
    x2, y2, z2, _ = q
    return (x1 * z2 - x2 * z1) % P == 0 and (y1 * z2 - y2 * z1) % P == 0


def is_identity(p) -> bool:
    return point_equal(p, IDENTITY)


def recover_x(y: int, sign: int) -> int | None:
    """x from y via x^2 = (y^2-1)/(d y^2+1); None if not on curve."""
    if y >= P:
        return None
    x2 = (y * y - 1) * inv(D * y * y + 1) % P
    if x2 == 0:
        if sign:
            return None
        return 0
    # Square root by exponentiation to (p+3)/8.
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P != 0:
        x = x * SQRT_M1 % P
    if (x * x - x2) % P != 0:
        return None
    if (x & 1) != sign:
        x = P - x
    return x


# Base point: y = 4/5, x recovered with even sign.
_BY = 4 * inv(5) % P
_BX = recover_x(_BY, 0)
G = (_BX, _BY, 1, _BX * _BY % P)


def point_compress(p) -> bytes:
    x, y, z, _ = p
    zi = inv(z)
    x, y = x * zi % P, y * zi % P
    return int.to_bytes(y | ((x & 1) << 255), 32, "little")


def point_decompress(s: bytes):
    """Decompress 32 bytes to a point; None if invalid.

    Rejects non-canonical y (y >= p), matching dalek/RFC strictness on field
    element decoding.
    """
    if len(s) != 32:
        return None
    val = int.from_bytes(s, "little")
    sign = val >> 255
    y = val & ((1 << 255) - 1)
    if y >= P:
        return None
    x = recover_x(y, sign)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


def is_small_order(p) -> bool:
    """True if the point is in the 8-torsion subgroup."""
    return is_identity(point_mul(8, p))


def torsion_generator():
    """A point of exact order 8 (generator of the torsion subgroup).

    Found by clearing the prime-order component (L*Q) of deterministic
    pseudo-random curve points until one of full order 8 remains.
    """
    import random as _random

    rng = _random.Random(0xED25519)
    while True:
        y = rng.randrange(P)
        x = recover_x(y, 0)
        if x is None:
            continue
        t = point_mul(L, (x, y, 1, x * y % P))
        if not is_identity(point_mul(4, t)):
            return t


# ---------------------------------------------------------------------------
# Keys and signatures (RFC 8032 section 5.1.5-5.1.7).
# ---------------------------------------------------------------------------


def secret_expand(seed: bytes) -> tuple[int, bytes]:
    """Expand a 32-byte seed into the clamped scalar and the hash prefix."""
    h = _sha512(seed)
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


def secret_to_public(seed: bytes) -> bytes:
    a, _ = secret_expand(seed)
    return point_compress(point_mul(a, G))


def sign(seed: bytes, msg: bytes) -> bytes:
    a, prefix = secret_expand(seed)
    pub = point_compress(point_mul(a, G))
    r = int.from_bytes(_sha512(prefix + msg), "little") % L
    big_r = point_compress(point_mul(r, G))
    h = int.from_bytes(_sha512(big_r + pub + msg), "little") % L
    s = (r + h * a) % L
    return big_r + int.to_bytes(s, 32, "little")


def compute_challenge(big_r: bytes, pub: bytes, msg: bytes) -> int:
    """h = SHA-512(R || A || M) mod L — the per-signature challenge scalar."""
    return int.from_bytes(_sha512(big_r + pub + msg), "little") % L


def verify(pub: bytes, msg: bytes, sig: bytes, *, strict: bool = True) -> bool:
    """Verify a signature.

    ``strict=True`` mirrors dalek's ``verify_strict`` (reference
    ``crypto/src/lib.rs:200-204``): canonical s, canonical point encodings,
    and neither A nor R of small order; checks the cofactorless equation
    s·B == R + h·A. ``strict=False`` checks the cofactored equation
    8s·B == 8R + 8h·A (RFC 8032 semantics, matching dalek's batch verifier).
    """
    if len(sig) != 64 or len(pub) != 32:
        return False
    a_pt = point_decompress(pub)
    if a_pt is None:
        return False
    r_pt = point_decompress(sig[:32])
    if r_pt is None:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return False
    if strict and (is_small_order(a_pt) or is_small_order(r_pt)):
        return False
    h = compute_challenge(sig[:32], pub, msg)
    lhs = point_mul(s, G)
    rhs = point_add(r_pt, point_mul(h, a_pt))
    if strict:
        return point_equal(lhs, rhs)
    return point_equal(point_mul(8, lhs), point_mul(8, rhs))


def verify_batch_rlc(items, rng=None) -> bool:
    """Random-linear-combination batch verification (dalek-equivalent
    semantics of reference ``crypto/src/lib.rs:206-219``).

    ``items`` is a sequence of ``(pub32, msg, sig64)``. Checks

        8·[ (-sum z_i s_i mod L)·B + sum z_i·R_i + sum (z_i h_i mod L)·A_i ] == O

    with independent 128-bit random ``z_i``. This is the exact equation the
    TPU MSM kernel evaluates; kept here as the slow oracle.
    """
    terms = []  # (scalar, point) pairs of the MSM
    b_coeff = 0
    for pub, msg, sig in items:
        if len(sig) != 64:
            return False
        a_pt = point_decompress(pub)
        r_pt = point_decompress(sig[:32])
        if a_pt is None or r_pt is None:
            return False
        s = int.from_bytes(sig[32:], "little")
        if s >= L:
            return False
        z = (rng.getrandbits(128) if rng else secrets.randbits(128)) | 1
        h = compute_challenge(sig[:32], pub, msg)
        b_coeff = (b_coeff + z * s) % L
        terms.append((z, r_pt))
        terms.append((z * h % L, a_pt))
    terms.append(((-b_coeff) % L, G))
    acc = IDENTITY
    for scalar, pt in terms:
        acc = point_add(acc, point_mul(scalar, pt))
    return is_identity(point_mul(8, acc))
