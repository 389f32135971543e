"""Frozen plain Ed25519 (RFC 8032) in Python integers: signing, the strict
single check and the cofactored random-linear-combination batch check.

This is the yardstick's own arithmetic. It imports nothing of the program
under test and nothing outside the standard library, and it is frozen: the
verdicts it gives are the ones the benchmark holds the program to.

Points are extended twisted Edwards coordinates ``(X, Y, Z, T)`` with
``x = X/Z``, ``y = Y/Z``, ``xy = T/Z`` on ``-x^2 + y^2 = 1 + d x^2 y^2``
(RFC 8032 section 5.1.4). An addend that is used many times is kept in the
"cached" form ``(Y+X, Y-X, 2dT, 2Z)``, which saves two multiplications an
addition.

Acceptance rules, as the port states them:

- ``verify_strict`` (a block author's signature): ``s < L``, both
  encodings canonical (``y < p``) and decompressible, neither point of
  small order, and ``[s]B == R + [k]A`` exactly (cofactorless);
- ``verify_batch_cofactored`` (a certificate's votes): every ``s < L``,
  every encoding canonical and decompressible, and
  ``[8](sum z_i R_i + sum (z_i k_i) A_i - (sum z_i s_i) B) == O`` with
  128-bit random ``z_i`` (top bit set), where ``k_i = H(R_i || A_i || M_i)``.
"""

from __future__ import annotations

import hashlib

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = -121665 * pow(121666, P - 2, P) % P
D2 = 2 * D % P
SQRT_M1 = pow(2, (P - 1) // 4, P)
_HALF = (1 << 255) - 1

IDENTITY = (0, 1, 1, 0)


def _recover_x(y: int, sign: int) -> int | None:
    """RFC 8032 section 5.1.3, steps 2-4."""
    yy = y * y % P
    u = (yy - 1) % P
    v = (D * yy + 1) % P
    v3 = v * v % P * v % P
    x = u * v3 % P * pow(u * v3 % P * v3 % P * v, (P - 5) // 8, P) % P
    vxx = v * x % P * x % P
    if vxx != u:
        if vxx != (-u) % P:
            return None
        x = x * SQRT_M1 % P
    if x == 0 and sign:
        return None
    if x & 1 != sign:
        x = P - x
    return x


_BY = 4 * pow(5, P - 2, P) % P
_BX = _recover_x(_BY, 0)
BASE = (_BX, _BY, 1, _BX * _BY % P)


def add(p, q):
    """Unified addition (RFC 8032 section 5.1.4)."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = t1 * D2 % P * t2 % P
    d = 2 * z1 * z2 % P
    e = b - a
    f = d - c
    g = d + c
    h = b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def cached(p):
    """``p`` as an addend: (Y+X, Y-X, 2dT, 2Z)."""
    x, y, z, t = p
    return ((y + x) % P, (y - x) % P, t * D2 % P, 2 * z % P)


_INV_D = pow(D, P - 2, P)


def uncached(q):
    """A cached addend back in extended coordinates (all four scaled by 2)."""
    ypx, ymx, t2d, z2 = q
    return ((ypx - ymx) % P, (ypx + ymx) % P, z2, t2d * _INV_D % P)


def add_cached(p, q):
    """``p + q`` with ``q`` in cached form."""
    x1, y1, z1, t1 = p
    ypx, ymx, t2d, z2 = q
    a = (y1 - x1) * ymx % P
    b = (y1 + x1) * ypx % P
    c = t1 * t2d % P
    d = z1 * z2 % P
    e = b - a
    f = d - c
    g = d + c
    h = b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def double(p):
    """Doubling (RFC 8032 section 5.1.4)."""
    x1, y1, z1, _ = p
    a = x1 * x1 % P
    b = y1 * y1 % P
    c = 2 * z1 * z1 % P
    h = a + b
    e = h - (x1 + y1) * (x1 + y1) % P
    g = a - b
    f = c + g
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def neg(p):
    x, y, z, t = p
    return ((-x) % P, y, z, (-t) % P)


def is_identity(p) -> bool:
    x, y, z, _ = p
    return x % P == 0 and (y - z) % P == 0


def equal(p, q) -> bool:
    x1, y1, z1, _ = p
    x2, y2, z2, _ = q
    return (x1 * z2 - x2 * z1) % P == 0 and (y1 * z2 - y2 * z1) % P == 0


def compress(p) -> bytes:
    x, y, z, _ = p
    zi = pow(z, P - 2, P)
    x = x * zi % P
    y = y * zi % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def decompress(enc: bytes):
    """The point an encoding names, or None: non-canonical (``y >= p``),
    off the curve, or ``x = 0`` with the sign bit set."""
    if len(enc) != 32:
        return None
    v = int.from_bytes(enc, "little")
    y = v & _HALF
    if y >= P:
        return None
    x = _recover_x(y, v >> 255)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


def mul(k: int, p):
    """``[k]p`` by a 4-bit fixed window (any point, any k >= 0)."""
    table = [IDENTITY, p]
    for _ in range(14):
        table.append(add(table[-1], p))
    table = [cached(q) for q in table]
    acc = IDENTITY
    for shift in range(((k.bit_length() + 3) // 4) * 4 - 4, -4, -4):
        acc = double(double(double(double(acc))))
        d = (k >> shift) & 15
        if d:
            acc = add_cached(acc, table[d])
    return acc


def small_order(p) -> bool:
    return is_identity(double(double(double(p))))


class Comb:
    """Fixed-base comb of radix ``2^w``: ``[k]Q`` for any ``k < 2^256`` in at
    most ``256 / w`` cached additions and no doubling."""

    __slots__ = ("rows", "w")

    def __init__(self, q, w: int = 4) -> None:
        self.w = w
        rows = []
        base = q
        for _ in range(-(-256 // w)):
            row = [None]
            acc = base
            for _ in range((1 << w) - 1):
                row.append(cached(acc))
                acc = add(acc, base)
            rows.append(row)
            base = acc  # 2^w * base
        self.rows = rows

    def mul(self, k: int):
        acc = IDENTITY
        i = 0
        rows, w = self.rows, self.w
        mask = (1 << w) - 1
        while k:
            d = k & mask
            if d:
                acc = add_cached(acc, rows[i][d])
            k >>= w
            i += 1
        return acc


_BASE_COMB: Comb | None = None


def base_comb() -> Comb:
    """The radix-256 comb of the base point, built at first use."""
    global _BASE_COMB
    if _BASE_COMB is None:
        _BASE_COMB = Comb(BASE, 8)
    return _BASE_COMB


def sha512_int(*chunks: bytes) -> int:
    h = hashlib.sha512()
    for c in chunks:
        h.update(c)
    return int.from_bytes(h.digest(), "little")


# ---------------------------------------------------------------------------
# Keys and signing (RFC 8032 section 5.1.5-5.1.6)
# ---------------------------------------------------------------------------


def expand(seed: bytes) -> tuple[int, bytes, bytes]:
    """(secret scalar a, prefix, public key encoding) of a 32-byte seed."""
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:], compress(base_comb().mul(a))


def sign(a: int, prefix: bytes, pub: bytes, msg: bytes) -> bytes:
    return sign_many([(a, prefix, pub, msg)])[0]


def compress_many(points) -> list[bytes]:
    """``compress`` of each point, with one inversion for all of them."""
    prefix = []
    acc = 1
    for p in points:
        prefix.append(acc)
        acc = acc * p[2] % P
    inv = pow(acc, P - 2, P)
    out = [b""] * len(points)
    for i in range(len(points) - 1, -1, -1):
        x, y, z, _ = points[i]
        zi = inv * prefix[i] % P
        inv = inv * z % P
        out[i] = ((y * zi % P) | (((x * zi % P) & 1) << 255)).to_bytes(32, "little")
    return out


def sign_many(items) -> list[bytes]:
    """RFC 8032 signatures of ``(a, prefix, pub, msg)`` items."""
    comb = base_comb()
    rs = [sha512_int(prefix, msg) % L for _, prefix, _, msg in items]
    r_encs = compress_many([comb.mul(r) for r in rs])
    out = []
    for (a, _, pub, msg), r, r_enc in zip(items, rs, r_encs):
        k = sha512_int(r_enc, pub, msg) % L
        out.append(r_enc + ((r + k * a) % L).to_bytes(32, "little"))
    return out


# ---------------------------------------------------------------------------
# Verification
# ---------------------------------------------------------------------------


class KeyTable:
    """Decompressed public keys, memoised by encoding (a pure function)."""

    def __init__(self) -> None:
        self.points: dict[bytes, tuple | None] = {}

    def point(self, enc: bytes):
        if enc not in self.points:
            self.points[enc] = decompress(enc)
        return self.points[enc]


def _strict_parts(pub: bytes, msg: bytes, sig: bytes, keys: KeyTable):
    """(A, R, s, k) of a signature that passes the strict per-signature
    conditions short of the equation, else None."""
    if len(sig) != 64 or len(pub) != 32:
        return None
    r_enc, s = sig[:32], int.from_bytes(sig[32:], "little")
    if s >= L:
        return None
    a = keys.point(pub)
    r = decompress(r_enc)
    if a is None or r is None or small_order(a) or small_order(r):
        return None
    return a, r, s, sha512_int(r_enc, pub, msg) % L


def verify_strict(pub: bytes, msg: bytes, sig: bytes, keys: KeyTable | None = None) -> bool:
    """Strict single verification (see the module docstring)."""
    parts = _strict_parts(pub, msg, sig, keys if keys is not None else KeyTable())
    if parts is None:
        return False
    a, r, s, k = parts
    return equal(base_comb().mul(s), add(r, mul(k, a)))


def verify_strict_many(items, rng, keys: KeyTable | None = None) -> list[bool]:
    """``verify_strict`` of each ``(pub, msg, sig)``. The equations of all
    signatures that pass the per-signature conditions are first checked
    together, ``sum z_i ([s_i]B - R_i - [k_i]A_i) == O`` with 128-bit
    random ``z_i``; only when that fails is each checked alone. Equations
    that fail by points of large order cancel in the combination with
    chance below 2^-120; a defect of small order could cancel, and the
    signatures judged here are made by the benchmark, which crafts none."""
    keys = keys if keys is not None else KeyTable()
    parts = [_strict_parts(pub, msg, sig, keys) for pub, msg, sig in items]
    live = [i for i, p in enumerate(parts) if p is not None]
    verdicts = [False] * len(items)
    if not live:
        return verdicts
    r_points, r_scalars = [], []
    per_key: dict[bytes, int] = {}
    b_coeff = 0
    for i in live:
        a, r, s, k = parts[i]
        z = rng.getrandbits(128) | (1 << 127)
        b_coeff = (b_coeff + z * s) % L
        r_points.append(cached(neg(r)))
        r_scalars.append(z)
        pub = items[i][0]
        per_key[pub] = (per_key.get(pub, 0) + z * k) % L
    points = r_points + [cached(neg(keys.point(pub))) for pub in per_key] + [cached(BASE)]
    scalars = r_scalars + list(per_key.values()) + [b_coeff]
    if is_identity(_pippenger(points, scalars, _window_bits(len(points)))):
        for i in live:
            verdicts[i] = True
        return verdicts
    for i in live:
        a, r, s, k = parts[i]
        verdicts[i] = equal(base_comb().mul(s), add(r, mul(k, a)))
    return verdicts


def _pippenger(points, scalars, c: int):
    """sum scalars[i] * points[i]; points in cached form, scalars >= 0."""
    nbits = max((s.bit_length() for s in scalars), default=0)
    mask = (1 << c) - 1
    acc = None
    for w in range((nbits + c - 1) // c - 1, -1, -1):
        if acc is not None:
            for _ in range(c):
                acc = double(acc)
        shift = w * c
        buckets: list = [None] * (mask + 1)
        for q, s in zip(points, scalars):
            d = (s >> shift) & mask
            if d:
                b = buckets[d]
                buckets[d] = uncached(q) if b is None else add_cached(b, q)
        run = None
        total = None
        for d in range(mask, 0, -1):
            b = buckets[d]
            if b is not None:
                run = b if run is None else add(run, b)
            if run is not None:
                total = run if total is None else add(total, run)
        if total is not None:
            acc = total if acc is None else add(acc, total)
    return IDENTITY if acc is None else acc


def _window_bits(n: int) -> int:
    """Bucket width near the least additions for n points."""
    return max(2, n.bit_length() - 4)


def verify_batch_cofactored(msgs, pubs, sigs, rng, keys: KeyTable | None = None) -> bool:
    """Cofactored RLC batch verification (see the module docstring);
    ``rng`` is a ``random.Random`` that draws the coefficients."""
    if not len(msgs) == len(pubs) == len(sigs):
        return False
    if not msgs:
        return True
    points = []
    scalars = []
    b_coeff = 0
    for msg, pub, sig in zip(msgs, pubs, sigs):
        if len(sig) != 64 or len(pub) != 32:
            return False
        r_enc, s = sig[:32], int.from_bytes(sig[32:], "little")
        if s >= L:
            return False
        a = keys.point(pub) if keys is not None else decompress(pub)
        r = decompress(r_enc)
        if a is None or r is None:
            return False
        z = rng.getrandbits(128) | (1 << 127)
        k = sha512_int(r_enc, pub, msg) % L
        b_coeff = (b_coeff + z * s) % L
        points.append(cached(r))
        scalars.append(z)
        points.append(cached(a))
        scalars.append(z * k % L)
    points.append(cached(BASE))
    scalars.append((-b_coeff) % L)
    total = _pippenger(points, scalars, _window_bits(len(points)))
    return is_identity(double(double(double(total))))
