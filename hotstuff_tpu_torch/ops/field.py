"""GF(2^255-19) arithmetic in radix-2^13 limbs on torch int32.

Port of ``hotstuff_tpu/ops/field.py`` with the SAME representation, so
every intermediate compares limb for limb with the reference: a field
element is ``int32[..., 20]``, limb k weighing 2^(13k). Loose limbs
(< 2^13 + small slack) are the working form; ``canonical`` gives the unique
reduced form. Products of 13-bit limbs are <= 2^26 and a 20-term schoolbook
column sums to < 2^31; limbs >= 20 fold down by 2^260 = 19 * 2^5 (mod p).

torch int32 shares jnp int32's semantics here: ``>>`` is arithmetic, ``&``
is two's complement and products wrap mod 2^32. ``.at[].set/add`` become
slice assignment on a fresh tensor (never on a caller's view).

These functions run on any torch device. The plain versions of the CUDA
kernels are built from them; on the card, verification runs the kernels.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

NLIMB = 20
RADIX = 13
MASK = (1 << RADIX) - 1
P = 2**255 - 19

# p and 2p in canonical radix-13 limbs (int32).
P_LIMBS = np.array([8173] + [8191] * 18 + [255], dtype=np.int32)
TWO_P_LIMBS = (2 * P_LIMBS.astype(np.int64)).astype(np.int32)

# Fold factor for limbs >= 20: 2^260 = 19 * 32 (mod p).
FOLD = 19 * 32


def _int_to_limbs(x: int) -> np.ndarray:
    return np.array([(x >> (RADIX * k)) & MASK for k in range(NLIMB)], dtype=np.int32)


def _limbs_to_int(a) -> int:
    a = np.asarray(a)
    return sum(int(a[..., k]) << (RADIX * k) for k in range(NLIMB)) % P


# Curve constant d and sqrt(-1), as module-level limb constants.
D_INT = (-121665 * pow(121666, P - 2, P)) % P
D2_INT = (2 * D_INT) % P
SQRT_M1_INT = pow(2, (P - 1) // 4, P)

D_LIMBS = _int_to_limbs(D_INT)
D2_LIMBS = _int_to_limbs(D2_INT)
SQRT_M1_LIMBS = _int_to_limbs(SQRT_M1_INT)
ONE_LIMBS = _int_to_limbs(1)
ZERO_LIMBS = _int_to_limbs(0)


@functools.lru_cache(maxsize=64)
def _on_device(data: bytes, dtype: str, shape: tuple, device: torch.device) -> torch.Tensor:
    arr = np.frombuffer(data, dtype=np.dtype(dtype)).reshape(shape)
    return torch.from_numpy(arr.copy()).to(device)


def const(arr: np.ndarray, like) -> torch.Tensor:
    """A numpy constant as a tensor on the device of ``like`` (a tensor or a
    device). Copied there once per process and device, then shared, so it
    must not be written to: a fresh copy from pageable host memory would
    wait for the stream at every field op."""
    arr = np.asarray(arr)
    device = like.device if isinstance(like, torch.Tensor) else torch.device(like)
    return _on_device(arr.tobytes(), arr.dtype.str, arr.shape, device)


def fe_from_int(x: int, batch_shape=(), device="cpu") -> torch.Tensor:
    """x mod p as read-only limbs broadcast to ``batch_shape``."""
    return const(_int_to_limbs(x % P), device).expand(*batch_shape, NLIMB)


def fe_from_bytes(data: np.ndarray) -> np.ndarray:
    """uint8[..., 32] little-endian -> int32[..., 20] limbs (host-side).

    The top bit (the compression sign bit) must be cleared by the caller.
    Vectorized via 64-bit word windows."""
    data = np.asarray(data, dtype=np.uint8)
    # Pad to 40 bytes so every 13-bit window fits inside one u64 load
    # starting at the window's byte.
    padded = np.concatenate(
        [data, np.zeros((*data.shape[:-1], 8), dtype=np.uint8)], axis=-1
    )
    out = np.empty((*data.shape[:-1], NLIMB), dtype=np.int32)
    flat = padded.reshape(-1, 40)
    for k in range(NLIMB):
        bit = RADIX * k
        byte, off = bit // 8, bit % 8
        words = flat[:, byte : byte + 8].copy().view("<u8")[:, 0]
        out.reshape(-1, NLIMB)[:, k] = ((words >> off) & MASK).astype(np.int32)
    return out


def fe_to_bytes(limbs) -> np.ndarray:
    """int32[..., 20] -> uint8[..., 32] little-endian of the value mod p
    (host-side)."""
    limbs = np.asarray(limbs)
    batch = limbs.shape[:-1]
    out = np.zeros((*batch, 32), dtype=np.uint8)
    flat = limbs.reshape(-1, NLIMB)
    oflat = out.reshape(-1, 32)
    for i in range(flat.shape[0]):
        val = sum(int(flat[i, k]) << (RADIX * k) for k in range(NLIMB)) % P
        oflat[i] = np.frombuffer(val.to_bytes(32, "little"), dtype=np.uint8)
    return out


# ---------------------------------------------------------------------------
# Core arithmetic. All functions take/return int32[..., 20].
# ---------------------------------------------------------------------------


def _carry_pass(a: torch.Tensor) -> torch.Tensor:
    """One parallel carry pass with wraparound fold: every limb sheds its
    >= 2^13 part to its neighbour; the top limb's carry folds to limb 0
    with factor 608."""
    c = a >> RADIX
    return (a & MASK) + torch.cat([c[..., -1:] * FOLD, c[..., :-1]], dim=-1)


def carry(a: torch.Tensor) -> torch.Tensor:
    """Normalize to loose limbs < 2^13 + 608 (three parallel passes)."""
    return _carry_pass(_carry_pass(_carry_pass(a)))


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return carry(a + b)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b + 2p (keeps limbs non-negative for carried inputs)."""
    return carry(a + const(TWO_P_LIMBS, a) - b)


def neg(a: torch.Tensor) -> torch.Tensor:
    return carry(const(TWO_P_LIMBS, a) - a)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook 20x20 -> 39 columns, carry, fold >= 20 by 608, carry.

    The columns are the reference's (``ops/field.py`` ``mul``): the outer
    product is skewed so that product (i, j) lands in column i + j, and
    summed per column. The sum runs in int64 and is cut back to int32,
    which equals the reference's wrapping int32 sum mod 2^32.
    """
    a, b = torch.broadcast_tensors(a, b)
    batch = a.shape[:-1]
    prod = a[..., :, None] * b[..., None, :]  # [..., 20, 20], int32
    # Row i padded to 40 and re-read with row length 39 puts (i, j) at
    # column i + j (i + j <= 38), zeros elsewhere.
    skew = torch.nn.functional.pad(prod, (0, NLIMB))  # [..., 20, 40]
    skew = skew.reshape(*batch, 2 * NLIMB * NLIMB)[..., : NLIMB * (2 * NLIMB - 1)]
    cols = skew.reshape(*batch, NLIMB, 2 * NLIMB - 1).sum(dim=-2).to(torch.int32)

    # One parallel carry pass over the 39 columns (no wraparound: the top
    # carry becomes virtual column 39).
    c = cols >> RADIX
    low = cols & MASK
    cols = torch.cat([low[..., :1], low[..., 1:] + c[..., :-1]], dim=-1)
    c39 = c[..., -1:]

    # Fold columns 20..38 and the virtual column 39 down by 608.
    high = torch.cat([cols[..., NLIMB:], c39], dim=-1)  # 20 limbs
    return carry(cols[..., :NLIMB] + high * FOLD)


def square(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def pow_const(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a fixed public exponent: square-and-multiply over the
    exponent bits LSB-first (the reference's scan; a zero bit keeps the
    result, so its discarded product is skipped)."""
    assert e > 0
    result = torch.zeros_like(a) + const(ONE_LIMBS, a)
    base = a
    for k in range(e.bit_length()):
        if (e >> k) & 1:
            result = mul(result, base)
        base = square(base)
    return result


def inv(a: torch.Tensor) -> torch.Tensor:
    return pow_const(a, P - 2)


def canonical(a: torch.Tensor) -> torch.Tensor:
    """Fully reduced form in [0, p): fold the bits at and above 2^255 back
    as *19, twice, then one conditional subtract of p."""
    a = carry(carry(a))
    for _ in range(2):
        hi = a[..., 19:] >> 8
        a = torch.cat([a[..., :1] + hi * 19, a[..., 1:19], a[..., 19:] & 0xFF], dim=-1)
        a = carry(a)
    ge = _geq_p(a)
    return torch.where(ge[..., None], _sub_exact(a, const(P_LIMBS, a)), a)


def _geq_p(a: torch.Tensor) -> torch.Tensor:
    """a >= p for carried inputs (limbs < 2^13)."""
    gt = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    eq_ = torch.ones(a.shape[:-1], dtype=torch.bool, device=a.device)
    for k in range(NLIMB - 1, -1, -1):
        gt = gt | (eq_ & (a[..., k] > int(P_LIMBS[k])))
        eq_ = eq_ & (a[..., k] == int(P_LIMBS[k]))
    return gt | eq_


def _sub_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b with borrow propagation; requires a >= b (both carried)."""
    diff = a - b
    borrow = torch.zeros_like(diff[..., 0])
    limbs = []
    for k in range(NLIMB):
        t = diff[..., k] - borrow
        borrow = (t < 0).to(torch.int32)
        limbs.append(t + (borrow << RADIX))
    return torch.stack(limbs, dim=-1)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Field equality (canonicalizes both sides)."""
    return torch.all(canonical(a) == canonical(b), dim=-1)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return torch.all(canonical(a) == 0, dim=-1)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """mask ? a : b, with mask shaped [...]."""
    return torch.where(mask[..., None], a, b)


def sqrt_ratio(u: torch.Tensor, v: torch.Tensor, root_fn=None):
    """(was_square, sqrt(u/v)) — the decompression square root.

    r = u * v^3 * (u * v^7)^((p-5)/8); then r^2 * v in {u, -u} decides the
    branch, fixing r by sqrt(-1) when needed. ``root_fn(u, v)`` overrides
    the candidate-root computation (the CUDA kernel on the card).
    """
    if root_fn is not None:
        r = root_fn(u, v)
    else:
        v3 = mul(square(v), v)
        v7 = mul(square(v3), v)
        r = mul(mul(u, v3), pow_const(mul(u, v7), (P - 5) // 8))
    check = mul(square(r), v)
    u_neg = neg(u)
    correct = eq(check, u)
    flipped = eq(check, u_neg)
    r = select(flipped, mul(r, const(SQRT_M1_LIMBS, r)), r)
    return correct | flipped, r


def parity(a: torch.Tensor) -> torch.Tensor:
    """Low bit of the canonical value (the compression sign)."""
    return canonical(a)[..., 0] & 1
