"""Edwards25519 point operations and the plain MSM on torch tensors.

Port of ``hotstuff_tpu/ops/curve.py``. Points are ``int32[..., 4, 20]`` —
stacked (X, Y, Z, T) extended homogeneous coordinates on the a = -1 twisted
Edwards curve, with the unified add-2008-hwcd-3 and dbl-2008-hwcd formulas
of the pure-Python oracle (``crypto/ed25519_ref.py``).

``msm``/``msm_signed`` follow the reference's ``curve.msm``/``msm_signed``
step by step (shared doublings, per-point tables, a lane tree-reduce per
window). They are the plain versions the MSM wrappers of
``ops/msm_kernels.py`` take for CPU tensors; the recoders are numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from . import field as fe

# Identity element (0, 1, 1, 0).
IDENTITY = np.stack(
    [fe.ZERO_LIMBS, fe.ONE_LIMBS, fe.ONE_LIMBS, fe.ZERO_LIMBS]
).astype(np.int32)

# Base point.
_BX = 15112221349535400772501151409588531511454012693041857206046113283949847762202
_BY = 46316835694926478169428394003475163141307993866256225615783033603165251855960
BASE_POINT = np.stack(
    [
        fe._int_to_limbs(_BX),
        fe._int_to_limbs(_BY),
        fe.ONE_LIMBS,
        fe._int_to_limbs(_BX * _BY % fe.P),
    ]
).astype(np.int32)

WINDOW_BITS = 4
N_WINDOWS = 64  # 256 bits / 4
TABLE = 1 << WINDOW_BITS


def identity(batch_shape=(), device="cpu") -> torch.Tensor:
    """The identity, read-only, broadcast to ``batch_shape``."""
    return fe.const(IDENTITY, device).expand(*batch_shape, 4, 20)


def point_add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Unified addition (add-2008-hwcd-3, a = -1): valid for doubling and
    identity operands, no branches."""
    x1, y1, z1, t1 = p[..., 0, :], p[..., 1, :], p[..., 2, :], p[..., 3, :]
    x2, y2, z2, t2 = q[..., 0, :], q[..., 1, :], q[..., 2, :], q[..., 3, :]
    a = fe.mul(fe.sub(y1, x1), fe.sub(y2, x2))
    b = fe.mul(fe.add(y1, x1), fe.add(y2, x2))
    c = fe.mul(fe.mul(t1, fe.const(fe.D2_LIMBS, t1)), t2)
    d = fe.mul(fe.add(z1, z1), z2)
    e = fe.sub(b, a)
    f = fe.sub(d, c)
    g = fe.add(d, c)
    h = fe.add(b, a)
    return torch.stack([fe.mul(e, f), fe.mul(g, h), fe.mul(f, g), fe.mul(e, h)], dim=-2)


def point_double(p: torch.Tensor) -> torch.Tensor:
    """Dedicated doubling (dbl-2008-hwcd): 4 squarings + 4 muls."""
    x1, y1, z1 = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    a = fe.square(x1)
    b = fe.square(y1)
    zz = fe.square(z1)
    c = fe.add(zz, zz)
    h = fe.add(a, b)
    e = fe.sub(h, fe.square(fe.add(x1, y1)))
    g = fe.sub(a, b)
    f = fe.add(c, g)
    return torch.stack([fe.mul(e, f), fe.mul(g, h), fe.mul(f, g), fe.mul(e, h)], dim=-2)


def point_select(mask: torch.Tensor, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """mask ? p : q with mask shaped [...]."""
    return torch.where(mask[..., None, None], p, q)


def point_eq(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Projective equality: X1 Z2 == X2 Z1 and Y1 Z2 == Y2 Z1."""
    x1, y1, z1 = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    x2, y2, z2 = q[..., 0, :], q[..., 1, :], q[..., 2, :]
    return fe.eq(fe.mul(x1, z2), fe.mul(x2, z1)) & fe.eq(fe.mul(y1, z2), fe.mul(y2, z1))


def is_identity(p: torch.Tensor) -> torch.Tensor:
    x, y, z = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    return fe.is_zero(x) & fe.eq(y, z)


def point_neg(p: torch.Tensor) -> torch.Tensor:
    """-(X : Y : Z : T) = (-X : Y : Z : -T)."""
    return torch.stack(
        [fe.neg(p[..., 0, :]), p[..., 1, :], p[..., 2, :], fe.neg(p[..., 3, :])], dim=-2
    )


def mul_by_cofactor(p: torch.Tensor) -> torch.Tensor:
    return point_double(point_double(point_double(p)))


def decompress_ratio(y_limbs: torch.Tensor):
    """(u, v) = (y^2 - 1, d y^2 + 1): x^2 = u / v on the curve."""
    yy = fe.square(y_limbs)
    one = fe.fe_from_int(1, yy.shape[:-1], device=yy.device)
    return fe.sub(yy, one), fe.add(fe.mul(yy, fe.const(fe.D_LIMBS, yy)), one)


def decompress(y_limbs: torch.Tensor, sign: torch.Tensor, root_fn=None):
    """Batch point decompression: x^2 = (y^2-1)/(d y^2+1).

    ``y_limbs``: int32[..., 20] (the 255-bit y; the caller rejects
    non-canonical y >= p host-side and strips the sign bit); ``sign``:
    int32[...] in {0, 1}. Returns (ok[...], point[..., 4, 20]). ``root_fn``
    routes the exponentiation to the CUDA kernel on the card.
    """
    u, v = decompress_ratio(y_limbs)
    one = fe.fe_from_int(1, y_limbs.shape[:-1], device=y_limbs.device)
    ok, x = fe.sqrt_ratio(u, v, root_fn=root_fn)
    x = fe.canonical(x)
    flip = (x[..., 0] & 1) != sign
    x = fe.select(flip, fe.neg(x), x)
    # sign=1 with x=0 encodes no valid point (RFC 8032 strict decoding).
    ok = ok & ~(fe.is_zero(x) & (sign == 1))
    point = torch.stack([x, y_limbs, one, fe.mul(x, y_limbs)], dim=-2)
    return ok, point


def to_affine_bytes(p: torch.Tensor) -> bytes:
    """Single point -> 32-byte compressed encoding (host-side, for tests
    and for comparing MSM results whose additions ran in another order)."""
    zi = fe.inv(p[..., 2, :])
    x = fe.canonical(fe.mul(p[..., 0, :], zi)).cpu().numpy()
    y = fe.canonical(fe.mul(p[..., 1, :], zi)).cpu().numpy()
    xb = fe.fe_to_bytes(x)
    yb = fe.fe_to_bytes(y)
    yb[..., 31] |= (xb[..., 0] & 1) << 7
    return bytes(yb.reshape(-1))


# ---------------------------------------------------------------------------
# Scalar recoding (numpy, host-side).
# ---------------------------------------------------------------------------


def scalars_to_digits(scalars: list[int]) -> np.ndarray:
    """256-bit scalars -> int32[N_WINDOWS, m] radix-16 digits, MSB-first."""
    m = len(scalars)
    out = np.zeros((N_WINDOWS, m), dtype=np.int32)
    for j, s in enumerate(scalars):
        for w in range(N_WINDOWS):
            out[w, j] = (s >> (WINDOW_BITS * (N_WINDOWS - 1 - w))) & (TABLE - 1)
    return out


def _signed_carry_sweep(nibs: np.ndarray) -> np.ndarray:
    """LSB-first nibbles [n_windows, m] -> signed digits in [-8, 8],
    MSB-first (a digit above 8 borrows 16 from the next window)."""
    carry = np.zeros(nibs.shape[1], dtype=np.int32)
    for w in range(nibs.shape[0]):
        d = nibs[w] + carry
        carry = (d > 8).astype(np.int32)
        nibs[w] = d - 16 * carry
    if carry.any():
        raise ValueError("top-window carry (scalar too wide)")
    return nibs[::-1]


def scalars_to_signed_digits(scalars: list[int], n_windows: int) -> np.ndarray:
    """Scalars -> int32[n_windows, m] SIGNED radix-16 digits in [-8, 8],
    MSB-first, with sum_w d_w * 16^(n_windows-1-w) == s. Requires
    s < 16^n_windows / 2 (mod-L scalars fit 64 windows, 128-bit RLC
    coefficients fit 33)."""
    m = len(scalars)
    nibs = np.zeros((n_windows, m), dtype=np.int32)  # LSB-first here
    for j, s in enumerate(scalars):
        if 2 * s >= 1 << (4 * n_windows):
            raise ValueError("scalar too wide for window count")
        for w in range(n_windows):
            nibs[w, j] = (s >> (4 * w)) & 0xF
    return _signed_carry_sweep(nibs)


def signed_digits_from_bytes(scalar_bytes: np.ndarray, n_windows: int) -> np.ndarray:
    """Vectorized ``scalars_to_signed_digits``: uint8[m, 32] little-endian
    scalars -> int32[n_windows, m] signed digits, MSB-first."""
    sb = np.asarray(scalar_bytes, dtype=np.uint8)
    m = sb.shape[0]
    nibs = np.empty((64, m), dtype=np.int32)  # LSB-first
    nibs[0::2] = (sb & 0xF).astype(np.int32).T
    nibs[1::2] = (sb >> 4).astype(np.int32).T
    if nibs[n_windows:].any():
        raise ValueError("scalar too wide for window count")
    return _signed_carry_sweep(nibs[:n_windows])


# ---------------------------------------------------------------------------
# Plain multi-scalar multiplication.
# ---------------------------------------------------------------------------


def _build_table(points: torch.Tensor, size: int) -> torch.Tensor:
    """[m, 4, 20] -> [m, size, 4, 20] with table[:, d] = d * P."""
    entries = [identity((points.shape[0],), device=points.device), points]
    for _ in range(size - 2):
        entries.append(point_add(entries[-1], points))
    return torch.stack(entries, dim=1)


def _tree_reduce(points: torch.Tensor) -> torch.Tensor:
    """Sum [m, 4, 20] points (m a power of two) by pairwise reduction."""
    m = points.shape[0]
    if m & (m - 1):
        raise ValueError("tree reduction needs power-of-two lanes")
    while m > 1:
        m //= 2
        points = point_add(points[:m], points[m:])
    return points[0]


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[j, idx[j]] for each lane j: [m, T, 4, 20], [m] -> [m, 4, 20]."""
    return table[torch.arange(table.shape[0], device=table.device), idx.long()]


def msm(points: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """sum_j e_j * P_j with shared doublings.

    ``points``: [m, 4, 20] (m a power of two; pad with the identity),
    ``digits``: [64, m] radix-16 digits of the scalars, MSB-first.
    Returns a single point [4, 20].
    """
    table = _build_table(points, TABLE)  # [m, 16, 4, 20]
    acc = identity(device=points.device)
    for w in range(digits.shape[0]):
        acc = point_double(point_double(point_double(point_double(acc))))
        acc = point_add(acc, _tree_reduce(_take(table, digits[w])))
    return acc


def msm_signed(points: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """``msm`` over SIGNED radix-16 digits: 9-entry tables + conditional
    negation. ``digits``: [n_windows, m] in [-8, 8], MSB-first."""
    table = _build_table(points, 9)  # [m, 9, 4, 20]
    acc = identity(device=points.device)
    for w in range(digits.shape[0]):
        acc = point_double(point_double(point_double(point_double(acc))))
        row = digits[w]
        sel = _take(table, row.abs())
        sel = point_select(row >= 0, sel, point_neg(sel))
        acc = point_add(acc, _tree_reduce(sel))
    return acc
