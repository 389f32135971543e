"""The least time the H100 could take for the certificate checks of a
window: work counted from the batch equation, never from a kernel's grid.

A batch of n signatures (one certificate's votes) is checked by

    [8] (sum z_i R_i + sum (z_i k_i) A_i - (sum z_i s_i) B) == O

with 128-bit z_i. The committee's keys A_i are decompressed once and kept
(not counted per batch). Per batch the equation needs, in field
multiplications (M) and squarings (S):

- n decompressions of R_i, DECOMPRESS_MULS + DECOMPRESS_SQUARINGS each.
  RFC 8032's decoding takes y^2 (S), d y^2 (M), v^2 (S), v^3 (M),
  v^6 (S), v^7 (M), u v^3 (M), u v^7 (M), x (M), x^2 (S) and v x^2 (M)
  around the power (p - 5) / 8 = 2^252 - 3, whose shortest known chain
  takes 251 S and 11 M, and T = x y (M): 19 M and 255 S;
- one multi-scalar multiplication over n points at 128 bits (the R_i) and
  n + 1 at 253 bits (the A_i and B) by the bucket method, its doublings
  shared: 253 doublings (3 M + 4 S each, no T output) and the additions
  at the best window width (``msm_additions``), each a mixed addition
  with an affine addend (7 M), the cheapest addition;
- three doublings for the cofactor; the identity test (X = 0, Y = Z)
  compares limbs and multiplies nothing.

A field multiplication is FIELD_MUL_MADDS int32 multiply-adds: on eight
32-bit limbs, 64 schoolbook partial products of two int32 multiply-adds
each (low and high halves), and 8 products by 38 for the reduction mod
2^255 - 19. A squaring is FIELD_SQR_MADDS: 36 partial products (8 squares
and 28 cross products, doubled by a shift) and the same reduction. A
layout that needed fewer would lower the least time, and the share with
it.

Bytes: each signature (64), each distinct message digest (32), each
cached key row at the least a decompressed point takes (affine x and y,
64), and the one-byte verdict.

The peak: 64 int32 multiply-adds per clock per SM (CUDA C++ Programming
Guide, arithmetic instructions, compute capability 9.0) times the card's
SMs times its highest SM clock (``nvidia-smi`` ``clocks.max.sm``), and
HBM3 at 3.35 TB/s (H100 SXM data sheet). The least time is the larger of
the two quotients.
"""

from __future__ import annotations

DECOMPRESS_MULS = 19
DECOMPRESS_SQUARINGS = 255
ADD_MULS = 7
DOUBLE_MULS = 3
DOUBLE_SQUARINGS = 4
FIELD_MUL_MADDS = 2 * 64 + 2 * 8
FIELD_SQR_MADDS = 2 * 36 + 2 * 8
MADDS_PER_CLOCK_PER_SM = 64
HBM_BYTES_PER_S = 3.35e12
R_BITS = 128
FULL_BITS = 253
COFACTOR_DOUBLINGS = 3


def msm_additions(n: int) -> int:
    """Point additions of the bucket method over n scalars of R_BITS and
    n + 1 of FULL_BITS at its best window width c: one addition a point in
    each of its ceil(bits / c) windows, and 2^c a window to sum the
    buckets (signed digits, 2^(c-1) buckets, a running sum)."""
    if n == 0:
        return 0
    return min(-(-R_BITS // c) * n + -(-FULL_BITS // c) * (n + 1 + (1 << c))
               for c in range(1, 24))


def batch_field_ops(n: int) -> tuple[int, int]:
    """(multiplications, squarings) of one batch of n signatures."""
    if n == 0:
        return 0, 0
    doublings = FULL_BITS + COFACTOR_DOUBLINGS
    muls = n * DECOMPRESS_MULS + ADD_MULS * msm_additions(n) + DOUBLE_MULS * doublings
    sqrs = n * DECOMPRESS_SQUARINGS + DOUBLE_SQUARINGS * doublings
    return muls, sqrs


def batch_madds(n: int) -> int:
    muls, sqrs = batch_field_ops(n)
    return muls * FIELD_MUL_MADDS + sqrs * FIELD_SQR_MADDS


def batch_bytes(n: int, distinct_messages: int) -> int:
    return n * 64 + distinct_messages * 32 + n * 64 + 1


def least_seconds(batches, sms: int, clock_mhz: float) -> tuple[float, str]:
    """The least time for ``batches`` of (signatures, distinct messages),
    and which bound sets it."""
    madds = sum(batch_madds(n) for n, _ in batches)
    nbytes = sum(batch_bytes(n, m) for n, m in batches)
    t_ops = madds / (MADDS_PER_CLOCK_PER_SM * sms * clock_mhz * 1e6)
    t_mem = nbytes / HBM_BYTES_PER_S
    return (t_ops, "int32 multiply-adds") if t_ops >= t_mem else (t_mem, "memory")
