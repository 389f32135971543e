"""Wrappers of the hand-written CUDA kernels, with their plain versions.

Port of ``hotstuff_tpu/ops/pallas_msm.py``. Sources in
``hotstuff_tpu_torch/csrc/``:

- K1 ``decompress`` (``decompress.cu``) replaces ``_sqrt_pow_kernel``
  together with the field code of ``curve.decompress`` around it: the
  whole decompression in one kernel. ``sqrt_pow`` (``sqrt_pow.cu``) is the
  root alone, the reference's ``sqrt_pow``; the verify path no longer
  calls it;
- K2 ``msm_partials(signed=True)`` (``msm_partials.cu``) replaces
  ``_make_partials_kernel_signed``;
- K3 ``msm_combine`` (``msm_combine.cu``) replaces ``_make_combine_kernel``;
- K4 ``msm_partials(signed=False)`` (``msm_partials.cu``) replaces
  ``_partials_kernel``;
- ``verdict`` (``verdict.cu``): all(ok) and the cofactor-8 identity check
  of the MSM result, jnp code in the reference (``ops/verify.py``), no
  Pallas kernel.

``msm_signed``/``msm`` chain K2/K4 into K3, as the reference's ``_build``
functions chain its two ``pallas_call``s.

A wrapper takes its plain version only for a tensor on the CPU. For a
CUDA tensor it launches the kernel or raises. Each kernel's plain version
repeats the kernel's arithmetic in the same order, so kernel and plain
version agree limb for limb; for the whole MSM the CPU path is
``curve.msm_signed``/``curve.msm``, the step-by-step port of the
reference's plain MSM (its additions run in another order, so MSM results
compare by canonical affine encoding).

``LAUNCHES`` counts the launches of each kernel; a wrapper adds one where
it launches its kernel and nowhere else.
"""

from __future__ import annotations

import torch

from . import curve as cv
from . import field as fe

LAUNCHES = {
    "decompress": 0, "sqrt_pow": 0, "msm_partials_signed": 0, "msm_partials": 0,
    "msm_combine": 0, "verdict": 0,
}

# Lanes per CTA (one thread per lane) of sqrt_pow and of the partials kernels;
# the combine then sums m / block partials per window. ``block`` arguments
# override them, as the reference's lanes per grid step.
SQRT_POW_BLOCK = 128
PARTIALS_BLOCK = 64
MAX_WINDOWS = 64
# Windows per CTA of the partials kernels: their grid is m / block x
# ceil(n_windows / PARTIALS_WINDOW_GROUP) CTAs, 272 and 512 at the cached
# path's 33 and 64 windows over 1024 lanes, so every one of the H100's 132
# SMs takes two to four. Fixed; callers do not set it. Chosen by a sweep of
# 1, 2, 4 and 8 on the H100 (utils/kernel_times.py --window-groups; PERF.md):
# fewer windows a CTA shorten each thread's chain of point adds, but every
# CTA rebuilds its lanes' table, and 2 gave the least time for the two
# shapes of a cached QC together.
PARTIALS_WINDOW_GROUP = 2
# Threads per CTA of the combine (four warps), one CTA a window.
COMBINE_THREADS = 128
# Threads per CTA of the decompression: four warps, one lane a warp.
DECOMPRESS_THREADS = 128


def partials_geometry(m: int, n_windows: int, block: int) -> tuple[tuple[int, int], int]:
    """(grid, threads per CTA) of K2/K4 at these shapes."""
    return (m // block, -(-n_windows // PARTIALS_WINDOW_GROUP)), block


def combine_geometry(n_windows: int) -> tuple[tuple[int, int], int]:
    """(grid, threads per CTA) of K3 at these shapes."""
    return (n_windows, 1), COMBINE_THREADS


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def decompress_geometry(m: int) -> tuple[tuple[int, int], int]:
    """(grid, threads per CTA) of the decompression kernel."""
    return (-(-m // (DECOMPRESS_THREADS // 32)), 1), DECOMPRESS_THREADS


def _check(t: torch.Tensor, shape: tuple, what: str, dtype=torch.int32) -> torch.Tensor:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{what}: expected shape {shape}, got {tuple(t.shape)}")
    return t.contiguous()


def _launch(source: str, fn: str, counter: str, *args) -> None:
    from hotstuff_tpu_torch.utils.kernel_build import kernel

    stream = torch.cuda.current_stream().cuda_stream
    rc = kernel(source, fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn} failed to launch: cudaError {rc}")
    LAUNCHES[counter] += 1


# -- K1: decompression -------------------------------------------------------


def decompress_plain(y: torch.Tensor, sign: torch.Tensor):
    """``curve.decompress`` with K1's root chain: (ok [m], points [m, 4, 20])."""
    return cv.decompress(y, sign, root_fn=sqrt_pow_plain)


def decompress(y: torch.Tensor, sign: torch.Tensor):
    """K1 for y limbs int32 [m, 20] and signs int32 [m] in {0, 1}: (ok bool
    [m], points int32 [m, 4, 20]), limb for limb ``decompress_plain``.
    Failed lanes keep their point, as the plain version's do."""
    if y.device.type == "cpu":
        return decompress_plain(y, sign)
    m = y.shape[0]
    if m < 1:
        raise ValueError(f"decompress: bad shape m={m}")
    y = _check(y, (m, fe.NLIMB), "decompress y")
    sign = _check(sign, (m,), "decompress sign")
    ok = torch.empty(m, dtype=torch.bool, device=y.device)
    pts = torch.empty((m, 4, fe.NLIMB), dtype=torch.int32, device=y.device)
    _launch(
        "decompress", "decompress_launch", "decompress",
        y.data_ptr(), sign.data_ptr(), ok.data_ptr(), pts.data_ptr(), m,
    )
    return ok, pts


# -- sqrt_pow: the decompression root alone ----------------------------------


def _pow_p58(w: torch.Tensor) -> torch.Tensor:
    """w^(2^252 - 3): the addition chain of the reference's ``_pow_p58``."""

    def sqk(x, k):
        for _ in range(k):
            x = fe.mul(x, x)
        return x

    f1 = w
    f2 = fe.mul(sqk(f1, 1), f1)
    f4 = fe.mul(sqk(f2, 2), f2)
    f5 = fe.mul(sqk(f4, 1), f1)
    f10 = fe.mul(sqk(f5, 5), f5)
    f20 = fe.mul(sqk(f10, 10), f10)
    f40 = fe.mul(sqk(f20, 20), f20)
    f80 = fe.mul(sqk(f40, 40), f40)
    f160 = fe.mul(sqk(f80, 80), f80)
    f240 = fe.mul(sqk(f160, 80), f80)
    f250 = fe.mul(sqk(f240, 10), f10)
    return fe.mul(sqk(f250, 2), w)


def sqrt_pow_plain(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """r = u * v^3 * (u v^7)^((p-5)/8), step by step as ``_sqrt_pow_kernel``."""
    v2 = fe.mul(v, v)
    v3 = fe.mul(v2, v)
    v7 = fe.mul(fe.mul(v3, v3), v)
    w = fe.mul(u, v7)
    return fe.mul(fe.mul(u, v3), _pow_p58(w))


def sqrt_pow(u: torch.Tensor, v: torch.Tensor, block: int | None = None) -> torch.Tensor:
    """The root chain for [m, 20] int32 inputs, as a ``root_fn`` of
    ``field.sqrt_ratio``."""
    if u.device.type == "cpu":
        return sqrt_pow_plain(u, v)
    m = u.shape[0]
    u = _check(u, (m, fe.NLIMB), "sqrt_pow u")
    v = _check(v, (m, fe.NLIMB), "sqrt_pow v")
    r = torch.empty_like(u)
    block = min(SQRT_POW_BLOCK, m) if block is None else block
    _launch(
        "sqrt_pow", "sqrt_pow_launch", "sqrt_pow",
        u.data_ptr(), v.data_ptr(), r.data_ptr(), m, block,
    )
    return r


# -- K2 / K4: per-block window partials ------------------------------------


def msm_partials_plain(
    points: torch.Tensor, digits: torch.Tensor, block: int, signed: bool
) -> torch.Tensor:
    """[m, 4, 20] points, [n_windows, m] digits -> [m // block, n_windows,
    4, 20] per-block window sums, in the kernel's order: table[d] =
    table[d-1] + P, then per window a tree over each block pairing lane t
    with lane t + half."""
    m = points.shape[0]
    table = cv._build_table(points, 9 if signed else 16)
    out = []
    for w in range(digits.shape[0]):
        row = digits[w]
        if signed:
            sel = cv._take(table, row.abs())
            sel = cv.point_select(row >= 0, sel, cv.point_neg(sel))
        else:
            sel = cv._take(table, row)
        cur = sel.reshape(m // block, block, 4, fe.NLIMB)
        half = block // 2
        while half >= 1:
            cur = cv.point_add(cur[:, :half], cur[:, half : 2 * half])
            half //= 2
        out.append(cur[:, 0])
    return torch.stack(out, dim=1)


def msm_partials(
    points: torch.Tensor, digits: torch.Tensor, signed: bool, block: int | None = None
) -> torch.Tensor:
    """K2 (signed digits in [-8, 8]) or K4 (unsigned digits in 0..15)."""
    m = points.shape[0]
    n_windows = digits.shape[0]
    if block is None:
        block = min(PARTIALS_BLOCK, m)
    if m % block or block & (block - 1) or not 1 <= n_windows <= MAX_WINDOWS:
        raise ValueError(f"msm_partials: bad shape m={m} block={block} windows={n_windows}")
    if points.device.type == "cpu":
        return msm_partials_plain(points, digits, block, signed)
    points = _check(points, (m, 4, fe.NLIMB), "msm points")
    digits = _check(digits, (n_windows, m), "msm digits")
    out = torch.empty((m // block, n_windows, 4, fe.NLIMB), dtype=torch.int32, device=points.device)
    if signed:
        fn, counter = "msm_partials_signed_launch", "msm_partials_signed"
    else:
        fn, counter = "msm_partials_unsigned_launch", "msm_partials"
    _launch(
        "msm_partials", fn, counter,
        points.data_ptr(), digits.data_ptr(), out.data_ptr(), m, n_windows, block,
        PARTIALS_WINDOW_GROUP,
    )
    return out


# -- K3: combine + Horner ----------------------------------------------------


def msm_combine_plain(partials: torch.Tensor) -> torch.Tensor:
    """[n_blocks, n_windows, 4, 20] -> [4, 20]: sum the blocks in order,
    then S = 16 S + W[w] MSB-first, as ``_make_combine_kernel``."""
    cur = partials[0]
    for g in range(1, partials.shape[0]):
        cur = cv.point_add(cur, partials[g])
    s = cur[0]
    for w in range(1, cur.shape[0]):
        for _ in range(4):
            s = cv.point_double(s)
        s = cv.point_add(s, cur[w])
    return s


def msm_combine(partials: torch.Tensor) -> torch.Tensor:
    """K3."""
    if partials.device.type == "cpu":
        return msm_combine_plain(partials)
    n_blocks, n_windows = partials.shape[:2]
    if not 1 <= n_windows <= MAX_WINDOWS:
        raise ValueError(f"msm_combine: {n_windows} windows (at most {MAX_WINDOWS})")
    partials = _check(partials, (n_blocks, n_windows, 4, fe.NLIMB), "msm partials")
    out = torch.empty((4, fe.NLIMB), dtype=torch.int32, device=partials.device)
    # The window sums, and the ticket that elects the CTA which runs the
    # Horner once every window's sum is in (it must start at 0).
    sums = torch.empty((n_windows, 4, fe.NLIMB), dtype=torch.int32, device=partials.device)
    ticket = torch.zeros(1, dtype=torch.int32, device=partials.device)
    _launch(
        "msm_combine", "msm_combine_launch", "msm_combine",
        partials.data_ptr(), out.data_ptr(), sums.data_ptr(), ticket.data_ptr(),
        n_blocks, n_windows,
    )
    return out


# -- the MSMs ------------------------------------------------------------------


def msm_signed(
    points: torch.Tensor, digits: torch.Tensor, block: int | None = None
) -> torch.Tensor:
    """``curve.msm_signed`` semantics: [m, 4, 20] points, [n_windows, m]
    signed digits MSB-first (33 windows for RLC lanes, 64 for mod-L)."""
    if points.device.type == "cpu":
        return cv.msm_signed(points, digits)
    return msm_combine(msm_partials(points, digits, signed=True, block=block))


def msm(points: torch.Tensor, digits: torch.Tensor, block: int | None = None) -> torch.Tensor:
    """``curve.msm`` semantics: [m, 4, 20] points, [64, m] digits 0..15."""
    if points.device.type == "cpu":
        return cv.msm(points, digits)
    return msm_combine(msm_partials(points, digits, signed=False, block=block))


# -- the verdict -----------------------------------------------------------------


def verdict_plain(ok: torch.Tensor, a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """all(ok) and 8 (a + b) == O (8 a with no ``b``), as a 0-dim bool: the
    tail of the reference's verify graphs, in their order."""
    acc = a if b is None else cv.point_add(a, b)
    zero = cv.is_identity(cv.mul_by_cofactor(acc[None, ...]))[0]
    return ok.all() & zero


def verdict(ok: torch.Tensor, a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """The verdict kernel for ok bool [m] and points int32 [4, 20]: a 0-dim
    bool on the card, read by the caller (the one sync of a verify)."""
    if a.device.type == "cpu":
        return verdict_plain(ok, a, b)
    ok = _check(ok, (ok.shape[0],), "verdict ok", torch.bool)
    a = _check(a, (4, fe.NLIMB), "verdict a")
    if b is not None:
        b = _check(b, (4, fe.NLIMB), "verdict b")
    out = torch.empty((), dtype=torch.bool, device=a.device)
    _launch(
        "verdict", "verdict_launch", "verdict",
        ok.data_ptr(), ok.shape[0], a.data_ptr(), None if b is None else b.data_ptr(),
        out.data_ptr(),
    )
    return out
