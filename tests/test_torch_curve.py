"""The port's Edwards25519 points, recoders and MSMs
(``hotstuff_tpu_torch.ops.curve`` and the MSM kernels' plain versions in
``ops.msm_kernels``), held against the JAX package.

Tolerances: point ops, decompression and the plain MSMs are limb-exact
against ``hotstuff_tpu.ops.curve`` (same layout, same operation order); the
recoders are equal element for element. The kernels' plain versions add in
another order than ``curve.msm_signed``/``curve.msm``, so their MSM results
are compared by canonical affine encoding, and against the RFC 8032 oracle.
MSMs run at m = 4, the width the reference's own MSM tests compile.
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hotstuff_tpu.crypto import ed25519_ref as ref
from hotstuff_tpu.ops import curve as jcv
from hotstuff_tpu_torch.ops import curve as cv
from hotstuff_tpu_torch.ops import field as fe
from hotstuff_tpu_torch.ops import msm_kernels as mk


def oracle_points(m, seed):
    """(oracle points, [m, 4, 20] affine limbs) of random multiples of G."""
    rng = random.Random(seed)
    pts = [ref.point_mul(rng.getrandbits(250), ref.G) for _ in range(m)]
    rows = []
    for x, y, z, _ in pts:
        zi = ref.inv(z)
        xa, ya = x * zi % ref.P, y * zi % ref.P
        rows.append(
            np.stack([fe._int_to_limbs(xa), fe._int_to_limbs(ya), fe.ONE_LIMBS,
                      fe._int_to_limbs(xa * ya % ref.P)])
        )
    return pts, np.stack(rows).astype(np.int32)


def oracle_msm(scalars, pts) -> bytes:
    acc = ref.IDENTITY
    for s, p in zip(scalars, pts):
        acc = ref.point_add(acc, ref.point_mul(s, p))
    return ref.point_compress(acc)


def same(j, t):
    np.testing.assert_array_equal(np.asarray(j), t.cpu().numpy())


def test_point_ops_limb_exact():
    _, a = oracle_points(8, 1)
    b = np.roll(a, 3, axis=0)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    same(jcv.point_add(ja, jb), cv.point_add(ta, tb))
    same(jcv.point_double(ja), cv.point_double(ta))
    same(jcv.point_neg(ja), cv.point_neg(ta))
    same(jcv.mul_by_cofactor(ja), cv.mul_by_cofactor(ta))
    same(jcv.point_eq(ja, jb), cv.point_eq(ta, tb))
    same(jcv.is_identity(jcv.point_add(ja, jcv.point_neg(ja))),
         cv.is_identity(cv.point_add(ta, cv.point_neg(ta))))
    mask = np.array([True, False] * 4)
    same(jcv.point_select(jnp.asarray(mask), ja, jb),
         cv.point_select(torch.from_numpy(mask), ta, tb))


def test_affine_bytes_equal_reference_and_oracle():
    pts, a = oracle_points(2, 2)
    s = cv.point_add(torch.from_numpy(a[0]), torch.from_numpy(a[1]))
    assert cv.to_affine_bytes(s) == jcv.to_affine_bytes(jnp.asarray(s.numpy()))
    assert cv.to_affine_bytes(s) == ref.point_compress(ref.point_add(*pts))


def test_decompress_limb_exact():
    pts, _ = oracle_points(6, 3)
    encs = [ref.point_compress(p) for p in pts]
    encs += [(2).to_bytes(32, "little"), (1).to_bytes(32, "little")[:31] + b"\x80"]
    data = np.frombuffer(b"".join(encs), dtype=np.uint8).reshape(-1, 32).copy()
    sign = (data[:, 31] >> 7).astype(np.int32)
    data[:, 31] &= 0x7F
    y = fe.fe_from_bytes(data)
    ok_j, pt_j = jcv.decompress(jnp.asarray(y), jnp.asarray(sign))
    ok_t, pt_t = cv.decompress(torch.from_numpy(y), torch.from_numpy(sign))
    same(ok_j, ok_t)
    same(pt_j, pt_t)
    assert ok_t[:6].all() and not ok_t[6:].any()  # y=2 is off-curve; x=0 with sign 1
    _, pt_k = cv.decompress(torch.from_numpy(y), torch.from_numpy(sign), root_fn=mk.sqrt_pow)
    same(pt_j, pt_k)


def test_recoders_equal_reference():
    rng = random.Random(4)
    full = [rng.getrandbits(252) for _ in range(9)] + [0, 1, ref.L - 1]
    rlc = [rng.getrandbits(128) | (1 << 127) for _ in range(7)]
    np.testing.assert_array_equal(cv.scalars_to_digits(full), jcv.scalars_to_digits(full))
    for scalars, w in ((full, 64), (rlc, 33)):
        np.testing.assert_array_equal(
            cv.scalars_to_signed_digits(scalars, w), jcv.scalars_to_signed_digits(scalars, w)
        )
        sb = np.frombuffer(b"".join(s.to_bytes(32, "little") for s in scalars), dtype=np.uint8)
        sb = sb.reshape(-1, 32)
        np.testing.assert_array_equal(
            cv.signed_digits_from_bytes(sb, w), jcv.signed_digits_from_bytes(sb, w)
        )
    with pytest.raises(ValueError):
        cv.scalars_to_signed_digits([1 << 131], 33)


@pytest.mark.parametrize("kind", ["signed33", "signed64", "unsigned"])
def test_plain_msm_limb_exact_and_oracle(kind):
    """``curve.msm_signed``/``msm`` (the MSM wrappers' CPU path) against
    the reference's at m = 4, and the kernels' plain versions (partials,
    then combine) against both by affine encoding."""
    pts, arr = oracle_points(4, 5)
    rng = random.Random(6)
    if kind == "signed33":
        scalars = [rng.getrandbits(128) | (1 << 127) for _ in range(4)]
        digits = cv.scalars_to_signed_digits(scalars, 33)
    else:
        scalars = [rng.getrandbits(250) % ref.L for _ in range(4)]
        signed = kind == "signed64"
        digits = cv.scalars_to_signed_digits(scalars, 64) if signed else cv.scalars_to_digits(scalars)
    signed = kind != "unsigned"
    td = torch.from_numpy(digits.copy())
    tp = torch.from_numpy(arr)
    ref_fn, fn = (jcv.msm_signed, mk.msm_signed) if signed else (jcv.msm, mk.msm)
    want = ref_fn(jnp.asarray(arr), jnp.asarray(digits))
    got = fn(tp, td)
    same(want, got)
    assert cv.to_affine_bytes(got) == oracle_msm(scalars, pts)
    for block in (1, 2, 4):  # 4, 2 and 1 lane blocks through the combine
        part = mk.msm_partials(tp, td, signed=signed, block=block)
        assert part.shape == (4 // block, digits.shape[0], 4, 20)
        assert cv.to_affine_bytes(mk.msm_combine(part)) == cv.to_affine_bytes(got)


def test_msm_partials_rejects_bad_shapes():
    _, arr = oracle_points(4, 7)
    digits = torch.zeros((64, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        mk.msm_partials(torch.from_numpy(arr), digits, signed=True, block=3)
    with pytest.raises(ValueError):
        mk.msm_partials(torch.from_numpy(arr), torch.zeros((65, 4), dtype=torch.int32), signed=True)


@pytest.mark.parametrize("m,windows", [(1024, 33), (1024, 64), (2048, 64), (64, 1)])
def test_kernel_geometry_covers_every_window_once(m, windows):
    """K2/K4's grid takes every window of every block exactly once, in
    window groups whose last one may be ragged, and at the main path's
    widths launches a CTA for each of the H100's 132 SMs; K3 takes one CTA
    a window."""
    block = min(mk.PARTIALS_BLOCK, m)
    (gx, gy), threads = mk.partials_geometry(m, windows, block)
    assert (gx, threads) == (m // block, block)
    g = mk.PARTIALS_WINDOW_GROUP
    covered = [w for y in range(gy) for w in range(y * g, min(y * g + g, windows))]
    assert covered == list(range(windows))
    if m >= 1024:
        assert gx * gy >= 132
    assert mk.combine_geometry(windows) == ((windows, 1), mk.COMBINE_THREADS)
