"""The port's GF(2^255-19) (``hotstuff_tpu_torch.ops.field``) and its root
kernel K1, held against the JAX package.

Tolerance: limb-exact. Both sides keep the radix-2^13 x 20-limb int32
layout and the same operation order, so every output limb must be equal.
Inputs are made with numpy from a seed and handed to both sides.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from hotstuff_tpu.ops import field as jfe
from hotstuff_tpu.ops import pallas_msm as jpm
from hotstuff_tpu_torch.ops import field as fe
from hotstuff_tpu_torch.ops import msm_kernels as mk

CSRC = Path(__file__).resolve().parents[1] / "hotstuff_tpu_torch" / "csrc"


def loose(shape, seed):
    """Loose limbs in [0, 2^13 + 608), the working form both sides take."""
    return np.random.default_rng(seed).integers(0, 8192 + fe.FOLD, size=shape).astype(np.int32)


def same(j, t):
    np.testing.assert_array_equal(np.asarray(j), t.cpu().numpy())


def test_constants_equal_reference():
    for name in ("P_LIMBS", "TWO_P_LIMBS", "D_LIMBS", "D2_LIMBS", "SQRT_M1_LIMBS", "ONE_LIMBS"):
        np.testing.assert_array_equal(getattr(fe, name), getattr(jfe, name), err_msg=name)
    assert (fe.NLIMB, fe.RADIX, fe.FOLD, fe.P) == (jfe.NLIMB, jfe.RADIX, jfe.FOLD, jfe.P)


def test_kernel_header_constants_equal_field():
    """fe25519.cuh spells 2d and 2p out as literals: they must be the field's."""
    src = (CSRC / "fe25519.cuh").read_text()
    body = re.search(r"D2\[NLIMB\] = \{([^}]*)\}", src).group(1)
    assert [int(x) for x in body.replace("\n", " ").split(",")] == list(fe.D2_LIMBS)
    two_p = re.search(r"return k == 0 \? (\d+)u : \(k == NLIMB - 1 \? (\d+)u : (\d+)u\)", src)
    assert [int(x) for x in two_p.groups()] == [
        fe.TWO_P_LIMBS[0], fe.TWO_P_LIMBS[19], fe.TWO_P_LIMBS[1]
    ]


@pytest.mark.parametrize("op", ["carry", "add", "sub", "neg", "mul", "square"])
def test_arithmetic_limb_exact(op):
    a, b = loose((16, 20), 1), loose((16, 20), 2)
    if op == "carry":
        wide = np.random.default_rng(3).integers(0, 2**31 - 1, size=(16, 20)).astype(np.int32)
        same(jfe.carry(jnp.asarray(wide)), fe.carry(torch.from_numpy(wide)))
        return
    unary = op in ("neg", "square")
    args_j = (jnp.asarray(a),) if unary else (jnp.asarray(a), jnp.asarray(b))
    args_t = (torch.from_numpy(a),) if unary else (torch.from_numpy(a), torch.from_numpy(b))
    same(getattr(jfe, op)(*args_j), getattr(fe, op)(*args_t))


def test_canonical_eq_parity_limb_exact():
    a = loose((16, 20), 4)
    # edge cases: p - 1, 0, 1 and p itself
    edges = np.stack([fe._int_to_limbs(x) for x in (fe.P - 1, 0, 1)] + [fe.P_LIMBS])
    a = np.concatenate([a, edges.astype(np.int32)])
    same(jfe.canonical(jnp.asarray(a)), fe.canonical(torch.from_numpy(a)))
    same(jfe.parity(jnp.asarray(a)), fe.parity(torch.from_numpy(a)))
    same(jfe.is_zero(jnp.asarray(a)), fe.is_zero(torch.from_numpy(a)))
    b = np.roll(a, 1, axis=0)
    same(jfe.eq(jnp.asarray(a), jnp.asarray(b)), fe.eq(torch.from_numpy(a), torch.from_numpy(b)))


def test_inv_limb_exact():
    a = loose((8, 20), 5)
    inv_t = fe.inv(torch.from_numpy(a))
    same(jfe.inv(jnp.asarray(a)), inv_t)
    one = fe.canonical(fe.mul(inv_t, torch.from_numpy(a)))
    assert (one.numpy() == fe.ONE_LIMBS).all()


def test_sqrt_ratio_limb_exact():
    u, v = loose((16, 20), 6), loose((16, 20), 7)
    ok_j, r_j = jfe.sqrt_ratio(jnp.asarray(u), jnp.asarray(v))
    ok_t, r_t = fe.sqrt_ratio(torch.from_numpy(u), torch.from_numpy(v))
    same(ok_j, ok_t)
    same(r_j, r_t)
    assert ok_t.any() and not ok_t.all()  # both branches exercised
    # with the kernel's plain version as root_fn, as the port's decompress runs it
    ok_k, r_k = fe.sqrt_ratio(torch.from_numpy(u), torch.from_numpy(v), root_fn=mk.sqrt_pow)
    same(ok_j, ok_k)
    same(r_j, r_k)


def test_bytes_roundtrip_equal_reference():
    data = np.random.default_rng(8).integers(0, 256, size=(6, 32)).astype(np.uint8)
    data[:, 31] &= 0x7F
    np.testing.assert_array_equal(fe.fe_from_bytes(data), jfe.fe_from_bytes(data))
    limbs = fe.fe_from_bytes(data)
    np.testing.assert_array_equal(fe.fe_to_bytes(limbs), jfe.fe_to_bytes(limbs))


def test_sqrt_pow_plain_equals_pallas_kernel():
    """K1's plain version against the TPU kernel body itself, run by Pallas
    in interpret mode on the CPU at one 128-lane block."""
    m = 128
    u, v = loose((m, 20), 9), loose((m, 20), 10)
    spec = pl.BlockSpec((20, m), lambda b: (0, b))
    call = pl.pallas_call(
        jpm._sqrt_pow_kernel,
        grid=(1,),
        in_specs=[spec] * 2,
        out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((20, m), jnp.int32),
        interpret=True,
    )
    want = np.asarray(call(jnp.asarray(u.T), jnp.asarray(v.T))).T
    got = mk.sqrt_pow(torch.from_numpy(u), torch.from_numpy(v))  # CPU tensor: plain version
    np.testing.assert_array_equal(want, got.numpy())
    assert mk.LAUNCHES["sqrt_pow"] == 0  # a CPU tensor never reaches the kernel
