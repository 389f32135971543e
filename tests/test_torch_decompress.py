"""The decompression kernel's and the verdict kernel's plain versions
(``msm_kernels.decompress``/``verdict`` on CPU tensors), held against the
JAX package: ``hotstuff_tpu.ops.curve.decompress`` and the verdict
expression of the reference's verify graphs (``ops/verify.py``).

Tolerance: exact, every limb of every point and every ok flag. Shapes stay
at m = 8 on the JAX side.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hotstuff_tpu.ops import curve as jcv
from hotstuff_tpu_torch.ops import msm_kernels as mk
from tests.torch_inputs import VERDICT_CASES, decompress_inputs, verdict_case


@pytest.mark.parametrize("seed", [1, 2])
def test_decompress_limb_exact_against_reference(seed):
    y, sign, valid = decompress_inputs(8, seed)
    ok_j, pts_j = jcv.decompress(jnp.asarray(y), jnp.asarray(sign))
    mk.reset_launches()
    ok_t, pts_t = mk.decompress(torch.from_numpy(y), torch.from_numpy(sign))
    assert mk.LAUNCHES["decompress"] == 0  # a CPU tensor takes the plain version
    np.testing.assert_array_equal(np.asarray(ok_j), ok_t.numpy())
    np.testing.assert_array_equal(np.asarray(pts_j), pts_t.numpy())
    np.testing.assert_array_equal(ok_t.numpy(), valid)  # the RFC 8032 oracle's verdicts
    assert ok_t.dtype == torch.bool and pts_t.dtype == torch.int32


@pytest.mark.parametrize("with_b", [True, False])
@pytest.mark.parametrize("case", VERDICT_CASES)
def test_verdict_equals_reference_expression(case, with_b):
    ok, a, b, total, want = verdict_case(case, 8)
    if with_b:
        ja = jcv.point_add(jnp.asarray(a), jnp.asarray(b))
        got = mk.verdict(torch.from_numpy(ok), torch.from_numpy(a), torch.from_numpy(b))
    else:
        ja = jnp.asarray(total)
        got = mk.verdict(torch.from_numpy(ok), torch.from_numpy(total))
    expected = jcv.is_identity(jcv.mul_by_cofactor(ja[None, ...]))[0] & jnp.all(jnp.asarray(ok))
    assert got.shape == () and got.dtype == torch.bool
    assert bool(got) == bool(expected) == want


# one lane, ragged and whole CTAs, the fresh-R and uncached widths, the
# largest cache insert
@pytest.mark.parametrize("m", [1, 4, 5, 667, 1024, 2047, 2048, 4096])
def test_decompress_geometry_covers_every_lane(m):
    (gx, gy), threads = mk.decompress_geometry(m)
    lanes = threads // 32  # one warp a lane
    assert threads % 32 == 0 and gy == 1
    assert (gx - 1) * lanes < m <= gx * lanes
