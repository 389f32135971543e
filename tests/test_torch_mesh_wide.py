"""The port's sharded verdicts over 6 and 8 CPU shards (``cpu`` repeated), as
``test_torch_mesh_verdicts.py`` holds them over 1 to 4, and the sharded MSM
at the odd widths 3 and 6, where the reference's combine drops a shard.
Tolerance: equal verdicts; MSM points equal by canonical affine encoding.
"""

import random

import numpy as np
import pytest
import torch

from hotstuff_tpu_torch.crypto import ed25519_ref as ref
from hotstuff_tpu_torch.ops import curve as cv
from hotstuff_tpu_torch.ops import msm_kernels as mk
from hotstuff_tpu_torch.parallel import make_mesh, msm_sharded

from .torch_inputs import point_limbs
from .torch_mesh_cases import CPU, HOST_REJECTED, cases, oracle, sharded_verdict, unsharded


@pytest.mark.parametrize("name", cases(8))
def test_cached_sharded_verdict_at_8_shards(monkeypatch, name):
    want = oracle(name)
    assert unsharded(name, cached=True) == want
    assert sharded_verdict(8, name, True, monkeypatch) == want


@pytest.mark.parametrize("name", ["valid", *HOST_REJECTED])
def test_uncached_sharded_verdict_at_8_shards(monkeypatch, name):
    want = oracle(name)
    assert unsharded(name, cached=False) == want
    assert sharded_verdict(8, name, False, monkeypatch) == want


def test_valid_batch_accepted_at_6_shards(monkeypatch):
    """The reference's combine rejects a valid batch at 6 devices (it drops
    the carried shard); the port's accepts it."""
    assert sharded_verdict(6, "valid", True, monkeypatch) is True


@pytest.mark.parametrize("d", [3, 6])
def test_msm_sharded_at_odd_widths_equals_the_unsharded_msm(d):
    """At 3 and 6 shards of 4 lanes the combined point is the unsharded
    MSM's (over the same lanes padded with identities and zero digits) and
    the oracle's."""
    m = 4 * d
    rng = random.Random(d)
    scalars = [rng.randrange(ref.L) for _ in range(m)]
    oracle_pts = [ref.point_mul(rng.getrandbits(250), ref.G) for _ in range(m)]
    want = ref.IDENTITY
    for s, p in zip(scalars, oracle_pts):
        want = ref.point_add(want, ref.point_mul(s, p))
    points = torch.from_numpy(np.stack([point_limbs(p) for p in oracle_pts]))
    digits = torch.from_numpy(cv.scalars_to_digits(scalars))
    got = msm_sharded(make_mesh(devices=[CPU] * d), points, digits)
    pad = 16 * ((m + 15) // 16) - m
    whole = mk.msm(torch.cat([points, cv.identity((pad,)).clone()]),
                   torch.cat([digits, torch.zeros((64, pad), dtype=digits.dtype)], dim=1))
    assert cv.to_affine_bytes(got) == cv.to_affine_bytes(whole) == ref.point_compress(want)
