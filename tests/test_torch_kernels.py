"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA card with nvcc (``cuda`` marker) and
skips without one: the kernels have no CPU mode. The file imports nothing
of JAX, so it runs on a GPU host that has only the port's dependencies:

    python -m pytest tests/test_torch_kernels.py -q

Tolerance: limb-exact between each kernel and its plain version (they
repeat the same arithmetic in the same order), the decompression's ok flags
and the verdict's bool equal; MSM results also equal the RFC 8032 oracle by
compressed encoding, and the decompression's ok flags the oracle's.
"""

import random

import numpy as np
import pytest
import torch

from hotstuff_tpu_torch import crypto
from hotstuff_tpu_torch.crypto import ed25519_ref as ref
from hotstuff_tpu_torch.crypto.cuda_backend import CudaBackend
from hotstuff_tpu_torch.ops import curve as cv
from hotstuff_tpu_torch.ops import field as fe
from hotstuff_tpu_torch.ops import msm_kernels as mk
from tests.torch_inputs import VERDICT_CASES, decompress_inputs, verdict_case

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda")


def loose(shape, seed):
    return np.random.default_rng(seed).integers(0, 8192 + fe.FOLD, size=shape).astype(np.int32)


def oracle_points(m, seed):
    rng = random.Random(seed)
    pts = [ref.point_mul(rng.getrandbits(250), ref.G) for _ in range(m)]
    rows = []
    for x, y, z, _ in pts:
        zi = ref.inv(z)
        xa, ya = x * zi % ref.P, y * zi % ref.P
        rows.append(np.stack([fe._int_to_limbs(xa), fe._int_to_limbs(ya), fe.ONE_LIMBS,
                              fe._int_to_limbs(xa * ya % ref.P)]))
    return pts, np.stack(rows).astype(np.int32)


# one lane, one ragged CTA, the fresh-R width, the uncached width; valid
# points, non-squares, x = 0 with sign 1, y = 1 and y = p - 1 mixed in
@pytest.mark.parametrize("m", [1, 8, 1024, 2048])
def test_decompress_matches_plain(cuda, m):
    y, sign, valid = decompress_inputs(m, m)
    ty, ts = torch.from_numpy(y).to(cuda), torch.from_numpy(sign).to(cuda)
    before = mk.LAUNCHES["decompress"]
    ok, pts = mk.decompress(ty, ts)
    torch.cuda.synchronize()
    assert mk.LAUNCHES["decompress"] == before + 1
    ok_p, pts_p = mk.decompress_plain(ty, ts)
    assert torch.equal(pts, pts_p) and torch.equal(ok, ok_p)
    np.testing.assert_array_equal(ok.cpu().numpy(), valid)


@pytest.mark.parametrize("with_b", [True, False])
@pytest.mark.parametrize("m", [4, 1024, 2048])
@pytest.mark.parametrize("case", VERDICT_CASES)
def test_verdict_matches_plain(cuda, case, m, with_b):
    ok, a, b, total, want = verdict_case(case, m)
    pts = (a, b) if with_b else (total,)
    tok = torch.from_numpy(ok).to(cuda)
    tpts = [torch.from_numpy(p).to(cuda) for p in pts]
    got = mk.verdict(tok, *tpts)
    assert got.device.type == "cuda" and got.shape == () and got.dtype == torch.bool
    assert bool(got) == bool(mk.verdict_plain(tok, *tpts)) == want


# below one CTA's lanes; the fresh-R width; a ragged last CTA
@pytest.mark.parametrize("m,block", [(4, None), (1024, None), (100, 32)])
def test_sqrt_pow_matches_plain(cuda, m, block):
    u = torch.from_numpy(loose((m, 20), 11)).to(cuda)
    v = torch.from_numpy(loose((m, 20), 12)).to(cuda)
    before = mk.LAUNCHES["sqrt_pow"]
    got = mk.sqrt_pow(u, v, block=block)
    torch.cuda.synchronize()
    assert mk.LAUNCHES["sqrt_pow"] == before + 1
    assert torch.equal(got, mk.sqrt_pow_plain(u, v))


@pytest.mark.parametrize("signed,windows,m", [(True, 33, 4), (True, 64, 256), (False, 64, 128)])
def test_msm_kernels_match_plain_and_oracle(cuda, signed, windows, m):
    pts, arr = oracle_points(m, 8)
    rng = random.Random(9)
    scalars = [rng.getrandbits(4 * windows - 2) for _ in range(m)]
    digits = (cv.scalars_to_signed_digits(scalars, windows) if signed
              else cv.scalars_to_digits(scalars))
    tp, td = torch.from_numpy(arr).to(cuda), torch.from_numpy(digits.copy()).to(cuda)
    part = mk.msm_partials(tp, td, signed=signed)
    block = min(mk.PARTIALS_BLOCK, m)
    assert torch.equal(part, mk.msm_partials_plain(tp, td, block, signed))
    out = mk.msm_combine(part)
    assert torch.equal(out, mk.msm_combine_plain(part))
    whole = (mk.msm_signed if signed else mk.msm)(tp, td, block=2)  # m / 2 CTAs
    assert cv.to_affine_bytes(whole) == cv.to_affine_bytes(out)
    want = ref.IDENTITY
    for s, p in zip(scalars, pts):
        want = ref.point_add(want, ref.point_mul(s, p))
    assert cv.to_affine_bytes(out) == ref.point_compress(want)


# W = 1, 33 (a ragged last window group) and 64; m below one block, one
# block, the fresh and cached width, and the uncached width.
@pytest.mark.parametrize("m", [4, 64, 1024, 2048])
@pytest.mark.parametrize("windows", [1, 33, 64])
@pytest.mark.parametrize("signed", [True, False])
def test_msm_partials_match_plain_at_every_geometry(cuda, signed, windows, m):
    rng = np.random.default_rng(windows * m)
    pts = torch.from_numpy(loose((m, 4, 20), m)).to(cuda)
    low, high = (-8, 9) if signed else (0, 16)
    digits = torch.from_numpy(rng.integers(low, high, size=(windows, m)).astype(np.int32)).to(cuda)
    block = min(mk.PARTIALS_BLOCK, m)
    got = mk.msm_partials(pts, digits, signed=signed)
    torch.cuda.synchronize()
    assert torch.equal(got, mk.msm_partials_plain(pts, digits, block, signed))


@pytest.mark.parametrize("n_windows", [1, 33, 64])
@pytest.mark.parametrize("n_blocks", [1, 16, 32])
def test_msm_combine_matches_plain(cuda, n_blocks, n_windows):
    part = torch.from_numpy(loose((n_blocks, n_windows, 4, 20), n_blocks + n_windows)).to(cuda)
    got = mk.msm_combine(part)
    torch.cuda.synchronize()
    assert torch.equal(got, mk.msm_combine_plain(part))
    assert torch.equal(mk.msm_combine(part), got)  # the ticket starts from 0 at every call


def test_warm_cached_batch_launches_k2_and_k3_twice(cuda):
    rng = random.Random(4)
    seeds = [rng.randbytes(32) for _ in range(6)]
    digest = crypto.sha512_digest(b"warm")
    pubs = [ref.secret_to_public(s) for s in seeds]
    sigs = [ref.sign(s, digest.data) for s in seeds]
    backend = CudaBackend()
    backend.verify_batch([digest.data] * 6, pubs, sigs)  # fills the key cache
    mk.reset_launches()
    backend.verify_batch([digest.data] * 6, pubs, sigs)
    assert mk.LAUNCHES == {
        "decompress": 1, "sqrt_pow": 0, "msm_partials_signed": 2, "msm_combine": 2,
        "msm_partials": 0, "verdict": 1,
    }


def test_wrappers_check_their_inputs(cuda):
    u = torch.zeros((8, 20), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        mk.sqrt_pow(u, u)
    with pytest.raises(ValueError):
        mk.decompress(u, torch.zeros(8, dtype=torch.int32, device=cuda))
    pt = torch.zeros((4, 20), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        mk.verdict(torch.ones(8, dtype=torch.int32, device=cuda), pt)
    pts = torch.zeros((8, 4, 20), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        mk.msm_partials(pts, torch.zeros((64, 4), dtype=torch.int32, device=cuda), signed=True)


def test_backend_on_card_accepts_and_rejects(cuda):
    rng = random.Random(3)
    seeds = [rng.randbytes(32) for _ in range(5)]
    digest = crypto.sha512_digest(b"card")
    pubs = [ref.secret_to_public(s) for s in seeds]
    sigs = [ref.sign(s, digest.data) for s in seeds]
    mk.reset_launches()
    backend = CudaBackend()
    backend.verify_batch([digest.data] * 5, pubs, sigs)
    bad = sigs[:2] + [sigs[2][:4] + bytes([sigs[2][4] ^ 1]) + sigs[2][5:]] + sigs[3:]
    with pytest.raises(crypto.CryptoError):
        backend.verify_batch([digest.data] * 5, pubs, bad)
    CudaBackend(cache=False).verify_batch([digest.data] * 5, pubs, sigs)
    path = {name: count for name, count in mk.LAUNCHES.items() if name != "sqrt_pow"}
    assert all(count > 0 for count in path.values()), mk.LAUNCHES
    assert mk.LAUNCHES["sqrt_pow"] == 0  # the decompression runs the root itself
