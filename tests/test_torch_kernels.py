"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA card with nvcc (``cuda`` marker) and
skips without one: the kernels have no CPU mode. The file imports nothing
of JAX, so it runs on a GPU host that has only the port's dependencies:

    python -m pytest tests/test_torch_kernels.py -q

Tolerance: limb-exact between each kernel and its plain version (they
repeat the same arithmetic in the same order), the decompression's ok flags
and the verdict's bool equal, and the sharded verdict's combined point too;
MSM results and the combined point also equal the RFC 8032 oracle by
compressed encoding, and the decompression's ok flags the oracle's. A mesh
of the one card repeated verifies as the unsharded path does. The
SHA-512 kernel's digests equal its plain version's and ``hashlib``'s byte
for byte.
"""

import hashlib
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
from hotstuff_tpu_torch.ops import sha512 as sha
from hotstuff_tpu_torch.ops import verify
from hotstuff_tpu_torch.parallel import mesh as pm
from tests.torch_inputs import VERDICT_CASES, decompress_inputs, tree_case, verdict_case

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


@pytest.mark.parametrize("zero_sum", [True, False])
@pytest.mark.parametrize("with_b", [True, False])
@pytest.mark.parametrize("d", [1, 3, 8])
def test_verdict_tree_matches_plain(cuda, d, with_b, zero_sum):
    a, b, total = tree_case(d, seed=d, with_b=with_b, zero_sum=zero_sum)
    ta = torch.from_numpy(a).to(cuda)
    tb = None if b is None else torch.from_numpy(b).to(cuda)
    ok = torch.ones(5 * d, dtype=torch.bool, device=cuda)
    before = mk.LAUNCHES["verdict_tree"]
    verdict, point = mk.verdict_tree(ok, ta, tb)
    torch.cuda.synchronize()
    assert mk.LAUNCHES["verdict_tree"] == before + 1
    verdict_p, point_p = mk.verdict_tree_plain(ok, ta, tb)
    assert torch.equal(point, point_p)
    assert bool(verdict) == bool(verdict_p) == zero_sum
    assert cv.to_affine_bytes(point) == ref.point_compress(total)
    ok[-1] = False
    assert not bool(mk.verdict_tree(ok, ta, tb)[0])
    none, alone = mk.verdict_tree(None, ta, tb)
    assert none is None and torch.equal(alone, point_p)


def test_verdict_tree_refuses_more_than_64_shards(cuda):
    a = torch.zeros((mk.MAX_SHARDS + 1, 4, 20), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        mk.verdict_tree(None, a)


@pytest.mark.parametrize("d", [1, 3, 4])
def test_sharded_verify_on_one_card(cuda, d):
    """A mesh of ``cuda:0`` repeated: the sharded verdict equals the
    unsharded one on a valid and a tampered batch, with exactly
    decompress d, K2 2d, K3 2d and one ``verdict_tree`` a warm cached QC."""
    rng = random.Random(9)
    seeds = [rng.randbytes(32) for _ in range(7)]
    digest = crypto.sha512_digest(b"shards")
    pubs = [ref.secret_to_public(s) for s in seeds]
    sigs = [ref.sign(s, digest.data) for s in seeds]
    msgs = [digest.data] * 7
    mesh = pm.make_mesh(devices=[torch.device("cuda", 0)] * d)
    cache = verify.DevicePointCache(device=mesh.devices[0])
    assert pm.verify_batch_device_cached_sharded(mesh, msgs, pubs, sigs, cache)
    mk.reset_launches()
    assert pm.verify_batch_device_cached_sharded(mesh, msgs, pubs, sigs, cache)
    assert mk.LAUNCHES == {"decompress": d, "sqrt_pow": 0, "msm_partials_signed": 2 * d,
                           "msm_partials": 0, "msm_combine": 2 * d, "verdict": 0,
                           "verdict_tree": 1}
    bad = sigs[:3] + [sigs[3][:4] + bytes([sigs[3][4] ^ 1]) + sigs[3][5:]] + sigs[4:]
    assert not pm.verify_batch_device_cached_sharded(mesh, msgs, pubs, bad, cache)
    assert pm.verify_batch_device_sharded(mesh, msgs, pubs, sigs)
    assert not pm.verify_batch_device_sharded(mesh, msgs, pubs, bad)


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
        "msm_partials": 0, "verdict": 1, "verdict_tree": 0,
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
    path = {name: count for name, count in mk.LAUNCHES.items()
            if name not in ("sqrt_pow", "verdict_tree")}
    assert all(count > 0 for count in path.values()), mk.LAUNCHES
    assert mk.LAUNCHES["sqrt_pow"] == 0  # the decompression runs the root itself
    if torch.cuda.device_count() == 1:
        assert mk.LAUNCHES["verdict_tree"] == 0  # one card: no mesh, no sharded verdict


def test_sha512_matches_plain_and_hashlib(cuda):
    """Mixed lengths at every padding boundary and 128 lanes of 0-1 kB in
    one launch, byte for byte against the plain version; then drains up to
    500 kB against hashlib (the plain version walks blocks in Python)."""
    rng = random.Random(6)
    lengths = [0, 1, 7, 8, 9, 111, 112, 113, 127, 128, 129, 239, 240, 255, 256, 300]
    msgs = [rng.randbytes(n) for n in lengths] + [rng.randbytes(rng.randrange(0, 1025))
                                                  for _ in range(128)]
    buf = sha.pack(msgs).to(cuda)
    before = sha.LAUNCHES["sha512"]
    kernel = sha.sha512(*sha.unpack(buf, len(msgs)))
    assert sha.LAUNCHES["sha512"] == before + 1
    assert torch.equal(kernel, sha.sha512_plain(*sha.unpack(buf, len(msgs))))
    big = msgs + [rng.randbytes(n) for n in (15000, 500_000, 6000, 0)]
    assert sha.sha512_batch(big) == [hashlib.sha512(m).digest() for m in big]


def sha512_drain(case, rng):
    """The drains of the redesigned kernel's checks: lane counts around a
    CTA's 32, the challenge shape, ragged lanes in one CTA, lanes longer
    than the ring, every padding boundary."""
    lanes = {"n=1": 1, "n=31": 31, "n=32": 32, "n=33": 33, "n=129": 129}
    if case in lanes:
        return [rng.randbytes(rng.randrange(0, 1100)) for _ in range(lanes[case])]
    if case == "1024 x 96 B":
        return [rng.randbytes(96) for _ in range(1024)]
    if case == "ragged, 0 B beside 40 kB":
        return [b"", rng.randbytes(40_000), b"", rng.randbytes(1)] + [
            rng.randbytes(rng.randrange(0, 300)) for _ in range(28)]
    if case == "longer than the ring":
        return [rng.randbytes(15_000), rng.randbytes(769), rng.randbytes(767), rng.randbytes(5)]
    return [rng.randbytes(n) for n in (0, 1, 7, 8, 9, 15, 16, 17, 111, 112, 113, 127, 128, 129,
                                       239, 240, 255, 256, 300, 367, 368, 383, 384, 385)]


@pytest.mark.parametrize("case", ["n=1", "n=31", "n=32", "n=33", "n=129", "1024 x 96 B",
                                  "ragged, 0 B beside 40 kB", "longer than the ring",
                                  "boundaries"])
def test_sha512_drains_match_plain_and_hashlib(cuda, case):
    """One launch a drain, byte for byte against the plain version (run on
    a host copy of the same buffer: its rounds walk blocks in Python) and
    against hashlib, through the wrapper and through ``sha512_batch``."""
    msgs = sha512_drain(case, random.Random(case))
    buf = sha.pack(msgs)
    before = sha.LAUNCHES["sha512"]
    kernel = sha.sha512(*sha.unpack(buf.to(cuda), len(msgs))).cpu()
    assert sha.LAUNCHES["sha512"] == before + 1
    assert torch.equal(kernel, sha.sha512_plain(*sha.unpack(buf, len(msgs))))
    want = [hashlib.sha512(m).digest() for m in msgs]
    assert [bytes(row) for row in kernel.numpy()] == want
    assert sha.sha512_batch(msgs) == want


def test_sha512_ragged_cta_of_500_kb_matches_hashlib(cuda):
    """0 B beside 500 kB (3,907 blocks) in one CTA: the producers of the
    empty lanes must keep the ring turning until the long lane ends."""
    rng = random.Random(500)
    msgs = [b"", rng.randbytes(500_000), b""] + [rng.randbytes(rng.randrange(0, 200))
                                                 for _ in range(30)]
    assert sha.sha512_batch(msgs) == [hashlib.sha512(m).digest() for m in msgs]


def test_sha512_unaligned_lanes_match_hashlib(cuda):
    """Offsets the wrapper's pack never makes (odd, and a buffer that ends
    at the last byte): the kernel reads such lanes byte by byte."""
    rng = random.Random(9)
    msgs = [rng.randbytes(n) for n in (0, 5, 111, 112, 200, 1000)]
    offsets, data = [], b""
    for m in msgs:
        data += bytes(rng.randrange(1, 5))
        offsets.append(len(data))
        data += m
    tdata = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(cuda)
    toff = torch.tensor(offsets, dtype=torch.int64, device=cuda)
    tlen = torch.tensor([len(m) for m in msgs], dtype=torch.int64, device=cuda)
    got = sha.sha512(tdata, toff, tlen).cpu()
    assert [bytes(row) for row in got.numpy()] == [hashlib.sha512(m).digest() for m in msgs]


@pytest.mark.parametrize("last", [1, 5, 15, 17, 1000, 15_001])
def test_sha512_aligned_last_lane_ending_the_buffer_matches_hashlib(cuda, last):
    """Lanes on 16-byte boundaries, as ``pack`` lays them out, in a buffer
    cut at the last lane's last byte (no rounded span, no tail): the
    kernel must not take the 16-byte loads for that lane, whose last chunk
    would run past the buffer, and the digests still match hashlib."""
    rng = random.Random(last)
    msgs = [rng.randbytes(n) for n in (0, 111, 300)] + [rng.randbytes(last)]
    offsets, lengths, _ = sha.layout(msgs)
    packed = sha.pack(msgs)
    end = 16 * len(msgs) + int(offsets[-1] + lengths[-1])
    assert int(offsets[-1]) % 16 == 0 and end % 16 != 0
    data = packed[16 * len(msgs) : end].clone().to(cuda)
    toff = torch.from_numpy(offsets).to(cuda)
    tlen = torch.from_numpy(lengths).to(cuda)
    assert data.numel() == int(offsets[-1] + lengths[-1])
    got = sha.sha512(data, toff, tlen).cpu()
    assert [bytes(row) for row in got.numpy()] == [hashlib.sha512(m).digest() for m in msgs]
