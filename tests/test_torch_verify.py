"""The port's batch verification (``hotstuff_tpu_torch.ops.verify``) on the
CPU, held against the JAX package and the RFC 8032 oracle.

Tolerances: host prep is byte-identical to the reference's under the same
``_rng``; device unpacking and the committee cache's decompressed rows are
limb-exact; verdicts equal the oracle's cofactored verdict
(``ed25519_ref.verify(strict=False)``) on the reference tests' matrix.
No JAX verify graph is built: the reference side runs host prep, eager
unpacking and one decompression compile only.
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hotstuff_tpu.crypto import ed25519_ref as ref
from hotstuff_tpu.ops import verify as jv
from hotstuff_tpu_torch.ops import msm_kernels as mk
from hotstuff_tpu_torch.ops import verify as tv


def make_batch(n=3, seed=5):
    rng = random.Random(seed)
    msgs, pubs, sigs = [], [], []
    for _ in range(n):
        seed_bytes = rng.randbytes(32)
        pubs.append(ref.secret_to_public(seed_bytes))
        msgs.append(rng.randbytes(32))
        sigs.append(ref.sign(seed_bytes, msgs[-1]))
    return msgs, pubs, sigs


class StubCache:
    """Just the ``ensure``/``lookup`` surface host prep uses, so that the
    reference's prep runs without a decompression compile."""

    def __init__(self, pubs):
        self.rows = {p: i + 1 for i, p in enumerate(dict.fromkeys(pubs))}

    def ensure(self, encs):
        # the host-side canonicality check of DevicePointCache.ensure
        return all((int.from_bytes(e, "little") & ((1 << 255) - 1)) < ref.P for e in encs)

    def lookup(self, enc):
        return self.rows.get(enc)


def torsioned_signature(seed=16):
    rng = random.Random(seed)
    a, _ = ref.secret_expand(rng.randbytes(32))
    pub = ref.point_compress(ref.point_mul(a, ref.G))
    msg = rng.randbytes(32)
    r = rng.getrandbits(250) % ref.L
    r_enc = ref.point_compress(ref.point_add(ref.point_mul(r, ref.G), ref.torsion_generator()))
    s = (r + ref.compute_challenge(r_enc, pub, msg) * a) % ref.L
    return [msg], [pub], [r_enc + s.to_bytes(32, "little")]


def case(name):
    """A batch of the reference tests' verdict matrix."""
    if name == "torsioned_r":
        return torsioned_signature()
    msgs, pubs, sigs = make_batch(4, seed=11)
    if name == "tampered_message":
        msgs[0] = b"\x55" * 32
    elif name == "tampered_signature":
        bad = bytearray(sigs[2])
        bad[1] ^= 4
        sigs[2] = bytes(bad)
    elif name == "noncanonical_s":
        s = int.from_bytes(sigs[1][32:], "little") + ref.L
        sigs[1] = sigs[1][:32] + s.to_bytes(32, "little")
    elif name == "invalid_pubkey":
        pubs[3] = (ref.P + 1).to_bytes(32, "little")
    return msgs, pubs, sigs


# -- host prep -----------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 3, 8])
def test_prepare_batch_byte_identical(n):
    msgs, pubs, sigs = make_batch(n, seed=20 + n)
    want = jv.prepare_batch(msgs, pubs, sigs, _rng=random.Random(n))
    got = tv.prepare_batch(msgs, pubs, sigs, _rng=random.Random(n))
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(
        tv.pad_prepared(got[0], 2 * got[1]), jv.pad_prepared(want[0], 2 * want[1])
    )


@pytest.mark.parametrize("n", [1, 3, 8])
def test_prepare_batch_cached_byte_identical(n):
    msgs, pubs, sigs = make_batch(n, seed=30 + n)
    want = jv.prepare_batch_cached(msgs, pubs, sigs, StubCache(pubs), _rng=random.Random(n))
    got = tv.prepare_batch_cached(msgs, pubs, sigs, StubCache(pubs), _rng=random.Random(n))
    assert got[1:] == want[1:]
    np.testing.assert_array_equal(got[0], want[0])
    packed, mf, mc = got
    np.testing.assert_array_equal(
        tv.pad_prepared_cached(packed, mf, mc, 2 * mf, 2 * mc),
        jv.pad_prepared_cached(want[0], mf, mc, 2 * mf, 2 * mc),
    )


@pytest.mark.parametrize("name", ["noncanonical_s", "invalid_pubkey", "short_signature"])
def test_host_rejections_equal_reference(name):
    msgs, pubs, sigs = case("valid" if name == "short_signature" else name)
    if name == "short_signature":
        sigs[0] = sigs[0][:63]
    stub = StubCache(pubs)
    assert tv.prepare_batch(msgs, pubs, sigs) is None
    assert jv.prepare_batch(msgs, pubs, sigs) is None
    assert tv.prepare_batch_cached(msgs, pubs, sigs, stub) is None
    assert jv.prepare_batch_cached(msgs, pubs, sigs, stub) is None


def test_unpack_limb_exact():
    msgs, pubs, sigs = make_batch(3, seed=40)
    packed, _ = tv.prepare_batch(msgs, pubs, sigs, _rng=random.Random(1))
    view = packed.copy()
    for want, got in zip(jv._unpack_device(jnp.asarray(packed)),
                         tv._unpack_device(torch.from_numpy(packed))):
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
    np.testing.assert_array_equal(packed, view)  # the caller's array is untouched


# -- verdicts --------------------------------------------------------------------

MATRIX = ["valid", "tampered_message", "tampered_signature", "noncanonical_s",
          "invalid_pubkey", "torsioned_r"]


@pytest.mark.parametrize("name", MATRIX)
def test_verdict_matrix_equals_oracle(name):
    msgs, pubs, sigs = case(name)
    want = all(ref.verify(p, m, s, strict=False) for m, p, s in zip(msgs, pubs, sigs))
    assert want == (name in ("valid", "torsioned_r"))  # cofactored: torsioned R passes
    cache = tv.DevicePointCache(capacity=64, device="cpu")
    assert tv.verify_batch_device_cached(msgs, pubs, sigs, cache, _rng=random.Random(1)) == want
    assert tv.verify_batch_device(msgs, pubs, sigs, _rng=random.Random(1), device="cpu") == want


def test_failed_insert_never_aliases_registered_rows():
    msgs, pubs, sigs = make_batch(2, seed=19)
    off_curve = (2).to_bytes(32, "little")  # canonical y with no square root
    cache = tv.DevicePointCache(capacity=64, device="cpu")
    assert not cache.ensure([off_curve, pubs[0]])  # mixed insert fails overall
    row_a = cache.lookup(pubs[0])
    assert row_a is not None and cache.lookup(off_curve) is None
    assert not cache.ensure([off_curve])  # remembered host-side
    assert cache.ensure([pubs[1]])
    assert cache.lookup(pubs[1]) not in (None, row_a)
    assert tv.verify_batch_device_cached(msgs[:1], pubs[:1], sigs[:1], cache)


# -- the committee point cache -----------------------------------------------------


def test_cache_rows_equal_reference_cache():
    """Both caches decompress the same keys into the same limbs and rows,
    and ``cache_from_numpy`` carries the reference's state across."""
    msgs, pubs, sigs = make_batch(4, seed=50)
    jc = jv.DevicePointCache(capacity=16)
    tc = tv.DevicePointCache(capacity=16, device="cpu")
    assert jc.ensure(pubs) and tc.ensure(pubs)
    assert tc._rows == jc._rows
    np.testing.assert_array_equal(tc.array.numpy(), np.asarray(jc.array))
    carried = tv.cache_from_numpy(np.asarray(jc.array), jc._rows, device="cpu")
    assert torch.equal(carried.array, tc.array) and carried._next_row == tc._next_row
    assert tv.verify_batch_device_cached(msgs, pubs, sigs, carried, _rng=random.Random(2))
    assert carried.ensure([pubs[0]]) and carried._next_row == 5  # nothing re-inserted


def test_cache_layout_and_growth():
    cache = tv.DevicePointCache(capacity=4, device="cpu")
    assert cache.capacity == 16  # the reference's minimum
    assert torch.equal(cache.array[0], torch.from_numpy(tv.cv.BASE_POINT))
    assert torch.equal(cache.array[1:], torch.from_numpy(tv.cv.IDENTITY).expand(15, 4, 20))
    _, pubs, _ = make_batch(20, seed=60)
    assert cache.ensure(pubs[:10])
    before = cache.array[:11].clone()
    assert cache.ensure(pubs)  # 21 rows: grows to 32
    assert cache.capacity == 32 and cache.array.shape == (32, 4, 20)
    assert torch.equal(cache.array[:11], before)
    assert sorted(cache._rows.values()) == list(range(21))


def test_cache_full_at_65536_rows():
    cache = tv.DevicePointCache(capacity=tv.MAX_ROWS, device="cpu")
    cache._next_row = tv.MAX_ROWS - 1
    _, pubs, _ = make_batch(2, seed=70)
    with pytest.raises(tv.CacheFull):
        cache.ensure(pubs)
    assert cache.capacity == tv.MAX_ROWS and cache.lookup(pubs[0]) is None


def test_cpu_tensors_never_launch_kernels():
    mk.reset_launches()
    msgs, pubs, sigs = make_batch(2, seed=80)
    assert tv.verify_batch_device(msgs, pubs, sigs, device="cpu")
    assert all(count == 0 for count in mk.LAUNCHES.values())
