"""The port's sharded verifier (``hotstuff_tpu_torch/parallel/mesh.py``) and
``CudaBackend``'s auto-shard branch, on the CPU.

The first five tests are the twins of ``tests/test_tpu_backend_mesh.py``.
The reference runs them on the conftest's 8 virtual CPU devices; here the
port's ``visible_devices`` is patched to 8 ``cpu`` entries, so the backend
builds a mesh of 8 shards, each running the kernels' plain versions. Then
the slice's own tests:

- the combine's tree against the reference's ``_combine_partials``, limb
  for limb, computed eagerly with ``hotstuff_tpu.ops.curve.point_add`` on
  the same numpy inputs, outside ``shard_map``;
- odd tree widths, where the reference's tree drops a shard;
- ``_shard_target`` against the reference's;
- ``CacheFull`` and the mesh's devices;
- the kernel launcher's device guard.

The verdict matrix over mesh widths, and the sharded MSM at odd widths, are
in ``tests/test_torch_mesh_verdicts.py`` and ``tests/test_torch_mesh_wide.py``.
No JAX verify graph is built. Tolerance: exact equality of limbs, encodings,
verdicts and error classes.
"""

import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from hotstuff_tpu.ops import curve as jcv
from hotstuff_tpu.parallel import mesh as jmesh
from hotstuff_tpu_torch import crypto
from hotstuff_tpu_torch.consensus.aggregator import Aggregator
from hotstuff_tpu_torch.consensus.config import Authority, Committee
from hotstuff_tpu_torch.consensus.messages import Vote
from hotstuff_tpu_torch.crypto import ed25519_ref as ref
from hotstuff_tpu_torch.crypto.cuda_backend import CudaBackend
from hotstuff_tpu_torch.ops import curve as cv
from hotstuff_tpu_torch.ops import msm_kernels as mk
from hotstuff_tpu_torch.ops import verify as ov
from hotstuff_tpu_torch.parallel import make_mesh
from hotstuff_tpu_torch.parallel import mesh as pm
from hotstuff_tpu_torch.utils import kernel_build

from .test_torch_backend import make_batch
from .torch_inputs import tree_case

CPU = torch.device("cpu")


@pytest.fixture
def cpus(monkeypatch):
    """A host that shows ``n`` devices of each type (8 unless set), the
    port's backend switches unset and its certificate arena off; returns a
    setter for ``n``."""
    shown = {"n": 8}
    monkeypatch.setattr(pm, "visible_devices",
                        lambda device_type="cuda": [torch.device(device_type)] * shown["n"])
    for name in ("HOTSTUFF_TPU_SHARDED", "HOTSTUFF_TPU_CACHE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("HOTSTUFF_CERT_ARENA", "0")
    monkeypatch.setattr(crypto, "_BACKEND", None)
    return lambda n: shown.update(n=n)


def four_keys():
    rng = random.Random(0)
    return [crypto.generate_keypair(seed=rng.randbytes(32))[:2] for _ in range(4)]


# -- the twins of tests/test_tpu_backend_mesh.py ---------------------------------


def test_cuda_backend_auto_shards_on_multidevice(cpus):
    """On a host that shows more than one device the backend selects the
    lane-sharded mesh verifier, and both polarities flow through it."""
    backend = CudaBackend(device="cpu")
    assert backend._mesh is not None and backend._mesh.size == 8, "must auto-select the mesh"

    msgs, pubs, sigs = make_batch(5, seed=21)
    backend.verify_batch(msgs, pubs, sigs)  # must not raise
    bad = bytearray(sigs[2])
    bad[7] ^= 0x20
    with pytest.raises(crypto.CryptoError) as info:
        backend.verify_batch(msgs, pubs, [*sigs[:2], bytes(bad), *sigs[3:]])
    assert not isinstance(info.value, crypto.BackendUnavailable)


def test_cuda_backend_sharded_override_off(cpus):
    assert CudaBackend(device="cpu", sharded=False)._mesh is None


def test_cuda_backend_mesh_uses_committee_cache(cpus):
    """The sharded path consults the committee point cache: both polarities
    through the sharded cached verifier, and a repeat batch reuses the
    cached rows."""
    backend = CudaBackend(device="cpu")
    assert backend._mesh is not None and backend._cache is not None, (
        "the multi-device backend must keep the committee cache")

    msgs, pubs, sigs = make_batch(5, seed=33)
    mesh = make_mesh(devices=pm.visible_devices("cpu"))
    cache = ov.DevicePointCache(device="cpu")
    assert pm.verify_batch_device_cached_sharded(
        mesh, msgs, pubs, sigs, cache, _rng=random.Random(7)) is True

    bad = bytearray(sigs[1])
    bad[3] ^= 0x10
    bad_sigs = [sigs[0], bytes(bad), *sigs[2:]]
    assert pm.verify_batch_device_cached_sharded(
        mesh, msgs, pubs, bad_sigs, cache, _rng=random.Random(8)) is False
    # Steady state: repeat batches reuse the cached rows (no growth).
    rows_before = cache._next_row
    assert pm.verify_batch_device_cached_sharded(mesh, msgs, pubs, sigs, cache,
                                                 _rng=random.Random(9))
    assert cache._next_row == rows_before


def test_cuda_backend_through_signature_api(cpus):
    crypto.set_backend(CudaBackend(device="cpu"))
    assert crypto.get_backend()._mesh.size == 8
    d = crypto.sha512_digest(b"quorum certificate")
    votes = [(pk, crypto.Signature.new(d, sk)) for pk, sk in four_keys()]
    crypto.Signature.verify_batch(d, votes)  # must not raise
    votes[1] = (votes[1][0], crypto.Signature(bytes(64)))
    with pytest.raises(crypto.CryptoError):
        crypto.Signature.verify_batch(d, votes)


def test_cuda_backend_qc_verify(cpus):
    backend = CudaBackend(device="cpu")
    crypto.set_backend(backend)
    keys = four_keys()
    committee = Committee({pk: Authority(1, ("127.0.0.1", 23000 + i))
                           for i, (pk, _) in enumerate(keys)})
    block = crypto.sha512_digest(b"block", (1).to_bytes(8, "little"))
    agg = Aggregator(committee)
    qc = [agg.add_vote(Vote.new_from_key(block, 1, pk, sk)) for pk, sk in keys][2]
    qc.verify(committee)  # the QC's batch verifies on the sharded path
    assert (backend.dispatches, backend.sigs) == (1, 3)


# -- the combine ----------------------------------------------------------------


def reference_combine(partials: np.ndarray) -> np.ndarray:
    """The reference's ``_combine_partials`` after its ``all_gather``
    (``hotstuff_tpu/parallel/mesh.py:59-63``), eagerly."""
    d = partials.shape[0]
    while d > 1:
        half = d // 2
        partials = jcv.point_add(partials[:half], partials[half : 2 * half])
        d = half
    return np.asarray(partials[0])


@pytest.mark.parametrize("with_b", [False, True])
@pytest.mark.parametrize("d", [2, 4, 8])
def test_tree_order_equals_the_reference_combine(d, with_b):
    a, b, _ = tree_case(d, seed=d, with_b=with_b, zero_sum=False)
    # Doubled once, so the limbs are not the affine ones the oracle gave.
    a = cv.point_double(torch.from_numpy(a)).numpy()
    b = None if b is None else cv.point_double(torch.from_numpy(b)).numpy()
    summed = a if b is None else np.asarray(jcv.point_add(a, b))  # mesh.py:190-192
    want = reference_combine(summed)
    _, got = mk.verdict_tree_plain(None, torch.from_numpy(a),
                                   None if b is None else torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("d", [3, 6])
def test_tree_carries_the_odd_point_the_reference_drops(d):
    """At an odd level width the port carries the last point into the next
    level: its sum is the oracle's. The reference's tree leaves out shard
    d - 1 (and at d = 6 the carried middle shard), so its point differs."""
    a, _, total = tree_case(d, seed=10 + d, with_b=False, zero_sum=False)
    verdict, got = mk.verdict_tree_plain(torch.ones(4, dtype=torch.bool), torch.from_numpy(a))
    assert cv.to_affine_bytes(got) == ref.point_compress(total)
    assert not bool(verdict)  # the sum of random multiples is not the identity
    dropped = np.array(reference_combine(a))  # writable, for torch
    assert cv.to_affine_bytes(torch.from_numpy(dropped)) != ref.point_compress(total)


@pytest.mark.parametrize("d", [1, 3, 5])
def test_tree_verdict_accepts_a_zero_sum_of_shards(d):
    a, b, _ = tree_case(d, seed=20 + d, with_b=True, zero_sum=True)
    ok = torch.ones(7, dtype=torch.bool)
    verdict, _ = mk.verdict_tree_plain(ok, torch.from_numpy(a), torch.from_numpy(b))
    assert bool(verdict)
    ok[3] = False
    assert not bool(mk.verdict_tree_plain(ok, torch.from_numpy(a), torch.from_numpy(b))[0])


def test_shard_target_equals_the_reference():
    for n_dev in (1, 2, 3, 4, 5, 6, 7, 8, 16, 64):
        for m in [*range(1, 70), 127, 128, 129, 1024, 1025, 2048, 2049, 16384]:
            assert pm._shard_target(m, n_dev) == jmesh._shard_target(m, n_dev), (m, n_dev)


# -- the backend ------------------------------------------------------------------


def test_cache_full_falls_back_to_a_fresh_cache_and_the_uncached_sharded_path(cpus, monkeypatch):
    cpus(2)
    backend = CudaBackend(device="cpu")
    assert backend._mesh.size == 2
    full = ov.DevicePointCache(capacity=ov.MAX_ROWS, device="cpu")
    full._next_row = ov.MAX_ROWS - 1  # the next two keys cannot fit
    backend._cache = full
    calls = []
    real = pm.verify_batch_device_sharded

    def spy(mesh, *args, **kwargs):
        calls.append((mesh.size, len(args[0])))
        return real(mesh, *args, **kwargs)

    monkeypatch.setattr(pm, "verify_batch_device_sharded", spy)
    msgs, pubs, sigs = make_batch(2, seed=5)
    backend.verify_batch(msgs, pubs, sigs)
    assert calls == [(2, 2)]
    assert backend._cache is not full and backend._cache.capacity == 4096
    assert backend._cache._next_row == 1  # fresh: filled again by later batches


@pytest.mark.parametrize("value", ["1", "auto", None])
def test_one_visible_device_builds_no_mesh(cpus, monkeypatch, value):
    cpus(1)
    if value is not None:
        monkeypatch.setenv("HOTSTUFF_TPU_SHARDED", value)
    assert CudaBackend(device="cpu")._mesh is None
    assert CudaBackend(device="cpu", sharded=True)._mesh is None


def test_uncached_backend_shards_without_a_cache(cpus, monkeypatch):
    cpus(2)
    backend = CudaBackend(device="cpu", cache=False)
    assert backend._mesh.size == 2 and backend._cache is None
    calls = []
    monkeypatch.setattr(pm, "verify_batch_device_sharded",
                        lambda mesh, msgs, pubs, sigs: calls.append(len(msgs)) or True)
    backend.verify_batch(*make_batch(3, seed=6))
    assert calls == [3]


def test_visible_devices_are_every_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    cards = [torch.device("cuda", i) for i in range(8)]
    assert pm.visible_devices() == cards
    assert make_mesh().devices == tuple(cards)
    assert make_mesh(3).devices == tuple(cards[:3])
    assert pm.visible_devices("cpu") == [CPU]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(ValueError):
        make_mesh(devices=[CPU] * (mk.MAX_SHARDS + 1))


def test_the_backend_card_leads_its_mesh(monkeypatch):
    """On a host of 4 cards the backend shards over all of them, its own
    card first: the lead holds the key cache and runs the combine."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.delenv("HOTSTUFF_TPU_SHARDED", raising=False)
    backend = CudaBackend(device="cuda:2", cache=False)
    assert backend._mesh.devices == tuple(torch.device("cuda", i) for i in (2, 3, 0, 1))
    assert backend.device == torch.device("cuda", 2)
    assert CudaBackend(device="cuda", cache=False).device == torch.device("cuda", 0)
    assert CudaBackend(device="cuda:2", cache=False, sharded=False)._mesh is None


def test_the_cache_must_live_on_the_lead():
    mesh = pm.Mesh((torch.device("cuda", 1), CPU))
    with pytest.raises(ValueError, match="lead"):
        pm.verify_batch_device_cached_sharded(mesh, [b"m"], [b"k" * 32], [b"s" * 64],
                                              ov.DevicePointCache(device="cpu"))


# -- the launcher's device guard -----------------------------------------------------

CARD = torch.device("cuda", 2)


class OnCard:
    """A stand-in for a tensor on ``CARD``: what a wrapper reads of one."""

    def __init__(self, shape, dtype=torch.int32, device=CARD):
        self.shape = tuple(shape) if isinstance(shape, (tuple, list)) else (shape,)
        self.dtype, self.device = dtype, device

    def contiguous(self):
        return self

    def data_ptr(self):
        return id(self)


@pytest.fixture
def fake_cards(monkeypatch):
    """The card runtime faked: ``torch.cuda.device`` records the card it
    makes current, ``current_stream`` names the card it was asked for, and
    the kernel loader records each launch with the card current at the
    launch and the stream it was given. Returns the launches."""
    current = {"card": torch.device("cuda", 0)}
    launches = []

    class Guard:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            self.before, current["card"] = current["card"], self.device

        def __exit__(self, *exc):
            current["card"] = self.before

    def kernel(source, fn):
        return lambda *args: launches.append((fn, current["card"], args[-1])) or 0

    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=f"stream of {device}"))
    monkeypatch.setattr(kernel_build, "kernel", kernel)
    for name in ("empty", "zeros"):
        monkeypatch.setattr(torch, name, lambda shape, dtype=None, device=None: OnCard(shape, dtype,
                                                                                       device))
    monkeypatch.setattr(torch, "empty_like", lambda t: OnCard(t.shape, t.dtype, t.device))
    monkeypatch.setattr(mk, "LAUNCHES", dict.fromkeys(mk.LAUNCHES, 0))
    return launches


WRAPPERS = {
    "decompress": lambda: mk.decompress(OnCard((8, 20)), OnCard((8,))),
    "sqrt_pow": lambda: mk.sqrt_pow(OnCard((8, 20)), OnCard((8, 20))),
    "msm_partials": lambda: mk.msm_partials(OnCard((8, 4, 20)), OnCard((64, 8)), signed=False),
    "msm_signed": lambda: mk.msm_signed(OnCard((8, 4, 20)), OnCard((33, 8))),
    "verdict": lambda: mk.verdict(OnCard((8,), torch.bool), OnCard((4, 20)), OnCard((4, 20))),
    "verdict_tree": lambda: mk.verdict_tree(OnCard((8,), torch.bool), OnCard((3, 4, 20)),
                                            OnCard((3, 4, 20))),
    "verdict_tree point": lambda: mk.verdict_tree(None, OnCard((3, 4, 20))),
}


@pytest.mark.parametrize("wrapper", list(WRAPPERS))
def test_launch_runs_on_its_tensors_card(fake_cards, wrapper):
    """Every wrapper launches with its tensors' card current and on that
    card's stream, not on the card that was current (``cuda:0``)."""
    WRAPPERS[wrapper]()
    assert fake_cards, "nothing launched"
    for fn, card, stream in fake_cards:
        assert card == CARD, fn
        assert stream == f"stream of {CARD}", fn
    assert sum(mk.LAUNCHES.values()) == len(fake_cards)
