"""The port's ``CudaBackend`` error contract, on the CPU (``device="cpu"``
runs the kernels' plain versions). The contract is the reference's
(``hotstuff_tpu/crypto/tpu_backend.py:64-106``): a length mismatch and a
rejected batch raise ``CryptoError``; a runtime failure raises
``BackendUnavailable`` (the batch was not judged); ``CacheFull`` starts a
fresh cache and verifies through the uncached path.
"""

import random

import pytest

from hotstuff_tpu.crypto import ed25519_ref as ref
from hotstuff_tpu_torch import crypto
from hotstuff_tpu_torch.crypto.cuda_backend import CudaBackend
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


@pytest.fixture
def uncached_calls(monkeypatch):
    """Counts calls of the uncached verifier, which the backend resolves at
    call time through the ops module."""
    calls = []
    real = tv.verify_batch_device

    def spy(*args, **kwargs):
        calls.append(len(args[0]))
        return real(*args, **kwargs)

    monkeypatch.setattr(tv, "verify_batch_device", spy)
    return calls


def test_accepts_valid_batch_and_counts(uncached_calls):
    backend = CudaBackend(device="cpu")
    msgs, pubs, sigs = make_batch(3, seed=1)
    backend.verify_batch(msgs, pubs, sigs)
    backend.verify_batch([], [], [])  # empty: nothing dispatched
    assert (backend.dispatches, backend.sigs) == (1, 3)
    assert uncached_calls == []  # the cached path judged it


@pytest.mark.parametrize("fault", ["tampered_signature", "noncanonical_s"])
def test_rejected_batch_raises_crypto_error(fault):
    backend = CudaBackend(device="cpu")
    msgs, pubs, sigs = make_batch(3, seed=2)
    if fault == "tampered_signature":
        sigs[1] = sigs[1][:3] + bytes([sigs[1][3] ^ 1]) + sigs[1][4:]
    else:
        s = int.from_bytes(sigs[1][32:], "little") + ref.L
        sigs[1] = sigs[1][:32] + s.to_bytes(32, "little")
    with pytest.raises(crypto.CryptoError) as info:
        backend.verify_batch(msgs, pubs, sigs)
    assert not isinstance(info.value, crypto.BackendUnavailable)


def test_length_mismatch_raises_crypto_error():
    backend = CudaBackend(device="cpu")
    msgs, pubs, sigs = make_batch(2, seed=3)
    with pytest.raises(crypto.CryptoError) as info:
        backend.verify_batch(msgs, pubs, sigs[:1])
    assert not isinstance(info.value, crypto.BackendUnavailable)
    assert backend.dispatches == 0


def test_runtime_failure_raises_backend_unavailable(monkeypatch):
    backend = CudaBackend(device="cpu")
    msgs, pubs, sigs = make_batch(2, seed=4)

    def broken(*args, **kwargs):
        raise RuntimeError("injected kernel failure")

    monkeypatch.setattr(tv, "run_cached", broken)
    with pytest.raises(crypto.BackendUnavailable) as info:
        backend.verify_batch(msgs, pubs, sigs)
    assert isinstance(info.value.__cause__, RuntimeError)


def test_cache_full_restarts_cache_and_verifies_uncached(uncached_calls):
    backend = CudaBackend(device="cpu")
    full = tv.DevicePointCache(capacity=tv.MAX_ROWS, device="cpu")
    full._next_row = tv.MAX_ROWS - 1  # the next two keys cannot fit
    backend._cache = full
    msgs, pubs, sigs = make_batch(2, seed=5)
    backend.verify_batch(msgs, pubs, sigs)
    assert uncached_calls == [2]
    assert backend._cache is not full and backend._cache.capacity == 4096
    assert backend._cache._next_row == 1  # fresh: filled again by later batches


def test_uncached_backend(uncached_calls):
    backend = CudaBackend(device="cpu", cache=False)
    msgs, pubs, sigs = make_batch(2, seed=6)
    backend.verify_batch(msgs, pubs, sigs)
    msgs[0] = b"\x00" * 32
    with pytest.raises(crypto.CryptoError):
        backend.verify_batch(msgs, pubs, sigs)
    assert uncached_calls == [2, 2]


def test_set_backend_accepts_objects_and_the_cuda_name(monkeypatch):
    monkeypatch.setattr(crypto, "_BACKEND", None)
    backend = CudaBackend(device="cpu")
    crypto.set_backend(backend)
    assert crypto.get_backend() is backend
    with pytest.raises(ValueError):
        crypto.set_backend("tpu")
    assert crypto.get_backend() is backend
