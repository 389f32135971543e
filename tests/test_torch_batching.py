"""The super-batching matrix of ``tests/test_superbatching.py`` and the
cert cases of ``tests/test_agg_qc.py:295-366``, run on both packages'
``BatchingBackend``: every case is parametrised over the port and the
reference, with the same expectations, so each case counts for both and
shows that they agree. Inner backends are each package's serial CPU
backend, counting or gated (its first inner call blocks until released,
so requests pool behind an in-flight call deterministically)."""

import random
import threading
import time

import pytest

from .test_torch_wire import PKGS


@pytest.fixture(autouse=True)
def restore_backends(monkeypatch):
    for pkg in PKGS.values():
        monkeypatch.setattr(pkg.crypto, "_BACKEND", None)
    yield


def counting(pkg, gated: bool = False, fail=None):
    """A CPU backend of ``pkg`` recording its inner call sizes; ``gated``
    blocks its first call until ``release_first`` is set; ``fail`` is
    raised by the calls it names (``"all"`` or ``"first"``)."""

    class Counting(pkg.crypto.CpuBackend):
        def __init__(self):
            super().__init__()
            self.calls = []
            self.first_entered = threading.Event()
            self.release_first = threading.Event()

        def verify_batch(self, msgs, pubs, sigs):
            first = not self.calls
            self.calls.append(len(msgs))
            if gated and first:
                self.first_entered.set()
                assert self.release_first.wait(30)
            if fail == "all" or (fail == "first" and first):
                raise RuntimeError("device tunnel died")
            super().verify_batch(msgs, pubs, sigs)

    return Counting()


def make_request(pkg, n=3, tag=b"m"):
    crypto = pkg.crypto
    rng = random.Random(0)
    d = crypto.sha512_digest(tag)
    msgs, pubs, sigs = [], [], []
    for _ in range(n):
        pk, sk = crypto.generate_keypair(seed=rng.randbytes(32))
        msgs.append(d.data)
        pubs.append(pk.data)
        sigs.append(crypto.Signature.new(d, sk).data)
    return msgs, pubs, sigs


def packed_cert(pkg, n=4, seed=109):
    """(msg, pubs, sig_buf) of a valid packed QC-shaped cert."""
    crypto = pkg.crypto
    rng = random.Random(seed)
    d = crypto.sha512_digest(rng.randbytes(32))
    keys = [crypto.generate_keypair(seed=rng.randbytes(32)) for _ in range(n)]
    return d.data, [pk.data for pk, _ in keys], b"".join(crypto.Signature.new(d, sk).data for _, sk in keys)


def corrupt(buf: bytes, pos: int) -> bytes:
    b = bytearray(buf)
    b[pos] ^= 0x01
    return bytes(b)


def run_pooled(pkg, backend, inner, calls):
    """Start an opener that occupies the gated inner call, then ``calls``
    (each a zero-argument callable) in threads; release the gate once they
    have all pooled. Returns each call's exception or None."""
    errors = [None] * len(calls)
    opener = threading.Thread(target=backend.verify_batch, args=make_request(pkg, tag=b"opener"))
    opener.start()
    assert inner.first_entered.wait(30)  # the device is now busy

    def worker(i, fn):
        try:
            fn()
        except Exception as e:
            errors[i] = e

    threads = [threading.Thread(target=worker, args=(i, fn)) for i, fn in enumerate(calls)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        with backend._lock:
            if len(backend._pending) == len(calls):
                break
        time.sleep(0.005)
    inner.release_first.set()
    for t in (opener, *threads):
        t.join(30)
    return errors


def run_threads(backend, requests):
    errors = [None] * len(requests)

    def worker(i, req):
        try:
            backend.verify_batch(*req)
        except Exception as e:
            errors[i] = e

    threads = [threading.Thread(target=worker, args=(i, r)) for i, r in enumerate(requests)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    return errors


@pytest.fixture(params=list(PKGS))
def pkg(request):
    return PKGS[request.param]


def test_requests_pool_behind_inflight_call_and_fuse(pkg):
    inner = counting(pkg, gated=True)
    backend = pkg.batching.BatchingBackend(inner)
    requests = [make_request(pkg, tag=b"r%d" % i) for i in range(5)]
    errors = run_pooled(pkg, backend, inner, [lambda r=r: backend.verify_batch(*r) for r in requests])
    assert errors == [None] * 5
    assert inner.calls == [3, 15]
    assert (backend.fused_requests, backend.inner_calls) == (6, 2)


def test_identical_requests_dedup_inside_fused_flush(pkg):
    inner = counting(pkg, gated=True)
    backend = pkg.batching.BatchingBackend(inner)
    same = make_request(pkg, tag=b"same-qc")
    errors = run_pooled(pkg, backend, inner, [lambda: backend.verify_batch(*same)] * 5)
    assert errors == [None] * 5
    assert inner.calls == [3, 3] and backend.deduped_sigs == 12


def test_identical_bad_requests_still_reject_each_caller(pkg):
    inner = counting(pkg, gated=True)
    backend = pkg.batching.BatchingBackend(inner)
    msgs, pubs, sigs = make_request(pkg, tag=b"bad")
    bad = (msgs, pubs, [b"\x07" * 64 for _ in sigs])
    errors = run_pooled(pkg, backend, inner, [lambda: backend.verify_batch(*bad)] * 3)
    assert all(isinstance(e, pkg.crypto.CryptoError) for e in errors)
    assert not any(isinstance(e, pkg.crypto.BackendUnavailable) for e in errors)


def test_lone_request_flushes_immediately(pkg):
    inner = counting(pkg)
    backend = pkg.batching.BatchingBackend(inner)
    t0 = time.perf_counter()
    backend.verify_batch(*make_request(pkg, tag=b"lone"))
    assert inner.calls == [3] and backend.inner_calls == 1
    assert time.perf_counter() - t0 < 1.0


def test_byzantine_request_isolated(pkg):
    inner = counting(pkg, gated=True)
    backend = pkg.batching.BatchingBackend(inner)
    pooled = [make_request(pkg, tag=b"g%d" % i) for i in range(3)]
    bad_msgs, bad_pubs, bad_sigs = make_request(pkg, tag=b"bad")
    bad_sigs[1] = bytes(64)
    pooled.append((bad_msgs, bad_pubs, bad_sigs))
    errors = run_pooled(pkg, backend, inner, [lambda r=r: backend.verify_batch(*r) for r in pooled])
    assert errors[:3] == [None] * 3, "good requests poisoned by the bad one"
    assert isinstance(errors[3], pkg.crypto.CryptoError)
    # Opener + one fused attempt + one isolation pass per pooled request.
    assert inner.calls[:2] == [3, 12] and len(inner.calls) == 6


def test_sequential_requests_still_work(pkg):
    backend = pkg.batching.BatchingBackend(counting(pkg))
    for i in range(3):
        backend.verify_batch(*make_request(pkg, tag=b"s%d" % i))
    m, p, s = make_request(pkg, tag=b"x")
    with pytest.raises(pkg.crypto.CryptoError):
        backend.verify_batch(m, p, [bytes(64)] * len(s))
    with pytest.raises(pkg.crypto.CryptoError):
        backend.verify_batch(m, p, s[:1])  # length mismatch, before any pooling


def test_backend_variant_names(pkg):
    crypto = pkg.crypto
    crypto.set_backend("cpu-batched")
    backend = crypto.get_backend()
    assert isinstance(backend, pkg.batching.BatchingBackend)
    assert backend.name == "cpu+superbatch"
    d = crypto.sha512_digest(b"qc")
    rng = random.Random(1)
    keys = [crypto.generate_keypair(seed=rng.randbytes(32)) for _ in range(4)]
    crypto.Signature.verify_batch(d, [(pk, crypto.Signature.new(d, sk)) for pk, sk in keys])
    device = "cuda" if pkg.name == "port" else "tpu"
    for bad in ("cpu-bogus", f"{device}-", "gpu", "cpu-batched-batched"):
        with pytest.raises(ValueError):
            crypto.set_backend(bad)
        assert crypto.get_backend() is backend  # a failed call leaves it unchanged


def test_device_failure_does_not_wedge_waiters(pkg):
    """A failure that is not a verdict (a RuntimeError from the inner
    backend) releases every fused waiter with ``BackendUnavailable``."""
    backend = pkg.batching.BatchingBackend(counting(pkg, fail="all"))
    errors = run_threads(backend, [make_request(pkg, tag=b"w%d" % i) for i in range(4)])
    assert all(isinstance(e, pkg.crypto.BackendUnavailable) for e in errors), errors
    assert all("backend failure" in str(e) for e in errors)


def test_partial_device_failure_isolates_to_healthy_path(pkg):
    backend = pkg.batching.BatchingBackend(counting(pkg, fail="first"))
    errors = run_threads(backend, [make_request(pkg, tag=b"f%d" % i) for i in range(3)])
    assert errors == [None] * 3


def test_oversized_fusion_verifies_per_request(pkg):
    inner = counting(pkg, gated=True)
    backend = pkg.batching.BatchingBackend(inner, max_sigs=5)
    requests = [make_request(pkg, tag=b"o%d" % i) for i in range(3)]
    errors = run_pooled(pkg, backend, inner, [lambda r=r: backend.verify_batch(*r) for r in requests])
    assert errors == [None] * 3
    assert inner.calls == [3, 3, 3, 3]  # the opener, then one call a request
    assert backend.inner_calls == 5  # the refused fused attempt counts too


def test_enable_superbatching_idempotent(pkg):
    pkg.crypto.set_backend("cpu")
    first = pkg.batching.enable_superbatching()
    assert pkg.batching.enable_superbatching() is first
    assert pkg.crypto.get_backend() is first


def test_superbatch_dedups_same_cert_to_one_call(pkg):
    msg, pubs, buf = packed_cert(pkg)
    inner = counting(pkg, gated=True)
    backend = pkg.batching.BatchingBackend(inner)
    errors = run_pooled(pkg, backend, inner, [lambda: backend.verify_cert(msg, pubs, buf, 64, key=b"cert")] * 3)
    assert errors == [None] * 3
    assert backend.cert_requests == 3
    assert backend.cert_deduped_sigs == len(pubs) * 2
    # One inner call for the three requests: the fused entry of the CPU
    # backend (the reference's) or the exploded batch (the port's).
    assert backend.inner_calls == 2


def test_superbatch_bad_cert_fails_only_its_own_waiters(pkg):
    msg, pubs, buf = packed_cert(pkg, seed=110)
    inner = counting(pkg, gated=True)
    backend = pkg.batching.BatchingBackend(inner)
    errors = run_pooled(pkg, backend, inner, [
        lambda: backend.verify_cert(msg, pubs, buf, 64, key=b"good"),
        lambda: backend.verify_cert(msg, pubs, corrupt(buf, 5), 64, key=b"bad"),
        lambda: backend.verify_cert(msg, pubs, corrupt(buf, 5), 64),  # keyed by its statement
    ])
    assert errors[0] is None
    assert all(isinstance(e, pkg.crypto.CryptoError) for e in errors[1:])
    assert not any(isinstance(e, pkg.crypto.BackendUnavailable) for e in errors[1:])


def test_cert_device_failure_reaches_waiters_as_backend_unavailable(pkg):
    """An inner backend without a fused entry that raises RuntimeError: the
    cert's waiters get ``BackendUnavailable``, never acceptance."""
    inner = counting(pkg, fail="all")
    inner.verify_cert = None
    backend = pkg.batching.BatchingBackend(inner)
    msg, pubs, buf = packed_cert(pkg)
    with pytest.raises(pkg.crypto.BackendUnavailable, match="backend failure"):
        backend.verify_cert(msg, pubs, buf, 64)


def test_port_keeps_an_inner_backend_unavailable_on_the_cert_path():
    """The port's ``CudaBackend`` reports a device failure as
    ``BackendUnavailable`` itself; on the cert path the port's wrapper keeps
    it one (the reference's turns it into a plain ``CryptoError``, which the
    consensus layer reads as a bad signature)."""
    pkg = PKGS["port"]

    class Unavailable(pkg.crypto.CpuBackend):
        name = "cuda"
        verify_cert = None

        def verify_batch(self, msgs, pubs, sigs):
            raise pkg.crypto.BackendUnavailable("device verification failed")

    backend = pkg.batching.BatchingBackend(Unavailable())
    msg, pubs, buf = packed_cert(pkg)
    with pytest.raises(pkg.crypto.BackendUnavailable):
        backend.verify_cert(msg, pubs, buf, 64)
    with pytest.raises(pkg.crypto.BackendUnavailable):
        backend.verify_batch([msg] * len(pubs), pubs, [buf[i * 64:(i + 1) * 64] for i in range(len(pubs))])
