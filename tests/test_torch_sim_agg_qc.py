"""Twins of ``tests/test_sim_agg_qc.py`` on the port: the fused
certificate rule model-checked against the per-signature oracle, and the
verdict memo's one keyspace for fused and structured certificate paths.

- An exhaustive single-seat corruption model over a 4-seat certificate:
  the port's fused checks (``cpu_batch.verify_cert_rlc`` and the native
  ``verify_cert_native``) reject exactly what the per-signature cofactored
  rule rejects.
- Under the memo, ``backend_verify_cert`` explodes into per-signature
  triples and never reaches a fused entry point, so the structured path
  is served from the same entries; a certificate with one bad signature
  raises on every arrival.

Backend: ``cpu`` through ``HOTSTUFF_CRYPTO_BACKEND`` (the fixture), or a
counting ``CpuBackend``. Tolerance: exact.
"""

import random

import pytest

from hotstuff_tpu_torch import crypto
from hotstuff_tpu_torch.crypto import CpuBackend, CryptoError, backend_verify_cert, set_backend
from hotstuff_tpu_torch.crypto import ed25519_ref as ref
from hotstuff_tpu_torch.crypto.cpu_batch import verify_cert_rlc
from hotstuff_tpu_torch.crypto.native_ed25519 import native_available, verify_cert_native

from .torch_sim_cases import cpu_backends  # noqa: F401


@pytest.fixture(autouse=True)
def _isolate(cpu_backends, monkeypatch):  # noqa: F811
    monkeypatch.delenv("HOTSTUFF_AGG_QC", raising=False)
    yield


def _cert(n, rng):
    seeds = [rng.randbytes(32) for _ in range(n)]
    pubs = [ref.secret_to_public(s) for s in seeds]
    msg = rng.randbytes(32)
    return msg, seeds, pubs, b"".join(ref.sign(s, msg) for s in seeds)


def _oracle(msg, pubs, sig_buf):
    """The per-signature rule the fused check must reproduce."""
    return all(ref.verify(pub, msg, sig_buf[i * 64:(i + 1) * 64], strict=False)
               for i, pub in enumerate(pubs))


def _fused_verdicts(msg, pubs, buf):
    verdicts = {"rlc": verify_cert_rlc(msg, pubs, buf)}
    if native_available():
        verdicts["native"] = verify_cert_native(msg, pubs, buf)
    return verdicts


def test_model_check_fused_rule_matches_per_signature_oracle():
    rng = random.Random(201)
    msg, seeds, pubs, buf = _cert(4, rng)
    cases = [("valid", buf)]
    for seat in range(4):
        base = seat * 64
        for tag, pos in (("R", base + 3), ("s", base + 40)):
            b = bytearray(buf)
            b[pos] ^= 0x01
            cases.append((f"seat{seat}-{tag}", bytes(b)))
        # A valid signature of the WRONG statement spliced in.
        alien = ref.sign(seeds[seat], rng.randbytes(32))
        b = bytearray(buf)
        b[base:base + 64] = alien
        cases.append((f"seat{seat}-alien", bytes(b)))
        if seat:  # a neighbour's valid signature under this seat's key
            b = bytearray(buf)
            b[base:base + 64] = buf[:64]
            cases.append((f"seat{seat}-swapped", bytes(b)))
    for tag, candidate in cases:
        want = _oracle(msg, pubs, candidate)
        assert want == (tag == "valid"), tag  # the model is well-formed
        for impl, got in _fused_verdicts(msg, pubs, candidate).items():
            assert got == want, (tag, impl)


class CountingBackend(CpuBackend):
    def __init__(self):
        super().__init__()
        self.batch_calls = 0
        self.cert_calls = 0

    def verify_batch(self, msgs, pubs, sigs):
        self.batch_calls += 1
        super().verify_batch(msgs, pubs, sigs)

    def verify_cert(self, msgs, pubs, sig_buf, stride=64, key=None):
        self.cert_calls += 1
        super().verify_cert(msgs, pubs, sig_buf, stride, key=key)


def test_memo_unifies_fused_and_structured_keyspaces():
    rng = random.Random(202)
    msg, _seeds, pubs, buf = _cert(3, rng)
    backend = CountingBackend()
    set_backend(backend)
    crypto.enable_verify_memo(True)
    backend_verify_cert(msg, pubs, buf, 64)
    assert backend.cert_calls == 0  # memo on: no fused entry touched
    first = backend.batch_calls
    assert first >= 1
    sigs = [buf[i * 64:(i + 1) * 64] for i in range(3)]
    crypto.backend_verify_batch([msg] * 3, pubs, sigs)  # all memo hits
    assert backend.batch_calls == first


def test_byzantine_cert_rejected_on_every_arrival_under_memo():
    rng = random.Random(203)
    msg, _seeds, pubs, buf = _cert(3, rng)
    bad = bytearray(buf)
    bad[64 + 10] ^= 0x01
    bad = bytes(bad)
    set_backend(CountingBackend())
    crypto.enable_verify_memo(True)
    for _ in range(3):
        with pytest.raises(CryptoError):
            backend_verify_cert(msg, pubs, bad, 64)
    backend_verify_cert(msg, pubs, buf, 64)  # the honest cert still passes
