"""The port's opt-in verdict memo and signer memo, held against the
reference's (``hotstuff_tpu/crypto/__init__.py:140-152``, ``:253-318``,
``:350-375``, ``:505-521``).

- The same verifications in each package, memo on, telemetry on: equal
  memo contents (keys and verdicts, failure messages included) and equal
  ``crypto.verify_memo.hits``; a batch in either order is one entry.
- Without ``cryptography`` (``_HAVE_PYCA`` forced off in both): the signer
  memo's entries and signatures equal the reference's, and a memoised
  signature equals a fresh one.
- One sim run in each package (the byzantine equivocation scenario of
  ``tests/test_sim.py``): equal hits and memo contents.
- The port's departure: a ``BackendUnavailable`` is never memoised (the
  reference's ``except CryptoError`` caches it as a failure); the next call
  reaches the backend again.

Backends: ``cpu`` through ``HOTSTUFF_CRYPTO_BACKEND``. Tolerance: exact.
"""

import pytest

import hotstuff_tpu.crypto as j_crypto
import hotstuff_tpu.telemetry as j_telemetry
import hotstuff_tpu_torch.crypto as t_crypto
import hotstuff_tpu_torch.telemetry as t_telemetry
from hotstuff_tpu.faultline.policy import Scenario as JScenario
from hotstuff_tpu.sim import run_sim as j_run_sim
from hotstuff_tpu_torch.faultline.policy import Scenario as TScenario
from hotstuff_tpu_torch.sim import run_sim as t_run_sim

from .torch_sim_cases import cpu_backends  # noqa: F401  (autouse below)

PKGS = {"port": (t_crypto, t_telemetry), "reference": (j_crypto, j_telemetry)}


@pytest.fixture(autouse=True)
def isolated(cpu_backends):  # noqa: F811
    yield


def hits(tm) -> int:
    return tm.get_registry().snapshot()["counters"].get("crypto.verify_memo.hits", 0)


def memo_sequence(crypto) -> list[str]:
    """``tests/test_sim.py::test_verify_memo_caches_both_verdicts``'s calls,
    with a cert through ``backend_verify_cert``; returns each call's
    outcome."""
    pk, sk = crypto.generate_keypair(seed=b"m" * 32)[:2]
    digest = crypto.sha512_digest(b"memo-test")
    sig = crypto.Signature.new(digest, sk)
    bad = crypto.Signature(bytes(32) + sig.data[32:])
    pk2, sk2 = crypto.generate_keypair(seed=b"n" * 32)[:2]
    sig2 = crypto.Signature.new(digest, sk2)
    outcomes = []

    def run(fn):
        try:
            fn()
            outcomes.append("ok")
        except crypto.CryptoError as e:
            outcomes.append(f"{type(e).__name__}: {e}")

    for _ in range(2):
        run(lambda: sig.verify(digest, pk))
        run(lambda: bad.verify(digest, pk))
    run(lambda: crypto.Signature.verify_batch(digest, [(pk, sig), (pk2, sig2)]))
    run(lambda: crypto.Signature.verify_batch(digest, [(pk2, sig2), (pk, sig)]))
    run(lambda: crypto.Signature.verify_batch(digest, [(pk, bad)]))
    run(lambda: crypto.Signature.verify_batch(digest, [(pk, bad)]))
    buf = sig.data + sig2.data
    run(lambda: crypto.backend_verify_cert(digest.data, [pk.data, pk2.data], buf, 64))
    run(lambda: crypto.backend_verify_cert(digest.data, [pk.data, pk2.data], bad.data + sig2.data, 64))
    return outcomes


def test_memo_off_by_default_on_is_idempotent_off_drops_it():
    for crypto, _ in PKGS.values():
        assert not crypto.verify_memo_enabled()
        crypto.enable_verify_memo(True)
        crypto._VERIFY_MEMO["probe"] = True
        crypto.enable_verify_memo(True)  # kept warm
        assert crypto._VERIFY_MEMO == {"probe": True}
        crypto.enable_verify_memo(False)
        assert crypto._VERIFY_MEMO is None and not crypto.verify_memo_enabled()


def test_memo_hits_and_cached_failures_equal_the_references():
    got = {}
    for label, (crypto, tm) in PKGS.items():
        tm.enable()
        crypto.enable_verify_memo(True)
        outcomes = memo_sequence(crypto)
        got[label] = (outcomes, dict(crypto._VERIFY_MEMO), hits(tm))
    assert got["port"] == got["reference"]
    outcomes, memo, n_hits = got["port"]
    single_bad = "CryptoError: small-order or non-canonical point in signature"
    batch_bad = "CryptoError: invalid signature in batch"
    assert outcomes == ["ok", single_bad, "ok", single_bad, "ok", "ok", batch_bad, batch_bad,
                        "ok", batch_bad]
    # Both orders of the two-signature batch and the exploded valid cert are
    # one entry: three hits; the second bad batch one more.
    assert n_hits == 3
    assert sum(1 for v in memo.values() if v is not True) == 3  # failures cached


def test_signer_memo_signatures_equal_the_references(monkeypatch):
    sigs = {}
    for label, (crypto, _) in PKGS.items():
        monkeypatch.setattr(crypto, "_HAVE_PYCA", False)
        crypto.enable_verify_memo(True)
        sk = crypto.generate_keypair(seed=bytes(range(32)))[1]
        digests = [crypto.sha512_digest(b"signer", bytes([i])) for i in range(4)]
        first = [crypto.Signature.new(d, sk).data for d in digests]
        again = [crypto.Signature.new(d, sk).data for d in digests]  # from the memo
        assert first == again
        entries = {k: v for k, v in crypto._VERIFY_MEMO.items() if k[0] == b"sign"}
        assert len(entries) == 4
        sigs[label] = (first, entries)
        crypto.enable_verify_memo(False)
        fresh = [crypto.Signature.new(d, sk).data for d in digests]
        assert fresh == first
    assert sigs["port"] == sigs["reference"]


def test_sim_run_memo_equals_the_references():
    scenario = dict(name="byz", seed=9, duration_s=6.0,
                    events=[{"kind": "byzantine", "node": 2, "behavior": "equivocate",
                             "at": 1.0, "until": 4.0}])
    got = {}
    for label, (crypto, tm), scenario_cls, run_sim in (
            ("port", PKGS["port"], TScenario, t_run_sim),
            ("reference", PKGS["reference"], JScenario, j_run_sim)):
        tm.enable()
        result = run_sim(scenario_cls(**scenario), 4)
        verdict = result["verdict"]
        assert verdict["safety"]["ok"] and verdict["liveness"]["recovered"], (label, verdict)
        got[label] = (hits(tm), dict(crypto._VERIFY_MEMO), result["commit_streams"])
    assert got["port"] == got["reference"]
    assert got["port"][0] > 0 and got["port"][1]


class _FlakyCard:
    """A card backend that fails once (``BackendUnavailable``), then judges."""

    name = "cuda-flaky"

    def __init__(self):
        self.calls = 0
        self.inner = t_crypto.CpuBackend()

    def verify_batch(self, msgs, pubs, sigs):
        self.calls += 1
        if self.calls == 1:
            raise t_crypto.BackendUnavailable("card lost")
        self.inner.verify_batch(msgs, pubs, sigs)


def test_backend_unavailable_is_never_memoised_where_the_reference_caches_it():
    pk, sk = t_crypto.generate_keypair(seed=b"u" * 32)
    digest = t_crypto.sha512_digest(b"unjudged")
    sig = t_crypto.Signature.new(digest, sk)
    flaky = _FlakyCard()
    t_crypto.set_backend(flaky)
    t_crypto.enable_verify_memo(True)
    with pytest.raises(t_crypto.BackendUnavailable):
        t_crypto.Signature.verify_batch(digest, [(pk, sig)])
    assert t_crypto._VERIFY_MEMO == {}
    t_crypto.Signature.verify_batch(digest, [(pk, sig)])  # judged now
    assert flaky.calls == 2 and list(t_crypto._VERIFY_MEMO.values()) == [True]
    # The reference memoises the unjudged call as a failure verdict.
    j_crypto.set_backend(_JFlakyCard())
    j_crypto.enable_verify_memo(True)
    for _ in range(2):
        with pytest.raises(j_crypto.CryptoError):
            j_crypto.Signature.verify_batch(
                j_crypto.Digest(digest.data),
                [(j_crypto.PublicKey(pk.data), j_crypto.Signature(sig.data))])
    assert list(j_crypto._VERIFY_MEMO.values()) == ["card lost"]


class _JFlakyCard:
    name = "tpu-flaky"

    def __init__(self):
        self.calls = 0

    def verify_batch(self, msgs, pubs, sigs):
        self.calls += 1
        if self.calls == 1:
            raise j_crypto.BackendUnavailable("card lost")
        j_crypto.CpuBackend().verify_batch(msgs, pubs, sigs)
