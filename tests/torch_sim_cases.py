"""Shared set-up of the port's simulation-plane and memo tests
(``tests/test_torch_sim*.py``, ``tests/test_torch_memo.py``).

Both packages run their sim plane under the ``cpu`` backend, selected
through ``HOTSTUFF_CRYPTO_BACKEND`` at the first ``get_backend()``. A sim
run turns the process-wide verdict memo on and leaves it on (the
reference's behaviour, kept warm across a sweep's seeds), so every test
starts and ends with both packages' memos off, their telemetry reset and
off, each decode arena told so (``settle``), and both certificate arenas
empty: tier-1 runs many files in one worker, and a later test that counts
backend calls, memo hits or arena hits must not see an earlier file's
memo, counters or verified certificates.
"""

import pytest

import hotstuff_tpu.crypto as j_crypto
import hotstuff_tpu.telemetry as j_telemetry
import hotstuff_tpu_torch.crypto as t_crypto
import hotstuff_tpu_torch.telemetry as t_telemetry
from hotstuff_tpu.consensus import cert_arena as j_cert_arena
from hotstuff_tpu.consensus import decode_arena as j_decode_arena
from hotstuff_tpu_torch.consensus import cert_arena as t_cert_arena
from hotstuff_tpu_torch.consensus import decode_arena as t_decode_arena


def settle() -> None:
    for crypto, tm, arena in ((t_crypto, t_telemetry, t_decode_arena),
                              (j_crypto, j_telemetry, j_decode_arena)):
        crypto.enable_verify_memo(False)
        tm.reset_for_tests()
        tm.disable()
        arena.arena()._metrics()


@pytest.fixture
def cpu_backends(monkeypatch):
    """Both packages on ``HOTSTUFF_CRYPTO_BACKEND=cpu``, memos off before
    and after, telemetry settled."""
    monkeypatch.setenv("HOTSTUFF_CRYPTO_BACKEND", "cpu")
    monkeypatch.setattr(t_crypto, "_BACKEND", None)
    monkeypatch.setattr(j_crypto, "_BACKEND", None)
    reset_cert_arenas()
    settle()
    yield
    settle()
    reset_cert_arenas()


def reset_cert_arenas() -> None:
    """Both packages' process-wide certificate arenas emptied: an earlier
    test's run of the same seeded committee would leave its certificates
    verified in one package's arena and not the other's."""
    t_cert_arena.reset()
    j_cert_arena.reset()


def commit_sequences(world) -> dict:
    """Each instance's commits as (round, block digest, virtual time)."""
    return {name: [(rec.round, bytes(rec.digest), rec.t) for rec in recs]
            for name, recs in world.commits.items()}
