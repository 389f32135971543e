"""``benchmark/scenarios/crash.json`` (read as data) at N = 4 through the
port's ``run_scenario`` under ``cuda-batched`` on the card: the verdict is
safe and recovered, the trace is the compiled schedule's, and the faults'
QCs went through the cached path's kernels (decompress, K2 signed, K3 and
the verdict; K4 and the root alone never), with ``crypto.dispatch.cuda``
moving by exactly the verdict's launches.

Needs a CUDA card with nvcc (``cuda`` marker; it skips without one).
Imports neither JAX nor the JAX package. Ports 10900-10931: below the H100
host's ephemeral range (16000-65535), clear of ``chip_smoke.py``'s
(10000-10599, 10800-10899, 11000-11199), the bench's (10600-10699) and the
other card tests' (10700-10747).
"""

import asyncio
import threading
from pathlib import Path

import pytest
import torch

import hotstuff_tpu_torch.crypto as t_crypto
from hotstuff_tpu_torch import telemetry
from hotstuff_tpu_torch.consensus import cert_arena
from hotstuff_tpu_torch.crypto.batching import BatchingBackend
from hotstuff_tpu_torch.crypto.cuda_backend import CudaBackend
from hotstuff_tpu_torch.faultline import Scenario, hooks, run_scenario
from hotstuff_tpu_torch.ops import msm_kernels as mk

pytestmark = pytest.mark.cuda
BASE = 10900
SCENARIO = Path(__file__).resolve().parents[1] / "benchmark" / "scenarios" / "crash.json"


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    telemetry.reset_for_tests()
    telemetry.enable()
    monkeypatch.setattr(t_crypto, "_BACKEND", None)
    monkeypatch.setenv("HOTSTUFF_CERT_ARENA", "1")
    t_crypto.set_backend("cuda-batched")
    cert_arena.reset()
    yield torch.device("cuda")
    cert_arena.reset()
    telemetry.reset_for_tests()


def test_crash_scenario_verifies_its_qcs_on_the_card(cuda):
    backend = t_crypto.get_backend()
    assert isinstance(backend, BatchingBackend) and isinstance(backend.inner, CudaBackend)
    inner = backend.inner
    gate = threading.Lock()
    real = inner.verify_batch

    def gated(*args):
        with gate:
            return real(*args)

    inner.verify_batch = gated
    registry = telemetry.get_registry()
    scenario = Scenario.load(str(SCENARIO))
    try:
        with gate:
            mk.reset_launches()
            before = registry.snapshot()["counters"].get("crypto.dispatch.cuda", 0)
        result = asyncio.run(run_scenario(scenario, 4, base_port=BASE, timeout_delay=1_000))
        with gate:
            launches = dict(mk.LAUNCHES)
            dispatched = registry.snapshot()["counters"].get("crypto.dispatch.cuda", 0) - before
    finally:
        del inner.verify_batch
    verdict = result["verdict"]
    assert verdict["safety"]["ok"], verdict["safety"]
    assert verdict["liveness"]["recovered"], verdict["liveness"]
    assert verdict["injections"]["counts"]["events_applied"] == 2
    assert result["trace"] == scenario.compile([f"n{i:03d}" for i in range(4)]).trace()
    assert hooks.plane is None
    for name in ("decompress", "msm_partials_signed", "msm_combine", "verdict"):
        assert launches[name] > 0, launches
    assert launches["msm_partials"] == 0 and launches["sqrt_pow"] == 0, launches
    assert launches["msm_partials_signed"] == launches["msm_combine"] == 2 * launches["verdict"]
    assert dispatched == launches["verdict"], (dispatched, launches)
