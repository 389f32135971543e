"""The port stands alone: importing every ``hotstuff_tpu_torch`` module
loads neither ``jax`` nor any module of the JAX package, ``chip_smoke.py``
and ``bench_torch.py`` import neither (nor the reference's ``benchmark``
package), and the port's entry points, called without ``device`` on a host
without CUDA, raise instead of running on the CPU. The network imports
faultline's hooks on its hot path, and nothing more of faultline. Checked in a
fresh interpreter, since this test process itself imports the JAX
package."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, json, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import hotstuff_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(hotstuff_tpu_torch.__path__, "hotstuff_tpu_torch."))
for name in names:
    importlib.import_module(name)

def leaked():
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "hotstuff_tpu", "benchmark"))


import torch
import bench_torch
from hotstuff_tpu_torch import crypto
from hotstuff_tpu_torch.crypto.cuda_backend import CudaBackend
from hotstuff_tpu_torch.ops import sha512, verify
from hotstuff_tpu_torch.parallel import make_mesh
raised = {}
if not torch.cuda.is_available():
    for what, call in [
        ("CudaBackend", lambda: CudaBackend()),
        ("DevicePointCache", lambda: verify.DevicePointCache()),
        ("verify_batch_device", lambda: verify.verify_batch_device([b"m"], [b"k" * 32], [b"s" * 64])),
        ("get_backend", crypto.get_backend),
        ("set_backend cuda-batched", lambda: crypto.set_backend("cuda-batched")),
        ("sha512_batch", lambda: sha512.sha512_batch([b"m"])),
        ("make_mesh", make_mesh),
        ("bench_device_cached", lambda: bench_torch.bench_device_cached([b"m"], [b"k" * 32], [b"s" * 64])),
        ("bench_device", lambda: bench_torch.bench_device([b"m"], [b"k" * 32], [b"s" * 64])),
    ]:
        try:
            call()
            raised[what] = None
        except RuntimeError as e:
            raised[what] = str(e)
print(json.dumps({"modules": names, "leaked": leaked(), "cuda": torch.cuda.is_available(), "raised": raised}))
"""


def probe():
    out = subprocess.run(
        [sys.executable, "-c", PROBE, str(REPO)],
        capture_output=True, text=True, timeout=120, cwd=REPO, check=True,
    )
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_imports_no_jax_and_no_reference_module():
    result = probe()
    assert "hotstuff_tpu_torch.ops.msm_kernels" in result["modules"]
    for name in ("consensus.aggregator", "consensus.messages", "consensus.cert_arena",
                 "consensus.decode_arena", "crypto.batching", "utils.serde",
                 "consensus.core", "consensus.consensus", "consensus.crypto_bridge",
                 "consensus.helper", "consensus.leader", "consensus.mempool_driver",
                 "consensus.proposer", "consensus.statesync", "consensus.synchronizer",
                 "consensus.timer", "mempool.synchronizer", "mempool.dataplane.messages",
                 "mempool.dataplane", "mempool.dataplane.backpressure",
                 "mempool.dataplane.certificate", "mempool.dataplane.worker",
                 "mempool.dataplane.dataplane",
                 "network.budget", "network.receiver", "network.reliable_sender",
                 "network.simple_sender", "network.native", "store", "store.native",
                 "utils.quorum", "utils.tasks", "utils.scenario_runs", "utils.logging",
                 "ops.sha512", "mempool", "mempool.messages", "mempool.config",
                 "mempool.batch_maker", "mempool.quorum_waiter", "mempool.processor",
                 "mempool.helper", "mempool.mempool", "node", "node.config", "node.node",
                 "node.__main__", "node.client", "parallel", "parallel.mesh",
                 "crypto.native_ed25519", "crypto.cpu_batch", "telemetry",
                 "telemetry.registry", "telemetry.spans", "telemetry.trace",
                 "telemetry.profiler", "telemetry.emitter", "telemetry.dtrace",
                 "telemetry.resources", "telemetry.slo", "telemetry.validate",
                 "telemetry.watchtower", "faultline", "faultline.hooks", "faultline.policy",
                 "faultline.runtime", "faultline.checker", "faultline.byzantine",
                 "faultline.harness", "parallel.engine_groups", "sim", "sim.clock",
                 "sim.machine", "sim.world", "sim.shrink", "sim.twins", "sim.dataplane",
                 "sim.statesync", "sim.streams"):
        assert f"hotstuff_tpu_torch.{name}" in result["modules"]
    assert result["leaked"] == []
    if not result["cuda"]:
        for what, message in result["raised"].items():
            assert message is not None and "CUDA" in message, what


LIGHT_PROBE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import hotstuff_tpu_torch.network
print(json.dumps(sorted(m for m in sys.modules if ".faultline" in m or "consensus" in m)))
"""


def test_network_loads_faultline_hooks_and_not_its_harness():
    out = subprocess.run(
        [sys.executable, "-c", LIGHT_PROBE, str(REPO)],
        capture_output=True, text=True, timeout=120, cwd=REPO, check=True,
    )
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "hotstuff_tpu_torch.faultline.hooks" in loaded
    for lazy in ("harness", "byzantine", "checker"):
        assert f"hotstuff_tpu_torch.faultline.{lazy}" not in loaded
    assert not any(m.startswith("hotstuff_tpu_torch.consensus") for m in loaded)


def imported_by(script: str) -> set[str]:
    imported = set()
    for node in ast.walk(ast.parse((REPO / script).read_text())):
        if isinstance(node, ast.Import):
            imported.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            imported.add(node.module or "")
    return imported


def test_chip_smoke_imports_no_jax_and_no_reference_module():
    imported = imported_by("chip_smoke.py")
    top = {name.split(".")[0] for name in imported}
    assert "hotstuff_tpu_torch" in top and "bench_torch" in top
    assert not top & {"jax", "jaxlib", "hotstuff_tpu", "benchmark", "bench"}, sorted(imported)


def test_bench_torch_imports_no_jax_and_no_reference_module():
    imported = imported_by("bench_torch.py")
    top = {name.split(".")[0] for name in imported}
    assert "hotstuff_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "hotstuff_tpu", "benchmark", "bench"}, sorted(imported)


def test_kernel_times_runs_as_a_script_without_a_card():
    """Run by path, as its docstring says, the timer must reach its own
    check for a card. Python puts the script's directory first on the
    path, and there ``utils/logging.py`` shadowed the standard library's
    ``logging`` at ``import torch``."""
    script = REPO / "hotstuff_tpu_torch" / "utils" / "kernel_times.py"
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}  # no card, also on a GPU host
    out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                         timeout=300, cwd=REPO, env=env)
    assert "partially initialized module 'logging'" not in out.stderr, out.stderr
    assert out.returncode == 1 and "kernel_times: no CUDA device" in out.stderr, out.stderr
