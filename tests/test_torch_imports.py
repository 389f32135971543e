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

import pytest

REPO = Path(__file__).resolve().parents[1]

#: the data-plane and robustness harness scripts.
HARNESS_SCRIPTS = ("dtrace_assemble", "dataplane_sweep", "fleet_bench", "fault_matrix", "soak",
                   "detector_bench", "sim_sweep", "detector_sweep")

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
from hotstuff_tpu_torch.benchmark import committee_scale, digest_bench, superbatch_bench
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
        ("run_crypto_rounds", lambda: committee_scale.run_crypto_rounds(4, 1, False)),
        ("digest_bench.bench", lambda: digest_bench.bench(1, 8)),
        ("superbatch_bench.main", lambda: superbatch_bench.main([])),
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
                 "sim.statesync", "sim.streams", "benchmark", "benchmark.hostinfo",
                 "benchmark.logs", "benchmark.trace_assemble", "benchmark.profile_assemble",
                 "benchmark.watchtower", "benchmark.committee_scale", "benchmark.digest_bench",
                 "benchmark.superbatch_bench", "benchmark.local", "benchmark.run_local",
                 *(f"benchmark.{script}" for script in HARNESS_SCRIPTS)):
        assert f"hotstuff_tpu_torch.{name}" in result["modules"]
    assert result["leaked"] == []
    if not result["cuda"]:
        assert len(result["raised"]) == 12
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


@pytest.mark.parametrize("script", HARNESS_SCRIPTS)
def test_harness_script_imports_only_the_port(script):
    path = f"hotstuff_tpu_torch/benchmark/{script}.py"
    imported = imported_by(path)
    top = {name.split(".")[0] for name in imported}
    assert not top & {"jax", "jaxlib", "hotstuff_tpu", "benchmark", "bench"}, sorted(imported)
    text = (REPO / path).read_text()
    assert "sys.path.insert" not in text and "sys.path.append" not in text


#: each harness script that reaches the card: a short default run, and what
#: only its result would print.
CARD_RUNS = {
    "dataplane_sweep": (["--rates", "1000", "--duration", "1", "--base-port", "24800",
                         "--work-dir", "{tmp}/bench", "--output", "{tmp}/out"],
                        "hotstuff-dataplane-sweep-v1"),
    "fleet_bench": (["--duration", "1", "--base-port", "24800", "--work-dir", "{tmp}/bench",
                     "--output", "{tmp}/out"], "hotstuff-fleet-v1"),
    "fault_matrix": (["--nodes", "4", "--duration", "1", "--base-port", "24800",
                      "--output", "{tmp}/out"], "fault matrix N="),
    "soak": (["--duration", "1", "--base-port", "24800", "--work-dir", "{tmp}/soak/w",
              "--output", "{tmp}/out"], "soak verdict"),
    "detector_bench": (["--seeds", "3", "--controls", "0", "--duration", "1",
                        "--base-port", "24800", "--output", "{tmp}/out"], "detector bench"),
}


@pytest.mark.parametrize("script", sorted(CARD_RUNS))
def test_card_harness_script_exits_nonzero_without_a_card(tmp_path, script):
    """Run as a user types it, with no ``HOTSTUFF_*`` switch and no card, each
    script that reaches the card raises, names CUDA and prints no result:
    none falls back to the CPU. Ports: none bound (each raises first)."""
    args, result = CARD_RUNS[script]
    (tmp_path / "soak").mkdir()
    env = {k: v for k, v in os.environ.items() if not k.startswith("HOTSTUFF_")}
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, also on a GPU host
    out = subprocess.run(
        [sys.executable, "-m", f"hotstuff_tpu_torch.benchmark.{script}",
         *(a.format(tmp=tmp_path) for a in args)],
        capture_output=True, text=True, timeout=120, cwd=REPO, env=env)
    assert out.returncode != 0
    assert "CUDA" in out.stderr, out.stderr[-2000:]
    assert result not in out.stdout
    assert not (tmp_path / "out").exists() and not (tmp_path / "bench").exists()
