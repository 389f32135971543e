"""The port stands alone: importing every ``hotstuff_tpu_torch`` module
loads neither ``jax`` nor any module of the JAX package, ``chip_smoke.py``
imports neither, and the port's entry points, called without ``device`` on
a host without CUDA, raise instead of running on the CPU. Checked in a
fresh interpreter, since this test process itself imports the JAX
package."""

import ast
import json
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
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.") or m == "hotstuff_tpu" or m.startswith("hotstuff_tpu."))

import torch
from hotstuff_tpu_torch import crypto
from hotstuff_tpu_torch.crypto.cuda_backend import CudaBackend
from hotstuff_tpu_torch.ops import verify
raised = {}
if not torch.cuda.is_available():
    for what, call in [
        ("CudaBackend", lambda: CudaBackend()),
        ("DevicePointCache", lambda: verify.DevicePointCache()),
        ("verify_batch_device", lambda: verify.verify_batch_device([b"m"], [b"k" * 32], [b"s" * 64])),
        ("get_backend", crypto.get_backend),
        ("set_backend cuda-batched", lambda: crypto.set_backend("cuda-batched")),
    ]:
        try:
            call()
            raised[what] = None
        except RuntimeError as e:
            raised[what] = str(e)
print(json.dumps({"modules": names, "leaked": leaked, "cuda": torch.cuda.is_available(), "raised": raised}))
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
                 "consensus.decode_arena", "crypto.batching", "utils.serde"):
        assert f"hotstuff_tpu_torch.{name}" in result["modules"]
    assert result["leaked"] == []
    if not result["cuda"]:
        for what, message in result["raised"].items():
            assert message is not None and "CUDA" in message, what


def test_chip_smoke_imports_no_jax_and_no_reference_module():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            imported.add(node.module or "")
    top = {name.split(".")[0] for name in imported}
    assert "hotstuff_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "hotstuff_tpu"}, sorted(imported)
