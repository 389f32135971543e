"""What the benchmark may import: never JAX or the JAX package (compared by
the whole top-level name, since ``hotstuff_tpu_torch`` begins with
``hotstuff_tpu``), never the old harnesses; the reference nothing of the
program."""

import ast
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
REPO = HERE.parent
FORBIDDEN_TOP = {"jax", "jaxlib", "flax", "hotstuff_tpu", "benchmark", "chip_smoke", "bench_torch"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
            for a in node.names:
                yield f"{node.module}.{a.name}"


def test_no_jax_and_no_old_harness_in_any_source():
    for path in HERE.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN_TOP, (path, name)
            assert not name.startswith("hotstuff_tpu_torch.benchmark"), (path, name)


def test_reference_imports_only_the_standard_library_and_itself():
    allowed = set(sys.stdlib_module_names) | {"perfbench", "__future__"}
    for path in (HERE / "reference").rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] in allowed, (path, name)


def test_loaded_modules_at_run_time():
    """Importing the harness with the program's entry loads no JAX; the
    reference alone loads nothing of the program and no torch."""
    code = (
        "import sys\n"
        "import perfbench.run, perfbench.program, perfbench.trace, perfbench.inputs\n"
        "from hotstuff_tpu_torch.consensus import messages, crypto_bridge\n"
        "from hotstuff_tpu_torch.crypto import cuda_backend, batching\n"
        "bad = {m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'hotstuff_tpu'}\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=300)
    code = (
        "import sys\n"
        "import perfbench.reference.judge, perfbench.reference.ed25519, perfbench.reference.wire\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "assert not tops & {'hotstuff_tpu_torch', 'hotstuff_tpu', 'torch', 'jax'}, tops\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=300)
