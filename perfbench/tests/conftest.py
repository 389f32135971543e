"""Fixtures of the benchmark's own tests.

``pytest perfbench/tests`` runs them here on the host; the ``cuda`` ones
skip without a card and run on the H100 by the same command. The tiny cell
runs through the kernels' plain versions, so a window of a few seconds
judges one or two proposals.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

TINY_CONFIG = {
    "name": "tiny-4", "validators": 4, "faults": 1, "stake": 1, "quorum": 3,
    "payload_digests": 2, "reduced": [], "guarantees": ["as committee-1008"],
}
# Every proposal forged: a window of one or two proposals has something
# to reject.
TINY_TRAFFIC = {
    "certificates": ["qc"], "in_flight": 1, "backend": "cuda", "workers": 1,
    "forged_per_64": 64, "short_per_64": 0, "pool": 2, "forged_pool": 1,
    "short_pool": 1, "plan_sigs_per_s": 30,
}


@pytest.fixture
def cuda():
    """Skips unless a CUDA card is present (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def copy_benchmark(dest: Path, configs=(), traffic=(), workloads=(), metrics=()) -> Path:
    """A copy of ``BENCHMARK.json`` and ``perfbench/`` in ``dest`` with files
    and entries added: ``configs`` (entry, content), ``traffic`` (name,
    content), ``workloads`` entries, ``metrics`` (per-layer entry, reader
    source)."""
    shutil.copytree(REPO / "perfbench", dest / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for entry, content in configs:
        (dest / entry["file"]).write_text(json.dumps(content))
        bench["configs"].append(entry)
    for name, content in traffic:
        (dest / "perfbench" / "traffic" / f"{name}.json").write_text(json.dumps(content))
    bench["workloads"].extend(workloads)
    for entry, source in metrics:
        (dest / "perfbench" / "metrics" / f"{entry['name']}.py").write_text(source)
        bench["per_layer"].append(entry)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest


def tiny_copy(dest: Path, **extra) -> Path:
    return copy_benchmark(
        dest,
        configs=[({"name": "tiny-4", "source": "https://arxiv.org/abs/1803.05069",
                   "file": "perfbench/configs/tiny-4.json", "reduced": [], "why": "tests"},
                  TINY_CONFIG)] + list(extra.get("configs", [])),
        traffic=[("tiny", TINY_TRAFFIC)] + list(extra.get("traffic", [])),
        workloads=[{"name": "tiny", "config": "tiny-4", "traffic": "tiny", "chips": 1,
                    "why": "tests"}] + list(extra.get("workloads", [])),
        metrics=extra.get("metrics", ()),
    )


def run_cell(where: Path, workload: str, seed: int, seconds: float, trace: int = 0,
             extra=(), program: bool = True, timeout: float = 600):
    """(exit code, result dict or None, standard error) of one run."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    if program:
        env["PYTHONPATH"] = str(REPO)
    cmd = [sys.executable, "-m", "perfbench.run", "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace), *extra]
    proc = subprocess.run(cmd, cwd=where, env=env, capture_output=True, text=True,
                          timeout=timeout)
    lines = proc.stdout.strip().splitlines()
    result = None
    if lines:
        try:
            result = json.loads(lines[-1])
        except json.JSONDecodeError:
            result = None
    return proc.returncode, result, proc.stderr
