"""The port's device benchmarks (``hotstuff_tpu_torch/benchmark/
{digest_bench,superbatch_bench}.py``) on the CPU, and every harness
script's default on a host without a card.

- ``superbatch_bench --qcs 2 --qc-size 4 --threads 1`` under ``cpu``: the
  same QC batches from the same seeds as the reference's, and the same
  header and fusion counts (one thread, so the fusion does not hang on
  timing).
- ``digest_bench --platform cpu --sizes 512 --drains 8``: the kernel's plain
  version matches ``hashlib`` (the script asserts it), one line with
  ``backend=cpu``, the recommendation, and ``digest-bench-cpu.txt``.
- Without a card, each script's default run (``committee_scale``,
  ``digest_bench``, ``superbatch_bench``, ``run_local``) exits non-zero,
  names CUDA and prints no result line: none falls back to the CPU.
- On a card (``cuda`` marker, skipped here): ``digest_bench.bench`` launches
  the SHA-512 kernel once a call, and ``run_crypto_rounds`` under ``cuda``
  launches decompress, K2, K3 and the verdict, never K4.

Tolerance: exact equality. Ports: none bound (``run_local`` raises before
it starts a process).
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import benchmark.superbatch_bench as j_superbatch
import hotstuff_tpu.crypto as j_crypto
import hotstuff_tpu_torch.crypto as t_crypto
from hotstuff_tpu_torch.benchmark import committee_scale, digest_bench
from hotstuff_tpu_torch.benchmark import superbatch_bench as t_superbatch
from hotstuff_tpu_torch.consensus import cert_arena
from hotstuff_tpu_torch.ops import msm_kernels as mk
from hotstuff_tpu_torch.ops import sha512 as sha

REPO = Path(__file__).resolve().parents[1]
FUSION = re.compile(r"fusion: (\d+) requests in (\d+) inner calls")


@pytest.fixture
def cpu_backends(monkeypatch):
    monkeypatch.setenv("HOTSTUFF_CRYPTO_BACKEND", "cpu")
    for crypto in (t_crypto, j_crypto):
        monkeypatch.setattr(crypto, "_BACKEND", None)
    yield


def test_superbatch_bench_reports_the_references_fusion_counts(cpu_backends, monkeypatch,
                                                               tmp_path):
    assert t_superbatch.make_qc_batches(2, 4, seed=8) == j_superbatch.make_qc_batches(2, 4, seed=8)
    argv = ["--qcs", "2", "--qc-size", "4", "--threads", "1"]
    ours = t_superbatch.main(argv + ["--output", str(tmp_path / "port")])
    monkeypatch.setattr(sys, "argv", ["superbatch_bench", *argv,
                                      "--output", str(tmp_path / "reference")])
    j_superbatch.main()
    files = [(tmp_path / label / "superbatch-bench-cpu.txt").read_text().splitlines()
             for label in ("port", "reference")]
    assert files[0] == ours
    assert files[0][0] == files[1][0] == "qc_size=4 qcs=2 threads=1 inner=cpu"
    counts = [[m.groups() for m in map(FUSION.search, lines) if m] for lines in files]
    assert counts[0] == counts[1] == [("35", "35")]
    labels = [[line.split(":")[0] for line in lines[1:]] for lines in files]
    assert labels[0] == labels[1] == ["lone-QC plain", "lone-QC superbatch", "contended plain",
                                      "contended superbatch"]


def test_digest_bench_on_the_cpu_matches_hashlib(tmp_path, capsys):
    digest_bench.main(["--platform", "cpu", "--sizes", "512", "--drains", "8",
                       "--output", str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 and lines[0].startswith("digest k=8 size=512B backend=cpu: host ")
    assert lines[1].startswith("RECOMMEND device_batch_digests=")
    assert lines[1].endswith("[1/1 device wins]") or lines[1].endswith("[0/1 device wins]")
    assert (tmp_path / "digest-bench-cpu.txt").read_text() == "\n".join(lines) + "\n"
    host_s, dev_s = digest_bench.bench(3, 300, iters=1, device="cpu")
    assert host_s > 0 and dev_s > 0


DEFAULT_RUNS = {
    "committee_scale": (["--mode", "crypto", "--nodes", "4", "--rounds", "1"], "committee="),
    "digest_bench": (["--sizes", "512", "--drains", "8"], "digest k="),
    "superbatch_bench": (["--qcs", "1", "--qc-size", "1", "--threads", "1"], "lone-QC"),
    "run_local": (["--nodes", "4", "--duration", "1", "--base-port", "24520",
                   "--work-dir", "{tmp}/bench"], "SUMMARY"),
}


@pytest.mark.parametrize("script", sorted(DEFAULT_RUNS))
def test_each_script_default_exits_nonzero_without_a_card(tmp_path, script):
    args, result = DEFAULT_RUNS[script]
    env = {k: v for k, v in os.environ.items() if not k.startswith("HOTSTUFF_")}
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, also on a GPU host
    out = subprocess.run(
        [sys.executable, "-m", f"hotstuff_tpu_torch.benchmark.{script}",
         *(a.format(tmp=tmp_path) for a in args)],
        capture_output=True, text=True, timeout=120, cwd=REPO, env=env)
    assert out.returncode != 0
    assert "CUDA" in out.stderr, out.stderr[-2000:]
    assert result not in out.stdout
    assert not (tmp_path / "bench").exists()


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(t_crypto, "_BACKEND", None)
    monkeypatch.setenv("HOTSTUFF_CERT_ARENA", "0")
    cert_arena.reset()
    yield
    cert_arena.reset()


@pytest.mark.cuda
def test_digest_bench_launches_the_kernel_once_a_call(card):
    before = sha.LAUNCHES["sha512"]
    digest_bench.bench(8, 15_000, iters=2)
    assert sha.LAUNCHES["sha512"] - before == 4


@pytest.mark.cuda
def test_run_crypto_rounds_runs_the_cached_kernels_on_the_card(card):
    t_crypto.set_backend("cuda")
    mk.reset_launches()
    committee_scale.run_crypto_rounds(16, 2, True)
    verifies = 3 * 2  # the warm-up and two rounds, a QC and a TC each
    got = dict(mk.LAUNCHES)
    assert got["msm_partials_signed"] == got["msm_combine"] == 2 * verifies
    assert got["verdict"] == verifies and got["decompress"] >= verifies
    assert got["msm_partials"] == 0
