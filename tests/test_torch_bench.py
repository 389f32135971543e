"""The port's bench (``bench_torch.py``) on the CPU, through the kernels'
plain versions, at a small batch (8 signatures, one round of one batch).

- ``make_batch`` signs what ``bench.py``'s does, byte for byte.
- Both device paths accept the batch and time it; a tampered batch makes
  each raise ``BenchFailure`` (the bench then exits non-zero).
- The JSON line has ``bench.py``'s keys and metric name, plus the stamps.
- ``main()`` without a card exits non-zero, its last line the labelled
  CPU-only line, never a device figure.

The card's half is ``tests/test_torch_bench_card.py``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import bench as j_bench
import bench_torch

REPO = Path(__file__).resolve().parents[1]
N = 8
SMALL = dict(iters=1, threads=1, rounds=1, device="cpu")


def test_make_batch_is_the_references():
    assert bench_torch.make_batch(N) == j_bench.make_batch(N)
    assert bench_torch.DEFAULT_SIGS == 1343


def test_bench_paths_on_the_cpu_give_the_json_line():
    msgs, pubs, sigs = bench_torch.make_batch(N)
    cached = bench_torch.bench_device_cached(msgs, pubs, sigs, **SMALL)
    cold = bench_torch.bench_device(msgs, pubs, sigs, **SMALL)
    cpu = bench_torch.bench_cpu(msgs, pubs, sigs, iters=1)
    batch = bench_torch.bench_cpu_batch(msgs, pubs, sigs)
    assert min(cached, cold, cpu, batch) > 0
    line = bench_torch.result_line(N, cpu, batch, cached, cold, "native-rlc")
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "vs_serial", "vs_batch",
                         "cpu_serial_us", "cpu_batch_us", "device_cold_us",
                         "card", "cpu_count", "cpu_model", "engine"}
    assert line["metric"] == f"ed25519_qc_batch_verify_{N}sigs" and line["unit"] == "us/sig"
    assert line["value"] == round(cached / N * 1e6, 3)
    assert line["vs_baseline"] == round(min(cpu, batch) / cached, 3)
    assert line["engine"] == "native-rlc" and isinstance(line["cpu_model"], str)
    json.dumps(line)


@pytest.mark.parametrize("path", ["bench_device_cached", "bench_device"])
def test_a_rejected_batch_fails_the_bench(path):
    msgs, pubs, sigs = bench_torch.make_batch(4)
    msgs[2] = b"\x55" * 32
    with pytest.raises(bench_torch.BenchFailure):
        getattr(bench_torch, path)(msgs, pubs, sigs, **SMALL)


def test_host_meta_reads_the_model_or_what_the_host_shows(tmp_path):
    """The model name where the host gives one (``benchmark/hostinfo.py``
    reads the same line); where it prints ``unknown``, as the H100 host's
    kernel does, the vendor, family and model numbers."""
    named = tmp_path / "named"
    named.write_text("processor\t: 0\nvendor_id\t: GenuineIntel\nmodel name\t: Intel(R) Xeon(R)"
                     " Platinum 8480C\n\nprocessor\t: 1\nmodel name\t: other\n")
    hidden = tmp_path / "hidden"
    hidden.write_text("processor\t: 0\nvendor_id\t: GenuineIntel\ncpu family\t: 6\n"
                      "model\t\t: 207\nmodel name\t: unknown\n")
    assert bench_torch.host_meta(str(named))["cpu_model"] == "Intel(R) Xeon(R) Platinum 8480C"
    assert bench_torch.host_meta(str(hidden))["cpu_model"] == "GenuineIntel family 6 model 207"
    assert bench_torch.host_meta(str(tmp_path / "absent"))["cpu_count"] >= 1


def test_main_without_a_card_exits_nonzero_after_the_labelled_cpu_line():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}  # no card, also on a GPU host
    out = subprocess.run([sys.executable, str(REPO / "bench_torch.py"), str(N)],
                         capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert out.returncode != 0, out.stdout
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["metric"] == f"ed25519_qc_batch_verify_{N}sigs_CUDA_UNREACHABLE_cpu_only"
    assert last["fallback"] == "CUDA_UNREACHABLE" and "vs_baseline" not in last
    assert last["engine"] == "native-rlc"
    assert "no CUDA device" in out.stderr

