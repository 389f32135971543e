"""The comparison that decides ``correct`` fails what it must: the control
(the reference's rules with the signature check left out) and each fault a
cell can have, planted under the timed path. On the host through the
kernels' plain versions at a tiny size; the cell-size control runs on the
card (``cuda``)."""

import pytest

from conftest import REPO, TINY_TRAFFIC, copy_benchmark, run_cell, tiny_copy


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    # "tiny-parts": the tiny cell with its run spread over two processes.
    return tiny_copy(tmp_path_factory.mktemp("tiny"),
                     traffic=[("tiny-parts", {**TINY_TRAFFIC, "processes": 2})],
                     workloads=[{"name": "tiny-parts", "config": "tiny-4",
                                 "traffic": "tiny-parts", "chips": 1, "why": "tests"}])


def test_sound_run_is_correct(tiny):
    rc, result, err = run_cell(tiny, "tiny", 4_200_000_001, 4, extra=["--device", "cpu"])
    assert rc == 0, err[-3000:]
    assert result["correct"] is True, err[-3000:]
    assert result["attempted"] >= 1


def test_a_run_in_two_processes_reads_both_windows(tiny):
    rc, result, err = run_cell(tiny, "tiny-parts", 4_200_000_002, 8, extra=["--device", "cpu"])
    assert rc == 0, err[-3000:]
    assert "2 processes: windows" in err
    assert err.count("check verdicts_wrong") == 3  # each process's, then the run's
    assert result["correct"] is True, err[-3000:]
    assert result["attempted"] >= 2
    assert set(result["metrics"]) == {"rounds_per_s", "round_p50_ms", "round_p95_ms", "setup_s"}
    assert list(result)[-1] == "checks" and "part" not in result


@pytest.mark.parametrize("extra", [
    ["--control", "quorum-only"],
    ["--fault", "half-batch"],
    ["--fault", "altered-verdict"],
    ["--fault", "unchanged"],
    ["--fault", "altered-decode"],
    ["--fault", "unavailable"],
])
def test_control_and_faults_come_out_not_correct(tiny, extra):
    rc, result, err = run_cell(tiny, "tiny", 4_200_000_003, 6, extra=["--device", "cpu", *extra])
    assert rc == 0, err[-3000:]
    assert result["correct"] is False, err[-3000:]
    assert result["failed"] >= 1


@pytest.mark.parametrize("extra", [
    ["--control", "quorum-only"],
    ["--fault", "altered-verdict"],
    ["--fault", "unchanged"],
])
def test_control_and_faults_fail_a_run_in_two_processes(tiny, extra):
    rc, result, err = run_cell(tiny, "tiny-parts", 4_200_000_004, 8,
                               extra=["--device", "cpu", *extra])
    assert rc == 0, err[-3000:]
    assert result["correct"] is False, err[-3000:]
    assert result["failed"] >= 1


@pytest.mark.cuda
def test_control_fails_at_the_cells_own_size(cuda, tmp_path):
    where = copy_benchmark(tmp_path)
    for seed in (3_000_000_001, 3_000_000_002, 3_000_000_003):
        rc, result, err = run_cell(where, "n1008-viewchange", seed, 10,
                                   extra=["--control", "quorum-only"])
        assert rc == 0, err[-3000:]
        assert result["correct"] is False
        assert result["checks"]["verdicts_wrong"]["value"] >= 1
