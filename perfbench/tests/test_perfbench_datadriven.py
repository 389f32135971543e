"""The harness is driven by data: a new configuration, a new traffic mix
and a new per-layer metric are files and entries only, and a tiny cell made
of them lists and runs on the host through the kernels' plain versions."""

import json

from conftest import REPO, copy_benchmark, run_cell

NEW_METRIC = '''"""Proposals the window judged, as a count."""


def read(run):
    return float(len(run.records))
'''


def test_added_files_make_a_cell_that_runs(tmp_path):
    before = {p: p.read_bytes() for p in (REPO / "perfbench").rglob("*") if p.is_file()}
    where = copy_benchmark(
        tmp_path,
        configs=[({"name": "mini-4", "source": "https://arxiv.org/abs/1803.05069",
                   "file": "perfbench/configs/mini-4.json", "reduced": [], "why": "test"},
                  {"name": "mini-4", "validators": 4, "faults": 1, "stake": 1, "quorum": 3,
                   "payload_digests": 1, "reduced": [], "guarantees": []})],
        traffic=[("mini", {"certificates": ["qc"], "in_flight": 1, "backend": "cuda",
                           "workers": 1, "forged_per_64": 1, "short_per_64": 1,
                           "pool": 2, "forged_pool": 1, "short_pool": 1,
                           "plan_sigs_per_s": 30})],
        workloads=[{"name": "mini", "config": "mini-4", "traffic": "mini", "chips": 1,
                    "why": "test"}],
        metrics=[({"name": "proposals_seen", "unit": "proposals", "better": "higher",
                   "source": "host_clock", "layer": "harness", "moves": "rounds_per_s",
                   "workloads": ["mini"]}, NEW_METRIC)],
    )
    names = [w["name"] for w in json.loads((where / "BENCHMARK.json").read_text())["workloads"]]
    assert "mini" in names
    rc, result, err = run_cell(where, "mini", 4_100_000_001, 2, trace=1, extra=["--device", "cpu"])
    assert rc == 0, err[-3000:]
    assert result["correct"] is True, err[-3000:]
    assert result["metrics"]["proposals_seen"]["value"] >= 1
    assert result["metrics"]["sigs_per_dispatch"]["value"] == 3.0
    assert list(result)[-1] == "checks"
    after = {p: p.read_bytes() for p in (REPO / "perfbench").rglob("*") if p.is_file()}
    assert {p: b for p, b in after.items() if p in before} == before


def test_refuses_without_a_card_and_without_the_program(tmp_path):
    where = copy_benchmark(tmp_path)
    rc, result, err = run_cell(where, "n1008-viewchange", 5, 1, program=False)
    assert rc != 0 and result is None
    rc, result, err = run_cell(where, "n1008-viewchange", 5, 1, program=True)
    assert rc != 0 and result is None
