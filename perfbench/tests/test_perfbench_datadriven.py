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


def test_every_cell_loads_and_names_an_entry_that_exists():
    from perfbench import entries, spec

    bench = spec.load()
    for w in bench["workloads"]:
        cell = spec.cell(bench, w["name"])
        module = entries.load(cell.traffic)
        assert hasattr(module, "Entry") and hasattr(module, "configure_environment")
        assert cell.end_to_end and cell.per_layer, w["name"]
    # A traffic file that names no entry takes the proposal entry.
    traffic = spec.cell(bench, "n1008-viewchange").traffic
    assert "entry" not in traffic
    assert entries.load(traffic).__name__ == "perfbench.entries.proposal"


def test_a_cell_and_an_entry_are_added_as_new_files(tmp_path):
    """A cell of an existing entry loads from a traffic file added beside
    the others, whether it names its entry or not; a new entry is found by
    its file's name."""
    import subprocess
    import sys

    from perfbench import entries, spec

    viewchange = json.loads((REPO / "perfbench/traffic/viewchange.json").read_text())
    where = copy_benchmark(
        tmp_path,
        traffic=[("viewchange-named", {**viewchange, "entry": "proposal"}),
                 ("viewchange-deep", {**viewchange, "in_flight": 4})],
        workloads=[{"name": "n1008-named", "config": "committee-1008",
                    "traffic": "viewchange-named", "chips": 1, "why": "test"},
                   {"name": "n1008-deep", "config": "committee-1008",
                    "traffic": "viewchange-deep", "chips": 1, "why": "test"}],
    )
    bench = spec.load(where)
    for name in ("n1008-named", "n1008-deep"):
        cell = spec.cell(bench, name, where)
        assert cell.config["validators"] == 1008
        assert entries.load(cell.traffic).__name__ == "perfbench.entries.proposal"
        assert [m["name"] for m in cell.end_to_end] == [m["name"] for m in bench["end_to_end"]]
        assert [m["name"] for m in cell.per_layer] == [m["name"] for m in bench["per_layer"]]
    assert spec.cell(bench, "n1008-deep", where).traffic["in_flight"] == 4
    (where / "perfbench" / "entries" / "echo.py").write_text('"""A new entry."""\n')
    code = ("from perfbench import entries\n"
            "m = entries.load({'entry': 'echo'})\n"
            "assert m.__doc__ == 'A new entry.', m\n")
    subprocess.run([sys.executable, "-c", code], cwd=where, check=True, timeout=120)
