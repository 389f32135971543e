"""The port's harness CLI and plots (``hotstuff_tpu_torch/benchmark/fabfile.py``
and ``plot.py``) held to the reference's (``benchmark/fabfile.py``,
``benchmark/plot.py``) on the same inputs:

- every subcommand's flags reach the same task with the same values in both
  packages (tasks stubbed), and both refuse the same bad command lines;
- the README's crash-fault quick start, ``fabfile local --nodes 4 --faults 1
  --rate 600 --duration 4 --save``, run for real under the ``cpu`` backend:
  three node and three client processes, a SUMMARY with committed
  throughput that both packages' ``LogParser``s and both ``fabfile logs``
  print alike from its logs, and its result file;
- ``fabfile aggregate`` writes the reference's series files, and ``fabfile
  plot`` and ``Ploter`` the reference's PDFs, byte for byte, with
  ``SOURCE_DATE_EPOCH`` and the SVG hash salt fixed.

Every task runs in a temporary working directory, so the repository's
``results/`` and ``plots/`` are never written. Tolerance: exact equality.
Ports 24530-24541 (the local run's four nodes).
"""

from __future__ import annotations

import contextlib
import functools
import glob
import io
import os
import re
import shutil
from pathlib import Path

import matplotlib
import pytest

import benchmark.fabfile as j_fab
import benchmark.logs as j_logs
from hotstuff_tpu_torch.benchmark import fabfile as t_fab
from hotstuff_tpu_torch.benchmark import logs as t_logs
from hotstuff_tpu_torch.benchmark.local import LocalBench
from tests.test_harness import _write_results

BASE = 24530
REPO = Path(__file__).resolve().parents[1]
TASKS = ("local", "remote", "kill", "logs", "aggregate", "plot")
QUICK_START = ["local", "--nodes", "4", "--faults", "1", "--rate", "600", "--duration", "4",
               "--save"]


# -- the command line ----------------------------------------------------------


def parsed(module, argv: list[str], monkeypatch) -> tuple:
    """The task ``module.main`` calls for ``argv``, and its arguments."""
    calls = []
    for task in TASKS:
        monkeypatch.setattr(module, task,
                            lambda *a, task=task, **kw: calls.append((task, a, kw)))
    if module is j_fab:
        monkeypatch.setattr("sys.argv", ["fabfile.py", *argv])
        module.main()
    else:
        module.main(argv)
    assert len(calls) == 1
    return calls[0]


@pytest.mark.parametrize("argv", [
    ["local"],
    ["local", "--nodes", "10", "--rate", "50000", "--tx-size", "256", "--duration", "30",
     "--faults", "3", "--timeout", "2000", "--save"],
    QUICK_START,
    ["remote", "--hosts", "10.0.0.1", "10.0.0.2"],
    ["remote", "--hosts", "h1", "--rate", "20000", "--tx-size", "128", "--duration", "90",
     "--faults", "1"],
    ["kill", "--hosts", "h1", "h2", "h3"],
    ["logs"],
    ["logs", "--dir", "some/logs", "--faults", "2"],
    ["aggregate"],
    ["plot"],
    ["plot", "--tx-size", "1024"],
], ids=lambda argv: "-".join(a.lstrip("-") for a in argv))
def test_every_subcommand_reaches_the_references_task_with_its_values(monkeypatch, argv):
    ours = parsed(t_fab, argv, monkeypatch)
    assert ours == parsed(j_fab, argv, monkeypatch)
    assert ours[0] == argv[0]


@pytest.mark.parametrize("argv", [[], ["remote"], ["kill"], ["create"], ["destroy"],
                                  ["local", "--nodes", "four"], ["local", "--batch-size", "1"]],
                         ids=lambda argv: "-".join(argv) or "none")
def test_both_refuse_the_same_command_lines(monkeypatch, capsys, argv):
    codes = []
    for module in (t_fab, j_fab):
        with pytest.raises(SystemExit) as e:
            parsed(module, argv, monkeypatch)
        codes.append(e.value.code)
    assert codes == [2, 2]


def test_fabfile_keeps_the_references_task_functions():
    for task in ("local", "remote", "create", "destroy", "kill", "logs", "aggregate", "plot"):
        ours, theirs = getattr(t_fab, task), getattr(j_fab, task)
        assert ours.__code__.co_varnames[:ours.__code__.co_argcount] == \
            theirs.__code__.co_varnames[:theirs.__code__.co_argcount], task
        assert ours.__defaults__ == theirs.__defaults__, task


# -- the README's crash-fault quick start, for real ----------------------------


@pytest.fixture(scope="module")
def quick_start(tmp_path_factory):
    """``fabfile local`` as the README gives it (4 s of its 20), in a
    temporary working directory, under ``HOTSTUFF_CRYPTO_BACKEND=cpu``."""
    work = tmp_path_factory.mktemp("fabfile-local")
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(work)
        mp.setenv("HOTSTUFF_CRYPTO_BACKEND", "cpu")
        mp.setattr(t_fab, "LocalBench",
                   functools.partial(LocalBench, base_port=BASE, work_dir=str(work / ".bench")))
        with contextlib.redirect_stdout(out):
            t_fab.main(QUICK_START)
    return work, out.getvalue()


def consensus_tps(summary: str) -> int:
    return int(re.search(r" Consensus TPS: ([\d,]+) tx/s", summary)[1].replace(",", ""))


def test_quick_start_commits_with_the_faulty_node_down(quick_start):
    work, printed = quick_start
    assert " Faults: 1 nodes" in printed and " Committee size: 4 nodes" in printed
    assert " Input rate: 600 tx/s" in printed
    assert consensus_tps(printed) > 0
    logs = sorted(os.listdir(work / ".bench" / "logs"))
    assert [n for n in logs if n.endswith(".log")] == [
        *(f"client-{i}.log" for i in range(3)), *(f"node-{i}.log" for i in range(3))]
    saved = (work / "results" / "bench-1-4-600-512.txt").read_text()
    assert " SUMMARY:" in saved and printed.endswith(saved + "\n")


def test_both_log_parsers_and_both_logs_tasks_print_the_same_summary(quick_start, monkeypatch):
    work, printed = quick_start
    logs_dir = str(work / ".bench" / "logs")
    summary = t_logs.LogParser.process(logs_dir, faults=1).result()
    assert j_logs.LogParser.process(logs_dir, faults=1).result() == summary
    assert printed.endswith(summary + "\n")
    outs = []
    for module in (t_fab, j_fab):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            if module is j_fab:
                monkeypatch.setattr("sys.argv", ["fabfile.py", "logs", "--dir", logs_dir,
                                                 "--faults", "1"])
                module.main()
            else:
                module.main(["logs", "--dir", logs_dir, "--faults", "1"])
        outs.append(out.getvalue())
    assert outs == [printed, printed]


# -- aggregate and plot, byte for byte -----------------------------------------


def results_copy(root: Path) -> Path:
    """A working directory holding a copy of the repository's result files."""
    (root / "results").mkdir(parents=True)
    for path in glob.glob(str(REPO / "results" / "bench-*.txt")):
        shutil.copy(path, root / "results")
    return root


def run_task(module, argv: list[str], cwd: Path, monkeypatch) -> str:
    monkeypatch.chdir(cwd)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        if module is j_fab:
            monkeypatch.setattr("sys.argv", ["fabfile.py", *argv])
            module.main()
        else:
            module.main(argv)
    return out.getvalue()


def files(root: Path) -> dict[str, bytes]:
    return {p.name: p.read_bytes() for p in sorted(root.iterdir())}


def test_aggregate_writes_the_references_series(tmp_path, monkeypatch):
    ours = run_task(t_fab, ["aggregate"], results_copy(tmp_path / "port"), monkeypatch)
    theirs = run_task(j_fab, ["aggregate"], results_copy(tmp_path / "reference"), monkeypatch)
    assert ours == theirs and "wrote plots/agg-l-0-4-x-512.txt" in ours
    assert files(tmp_path / "port" / "plots") == files(tmp_path / "reference" / "plots")
    assert len(files(tmp_path / "port" / "plots")) >= 2


@pytest.fixture()
def fixed_dates(monkeypatch):
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "0")
    monkeypatch.setitem(matplotlib.rcParams, "svg.hashsalt", "hotstuff")


def test_plot_writes_the_references_pdfs(tmp_path, monkeypatch, fixed_dates):
    tx_size = 512
    argv = ["plot", "--tx-size", str(tx_size)]
    ours = run_task(t_fab, argv, results_copy(tmp_path / "port"), monkeypatch)
    theirs = run_task(j_fab, argv, results_copy(tmp_path / "reference"), monkeypatch)
    assert ours == theirs == (f"wrote plots/latency-{tx_size}.pdf\n"
                              f"wrote plots/tps-{tx_size}.pdf\n")
    plots = files(tmp_path / "port" / "plots")
    assert plots == files(tmp_path / "reference" / "plots")
    assert sorted(plots) == [f"latency-{tx_size}.pdf", f"tps-{tx_size}.pdf"]
    assert all(len(data) > 1_000 and data.startswith(b"%PDF") for data in plots.values())


def test_plots_render(tmp_path, fixed_dates):
    """The twin of ``tests/test_harness.py::test_plots_render``, and the
    reference's bytes from the same result files."""
    from benchmark.plot import Ploter as JPloter
    from hotstuff_tpu_torch.benchmark.plot import Ploter

    results = _write_results(tmp_path)
    ploter = Ploter(results)
    out1 = ploter.plot_latency([0, 1], [4], 512, out=str(tmp_path / "lat.pdf"))
    out2 = ploter.plot_tps([0], 512, out=str(tmp_path / "tps.pdf"))
    assert os.path.getsize(out1) > 1_000
    assert os.path.getsize(out2) > 1_000
    theirs = JPloter(results)
    ref1 = theirs.plot_latency([0, 1], [4], 512, out=str(tmp_path / "ref-lat.pdf"))
    ref2 = theirs.plot_tps([0], 512, out=str(tmp_path / "ref-tps.pdf"))
    for ours_path, ref_path in ((out1, ref1), (out2, ref2)):
        with open(ours_path, "rb") as a, open(ref_path, "rb") as b:
            assert a.read() == b.read()
