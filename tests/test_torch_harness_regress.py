"""The port's regression gate (``hotstuff_tpu_torch/benchmark/regress.py``)
against the reference's ``benchmark/regress.py``, under ``cpu``.

- The same protocol baseline rows and best rows from the same result files:
  the repository's own ``results/`` (the card's committed rows beside the
  reference host's) and fixture files.
- The same crypto baseline from the same figures, each package reading its
  own committed form (the reference ``BENCH_r0*.json``'s ``parsed``, the
  port ``results/bench-torch-*.json``, a bench line each).
- The same reports, artifacts and exit codes from both mains on the same
  fresh figures and baselines: GREEN, RED and ``no-baseline`` for the
  protocol and crypto checks, the ``--dataplane`` floor and the
  ``--dataplane-parity`` legs (the measurements replaced by the same
  figures in both packages).
- The port's gate once end to end at a tiny size: a one-node committee with
  telemetry on, and the CPU batch verify through ``bench_torch``.

Tolerance: exact. Ports: 24800 (the one-node committee).
"""

from __future__ import annotations

import json
import os
import sys

import pytest

import benchmark.regress as j_regress
from hotstuff_tpu_torch.benchmark import regress

from .torch_sim_cases import cpu_backends  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS = os.path.join(REPO, "results")
CARD_ROW = {"nodes": 40, "backend": "cuda+superbatch", "transport": "asyncio",
            "ms_per_round": 114.7, "source": "committee-protocol-cuda-batched-40.txt"}


@pytest.fixture(autouse=True)
def isolated(cpu_backends, monkeypatch):  # noqa: F811
    # Both mains set this default for the protocol check; keep it scoped.
    monkeypatch.setenv("HOTSTUFF_CRYPTO_WORKERS", "32")
    yield


def test_protocol_baselines_of_the_repository_equal_the_references():
    ours = regress.load_protocol_baselines(RESULTS)
    assert ours == j_regress.load_protocol_baselines(RESULTS)
    assert CARD_ROW in ours
    assert sum(r["source"] == CARD_ROW["source"] for r in ours) >= 3


@pytest.mark.parametrize("nodes,backend,transport", [
    (40, "cuda+superbatch", "asyncio"), (40, "cuda+superbatch", "native"),
    (40, "cpu", "asyncio"), (40, "cpu", "native"), (100, "cpu+superbatch", "native"),
    (1000, "cpu+superbatch", "asyncio"), (40, "cuda", "asyncio"), (7, "cpu", "asyncio")])
def test_best_protocol_baseline_equals_the_references(nodes, backend, transport):
    rows = regress.load_protocol_baselines(RESULTS)
    best = regress.best_protocol_baseline(rows, nodes, backend, transport)
    assert best == j_regress.best_protocol_baseline(rows, nodes, backend, transport)
    if backend == "cuda+superbatch" and transport == "asyncio":
        assert best == CARD_ROW
    if backend == "cuda":
        assert best is None


def write_bench_lines(root, figures: list[float | None]) -> None:
    """The same CPU batch figures in each package's committed form: the
    reference's ``BENCH_r0<i>.json`` (the bench line under ``parsed``) and the
    port's ``results/bench-torch-<i>.json`` (the bench line itself). A None
    is a line without the figure."""
    os.makedirs(root / "results", exist_ok=True)
    for i, us in enumerate(figures, 1):
        line = {"metric": "ed25519_qc_batch_verify_1343sigs", "value": 9.0}
        if us is not None:
            line["cpu_batch_us"] = us
        (root / f"BENCH_r0{i}.json").write_text(json.dumps({"parsed": line}))
        (root / "results" / f"bench-torch-{i}.json").write_text(json.dumps(line) + "\n")


def test_crypto_baseline_of_the_repository_is_the_cards_bench_line():
    with open(os.path.join(RESULTS, "bench-torch-1343-h100.json")) as f:
        line = json.load(f)
    assert line["card"].startswith("NVIDIA H100") and line["engine"] == "native-rlc"
    assert regress.load_crypto_baseline(REPO) == {
        "cpu_batch_us": line["cpu_batch_us"], "source": "bench-torch-1343-h100.json"}


@pytest.mark.parametrize("figures", [[30.5, 21.9, None, 25.0], [None], [], [12.0]])
def test_crypto_baseline_equals_the_references_on_the_same_figures(tmp_path, figures):
    write_bench_lines(tmp_path, figures)
    ours, theirs = regress.load_crypto_baseline(str(tmp_path)), j_regress.load_crypto_baseline(
        str(tmp_path))
    assert (ours is None) == (theirs is None)
    if ours is not None:
        assert ours["cpu_batch_us"] == theirs["cpu_batch_us"] == min(
            f for f in figures if f is not None)
        assert ours["source"] == theirs["source"].replace("BENCH_r0", "bench-torch-")


def run_main(module, argv: list[str], monkeypatch) -> tuple[dict, int, list[str], dict]:
    """One package's ``main`` on ``argv``: (the printed report less its host
    and time, the exit code, the lines after the report, the artifact)."""
    import contextlib
    import io

    out = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out):
        try:
            if module is regress:
                module.main(argv)
            else:
                monkeypatch.setattr(sys, "argv", ["regress.py", *argv])
                module.main()
        except SystemExit as e:
            code = e.code
    text = out.getvalue()
    end = text.index("\n}\n") + 3
    report = json.loads(text[:end])
    tail = text[end:].splitlines()
    artifact = {}
    if "--output" in argv:
        with open(os.path.join(argv[argv.index("--output") + 1], "regress-gate.json")) as f:
            artifact = json.load(f)
        assert artifact == report
    for r in (report, artifact):
        r.pop("host", None), r.pop("ts", None)
        for c in r.get("checks", []):  # each package names its own committed form
            if "baseline_source" in c:
                c["baseline_source"] = c["baseline_source"].replace("BENCH_r0", "bench-torch-")
    return report, code, [line.replace(argv[argv.index("--output") + 1], "<out>")
                          if "--output" in argv else line for line in tail], artifact


def fake_measurements(monkeypatch, module, dataplane, protocol_ms: float) -> None:
    """The same fresh figures for both packages: ``protocol_ms`` a round with
    its telemetry, 30 µs a signature, and the Conveyor legs' rows (each
    plane's by ``HOTSTUFF_NET``)."""
    monkeypatch.setattr(module, "measure_protocol", lambda nodes, rounds, repeats, base_port,
                        pyprof=False: (protocol_ms, {"consensus.rounds_advanced": rounds}))
    monkeypatch.setattr(module, "measure_crypto", lambda sigs, repeats: 30.0)
    tps = {"": 15000, "asyncio": 9000, "native": 6000}

    def run_point(rate, **kw):
        return {"rate": rate, "e2e_tps": min(rate, tps[os.environ.get("HOTSTUFF_NET", "")]),
                "e2e_latency_ms": 700, "shed": 0}

    monkeypatch.setattr(dataplane, "run_point", run_point)


# argv, the committed CPU batch figures, the committed sweep peak, the fresh
# protocol ms. Under ``cpu`` the best N = 40 row tagged ``asyncio`` is the
# reference host's 111.0 ms (limit 166.5 at the default tolerance); the
# crypto baselines are the figures' least (fresh 30 µs).
CASES = {
    "protocol-green": (["--skip-crypto"], [], None, 90.0),
    "protocol-red": (["--skip-crypto"], [], None, 170.0),
    "protocol-no-baseline": (["--skip-crypto", "--nodes", "7"], [], None, 90.0),
    "crypto-green": (["--skip-protocol"], [40.0, 22.0], None, 0.0),
    "crypto-red": (["--skip-protocol", "--tolerance", "0.25"], [22.0], None, 0.0),
    "crypto-no-baseline": (["--skip-protocol"], [], None, 0.0),
    "both-green": ([], [23.0], None, 100.0),
    "both-red": ([], [23.0], None, 170.0),
    "dataplane-green": (["--skip-protocol", "--skip-crypto", "--dataplane", "20000"], [],
                        19000, 0.0),
    "dataplane-red": (["--skip-protocol", "--skip-crypto", "--dataplane", "20000",
                       "--tolerance", "0.1"], [], 19000, 0.0),
    "dataplane-no-baseline": (["--skip-protocol", "--skip-crypto", "--dataplane", "20000"],
                              [], None, 0.0),
    "dataplane-parity-green": (["--skip-protocol", "--skip-crypto", "--dataplane-parity",
                                "20000"], [], None, 0.0),
    "dataplane-parity-red": (["--skip-protocol", "--skip-crypto", "--dataplane-parity",
                              "20000", "--tolerance", "0.2"], [], None, 0.0),
}


def fixture_repository(root, bench_figures, sweep_peak) -> None:
    """A repository root holding the committed protocol rows, the bench
    figures in both forms and, given a peak, one Conveyor sweep."""
    write_bench_lines(root, bench_figures)
    for name in os.listdir(RESULTS):
        if name.startswith("committee-protocol-"):
            with open(os.path.join(RESULTS, name), "rb") as f:
                (root / "results" / name).write_bytes(f.read())
    if sweep_peak is not None:
        (root / "results" / "dataplane-sweep-n4-w1-512B.json").write_text(
            json.dumps({"peak": {"e2e_tps": sweep_peak}}))


@pytest.mark.parametrize("case", sorted(CASES))
def test_gate_reports_and_exit_codes_equal_the_references(tmp_path, monkeypatch, case):
    import benchmark.dataplane_sweep as j_dataplane
    from hotstuff_tpu_torch.benchmark import dataplane_sweep

    argv, bench_figures, sweep_peak, protocol_ms = CASES[case]
    fixture_repository(tmp_path, bench_figures, sweep_peak)
    results = {}
    for name, module, dataplane in (("ours", regress, dataplane_sweep),
                                    ("theirs", j_regress, j_dataplane)):
        monkeypatch.setattr(module, "REPO_ROOT", str(tmp_path))
        fake_measurements(monkeypatch, module, dataplane, protocol_ms)
        results[name] = run_main(module, [*argv, "--output", str(tmp_path / f"out-{name}")],
                                 monkeypatch)
    assert results["ours"] == results["theirs"]
    report, code, tail, _ = results["ours"]
    statuses = [c["status"] for c in report["checks"]]
    want_ok = not case.endswith("red")
    assert report["ok"] is want_ok and code == (0 if want_ok else 1)
    assert tail[-1] == f"regression gate: {'GREEN' if want_ok else 'RED'}"
    assert ("no-baseline" in statuses) == case.endswith("no-baseline")


def test_nothing_to_check_is_a_usage_error_in_both(monkeypatch, capsys):
    argv = ["--skip-protocol", "--skip-crypto"]
    with pytest.raises(SystemExit) as ours:
        regress.main(argv)
    monkeypatch.setattr(sys, "argv", ["regress.py", *argv])
    with pytest.raises(SystemExit) as theirs:
        j_regress.main()
    assert ours.value.code == theirs.value.code == 2
    assert capsys.readouterr().err == "nothing to check\nnothing to check\n"


def test_the_gate_runs_end_to_end_at_a_tiny_size(tmp_path):
    """The port's gate as a user runs it, on a one-node committee (no boot
    race between engines) and the CPU batch verify at 8 signatures: a
    one-node committee has no committed row, so the protocol check says
    ``no-baseline``; the crypto check compares against the card host's
    committed bench line."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            regress.main(["--nodes", "1", "--rounds", "20", "--repeats", "1", "--sigs", "8",
                          "--base-port", "24800", "--output", str(tmp_path)])
            code = 0
        except SystemExit as e:
            code = e.code
    with open(tmp_path / "regress-gate.json") as f:
        report = json.load(f)
    protocol, crypto = report["checks"]
    assert report["schema"] == "hotstuff-regress-v1"
    assert protocol["status"] == "no-baseline" and protocol["backend"] == "cpu"
    assert protocol["transport"] == "asyncio" and protocol["fresh"] > 0
    assert protocol["telemetry"]["consensus.rounds_advanced"] >= 20
    assert crypto["status"] == "compared" and crypto["baseline_source"] == "bench-torch-1343-h100.json"
    assert crypto["metric"] == "crypto_cpu_batch_us_per_sig_8sigs" and crypto["fresh"] > 0
    assert out.getvalue().splitlines()[-1] == f"regression gate: {'GREEN' if report['ok'] else 'RED'}"
    assert code == (0 if report["ok"] else 1)
