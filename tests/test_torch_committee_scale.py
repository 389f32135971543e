"""The port's ``committee_scale`` (``hotstuff_tpu_torch/benchmark/
committee_scale.py``) against the reference's ``benchmark/committee_scale.py``,
each package's ``main`` run in this process on the same command line under
the ``cpu`` backend.

- ``--mode crypto --nodes 16``, with and without ``--tc-heavy``: the same
  line up to its timing, and the same result-file name holding it.
- ``--mode protocol --nodes 4 --rounds 3 --profile``: both commit and
  print a stage table with the same stages.
- ``--faults chaos:<seed> --nodes 4 --replay`` at a 4 s fault duration: the
  two packages' replay traces are byte-identical, and each replay matched
  its first run.
- The flag errors (``--pyprof`` with ``--mode crypto``, ``--groups`` with
  ``--profile``, ``--watch`` without ``--telemetry``) exit 2 in both.

Tolerance: exact equality of the compared parts. Ports 24410-24479.
"""

from __future__ import annotations

import json
import sys

import pytest

import benchmark.committee_scale as j_scale
import hotstuff_tpu.crypto as j_crypto
import hotstuff_tpu.telemetry as j_telemetry
import hotstuff_tpu_torch.crypto as t_crypto
from hotstuff_tpu.consensus import cert_arena as j_arena
from hotstuff_tpu_torch import telemetry as t_telemetry
from hotstuff_tpu_torch.benchmark import committee_scale as t_scale
from hotstuff_tpu_torch.consensus import cert_arena as t_arena

BASE = 24410
PACKAGES = {"port": (t_scale, t_crypto), "reference": (j_scale, j_crypto)}


@pytest.fixture(autouse=True)
def isolated(monkeypatch):
    monkeypatch.setenv("HOTSTUFF_CRYPTO_BACKEND", "cpu")
    monkeypatch.setenv("HOTSTUFF_CRYPTO_WORKERS", "32")
    monkeypatch.delenv("HOTSTUFF_NET", raising=False)
    monkeypatch.delenv("HOTSTUFF_ENGINE_GROUPS", raising=False)
    for crypto in (t_crypto, j_crypto):
        monkeypatch.setattr(crypto, "_BACKEND", None)
    for arena in (t_arena, j_arena):
        arena.reset()
    yield
    for arena in (t_arena, j_arena):
        arena.reset()
    t_telemetry.reset_for_tests()
    j_telemetry.reset_for_tests()


def run_main(label, argv, monkeypatch, capsys) -> tuple[int, list[str]]:
    """One package's ``main`` on ``argv``: (its exit code, its stdout lines)."""
    module = PACKAGES[label][0]
    monkeypatch.setattr(sys, "argv", ["committee_scale", *argv])
    capsys.readouterr()
    try:
        module.main()
        code = 0
    except SystemExit as e:
        code = e.code
    return code, capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("tc_heavy", [False, True], ids=["qc", "tc-heavy"])
def test_crypto_mode_prints_the_references_line(tmp_path, monkeypatch, capsys, tc_heavy):
    out = {}
    for label in PACKAGES:
        directory = tmp_path / label
        argv = ["--mode", "crypto", "--nodes", "16", "--rounds", "3", "--output", str(directory)]
        code, lines = run_main(label, argv + (["--tc-heavy"] if tc_heavy else []),
                               monkeypatch, capsys)
        assert code == 0 and len(lines) == 1, (label, lines)
        fixed, timing = lines[0].split(": ")
        assert timing.endswith(" rounds/s)") and " ms/round (" in timing
        files = sorted(p.name for p in directory.iterdir())
        assert (directory / files[0]).read_text() == lines[0] + "\n"
        out[label] = (fixed, files)
    assert out["port"] == out["reference"]
    tag = "crypto-tc" if tc_heavy else "crypto"
    assert out["port"] == (
        f"committee=16 (f=5, QC size 11) mode=crypto{' tc-heavy' if tc_heavy else ''} "
        "backend=cpu transport=asyncio", [f"committee-{tag}-cpu-16.txt"])


def stage_table(lines: list[str]) -> list[str]:
    at = next(i for i, line in enumerate(lines) if line.startswith("per-stage handler cost"))
    assert lines[at + 1].split() == ["stage", "calls/round", "us/round"]
    rows = [line.split() for line in lines[at + 2:] if line.startswith("  ")]
    assert rows and all(float(calls) > 0 for _, calls, _ in rows)
    return sorted(stage for stage, _, _ in rows)


def test_protocol_mode_commits_and_profiles_the_same_stages(tmp_path, monkeypatch, capsys):
    out = {}
    for i, label in enumerate(PACKAGES):
        argv = ["--nodes", "4", "--rounds", "3", "--profile", "--base-port", str(BASE + 10 * i),
                "--output", str(tmp_path / label)]
        code, lines = run_main(label, argv, monkeypatch, capsys)
        assert code == 0, (label, lines)
        fixed = lines[0].split(": ")[0]
        assert (tmp_path / label / "committee-protocol-cpu-4.txt").read_text() == "".join(
            line + "\n" for line in lines)
        out[label] = (fixed, stage_table(lines))
    assert out["port"] == out["reference"]
    assert out["port"][0] == "committee=4 (f=1, QC size 3) mode=protocol backend=cpu transport=asyncio"
    assert "propose" in out["port"][1]


def test_chaos_replay_traces_are_byte_identical_across_packages(tmp_path, monkeypatch, capsys):
    traces = {}
    for i, label in enumerate(PACKAGES):
        # Each run binds its base and, for the replay, base + 20: the last
        # replay ends at BASE + 63, inside this file's range.
        argv = ["--nodes", "4", "--faults", "chaos:3", "--faults-duration", "4", "--replay",
                "--base-port", str(BASE + 20 + 20 * i), "--output", str(tmp_path / label)]
        code, lines = run_main(label, argv, monkeypatch, capsys)
        assert code == 0, (label, lines)
        assert lines[0].startswith("faultline scenario=chaos-3 seed=3 nodes=4: safety=ok "
                                   "liveness=recovered ")
        report = json.loads((tmp_path / label / "chaos-chaos-3-4.json").read_text())
        assert report["replay_trace_match"] is True
        traces[label] = json.dumps(report["trace"], sort_keys=True)
    assert traces["port"] == traces["reference"]


FLAG_ERRORS = {
    "pyprof-crypto": (["--mode", "crypto", "--pyprof"], "--pyprof requires --mode protocol"),
    "groups-profile": (["--groups", "2", "--profile"], "--groups is incompatible with"),
    "watch-no-telemetry": (["--watch"], "--watch requires --mode protocol with --telemetry"),
}


@pytest.mark.parametrize("case", sorted(FLAG_ERRORS))
def test_flag_errors_exit_2_in_both(monkeypatch, capsys, case):
    argv, message = FLAG_ERRORS[case]
    for label in PACKAGES:
        monkeypatch.setattr(sys, "argv", ["committee_scale", *argv])
        with pytest.raises(SystemExit) as info:
            PACKAGES[label][0].main()
        assert info.value.code == 2, label
        assert message in capsys.readouterr().err, label
