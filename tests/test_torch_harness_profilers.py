"""The port's profilers and aggregation (``hotstuff_tpu_torch/benchmark/
{profile_device,sample_profile,profile_protocol,diag_protocol,
netplane_frames,aggregate,utils}.py``) against the reference's
``benchmark/`` scripts, under ``cpu``.

- ``profile_device``: the reference's stage names in its order (read from
  its source: importing it enables JAX's compile cache); the packed batch
  byte for byte the reference's, its unpacking limb for limb the
  reference's; on the CPU at one and two signatures each stage's function
  (the kernels' plain versions, as ``device="cpu"`` asks): the ``msm`` stage
  and K3 over K4 equal the plain curve MSM and the RFC 8032 oracle, the
  pipeline accepts the batch and rejects a tampered one; ``main`` once end to
  end. No JAX verify graph is built.
- ``sample_profile``, ``diag_protocol``, ``profile_protocol`` and
  ``netplane_frames``: each port script and the reference's, run together
  on the same arguments (one engine for the committees, so no boot race), print
  the same lines up to their measured figures; ``netplane_frames``' rows
  carry the same keys and counts.
- ``aggregate`` and ``utils.PathMaker``: the same series and ``agg-*`` files
  from the repository's ``results/`` and from fixture result files.

Tolerance: exact. Ports: 25000-25003 (the committees), 24944-24951,
25044-25051, 25144-25151 (the two ``profile_protocol`` runs), 24991-24999
(the ``netplane_frames`` rows).
"""

from __future__ import annotations

import ast
import contextlib
import io
import os
import random
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import benchmark.aggregate as j_aggregate
import benchmark.utils as j_utils
from hotstuff_tpu_torch.benchmark import aggregate, profile_device, utils
from hotstuff_tpu_torch.crypto import ed25519_ref as oracle
from hotstuff_tpu_torch.ops import curve as cv
from hotstuff_tpu_torch.ops import verify as ov

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS = os.path.join(REPO, "results")
NUMBER = re.compile(r"-?\d[\d,]*(?:\.\d+)?")


def reference_stage_names() -> list[str]:
    """The string keys of the stage dicts in the reference's ``main``, in
    source order."""
    with open(os.path.join(REPO, "benchmark", "profile_device.py")) as f:
        tree = ast.parse(f.read())
    (main,) = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main"]
    keys = [k for node in ast.walk(main) if isinstance(node, ast.Dict)
            and all(isinstance(k, ast.Constant) for k in node.keys) for k in node.keys]
    return [k.value for k in sorted(keys, key=lambda k: (k.lineno, k.col_offset))]


def test_profile_device_stages_are_the_references():
    assert list(profile_device.STAGES) == reference_stage_names()


def packed_batch(n_sigs: int) -> tuple[np.ndarray, int]:
    import bench_torch

    msgs, pubs, sigs = bench_torch.make_batch(n_sigs)
    return ov.prepare_batch(msgs, pubs, sigs, _rng=random.Random(7))


@pytest.mark.parametrize("n_sigs", [1, 2])
def test_profile_device_batch_and_unpacking_equal_the_references(n_sigs):
    import bench
    from hotstuff_tpu.ops import verify as j_verify

    packed, m = packed_batch(n_sigs)
    j_packed, j_m = j_verify.prepare_batch(*bench.make_batch(n_sigs), _rng=random.Random(7))
    assert m == j_m and packed.tobytes() == np.asarray(j_packed).tobytes()
    ours = ov._unpack_device(torch.from_numpy(packed))
    theirs = j_verify._unpack_device(j_packed)
    for a, b in zip(ours, theirs):
        assert np.array_equal(a.numpy(), np.asarray(b))


def oracle_msm(packed: np.ndarray):
    """The batch's MSM by the RFC 8032 oracle: sum of scalar * point over the
    lanes, as an affine encoding."""
    acc = oracle.IDENTITY
    for row in packed:
        enc = bytearray(row[:32].tobytes())
        enc[31] |= int(row[64]) << 7
        point = oracle.point_decompress(bytes(enc))
        acc = oracle.point_add(acc, oracle.point_mul(int.from_bytes(row[32:64].tobytes(), "little"),
                                                     point))
    return oracle.point_compress(acc)


def test_profile_device_stages_on_the_cpu():
    packed, m = packed_batch(2)
    calls = profile_device.stage_calls(torch.from_numpy(packed))
    assert list(calls) == list(profile_device.STAGES)
    out = {name: fn(*args) for name, (fn, args) in calls.items()}
    pts, digits = calls["kernelA_partials"][1]
    plain = cv.to_affine_bytes(out["msm"])  # on the CPU: curve.msm itself
    assert cv.to_affine_bytes(out["kernelB_combine"]) == plain == oracle_msm(packed)
    ok, points = out["decompress(all)"]
    assert bool(ok.all()) and torch.equal(points, pts)
    assert bool(out["full_pipeline"]) and bool(out["cofactor_check"])
    tampered = packed.copy()
    tampered[0, 40] ^= 1  # an RLC scalar byte: the sum no longer cancels
    assert not bool(ov.run_uncached(torch.from_numpy(tampered)))


def test_profile_device_main_end_to_end_on_the_cpu(monkeypatch):
    monkeypatch.setattr(profile_device, "WARMUP", 0)
    monkeypatch.setattr(profile_device, "ROUNDS", 1)
    monkeypatch.setattr(profile_device, "ITERS", 1)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        results = profile_device.main(["1"], device="cpu")
    lines = out.getvalue().splitlines()
    assert lines[0] == "n_sigs=1 lanes=4"
    row = re.compile(r"(.{18}) +[\d.]+ ms/batch +[\d.]+ us/sig")
    assert [row.fullmatch(line)[1].strip() for line in lines[1:-1]] == list(profile_device.STAGES)
    assert lines[-1].startswith("(cuda K4 block=4 grid=(1, 32) x 4 threads; K3 grid=(64, 1)")
    assert list(results) == list(profile_device.STAGES)
    assert all(r["s"] > 0 and r["launches"] == {} for r in results.values())


#: each script's arguments, then the port's and the reference's base ports.
PAIR_RUNS = {
    "sample_profile": (["--nodes", "1", "--rounds", "200", "--by-stage", "--top", "5"],
                       25000, 25001),
    "diag_protocol": (["--nodes", "1", "--seconds", "5"], 25002, 25003),
    "profile_protocol": (["--seconds", "2", "--top", "5"], 24944, 24948),
    "netplane_frames": (["--sizes", "1024,65536", "--frames", "20", "--window", "8"],
                        24990, 24995),
}


@pytest.fixture(scope="module")
def pair_runs(tmp_path_factory):
    """Each script of ``PAIR_RUNS`` from both packages, all started together
    under ``cpu``: {script: (the port's output, the reference's)}.
    ``netplane_frames`` also writes its rows to ``<tmp>/<package>.json``."""
    tmp = tmp_path_factory.mktemp("profilers")
    env = {k: v for k, v in os.environ.items() if not k.startswith("HOTSTUFF_")}
    env["HOTSTUFF_CRYPTO_BACKEND"] = "cpu"
    procs = {}
    for script, (args, ours, theirs) in PAIR_RUNS.items():
        for package, module, port in (("ours", f"hotstuff_tpu_torch.benchmark.{script}", ours),
                                      ("theirs", f"benchmark.{script}", theirs)):
            extra = ["--json", str(tmp / f"{package}.json")] if script == "netplane_frames" else []
            procs[script, package] = subprocess.Popen(
                [sys.executable, "-m", module, *args, "--base-port", str(port), *extra],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO, env=env)
    out = {}
    for (script, package), proc in procs.items():
        stdout, stderr = proc.communicate(timeout=180)
        assert proc.returncode == 0, (script, package, stderr[-2000:])
        out.setdefault(script, {})[package] = stdout
    return {script: (v["ours"], v["theirs"]) for script, v in out.items()}, tmp


def shape(text: str, keep=lambda line: True) -> list[str]:
    """The lines of ``text`` that ``keep`` takes, with every number blanked
    and runs of spaces (a number's padding) made one."""
    return [" ".join(NUMBER.sub("#", line).split()) for line in text.splitlines() if keep(line)]


FUNCTION_ROW = re.compile(r" *\d+\.\d\d +\d+\.\d\d  .*")


def test_sample_profile_prints_the_references_tables(pair_runs):
    ours, theirs = pair_runs[0]["sample_profile"]
    for text in (ours, theirs):
        lines = text.splitlines()
        head = [line for line in lines if line.startswith("committee=1 protocol: ")]
        assert len(head) == 1 and "samples by round-trace stage:" in lines
        assert lines.count(" SELF%   CUM%  function") == 1
        assert 0 < sum(bool(FUNCTION_ROW.fullmatch(line)) for line in lines) <= 5
    keep = lambda line: not line.startswith("  ") and not FUNCTION_ROW.fullmatch(line)  # noqa: E731
    assert shape(ours, keep) == shape(theirs, keep)


def test_diag_protocol_prints_the_references_progress(pair_runs):
    ours, theirs = pair_runs[0]["diag_protocol"]
    assert shape(ours) == shape(theirs)
    lines = ours.splitlines()
    assert len(lines) == 2 and lines[0].startswith("spawned 1 engines in ")
    assert lines[1].startswith("t=") and int(lines[1].split("commits min/max=")[1].split("/")[0]) > 0


def test_profile_protocol_prints_the_references_table(pair_runs):
    for text in pair_runs[0]["profile_protocol"]:
        assert re.search(r"\d+ function calls .* in [\d.]+ seconds", text)
        assert "   Ordered by: cumulative time" in text
        assert re.search(r"ncalls +tottime +percall +cumtime +percall filename:lineno\(function\)",
                         text)


def test_netplane_frames_rows_are_the_references(pair_runs):
    import json

    (ours, theirs), tmp = pair_runs[0]["netplane_frames"], pair_runs[1]
    rows = [json.loads((tmp / f"{p}.json").read_text())["rows"] for p in ("ours", "theirs")]
    for ours_row, theirs_row in zip(*rows):
        assert set(ours_row) == set(theirs_row)
        assert set(ours_row.get("native_delta", {})) == set(theirs_row.get("native_delta", {}))
        for key in ("transport", "size", "frames", "window", "received"):
            assert ours_row[key] == theirs_row[key]
    assert [(r["transport"], r["size"], r["received"]) for r in rows[0]] == [
        ("asyncio", 1024, 20), ("native", 1024, 20), ("asyncio", 65536, 20), ("native", 65536, 20)]
    assert shape(ours)[:-1] == shape(theirs)[:-1]
    assert ours.splitlines()[-1] == f"wrote {tmp / 'ours.json'}"


def summary_block(faults: int, nodes: int, rate: int, size: int, tps: int, latency: int) -> str:
    return ("-----------------------------------------\n SUMMARY:\n"
            "-----------------------------------------\n + CONFIG:\n"
            f" Faults: {faults} node(s)\n Committee size: {nodes} node(s)\n"
            f" Input rate: {rate:,} tx/s\n Transaction size: {size:,} B\n"
            " Execution time: 20 s\n\n + RESULTS:\n"
            f" End-to-end TPS: {tps:,} tx/s\n End-to-end latency: {latency:,} ms\n")


def aggregates(module, results_dir: str, out_dir: str) -> dict:
    agg = module.LogAggregator(results_dir)
    setups = {(s.faults, s.nodes, s.rate, s.tx_size): (m.tps, m.latency)
              for s, m in agg.data.items()}
    families = sorted({(s.faults, s.nodes, s.tx_size) for s in agg.data})
    files = {}
    for path in agg.print_series(out_dir):
        with open(path) as f:
            files[os.path.basename(path)] = f.read()
    return {
        "setups": setups,
        "latency_vs_rate": {f: agg.latency_vs_rate(*f) for f in families},
        "tps_vs_nodes": {(faults, size, cap): agg.tps_vs_nodes(faults, size, cap)
                         for faults, _, size in families for cap in (None, 1500.0)},
        "files": files,
    }


def test_aggregate_of_the_repositorys_results_equals_the_references(tmp_path):
    ours = aggregates(aggregate, RESULTS, str(tmp_path / "ours"))
    assert ours == aggregates(j_aggregate, RESULTS, str(tmp_path / "theirs"))
    assert ours["setups"] and ours["files"]


def test_aggregate_of_fixture_results_equals_the_references(tmp_path):
    results = tmp_path / "results"
    results.mkdir()
    runs = {(0, 4, 1000, 512): [(950, 1200), (990, 1100), (970, 1500)],
            (0, 4, 2000, 512): [(1890, 1400)],
            (1, 4, 1000, 512): [(700, 2600), (650, 2900)],
            (0, 10, 1000, 512): [(900, 1700), (920, 1650)]}
    for (faults, nodes, rate, size), figures in runs.items():
        (results / f"bench-{faults}-{nodes}-{rate}-{size}.txt").write_text("".join(
            summary_block(faults, nodes, rate, size, tps, lat) for tps, lat in figures))
    ours = aggregates(aggregate, str(results), str(tmp_path / "ours"))
    assert ours == aggregates(j_aggregate, str(results), str(tmp_path / "theirs"))
    assert ours["setups"][(0, 4, 1000, 512)] == ([950, 990, 970], [1200, 1100, 1500])
    assert sorted(ours["files"]) == ["agg-l-0-10-x-512.txt", "agg-l-0-4-x-512.txt",
                                     "agg-l-1-4-x-512.txt"]


def test_path_maker_and_printing_are_the_references(capsys):
    for name, args in (("results_path", ()), ("plots_path", ()), ("logs_path", ()),
                       ("result_file", (1, 4, 1000, 512)), ("agg_file", ("l", 0, 4, "x", 512)),
                       ("plot_file", ("latency",)), ("plot_file", ("tps", "png")),
                       ("node_log_file", (3,)), ("client_log_file", (2,))):
        assert getattr(utils.PathMaker, name)(*args) == getattr(j_utils.PathMaker, name)(*args)
    printed = []
    for module in (utils, j_utils):
        for kind in ("heading", "info", "warn", "error"):
            getattr(module.Print, kind)("a message")
        list(module.progress_bar([1, 2, 3], prefix="run "))
        printed.append(capsys.readouterr())
    assert printed[0] == printed[1]
