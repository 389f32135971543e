"""The port's smoke gates (``hotstuff_tpu_torch/benchmark/{telemetry_smoke,
profile_smoke,watchtower_smoke,dtrace_smoke}.py``) against the reference's
``benchmark/`` scripts, under ``cpu``.

- Each port script once end to end as a user types it, the four together in
  processes of their own: the committees at N = 1 (one engine, so no boot
  race between engines can hold round 1 for the 30 s timeout), the lifeline
  smoke at 4 batch pairs of 50 kB. Each must exit 0, or 2 over its 1%
  budget, with no problem, and leave its streams.
- Each package's ``main`` on the same legs (its measurement replaced by the
  same scripted times, its streams the real ones of the runs above, some
  doctored to fail a check): the same summary, checks, overhead arithmetic
  and exit code.
- ``dtrace_smoke``'s attribution and record count on the same streams: the
  same lifeline report in both packages.

Tolerance: exact. Ports: 24840-24844, 24850-24854, 24860-24864 (the
committees), 24940-24943, 24960-24963, 25040-25043, 25060-25063,
25140-25143, 25160-25163 (the lifeline smoke's three legs, 100 apart from
24900).
"""

from __future__ import annotations

import contextlib
import glob
import io
import json
import os
import shutil
import subprocess
import sys

import pytest

import benchmark.dtrace_smoke as j_dtrace_smoke
import benchmark.profile_smoke as j_profile_smoke
import benchmark.telemetry_smoke as j_telemetry_smoke
import benchmark.watchtower_smoke as j_watchtower_smoke
from hotstuff_tpu_torch.benchmark import dtrace_smoke, profile_smoke, telemetry_smoke
from hotstuff_tpu_torch.benchmark import watchtower_smoke

from .torch_sim_cases import cpu_backends  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = {
    "telemetry_smoke": ["--nodes", "1", "--rounds", "100", "--repeats", "1",
                        "--base-port", "24840"],
    "profile_smoke": ["--nodes", "1", "--rounds", "100", "--repeats", "1",
                      "--base-port", "24850"],
    "watchtower_smoke": ["--nodes", "1", "--rounds", "100", "--repeats", "1",
                         "--base-port", "24860"],
    "dtrace_smoke": ["--batches", "4", "--repeats", "1", "--batch-bytes", "50000",
                     "--base-port", "24900"],
}
PAIRS = {"telemetry_smoke": (telemetry_smoke, j_telemetry_smoke),
         "profile_smoke": (profile_smoke, j_profile_smoke),
         "watchtower_smoke": (watchtower_smoke, j_watchtower_smoke),
         "dtrace_smoke": (dtrace_smoke, j_dtrace_smoke)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four port scripts, started together, each with a temporary
    directory of its own (``TMPDIR``) for its streams."""
    root = tmp_path_factory.mktemp("smokes")
    env = {k: v for k, v in os.environ.items() if not k.startswith("HOTSTUFF_")}
    env["HOTSTUFF_CRYPTO_BACKEND"] = "cpu"
    procs = {}
    for name, args in RUNS.items():
        tmp = root / name
        tmp.mkdir()
        extra = ["--work-dir", str(tmp / "work")] if name == "dtrace_smoke" else []
        procs[name] = (subprocess.Popen(
            [sys.executable, "-m", f"hotstuff_tpu_torch.benchmark.{name}", *args, *extra],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
            env={**env, "TMPDIR": str(tmp)}), tmp)
    out = {}
    for name, (proc, tmp) in procs.items():
        stdout, stderr = proc.communicate(timeout=240)
        out[name] = {"code": proc.returncode, "stdout": stdout, "stderr": stderr, "tmp": tmp}
    return out


@pytest.fixture(autouse=True)
def isolated(cpu_backends, monkeypatch):  # noqa: F811
    # Both packages' smokes set these defaults; keep them scoped.
    monkeypatch.setenv("HOTSTUFF_TELEMETRY_INTERVAL", "1")
    monkeypatch.setenv("HOTSTUFF_CRYPTO_WORKERS", "32")
    yield


def summary_of(stdout: str) -> dict:
    (line,) = [line for line in stdout.splitlines() if line.startswith('{"metric": ')]
    return json.loads(line)


def stream(runs, name: str, file: str) -> str:
    (path,) = glob.glob(str(runs[name]["tmp"] / "**" / file), recursive=True)
    return path


@pytest.mark.parametrize("name", sorted(RUNS))
def test_smoke_runs_end_to_end(runs, name):
    run = runs[name]
    assert run["code"] in (0, 2), run["stderr"][-2000:]
    summary = summary_of(run["stdout"])
    assert summary.get("schema_problems", summary.get("problems")) == []
    over = summary["overhead"] > summary["budget"]
    assert run["code"] == (2 if over else 0)
    if not over:
        assert run["stdout"].splitlines()[-1].startswith("PASS: ")
    streams = glob.glob(str(run["tmp"] / "**" / "*.jsonl"), recursive=True)
    assert streams, name
    if name == "dtrace_smoke":
        assert summary["batches_assembled"] > 0 and set(summary["edges"]) == set(
            dtrace_smoke.DATAPLANE_EDGES)


def run_main(module, argv: list[str], monkeypatch) -> tuple[dict, int, list[str]]:
    """One package's ``main`` on ``argv``: (its summary less the host and the
    stream directory, its exit code, its printed lines after the summary)."""
    out = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        try:
            if module.__name__.startswith("hotstuff_tpu_torch"):
                module.main(argv)
            else:
                monkeypatch.setattr(sys, "argv", ["smoke", *argv])
                module.main()
        except SystemExit as e:
            code = e.code
    lines = out.getvalue().splitlines()
    summary = summary_of(out.getvalue())
    summary.pop("host"), summary.pop("snap_dir", None)
    return summary, code, lines[lines.index(next(x for x in lines if x.startswith('{"metric'))) + 1:]


def compare(name: str, argv: list[str], monkeypatch, patch) -> tuple[dict, int]:
    """Both packages' ``main`` on ``argv`` after ``patch(module)``; their
    results must be equal. Returns the port's summary and exit code."""
    results = []
    for module in PAIRS[name]:
        patch(module)
        results.append(run_main(module, argv, monkeypatch))
    assert results[0] == results[1]
    return results[0][:2]


def doctored(src: str, dst: str, edit) -> str:
    """``src``'s lines through ``edit`` (a line's JSON object to its
    replacement, or None to drop it) into ``dst``."""
    with open(src) as f, open(dst, "w") as out:
        for line in f:
            rec = edit(json.loads(line))
            if rec is not None:
                out.write(json.dumps(rec) + "\n")
    return dst


# Each case: the legs' seconds a round in call order (the warm-up, then the
# repeats' legs in alternating order: off, on, on, off at 2 repeats) and a
# doctoring of the stream.
TELEMETRY_CASES = {
    "within": ([0.5, 0.100, 0.0996, 0.0995, 0.099], None),
    "over": ([0.5, 0.100, 0.121, 0.120, 0.101], None),
    "missing-counter": ([0.5, 0.100, 0.0996, 0.0995, 0.099], "drop-counter"),
    "bad-stream": ([0.5, 0.100, 0.0996, 0.0995, 0.099], "bad-schema"),
    "no-stage": ([0.5, 0.100, 0.0996, 0.0995, 0.099], "no-stage"),
}


@pytest.mark.parametrize("case", sorted(TELEMETRY_CASES))
def test_telemetry_smoke_equals_the_references(runs, tmp_path, monkeypatch, case):
    times, doctor = TELEMETRY_CASES[case]
    real = stream(runs, "telemetry_smoke", "telemetry-run0.jsonl")
    if doctor == "drop-counter":
        def edit(rec):
            rec.get("counters", {}).pop("consensus.qcs_formed", None)
            return rec
        real = doctored(real, str(tmp_path / "s.jsonl"), edit)
    elif doctor == "bad-schema":
        real = doctored(real, str(tmp_path / "s.jsonl"),
                        lambda rec: {**rec, "counters": "none"} if "counters" in rec else rec)
    stage = None if doctor == "no-stage" else {"propose": (5_000_000, 20), "vote": (2_000, 4)}

    def patch(module):
        calls = iter(times)

        def run_once(n, rounds, base_port, with_telemetry, snap_path):
            if with_telemetry:
                shutil.copy(real, snap_path)
            return next(calls), stage if with_telemetry else None

        monkeypatch.setattr(module, "_run_once", run_once)

    summary, code = compare("telemetry_smoke", ["--repeats", "2"], monkeypatch, patch)
    want = {"within": 0, "over": 2}.get(case, 1)
    assert code == want, summary
    assert summary["off_ms_per_round"] == round(min(times[1], times[4]) * 1e3, 2)


PROFILE_CASES = {
    "within": ([0.5, 0.100, 0.0996, 0.0995, 0.099], 400, None),
    "over": ([0.5, 0.100, 0.121, 0.120, 0.101], 400, None),
    "no-records": ([0.5, 0.100, 0.0996, 0.0995, 0.099], 400, "no-profiles"),
    "untagged": ([0.5, 0.100, 0.0996, 0.0995, 0.099], 400, "untag"),
    "untagged-no-samples": ([0.5, 0.100, 0.0996, 0.0995, 0.099], 0, "untag"),
}


@pytest.mark.parametrize("case", sorted(PROFILE_CASES))
def test_profile_smoke_equals_the_references(runs, tmp_path, monkeypatch, case):
    times, samples, doctor = PROFILE_CASES[case]
    real = stream(runs, "profile_smoke", "telemetry-run0.jsonl")
    if doctor == "no-profiles":
        real = doctored(real, str(tmp_path / "s.jsonl"),
                        lambda rec: None if rec.get("schema") == "hotstuff-profile-v1" else rec)
    elif doctor == "untag":
        def edit(rec):
            if rec.get("schema") == "hotstuff-profile-v1":
                rec["stacks"] = [["", folded, n] for _stage, folded, n in rec["stacks"]]
            return rec
        real = doctored(real, str(tmp_path / "s.jsonl"), edit)

    def patch(module):
        calls = iter(times)

        def spawn_once(n, rounds, base_port, with_sampler, interval_ms, snap_path):
            if snap_path:
                shutil.copy(real, snap_path)
            return next(calls), samples if with_sampler else 0

        monkeypatch.setattr(module, "_spawn_once", spawn_once)

    summary, code = compare("profile_smoke", ["--repeats", "2"], monkeypatch, patch)
    want = {"within": 0, "over": 2, "untagged-no-samples": 0}.get(case, 1)
    assert code == want, summary


WATCH_CASES = {
    "within": ([0.5, 0.100, 0.0996, 0.0995, 0.099], (0, 40, 12)),
    "over": ([0.5, 0.100, 0.121, 0.120, 0.101], (0, 40, 12)),
    "alerts": ([0.5, 0.100, 0.0996, 0.0995, 0.099], (1, 40, 12)),
    "no-records": ([0.5, 0.100, 0.0996, 0.0995, 0.099], (0, 0, 0)),
    "no-rounds": ([0.5, 0.100, 0.0996, 0.0995, 0.099], (0, 40, 0)),
}


@pytest.mark.parametrize("case", sorted(WATCH_CASES))
def test_watchtower_smoke_equals_the_references(monkeypatch, case):
    times, (alerts, records, rounds) = WATCH_CASES[case]

    def patch(module):
        calls = iter(times)

        def spawn_once(n, rounds_, base_port, with_watch, snap_path):
            leg = {"per_round": next(calls), "alerts": 0, "records": 0, "rounds": 0}
            if with_watch:
                leg.update(alerts=alerts, records=records, rounds=rounds, frontier=rounds)
            return leg

        monkeypatch.setattr(module, "_spawn_once", spawn_once)

    summary, code = compare("watchtower_smoke", ["--repeats", "2"], monkeypatch, patch)
    assert code == {"within": 0, "over": 2}.get(case, 1), summary


def test_dtrace_attribution_equals_the_references(runs):
    attached = stream(runs, "dtrace_smoke", "telemetry-attached.jsonl")
    detached = stream(runs, "dtrace_smoke", "telemetry-detached.jsonl")
    report, problems = dtrace_smoke._check_attribution(attached)
    assert (report, problems) == j_dtrace_smoke._check_attribution(attached)
    assert problems == [] and report["batches"] > 0
    for path in (attached, detached):
        assert dtrace_smoke._count_dtrace_records(path) == j_dtrace_smoke._count_dtrace_records(
            path)
    assert dtrace_smoke._count_dtrace_records(detached) == 0
    assert dtrace_smoke._count_dtrace_records(attached) > 0
    assert j_dtrace_smoke._check_attribution(detached)[1] != []


# Each case: the paired legs' (delta, detached CPU a batch) and what goes
# wrong: the detached leg coming up attached, or the attached leg's stream
# holding no lifeline.
DTRACE_CASES = {
    "within": ([(0.0001, 0.02), (0.0003, 0.02)], None),
    "over": ([(0.0010, 0.02), (0.0008, 0.02)], None),
    "switch-broken": ([(0.0001, 0.02), (0.0003, 0.02)], "switch"),
    "no-lifelines": ([(0.0001, 0.02), (0.0003, 0.02)], "no-lifelines"),
}


@pytest.mark.parametrize("case", sorted(DTRACE_CASES))
def test_dtrace_smoke_equals_the_references(runs, tmp_path, monkeypatch, case):
    legs, fault = DTRACE_CASES[case]
    attached_stream = stream(runs, "dtrace_smoke", "telemetry-attached.jsonl")
    detached_stream = stream(runs, "dtrace_smoke", "telemetry-detached.jsonl")

    def patch(module):
        pair_legs = iter(legs)

        def spawn_once(args, *, batches, port, snap_path, paired=False, attached=True,
                       start_attached=True):
            if paired:
                delta, off = next(pair_legs)
                return {"pair_delta": delta, "off_cpu_per_batch": off, "dtrace_on": True}
            on = attached or fault == "switch"
            src = attached_stream if on and not (attached and fault == "no-lifelines") \
                else detached_stream
            shutil.copy(src, snap_path)
            return {"cpu_per_batch": 0.02, "dtrace_on": on}

        monkeypatch.setattr(module, "_spawn_once", spawn_once)

    summary, code = compare("dtrace_smoke", ["--repeats", "2", "--work-dir", str(tmp_path)],
                            monkeypatch, patch)
    assert code == {"within": 0, "over": 2}.get(case, 1), summary
