"""Sampling-profiler smoke + overhead gate (the profiling sibling of
``benchmark/telemetry_smoke.py``).

Runs the one-process committee bench twice per repeat — telemetry on in
BOTH legs (the baseline the <1% telemetry budget already paid for),
sampler OFF vs sampler ON (2 ms all-thread stack walks + stage tagging
+ ctypes accounting + profile-record emission) — and:

1. validates that the sampler actually produced ``hotstuff-profile-v1``
   records in the stream, that they parse back through
   ``benchmark.logs.read_stream_records``, and that stage tags joinable
   onto the trace edges are present;
2. gates the measured overhead: min-over-repeats per-round time with
   the sampler on must be within ``--budget`` (default 1%) of off —
   min-of-N with alternating order, the same noise-robust estimator the
   telemetry gate uses on a shared CI core.

Exit code 0 on pass, 1 on record/schema failure, 2 on budget failure.

    python -m hotstuff_tpu_torch.benchmark.profile_smoke --nodes 10 --rounds 20
    python -m hotstuff_tpu_torch.benchmark.profile_smoke --nodes 100 --rounds 20 \
        --output results/profile-overhead-100.txt

Port copy of the reference's ``benchmark/profile_smoke.py``: the same
flags, legs (each in a fresh ``python -m
hotstuff_tpu_torch.benchmark.profile_smoke --one-shot`` process, run from
the repository's root), record checks, overhead arithmetic, summary line
and exit codes, over the port's ``committee_scale``, ``logs`` and
profiler. The legs verify under ``HOTSTUFF_CRYPTO_BACKEND``, whose default
here is ``cuda``: without a card the parent raises before it starts a leg
and prints no summary. ``main`` takes ``argv``; there is no ``sys.path``
edit. On the H100 host pass a ``--base-port`` below 16000 (each leg takes
``2 * --nodes`` ports).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import subprocess
import sys
import tempfile


from hotstuff_tpu_torch.benchmark.hostinfo import host_meta
from hotstuff_tpu_torch.utils.device import resolve_backend_card

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def _run_once(
    n: int,
    rounds: int,
    base_port: int,
    with_sampler: bool,
    interval_ms: float,
    snap_path: str | None,
    ctypes_accounting: bool = True,
):
    from hotstuff_tpu_torch.benchmark.committee_scale import run_committee
    from hotstuff_tpu_torch import telemetry
    from hotstuff_tpu_torch.telemetry import profiler as pyprof

    telemetry.reset_for_tests()
    telemetry.enable()
    profiler = None
    if with_sampler:
        profiler = pyprof.SamplingProfiler(interval_ms=interval_ms)
        profiler.start(mode="auto", ctypes_accounting=ctypes_accounting)
    try:
        per_round, _ = asyncio.run(
            run_committee(
                n, rounds, base_port, timeout_delay=30_000,
                telemetry_path=snap_path, profiler=profiler,
            )
        )
    finally:
        if profiler is not None:
            profiler.stop()
        telemetry.disable()
    samples = profiler.samples if profiler is not None else 0
    return per_round, samples


def _spawn_once(
    n: int,
    rounds: int,
    base_port: int,
    with_sampler: bool,
    interval_ms: float,
    snap_path: str | None,
):
    """One measurement leg in a FRESH subprocess. The native transport's
    C++ context is process-wide and keeps outbound connections for the
    process lifetime, so repeated in-process committees accumulate
    state: later legs run slower regardless of the sampler, and the
    drift lands asymmetrically on the on/off sides. A process per leg
    makes every leg identical to a standalone run."""
    cmd = [
        sys.executable, "-m", "hotstuff_tpu_torch.benchmark.profile_smoke", "--one-shot",
        "--nodes", str(n), "--rounds", str(rounds),
        "--base-port", str(base_port), "--interval-ms", str(interval_ms),
    ]
    if with_sampler:
        cmd.append("--sampler-on")
    if snap_path:
        cmd += ["--snap", snap_path]
    proc = subprocess.run(
        cmd, capture_output=True, text=True,
        cwd=REPO_ROOT,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"one-shot leg failed (rc={proc.returncode}):\n{proc.stderr[-2000:]}"
        )
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    return result["per_round"], result["samples"]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--nodes", type=int, default=10)
    p.add_argument("--rounds", type=int, default=15)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--interval-ms", type=float, default=2.0)
    p.add_argument(
        "--budget",
        type=float,
        default=float(os.environ.get("HOTSTUFF_PYPROF_BUDGET", "0.01")),
        help="max allowed relative overhead (default 0.01 = 1%%)",
    )
    p.add_argument("--base-port", type=int, default=19000)
    p.add_argument("--output", help="file to append the result summary to")
    # Internal: one measurement leg (see _spawn_once).
    p.add_argument("--one-shot", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--sampler-on", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--no-ctypes-acct", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--snap", help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    os.environ.setdefault("HOTSTUFF_TELEMETRY_INTERVAL", "1")
    # Measurement parity with committee_scale's protocol mode: enough
    # bridge workers for the superbatching backend to fuse (the regime
    # the committed ms/round numbers were measured in).
    os.environ.setdefault("HOTSTUFF_CRYPTO_WORKERS", "32")

    if args.one_shot:
        per_round, samples = _run_once(
            args.nodes, args.rounds, args.base_port, args.sampler_on,
            args.interval_ms, args.snap,
            ctypes_accounting=not args.no_ctypes_acct,
        )
        print(json.dumps({"per_round": per_round, "samples": samples}))
        return

    resolve_backend_card()
    from hotstuff_tpu_torch.benchmark.logs import read_stream_records

    snap_dir = tempfile.mkdtemp(prefix="hotstuff_profile_smoke_")
    off_times: list[float] = []
    on_times: list[float] = []
    total_samples = 0
    port = args.base_port

    # Discarded warm-up: one-time costs (native lib builds, bytecode
    # caches) must not land on either side of the gate.
    _spawn_once(args.nodes, max(2, args.rounds // 4), port, False,
                args.interval_ms, None)
    port += 2 * args.nodes

    for rep in range(args.repeats):
        order = (False, True) if rep % 2 == 0 else (True, False)
        for with_sampler in order:
            snap_path = (
                os.path.join(snap_dir, f"telemetry-run{rep}.jsonl")
                if with_sampler
                else None
            )
            per_round, samples = _spawn_once(
                args.nodes, args.rounds, port, with_sampler,
                args.interval_ms, snap_path,
            )
            port += 2 * args.nodes
            if with_sampler:
                on_times.append(per_round)
                total_samples += samples
            else:
                off_times.append(per_round)

    # -- profile-record gate -------------------------------------------------
    problems: list[str] = []
    records = 0
    staged = 0
    for fn in sorted(os.listdir(snap_dir)):
        path = os.path.join(snap_dir, fn)
        try:
            recs = read_stream_records(path)  # raises on schema violation
        except Exception as e:  # noqa: BLE001
            problems.append(f"{fn}: {e}")
            continue
        records += len(recs.profiles)
        for rec in recs.profiles:
            staged += sum(
                c for stage, _f, c in rec["stacks"] if stage
            )
    if records == 0:
        problems.append("no hotstuff-profile-v1 records were emitted")
    if total_samples and not staged:
        problems.append("no sample carried a round-trace stage tag")

    # -- overhead gate -------------------------------------------------------
    best_off = min(off_times)
    best_on = min(on_times)
    overhead = (best_on - best_off) / best_off

    result = {
        "metric": f"pyprof_overhead_n{args.nodes}",
        "host": host_meta(),
        "off_ms_per_round": round(best_off * 1e3, 2),
        "on_ms_per_round": round(best_on * 1e3, 2),
        "overhead": round(overhead, 4),
        "budget": args.budget,
        "interval_ms": args.interval_ms,
        "samples": total_samples,
        "profile_records": records,
        "stage_tagged_samples": staged,
        "schema_problems": problems,
    }
    print(json.dumps(result))

    if args.output:
        os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
        with open(args.output, "a") as f:
            f.write(json.dumps(result) + "\n")

    if problems:
        print(f"FAIL: profile problems: {problems}", file=sys.stderr)
        sys.exit(1)
    if overhead > args.budget:
        print(
            f"FAIL: sampler overhead {overhead:.2%} exceeds the "
            f"{args.budget:.2%} budget",
            file=sys.stderr,
        )
        sys.exit(2)
    print(
        f"PASS: sampler overhead {overhead:+.2%} within {args.budget:.2%}; "
        f"{records} profile record(s), {total_samples} samples "
        f"({staged} stage-tagged)"
    )


if __name__ == "__main__":
    main()
