"""Run one cell of the benchmark and print its result as the last line.

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

One process a run: the cell's entry (``entries/``, named by its traffic
file) makes its inputs from the seed and warms the cell's shapes, the
window runs for ``--seconds``, then the entry's comparison with the plain
reference decides ``correct``. The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
and with ``--trace 1`` ``breakdown``, then ``checks``); the last lines of
standard error give each compared number beside its limit. Without a CUDA
card the run exits with 2 and prints no result.

A traffic file may spread a run's window over ``"processes"`` processes,
started one after another, each with its own set-up and an equal share of
``--seconds`` (not with ``--trace 1``, which runs in one process): the rate
is read over the work and the time of all their windows, a latency over all
their requests, ``setup_s`` is their set-ups together, and the run is
correct only where every process is.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

from perfbench import drive, entries, faults, spec  # noqa: E402

# Checked once the window has closed: none of these may have been loaded.
_FORBIDDEN = ("jax", "jaxlib", "flax", "hotstuff_tpu")


@dataclass
class RunData:
    """What a metric reader sees."""

    records: list
    t_start: int
    t_end: int
    seconds: float  # the windows' length together
    windows: list  # (start, end) ns of each process's window, in order
    setup_s: float
    counters: dict  # change over the window
    spans: drive.Spans | None = None
    trace: object = None
    launches_lost: bool = False
    batches: list = field(default_factory=list)  # (signatures, distinct messages)
    card: dict = field(default_factory=dict)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _card_info(torch) -> dict:
    info = {"name": torch.cuda.get_device_name(0),
            "sms": torch.cuda.get_device_properties(0).multi_processor_count}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        sm, sm_max, limit = (v.strip() for v in out.strip().splitlines()[0].split(","))
        info.update(clock_mhz=float(sm), clock_max_mhz=float(sm_max), power_limit_w=float(limit))
    except (OSError, subprocess.SubprocessError, ValueError, IndexError) as e:
        _log(f"nvidia-smi unread: {e!r}")
    return info


def _parse(argv):
    ap = argparse.ArgumentParser(prog="perfbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # For the harness's own tests: run on the host through the kernels'
    # plain versions, or with the control or a fault in the program's place.
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--control", choices=faults.CONTROLS, help=argparse.SUPPRESS)
    ap.add_argument("--fault", choices=faults.FAULTS, help=argparse.SUPPRESS)
    # One process of a run spread over several (_run_in_parts).
    ap.add_argument("--part", action="store_true", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _parse(argv)
    bench = spec.load()
    cell = spec.cell(bench, args.workload)
    parts = int(cell.traffic.get("processes", 1))
    if parts > 1 and not args.trace and not args.part:
        return _run_in_parts(args, cell, parts)
    module = entries.load(cell.traffic)
    module.configure_environment(cell.traffic, cell.chips)
    import torch

    _log(f"set-up: torch imported {time.perf_counter() - T_PROCESS:.2f} s")
    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            _log(f"needs {cell.chips} CUDA card(s); found "
                 f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        card = _card_info(torch)
        _log(f"card {card}")
    else:
        card = {"name": "cpu", "sms": 0}
    if importlib.util.find_spec("hotstuff_tpu_torch") is None:
        _log("the program is not importable here")
        return 2

    _log(f"set-up: imports and the card {time.perf_counter() - T_PROCESS:.2f} s")
    entry = module.Entry(cell.config, cell.traffic, args.seed, args.seconds, args.device, _log)
    entry.setup()
    if args.device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    entry.install(args.control, args.fault)

    gc.collect()
    gc.freeze()
    spans = recorder = unwrap = None
    if args.trace:
        spans = drive.Spans()
        unwrap = drive.wrap_backend(entry.backend, spans)
        if args.device == "cuda":
            from perfbench import trace

            recorder = trace.Recorder(torch)
            recorder.start()
    launches0 = entry.launches()
    counters0 = entry.counters()
    setup_s = time.perf_counter() - T_PROCESS
    outcome = entry.window(args.seconds, spans)
    counters1 = entry.counters()
    launches1 = entry.launches()
    if recorder is not None:
        recorder.stop()
    if unwrap is not None:
        unwrap()
    memory_peak = torch.cuda.max_memory_allocated(0) if args.device == "cuda" else 0
    counters = {k: counters1[k] - counters0[k] for k in counters0}
    records = outcome.records
    _log(f"window: {len(records)} records, "
         f"{(outcome.t_drained - outcome.t_end) / 1e9:.3f} s to drain")
    bins = [0] * max(1, int(args.seconds + 0.999) // 2)
    for r in records:
        if r.t1 <= outcome.t_end:
            bins[min(len(bins) - 1, int((r.t1 - outcome.t_start) / 2e9))] += 1
    _log(f"window: records a 2 s bin {bins}")

    run = RunData(records, outcome.t_start, outcome.t_end, args.seconds,
                  [(outcome.t_start, outcome.t_end)], setup_s, counters, spans=spans, card=card)
    if args.trace:
        _reduce_trace(run, entry, recorder, launches0, launches1)

    judged = entry.check(run)
    if judged is None:
        return 4
    checks, failed = judged
    device = {
        "platform": "gpu" if args.device == "cuda" else "cpu",
        "kind": card["name"],
        "count": cell.chips,
        "memory_peak_bytes": memory_peak,
    }
    part = None
    if args.part:
        part = {"setup_s": setup_s, "window": [outcome.t_start, outcome.t_end],
                "records": [[r.t0, r.t1] for r in records]}
    _log(f"card {card.get('name')} power limit {card.get('power_limit_w')} W, "
         f"SM clock {card.get('clock_mhz')} of {card.get('clock_max_mhz')} MHz")
    return _finish(cell, run, args.trace, checks, failed, device, part)


def _finish(cell, run: RunData, traced: int, checks: dict, failed: int, device: dict,
            part: dict | None = None) -> int:
    """Read the cell's metrics from ``run`` and print the result line, after
    each compared number beside its limit."""
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(_FORBIDDEN))
    if loaded:
        _log(f"modules that the port may not load are loaded: {loaded}")
        return 3

    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = spec.reader(m["name"])(run)
        if v is None:
            _log(f"metric {m['name']}: nothing to read")
        else:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": len(run.records), "failed": failed, "metrics": metrics,
              "device": device}
    if traced and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    if part is not None:
        result["part"] = part
    result["checks"] = checks
    for name, c in checks.items():
        _log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


def _run_in_parts(args, cell, parts: int) -> int:
    """The run as ``parts`` processes in turn, each this command with
    ``--part`` and a share of the window; a process's speed varies with
    what it draws at start (see the module's docstring)."""
    share = args.seconds / parts
    cmd = [sys.executable, "-m", "perfbench.run", "--workload", args.workload,
           "--seed", str(args.seed), "--seconds", repr(share), "--trace", "0",
           "--device", args.device, "--part"]
    cmd += ["--control", args.control] if args.control else []
    cmd += ["--fault", args.fault] if args.fault else []
    setup_s = time.perf_counter() - T_PROCESS
    results = []
    for i in range(parts):
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, text=True)  # stderr passes on
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            _log(f"process {i + 1} of {parts} exited with {proc.returncode}: no result")
            return proc.returncode if proc.returncode > 0 else 5
        results.append(json.loads(lines[-1]))
        setup_s += results[-1]["part"]["setup_s"]

    records = [drive.Record(-1, t0, t1, "", None)
               for r in results for t0, t1 in r["part"]["records"]]
    windows = [tuple(r["part"]["window"]) for r in results]
    run = RunData(records, windows[0][0], windows[-1][1], args.seconds, windows, setup_s, {})
    # A process's numbers each meet their limit where the largest does.
    checks = {name: {"value": max(r["checks"][name]["value"] for r in results),
                     "limit": c["limit"]} for name, c in results[0]["checks"].items()}
    device = dict(results[0]["device"],
                  memory_peak_bytes=max(r["device"]["memory_peak_bytes"] for r in results))
    _log(f"{parts} processes: windows {[round((b - a) / 1e9, 3) for a, b in windows]} s, "
         f"set-ups {[round(r['part']['setup_s'], 2) for r in results]} s, "
         f"correct {[r['correct'] for r in results]}")
    return _finish(cell, run, 0, checks, sum(r["failed"] for r in results), device)


def _reduce_trace(run: RunData, entry, recorder, launches0: dict, launches1: dict) -> None:
    # Precedence: the first label whose spans cover an instant names it.
    host = entry.host_spans(run)
    run.batches = [(n, len(set(msgs))) for _, _, n, msgs in run.spans.backend]
    if recorder is None:
        return
    run.trace = recorder.reduce(host)
    expected = sum(launches1.values()) - sum(launches0.values())
    if run.trace is None:
        _log("trace: no device events read")
        return
    run.launches_lost = run.trace.port_launches != expected
    _log(f"trace: {run.trace.port_launches} launches of the port's kernels, "
         f"{expected} counted; aligned {run.trace.aligned} ({run.trace.clock}); idle by host state "
         f"{ {k: round(v, 6) for k, v in run.trace.idle_by_label.items()} }")


if __name__ == "__main__":
    sys.exit(main())
