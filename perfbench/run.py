"""Run one cell of the benchmark and print its result as the last line.

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

One process a run: the inputs are made from the seed, the cell's shapes are
warmed, the window runs for ``--seconds``, then the plain reference judges
every proposal handed off in it. The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
and with ``--trace 1`` ``breakdown``, then ``checks``); the last lines of
standard error give each compared number beside its limit. Without a CUDA
card the run exits with 2 and prints no result.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

from perfbench import drive, faults, inputs, spec  # noqa: E402

# Checked once the window has closed: none of these may have been loaded.
_FORBIDDEN = ("jax", "jaxlib", "flax", "hotstuff_tpu")


@dataclass
class RunData:
    """What a metric reader sees."""

    records: list
    t_start: int
    t_end: int
    seconds: float
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
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _parse(argv)
    bench = spec.load()
    cell = spec.cell(bench, args.workload)
    traffic, config = cell.traffic, cell.config

    from perfbench import program as prog

    prog.configure_environment(traffic, cell.chips)
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
    try:
        import hotstuff_tpu_torch  # noqa: F401
    except ImportError as e:
        _log(f"the program is not importable here: {e!r}")
        return 2

    t = time.perf_counter()
    _log(f"set-up: imports and the card {t - T_PROCESS:.2f} s")
    plan = inputs.make_plan(args.seed, config, traffic, args.seconds)
    _log(f"set-up: plan of {len(plan.keys)} validators, {len(plan.certs)} certificates, "
         f"{len(plan.warmup)} warm-up and {len(plan.window)} window proposals "
         f"{time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    program = prog.Program(plan, traffic, args.device)
    warm = program.frames(plan, plan.warmup)
    frames = program.frames(plan, plan.window)
    _log(f"set-up: the program's objects and frames {time.perf_counter() - t:.2f} s")
    warm_ids = [(p.qc, p.tc) for p in plan.warmup]
    ids = [(p.qc, p.tc) for p in plan.window]
    in_flight = int(traffic["in_flight"])

    out = drive.run(program, warm, warm_ids, in_flight, None)
    wrong = sum(r.verdict != p.intended for r, p in zip(sorted(out.records, key=lambda r: r.j), plan.warmup))
    _log(f"set-up: warm-up of {len(out.records)} proposals, {wrong} verdicts unlike the plan, "
         f"{(out.t_drained - out.t_start) / 1e9:.2f} s")
    del out
    if args.device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    if args.control:
        faults.install_control(args.control, program)
    if args.fault:
        faults.install_fault(args.fault, program)

    gc.collect()
    gc.freeze()
    spans = recorder = unwrap = None
    if args.trace:
        spans = drive.Spans()
        unwrap = drive.wrap_backend(program.backend, spans)
        if args.device == "cuda":
            from perfbench import trace

            recorder = trace.Recorder(torch)
            recorder.start()
    launches0 = program.launches()
    counters0 = program.counters()
    setup_s = time.perf_counter() - T_PROCESS
    outcome = drive.run(program, frames, ids, in_flight, args.seconds, spans)
    counters1 = program.counters()
    launches1 = program.launches()
    if recorder is not None:
        recorder.stop()
    if unwrap is not None:
        unwrap()
    memory_peak = torch.cuda.max_memory_allocated(0) if args.device == "cuda" else 0
    counters = {k: counters1[k] - counters0[k] for k in counters0}
    records = outcome.records
    _log(f"window: {len(records)} proposals handed off, "
         f"{(outcome.t_drained - outcome.t_end) / 1e9:.3f} s to drain")
    bins = [0] * max(1, int(args.seconds + 0.999) // 2)
    for r in records:
        if r.t1 <= outcome.t_end:
            bins[min(len(bins) - 1, int((r.t1 - outcome.t_start) / 2e9))] += 1
    _log(f"window: verdicts a 2 s bin {bins}")

    run = RunData(records, outcome.t_start, outcome.t_end, args.seconds, setup_s,
                  counters, spans=spans, card=card)
    if args.trace:
        _reduce_trace(run, recorder, launches0, launches1)

    # The reference judges every distinct frame handed off in the window.
    t_ref = time.perf_counter()
    from perfbench.reference import judge as ref

    committee = ref.Committee(plan.keys, {k: plan.stake for k in plan.keys})
    idx = sorted({r.j % len(frames) for r in records})
    verdicts = dict(zip(idx, ref.Judge(committee, args.seed).judge([frames[i] for i in idx])))
    checks, failed = _compare(run, verdicts, program, len(frames))
    _log(f"reference: {len(idx)} frames judged in {time.perf_counter() - t_ref:.2f} s")
    unlike = sum(verdicts[i].verdict != plan.window[i].intended for i in idx)
    if unlike:
        # The yardstick's own inputs: the traffic is not what the plan made.
        _log(f"the reference's verdicts of {unlike} frames are not the plan's: no result")
        return 4

    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(_FORBIDDEN))
    if loaded:
        _log(f"modules that the port may not load are loaded: {loaded}")
        return 3

    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        v = spec.reader(m["name"])(run)
        if v is None:
            _log(f"metric {m['name']}: nothing to read")
        else:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {
        "platform": "gpu" if args.device == "cuda" else "cpu",
        "kind": card["name"],
        "count": cell.chips,
        "memory_peak_bytes": memory_peak,
    }
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": len(records), "failed": failed, "metrics": metrics,
              "device": device}
    if args.trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    result["checks"] = checks
    _log(f"card {card.get('name')} power limit {card.get('power_limit_w')} W, "
         f"SM clock {card.get('clock_mhz')} of {card.get('clock_max_mhz')} MHz")
    for name, c in checks.items():
        _log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


def _reduce_trace(run: RunData, recorder, launches0: dict, launches1: dict) -> None:
    from perfbench import trace

    spans = run.spans
    # Precedence: the first label whose spans cover an instant names it.
    host = {
        "backend call": trace.merge((a, b) for a, b, _, _ in spans.backend),
        "verify outside the backend": trace.merge(spans.verify),
        "decode": trace.merge(spans.decode),
        "bridge hand-off": trace.merge((r.t0, r.t1) for r in run.records),
    }
    run.batches = [(n, len(set(msgs))) for _, _, n, msgs in spans.backend]
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


def _compare(run: RunData, verdicts: dict, program, n_frames: int):
    wrong = decodes = unjudged = 0
    expected_sigs = 0
    failed = 0
    for r in run.records:
        ref = verdicts[r.j % n_frames]
        expected_sigs += ref.sigs_sent
        bad = False
        if r.verdict == "unjudged" or r.verdict.startswith("error:"):
            unjudged += 1
            bad = True
        elif r.verdict != ref.verdict:
            wrong += 1
            bad = True
        if r.block is not None:
            if program.fields(r.block) != (ref.digest, ref.fields):
                decodes += 1
                bad = True
        failed += bad
    sigs = run.counters.get("crypto.dispatch.cuda_sigs", 0)
    checks = {
        "verdicts_wrong": {"value": wrong, "limit": 0},
        "decodes_wrong": {"value": decodes, "limit": 0},
        "unjudged": {"value": unjudged, "limit": 0},
        "sigs_gap": {"value": abs(sigs - expected_sigs), "limit": 0},
    }
    return checks, failed


if __name__ == "__main__":
    sys.exit(main())
