"""Fault matrix: the acceptance sweep behind the Robustness claims.

Runs the three canonical fault classes against a live in-process
committee — **f crash faults** (kill f nodes uncleanly, restart them on
their stores), **minority partition + heal** (isolate f nodes; the
majority must keep committing, the minority must catch up), and
**delay+duplicate+reorder** (every link impaired at once) — on BOTH
transport planes (asyncio and the native C++ engine), gating each run on
the invariant checker: safety=ok and liveness=recovered. One JSON
artifact records every verdict, the injected-fault counts, and the
measured post-heal recovery cost (``liveness.recovery_s``).

Plane selection must happen before ``hotstuff_tpu_torch.network`` first
imports (``HOTSTUFF_NET`` is read at import time), so the matrix
re-executes itself per plane as a subprocess.

    python -m hotstuff_tpu_torch.benchmark.fault_matrix --nodes 20 --output results

Port copy of the reference's ``benchmark/fault_matrix.py``, over the port's
faultline harness and telemetry. Its flags (``--base-port`` still defaults
to 23000: on the H100 host pass one below 16000), printed lines and
artifact are the reference's. What differs:

- the committees verify under ``HOTSTUFF_CRYPTO_BACKEND``, whose default
  in the port is ``cuda``: the parent resolves the card before it starts a
  plane's child when the name holds ``cuda``, and ``run_plane`` makes the
  backend before its first scenario, so without a card the run raises and
  prints no verdict;
- each plane's child (``-m hotstuff_tpu_torch.benchmark.fault_matrix``,
  with the parent's environment and so its crypto switch) runs in a
  session of its own and is killed whole after it;
- ``main`` takes ``argv``; there is no ``sys.path`` edit.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal
import subprocess
import sys

from hotstuff_tpu_torch.benchmark.hostinfo import host_meta


def build_scenarios(n: int, duration: float):
    """The three acceptance scenarios, parameterized by committee size
    (f = (n-1)//3). Fixed seeds: the schedules — and therefore the whole
    runs' fault timelines — are reproducible artifacts."""
    from hotstuff_tpu_torch.faultline import Scenario

    f = max(1, (n - 1) // 3)
    crash_events = []
    for k in range(f):
        # Stagger the kills across the middle of the run; every victim
        # restarts before 0.8*duration so liveness is judged fault-free.
        at = round(0.2 * duration + k * (0.4 * duration / f), 3)
        crash_events.append({"kind": "crash", "node": k, "at": at})
        crash_events.append(
            {"kind": "restart", "node": k, "at": round(min(at + 0.25 * duration, 0.8 * duration), 3)}
        )
    return [
        Scenario(
            name=f"crash-f{f}", seed=501, duration_s=duration,
            events=crash_events,
        ),
        Scenario(
            name="minority-partition", seed=502, duration_s=duration,
            events=[
                {
                    "kind": "partition",
                    "groups": [list(range(f)), list(range(f, n))],
                    "at": round(0.3 * duration, 3),
                    "until": round(0.6 * duration, 3),
                }
            ],
        ),
        Scenario(
            name="delay-dup-reorder", seed=503, duration_s=duration,
            events=[
                {
                    "kind": "link", "src": "*", "dst": "*",
                    "at": round(0.2 * duration, 3),
                    "until": round(0.7 * duration, 3),
                    "drop": 0.05, "delay_ms": [5, 40],
                    "duplicate": 0.1, "reorder": 0.1,
                }
            ],
        ),
    ]


def run_plane(args) -> dict:
    """Worker: run the matrix on the CURRENT plane (this process's
    already-imported transport) and return {scenario: verdict}."""
    from hotstuff_tpu_torch import crypto, telemetry
    from hotstuff_tpu_torch.faultline import run_scenario
    from hotstuff_tpu_torch.telemetry import slo as slo_mod

    crypto.get_backend()  # without a card a cuda backend raises here
    telemetry.enable()
    # Chaos-appropriate SLOs evaluated on each run's final cumulative
    # snapshot: round latency p99 (clean rounds only — faulted rounds
    # have their own histogram) and the whole-run view-change rate.
    # Thresholds are deliberately loose: the matrix's hard gate stays the
    # invariant checker; the SLO section quantifies degradation.
    chaos_specs = [
        slo_mod.SloSpec(
            "p99_round_commit_ms", "quantile",
            "consensus.span.propose_to_commit_ms", q=0.99, max=15_000.0,
        ),
        slo_mod.SloSpec(
            "timeouts_per_round", "ratio",
            "consensus.timeouts_fired", per="consensus.rounds_advanced",
            max=2.0,
        ),
    ]
    out: dict[str, dict] = {}
    base = args.base_port
    for scenario in build_scenarios(args.nodes, args.duration):
        import time as _time

        # Window the registry around THIS scenario: the process registry
        # is cumulative across the matrix's scenarios, and each verdict
        # must judge only its own run.
        before = dict(telemetry.get_registry().snapshot(), ts=_time.time())
        result = asyncio.run(
            run_scenario(
                scenario,
                args.nodes,
                base_port=base,
                timeout_delay=args.timeout,
                recovery_timeout_s=90.0,
            )
        )
        after = dict(result["telemetry"], ts=_time.time())
        base += args.nodes + 16
        verdict = result["verdict"]
        verdict["slo"] = slo_mod.evaluate(
            [before, after], chaos_specs, source=scenario.name
        )
        verdict["flight_record"] = result.get("flight_record")
        out[scenario.name] = verdict
        status = (
            "ok"
            if verdict["safety"]["ok"] and verdict["liveness"]["recovered"]
            else "FAILED"
        )
        print(
            f"[{args.plane}] {scenario.name}: {status} "
            f"recovery_s={verdict['liveness']['recovery_s']} "
            f"injections={verdict['injections']['counts']}",
            file=sys.stderr,
        )
    return out


def _run_child(cmd: list[str], env: dict) -> subprocess.CompletedProcess:
    """``cmd`` in a session of its own, its output captured; every process
    it started is killed after it."""
    proc = subprocess.Popen(
        cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True,
    )
    try:
        out, err = proc.communicate()
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        if proc.poll() is None:
            proc.wait()
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--nodes", type=int, default=20)
    p.add_argument("--duration", type=float, default=12.0)
    p.add_argument("--timeout", type=int, default=1_000)
    p.add_argument("--base-port", type=int, default=23000)
    p.add_argument(
        "--planes", default="asyncio,native",
        help="comma-separated transport planes to sweep",
    )
    p.add_argument("--output", help="directory for the JSON artifact")
    p.add_argument(
        "--plane", help=argparse.SUPPRESS  # worker mode: a single plane
    )
    args = p.parse_args(argv)

    if args.plane:
        json.dump(run_plane(args), sys.stdout)
        return

    from hotstuff_tpu_torch.utils.device import resolve_backend_card

    resolve_backend_card()  # raises without a card, before any child starts

    report: dict = {"nodes": args.nodes, "host": host_meta(), "planes": {}}
    ok = True
    for plane in args.planes.split(","):
        env = dict(os.environ)
        env["HOTSTUFF_NET"] = "native" if plane == "native" else ""
        proc = _run_child(
            [
                sys.executable, "-m", "hotstuff_tpu_torch.benchmark.fault_matrix",
                "--plane", plane,
                "--nodes", str(args.nodes),
                "--duration", str(args.duration),
                "--timeout", str(args.timeout),
                "--base-port", str(args.base_port),
            ],
            env,
        )
        sys.stderr.write(proc.stderr)
        if proc.returncode != 0:
            print(f"plane {plane} worker failed:\n{proc.stdout}")
            ok = False
            continue
        verdicts = json.loads(proc.stdout)
        report["planes"][plane] = verdicts
        for name, v in verdicts.items():
            if not (v["safety"]["ok"] and v["liveness"]["recovered"]):
                ok = False
                print(f"FAILED: {plane}/{name}: {json.dumps(v, indent=2)}")

    print(
        f"fault matrix N={args.nodes}: "
        + ("all scenarios safe + recovered" if ok else "FAILURES (see above)")
    )
    if args.output:
        os.makedirs(args.output, exist_ok=True)
        path = os.path.join(args.output, f"fault-matrix-n{args.nodes}.json")
        with open(path, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"artifact written to {path}")
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
