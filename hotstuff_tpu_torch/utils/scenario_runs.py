"""Run one faultline scenario several times on the card; print each run's counts.

    python3 hotstuff_tpu_torch/utils/scenario_runs.py [--tree DIR] [--label NAME]
        [--runs 3] [--n 20] [--base-port 11200] [SCENARIO]

Imports ``hotstuff_tpu_torch`` from ``DIR`` (default: the checkout that
holds this file), installs ``cuda-batched`` with telemetry on, as
``chip_smoke.py`` phase 15 does, and runs ``faultline.run_scenario`` on an
N-engine committee at the harness's 1 s timeout ``--runs`` times, each run
on ports of its own. It prints the card's name and power limit, then one
JSON line a run: the label, the verdict's safety and recovery, the
injection counts, the commits a node and the run's seconds. So two trees,
say a commit and its parent unpacked with ``git archive``, can run in
turns within one call (parent, change, change, parent). The default
scenario, ``benchmark/scenarios/storm-n20.json``, has a silent leader whose
window may hold nothing for it to send, depending on how fast the rounds
ran before it. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    root = Path(__file__).resolve().parents[2]
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scenario", nargs="?", default=str(root / "benchmark/scenarios/storm-n20.json"))
    ap.add_argument("--tree", default=str(root))
    ap.add_argument("--label", default="")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--n", type=int, default=20)
    ap.add_argument("--base-port", type=int, default=11200)
    args = ap.parse_args()

    # Run as a script, Python puts this file's directory first on the path,
    # where utils/logging.py would shadow the standard library's logging.
    here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if not p or Path(p).resolve() != here]
    import asyncio

    import torch

    if not torch.cuda.is_available():
        print("scenario_runs: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.tree).resolve()))
    from hotstuff_tpu_torch import crypto, faultline, telemetry
    from hotstuff_tpu_torch.consensus import cert_arena

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    telemetry.reset_for_tests()
    telemetry.enable()  # before the backend is made: its counters record
    crypto.set_backend("cuda-batched")
    os.environ["HOTSTUFF_CERT_ARENA"] = "1"
    scenario = faultline.Scenario.load(args.scenario)
    stride = args.n + 5
    for i in range(args.runs):
        cert_arena.reset()
        t = time.perf_counter()
        result = asyncio.run(faultline.run_scenario(
            scenario, args.n, base_port=args.base_port + stride * i, timeout_delay=1_000))
        verdict = result["verdict"]
        print(json.dumps({
            "label": args.label, "scenario": scenario.name, "run": i,
            "safe": verdict["safety"]["ok"], "recovered": verdict["liveness"]["recovered"],
            "recovery_s": verdict["liveness"]["recovery_s"],
            "counts": verdict["injections"]["counts"],
            "commits": sorted(set(verdict["commits"].values())),
            "seconds": round(time.perf_counter() - t, 1),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
