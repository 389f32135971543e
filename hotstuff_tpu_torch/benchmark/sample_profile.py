"""Sampling profiler CLI for the in-process committee (1-core box).

Thin wrapper over ``hotstuff_tpu_torch.telemetry.profiler.SamplingProfiler`` —
the one sampler implementation in the tree (this script used to carry
its own main-thread-only SIGPROF walker; the telemetry profiler walks
ALL threads via ``sys._current_frames`` and tags samples with the
active round-trace stage). cProfile's tracing overhead multiplies
asyncio's per-event cost so much that an N=40 committee cannot even
form its mesh inside a CI window; a SIGPROF sampler costs one stack
walk per interval (~0.3% at 2 ms) and leaves the timing honest.

    python -m hotstuff_tpu_torch.benchmark.sample_profile --nodes 40 --rounds 15

For per-trace-edge attribution (which functions inside which edge), use
``committee_scale --pyprof --telemetry`` + ``profile_assemble`` instead.

Port copy of the reference's ``benchmark/sample_profile.py``: the same
flags (``--by-stage`` included), sampler and printed tables, over the
port's ``committee_scale`` and ``telemetry.profiler``. The committee
verifies under ``HOTSTUFF_CRYPTO_BACKEND``, whose default here is ``cuda``:
without a card the script raises before the committee starts and prints no
table. ``main`` takes ``argv``; there is no ``sys.path`` edit. On the H100
host pass a ``--base-port`` below 16000 (the committee binds ``--nodes``
ports from it).
"""

from __future__ import annotations

import argparse
import asyncio

from hotstuff_tpu_torch.utils.device import resolve_backend_card



def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--nodes", type=int, default=40)
    p.add_argument("--rounds", type=int, default=15)
    p.add_argument("--base-port", type=int, default=22000)
    p.add_argument("--interval-ms", type=float, default=2.0)
    p.add_argument("--top", type=int, default=35)
    p.add_argument(
        "--by-stage", action="store_true",
        help="break the table down by round-trace stage tag "
        "(requires telemetry marks; enabled automatically)",
    )
    args = p.parse_args(argv)
    resolve_backend_card()

    from hotstuff_tpu_torch.benchmark.committee_scale import run_committee
    from hotstuff_tpu_torch import telemetry
    from hotstuff_tpu_torch.telemetry import profiler as pyprof

    telemetry.enable()  # the stage tags come from RoundTrace marks
    profiler = pyprof.SamplingProfiler(interval_ms=args.interval_ms)
    profiler.start(mode="auto")
    try:
        per_round, _ = asyncio.run(
            run_committee(args.nodes, args.rounds, args.base_port, 30_000)
        )
    finally:
        profiler.stop()

    print(
        f"\ncommittee={args.nodes} protocol: {per_round * 1e3:.1f} ms/round; "
        f"{profiler.samples} samples @ {args.interval_ms} ms "
        f"({profiler.mode} mode, whole run incl. boot); "
        f"GIL delay {profiler.gil_delay_ns / 1e6:.1f} ms"
    )

    if args.by_stage:
        per_stage = {
            stage or "(untagged)": n
            for stage, n in profiler.stage_totals().items()
        }
        total = sum(per_stage.values()) or 1
        print("\nsamples by round-trace stage:")
        for stage, n in sorted(per_stage.items(), key=lambda kv: -kv[1]):
            print(f"  {stage:<14} {n:>8} ({100 * n / total:5.1f}%)")

    self_c, cum_c, _ = profiler.self_cum()
    total = sum(self_c.values()) or 1
    print(f"\n{'SELF%':>6} {'CUM%':>6}  function")
    for name, n in self_c.most_common(args.top):
        print(
            f"{100 * n / total:6.2f} {100 * cum_c[name] / total:6.2f}  {name}"
        )


if __name__ == "__main__":
    main()
