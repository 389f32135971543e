"""Time the kernels of one source tree at the main path's shapes.

    python3 hotstuff_tpu_torch/utils/kernel_times.py [--tree DIR] [--label NAME]
        [--window-groups 1,2,4]

Imports ``hotstuff_tpu_torch`` from ``DIR`` (default: the checkout that
holds this file), builds its kernels and times each one on the card
through its wrapper, at the shapes of a cached N = 1000 QC (decompression
or, in a tree that predates it, the K1 root over 1024 fresh lanes; K2 at
33 and 64 windows over 1024 lanes, K3 at [16, 33] and [16, 64], the
verdict over 1024 lanes with two points) and of the uncached fallback
(decompression over 2048 lanes, K4 over 2048 lanes, K3 at [32, 64], the
verdict over 2048 lanes with one point). Inputs are radix-2^13 limbs and
digits drawn from ``--seed``; the kernels' work does not depend on the
values, but for the decompression's one conditional mul. So two trees, say a
commit and its parent unpacked with ``git archive``, can be timed in turns
within one call on one card (parent, change, change, parent). Prints one
JSON line: ``{"label", "card", "kernels": [{"name", "shape", "ms",
"events_ms", "profiler_ms"}]}``.

``kernel_ms`` is also ``chip_smoke.py``'s kernel timer.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def kernel_ms(fn, iters: int, kernel_name: str) -> tuple[float, float, float]:
    """(ms, events_ms, profiler_ms) per call of ``fn``, which launches the
    kernel whose name contains ``kernel_name`` once.

    ``events_ms``: CUDA events around ``iters`` back-to-back calls, after a
    warm-up call; it includes any gap where the card waits for the host to
    issue the next launch. ``profiler_ms``: the kernel's mean device time in
    a ``torch.profiler`` trace of another ``iters`` calls. ``ms`` is the
    events' figure, or the profiler's where the two differ by more than 10%
    (then the host, not the kernel, set the pace of the events' run)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    events_ms = start.elapsed_time(end) / iters
    # The profiler may drop events of a window (once on the H100 it saw 3
    # launches of 10): a window that saw fewer than half is traced again.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        durs = [
            (e.time_range.end - e.time_range.start) / 1e3
            for e in prof.events()
            if e.device_type == DeviceType.CUDA and kernel_name in e.name
        ]
        if iters // 2 <= len(durs) <= iters:
            break
    else:
        raise RuntimeError(f"profiler saw {len(durs)} launches of {kernel_name}, expected {iters}")
    profiler_ms = sum(durs) / len(durs)
    ms = profiler_ms if abs(events_ms - profiler_ms) > 0.1 * profiler_ms else events_ms
    return ms, events_ms, profiler_ms


# Kernel names as the profiler reports them (a substring of each).
PROFILER_NAMES = {
    "decompress": "decompress_kernel",
    "sqrt_pow": "sqrt_pow_kernel",
    "msm_partials_signed": "msm_partials_kernel<true>",
    "msm_partials": "msm_partials_kernel<false>",
    "msm_combine": "msm_combine_kernel",
    "verdict": "verdict_kernel",
    "sha512": "sha512_kernel",
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--label", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--window-groups", default="",
                    help="also time K2 at each of these windows-per-CTA values (comma-separated)")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.tree).resolve()))
    from hotstuff_tpu_torch.ops import msm_kernels as mk

    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)

    def limbs(shape):
        return torch.from_numpy(rng.integers(0, 8192, size=shape).astype(np.int32)).to(dev)

    def digits(windows, m, signed):
        low, high = (-8, 9) if signed else (0, 16)
        return torch.from_numpy(rng.integers(low, high, size=(windows, m)).astype(np.int32)).to(dev)

    def signs(m):
        return torch.from_numpy(rng.integers(0, 2, size=m).astype(np.int32)).to(dev)

    rows = []

    def timed(name, shape, fn):
        ms, ev, pr = kernel_ms(fn, args.iters, PROFILER_NAMES[name])
        rows.append({"name": name, "shape": shape, "ms": ms, "events_ms": ev, "profiler_ms": pr})

    u, v = limbs((1024, 20)), limbs((1024, 20))
    timed("sqrt_pow", "u, v [1024, 20]", lambda: mk.sqrt_pow(u, v))
    if hasattr(mk, "decompress"):  # a tree before it has the root alone
        for m in (1024, 2048):
            y, sg = limbs((m, 20)), signs(m)
            timed("decompress", f"y [{m}, 20]", lambda: mk.decompress(y, sg))
    for windows in (33, 64):
        pts, dg = limbs((1024, 4, 20)), digits(windows, 1024, True)
        timed("msm_partials_signed", f"[1024, 4, 20], {windows} windows",
              lambda: mk.msm_partials(pts, dg, signed=True))
    pts, dg = limbs((2048, 4, 20)), digits(64, 2048, False)
    timed("msm_partials", "[2048, 4, 20], 64 windows", lambda: mk.msm_partials(pts, dg, signed=False))
    for blocks, windows in ((16, 33), (16, 64), (32, 64)):
        part = limbs((blocks, windows, 4, 20))
        timed("msm_combine", f"[{blocks}, {windows}, 4, 20]", lambda: mk.msm_combine(part))
    if hasattr(mk, "verdict"):
        a, b = limbs((4, 20)), limbs((4, 20))
        for m, pts in ((1024, (a, b)), (2048, (a,))):
            ok = torch.ones(m, dtype=torch.bool, device=dev)
            timed("verdict", f"ok [{m}], {len(pts)} point(s)", lambda: mk.verdict(ok, *pts))

    for group in filter(None, args.window_groups.split(",")):
        # The wrappers read the module's constant at each call.
        mk.PARTIALS_WINDOW_GROUP = int(group)
        for windows in (33, 64):
            pts, dg = limbs((1024, 4, 20)), digits(windows, 1024, True)
            timed("msm_partials_signed", f"[1024, 4, 20], {windows} windows, group {group}",
                  lambda: mk.msm_partials(pts, dg, signed=True))

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"label": args.label, "tree": args.tree, "card": card, "kernels": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
