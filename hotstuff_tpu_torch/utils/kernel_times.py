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
verdict over 2048 lanes with one point), and the SHA-512 kernel at
``chip_smoke.py`` phase 10b's drains (the reference digest bench's 8, 32
and 128 lanes of 512 B, 15 kB and 500 kB, 128 mempool batches of 12-30
transactions of 512 B, and the node path's 1024 x 96 B, 2 and 3 x 15 kB
and 18 x 15,485 B), each drain packed by the tree's own ``pack`` (the
layouts differ between trees) and checked against ``hashlib``. Inputs
are radix-2^13 limbs and digits, and message bytes, drawn from
``--seed``; the kernels' work does not depend on the values, but for the
decompression's one conditional mul. So two trees, say a commit and its
parent unpacked with ``git archive``, can be timed in turns within one
call on one card (parent, change, change, parent). Beside each SHA-512
drain, the whole ``sha512_32_batch`` of the tree (host clock, median of
7) and, in a tree whose pack has two routes, the pack by each (``pack by
join`` and ``pack by copy``, host clock, median of 7: the readings
``JOIN_BELOW`` is chosen from). Prints one JSON line: ``{"label", "card",
"kernels": [{"name", "shape", "ms", "events_ms", "profiler_ms"}]}`` (the
``sha512_32_batch`` and pack rows have ``ms`` only).

``kernel_ms`` is also ``chip_smoke.py``'s kernel timer.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def kernel_ms(fn, iters: int, kernel_name: str) -> tuple[float, float, float]:
    """(ms, events_ms, profiler_ms) per call of ``fn``, which launches the
    kernel whose name contains ``kernel_name`` once.

    ``events_ms``: CUDA events around ``iters`` back-to-back calls, after a
    warm-up call; it includes any gap where the card waits for the host to
    issue the next launch. ``profiler_ms``: the kernel's mean device time in
    a ``torch.profiler`` trace of another ``iters`` calls, or NaN where three
    traces in a row each lost more than half of the launches. ``ms`` is the
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
    # The profiler may drop events of a window (on the H100 it once saw 3
    # launches of 10, and once none of 20 in three traces in a row): a
    # window that saw fewer than half is traced again, and after three such
    # the events' figure stands alone.
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
        return events_ms, events_ms, float("nan")
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
    "verdict_tree": "verdict_tree_kernel",
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

    # Run as a script, Python puts this file's directory first on the path,
    # where utils/logging.py would shadow the standard library's logging.
    here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if not p or Path(p).resolve() != here]
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

    import hashlib
    import random

    from hotstuff_tpu_torch.mempool.messages import encode_batch
    from hotstuff_tpu_torch.ops import sha512 as sha

    mrng = random.Random(args.seed)
    drains = [(f"{lanes} x {size} B", [mrng.randbytes(size) for _ in range(lanes)])
              for lanes in (8, 32, 128) for size in (512, 15_000, 500_000)]
    drains.append(("128 mempool batches of 12-30 x 512-B txs",
                   [encode_batch([b"\x01" + mrng.randbytes(511)
                                  for _ in range(mrng.randint(12, 30))]) for _ in range(128)]))
    drains += [(f"{lanes} x {size} B", [mrng.randbytes(size) for _ in range(lanes)])
               for lanes, size in ((1024, 96), (2, 15_000), (3, 15_000), (18, 15_485))]
    for shape, msgs in drains:
        views = sha.unpack(sha.pack(msgs).to(dev), len(msgs))
        got = [bytes(row) for row in sha.sha512(*views).cpu().numpy()]
        if got != [hashlib.sha512(m).digest() for m in msgs]:
            raise RuntimeError(f"sha512 of {args.tree} differs from hashlib at {shape}")
        ms, ev, pr = kernel_ms(lambda: sha.sha512(*views),
                               5 if sum(map(len, msgs)) > 16_000_000 else args.iters,
                               PROFILER_NAMES["sha512"])
        rows.append({"name": "sha512", "shape": shape, "ms": ms, "events_ms": ev,
                     "profiler_ms": pr})
        # The whole call as the mempool makes it (host clock; median of 7).
        calls = []
        for _ in range(7):
            t = time.perf_counter()
            sha.sha512_32_batch(msgs)
            calls.append((time.perf_counter() - t) * 1e3)
        rows.append({"name": "sha512_32_batch", "shape": shape, "ms": float(np.median(calls))})
        if hasattr(sha, "JOIN_BELOW"):
            # The pack into a staging buffer by each of its two routes, which
            # ``JOIN_BELOW`` chooses between (host clock; median of 7).
            offsets, lengths, total = sha.layout(msgs)
            view = np.empty(total, dtype=np.uint8)
            threshold = sha.JOIN_BELOW
            for route, below in (("join", 1 << 62), ("copy", 0)):
                sha.JOIN_BELOW = below
                packs = []
                for _ in range(7):
                    t = time.perf_counter()
                    sha.pack_into(view, msgs, offsets, lengths)
                    packs.append((time.perf_counter() - t) * 1e3)
                rows.append({"name": f"pack by {route}", "shape": shape,
                             "ms": float(np.median(packs))})
            sha.JOIN_BELOW = threshold

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
