"""Device-side profile of the QC batch-verify pipeline.

Decomposes the per-batch device time into stages (decompress root /
kernel A partials / kernel B combine / full pipeline) by timing each
stage on device-resident inputs as a pipelined stream, which cancels the
host's launch latency the same way the bench does.

Usage: python -m hotstuff_tpu_torch.benchmark.profile_device [n_sigs]

Port of the reference's ``benchmark/profile_device.py``, which times the
JAX package's jitted stages. This one times the port's uncached path
(``ops/verify.py``'s ``verify_batch_device`` after host prep) on the card,
stage by stage under the reference's names, on the same batch
(``bench_torch.make_batch`` and ``prepare_batch`` with ``random.Random(7)``;
run from the repository's root, as the reference runs from its):

- ``full_pipeline``: ``run_uncached`` (K1, K4 + K3, the verdict);
- ``unpack``: ``_unpack_device``;
- ``decompress(all)``: the unpacking and K1 (``csrc/decompress.cu``);
- ``sqrt_pow_only``: the root alone, ``msm_kernels.sqrt_pow``
  (``csrc/sqrt_pow.cu``), on (u, v) from the unpacked y;
- ``msm``: ``msm_kernels.msm``, K4 + K3;
- ``cofactor_check``: ``msm_kernels.verdict`` on the MSM's one point;
- ``kernelA_partials``: K4, ``msm_partials`` unsigned;
- ``kernelB_combine``: K3, ``msm_combine``.

Each stage is timed as the reference times it (two warm-up calls, then the
best of three rounds of 16 back-to-back calls), with
``torch.cuda.synchronize()`` in place of ``block_until_ready``. What
differs: the two kernel rows are always printed (the reference prints
them only under ``jax.default_backend() == "tpu"``, where its Pallas
kernels run; the port's kernels are always on the card), followed by the
kernels' launch geometry where the reference prints ``(pallas block=...
grid=...)``; ``main`` takes ``argv`` and ``device``, whose default is the
card (without one it raises before any work); ``device="cpu"`` runs the
kernels' plain versions on the host because it was asked to. ``main``
returns each stage's seconds a call and the kernel launches it made
(``msm_kernels.LAUNCHES`` deltas over its timing).
"""

from __future__ import annotations

import random
import sys
import time

import torch

from hotstuff_tpu_torch.utils.device import resolve

#: calls before the clock, rounds of calls, calls a round (the best round is kept).
WARMUP, ROUNDS, ITERS = 2, 3, 16

#: the stages in the reference's order.
STAGES = (
    "full_pipeline", "unpack", "decompress(all)", "sqrt_pow_only", "msm",
    "cofactor_check", "kernelA_partials", "kernelB_combine",
)


def timed(fn, *args, sync=torch.cuda.synchronize) -> float:
    """The best of ``ROUNDS`` rounds of ``ITERS`` back-to-back calls on
    device-resident args, after ``WARMUP`` calls; seconds per call."""
    for _ in range(WARMUP):
        fn(*args)
    sync()
    best = float("inf")
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        for _ in range(ITERS):
            fn(*args)
        sync()
        best = min(best, (time.perf_counter() - t0) / ITERS)
    return best


def stage_calls(dev_packed: torch.Tensor) -> dict:
    """Each stage's (function, args) on the packed [m, 65] batch already on
    its device, as the reference builds them, in ``STAGES`` order."""
    from hotstuff_tpu_torch.ops import curve as cv
    from hotstuff_tpu_torch.ops import msm_kernels as mk
    from hotstuff_tpu_torch.ops import verify as ov

    def decomp(p):
        y, s, _ = ov._unpack_device(p)
        return mk.decompress(y, s)

    y_limbs, _, digits = ov._unpack_device(dev_packed)
    ok, pts = decomp(dev_packed)
    u, v = cv.decompress_ratio(y_limbs)
    acc = mk.msm(pts, digits)
    wsums = mk.msm_partials(pts, digits, signed=False)
    return {
        "full_pipeline": (ov.run_uncached, (dev_packed,)),
        "unpack": (ov._unpack_device, (dev_packed,)),
        "decompress(all)": (decomp, (dev_packed,)),
        "sqrt_pow_only": (mk.sqrt_pow, (u, v)),
        "msm": (mk.msm, (pts, digits)),
        "cofactor_check": (mk.verdict, (ok, acc)),
        "kernelA_partials": (lambda p, d: mk.msm_partials(p, d, signed=False), (pts, digits)),
        "kernelB_combine": (mk.msm_combine, (wsums,)),
    }


def geometry(m: int) -> str:
    """K4's and K3's launch geometry at ``m`` lanes (the reference prints
    its Pallas block and grid here)."""
    from hotstuff_tpu_torch.ops import msm_kernels as mk

    block = min(mk.PARTIALS_BLOCK, m)
    p_grid, p_threads = mk.partials_geometry(m, 64, block)
    c_grid, c_threads = mk.combine_geometry(64)
    return (f"(cuda K4 block={block} grid={p_grid} x {p_threads} threads; "
            f"K3 grid={c_grid} x {c_threads} threads)")


def main(argv=None, device="cuda") -> dict:
    argv = sys.argv[1:] if argv is None else argv
    n_sigs = int(argv[0]) if argv else 1343
    dev = resolve(device)

    import bench_torch

    from hotstuff_tpu_torch.ops import msm_kernels as mk
    from hotstuff_tpu_torch.ops.verify import prepare_batch

    msgs, pubs, sigs = bench_torch.make_batch(n_sigs)
    packed, m = prepare_batch(msgs, pubs, sigs, _rng=random.Random(7))
    print(f"n_sigs={n_sigs} lanes={m}")

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    dev_packed = torch.from_numpy(packed).to(dev)
    stages = stage_calls(dev_packed)
    sync()

    results = {}
    for name, (fn, args) in stages.items():
        before = dict(mk.LAUNCHES)
        s = timed(fn, *args, sync=sync)
        results[name] = {"s": s, "launches": {
            k: v - before[k] for k, v in mk.LAUNCHES.items() if v != before[k]}}
        print(f"{name:18s} {s * 1e3:9.3f} ms/batch  {s / n_sigs * 1e6:7.2f} us/sig")
    print(geometry(m))
    return results


if __name__ == "__main__":
    main()
