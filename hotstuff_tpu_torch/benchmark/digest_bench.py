"""Device vs host SHA-512 batch digesting (BASELINE config 3 decision), on
the port.

Port copy of the reference's ``benchmark/digest_bench.py``. Its flags,
printed lines and result-file name are the reference's. What changed: the
device path is the port's ``ops/sha512.py`` ``sha512_32_batch`` (the
``csrc/sha512.cu`` kernel), there is no XLA compile cache to enable, and
``--platform`` takes ``cuda`` (the default) or ``cpu`` in place of a jax
platform. ``cpu`` runs the kernel's plain PyTorch version because the caller
asked for it; without a card the default raises. ``backend=`` is the torch
device type, so results go to ``digest-bench-cuda.txt``. The assertion that
the device digests equal ``hashlib``'s stays.

Measures the mempool Processor's two digest paths at a drain of K batches
of S bytes each (the ``device_batch_digests`` opportunistic drain,
``mempool/processor.py``): host hashlib per batch vs one batched device
dispatch. Emits one line per configuration and a recommendation, appended
to ``<output>/digest-bench-<backend>.txt`` with ``--output``.

    python -m hotstuff_tpu_torch.benchmark.digest_bench --output results
"""

from __future__ import annotations

import argparse
import hashlib
import os
import random
import time


def bench(k: int, size: int, iters: int = 5, device="cuda") -> tuple[float, float]:
    """Returns (host_s, device_s) to digest k batches of `size` bytes."""
    from hotstuff_tpu_torch.ops.sha512 import sha512_32_batch

    rng = random.Random(42)
    batches = [rng.randbytes(size) for _ in range(k)]

    # Correctness first: the device path must match hashlib bit-for-bit.
    dev = sha512_32_batch(batches, device)
    host = [hashlib.sha512(b).digest()[:32] for b in batches]
    assert list(dev) == host, "device SHA-512 diverges from hashlib"

    t0 = time.perf_counter()
    for _ in range(iters):
        [hashlib.sha512(b).digest()[:32] for b in batches]
    host_s = (time.perf_counter() - t0) / iters

    sha512_32_batch(batches, device)  # warm (kernel library loaded)
    t0 = time.perf_counter()
    for _ in range(iters):
        sha512_32_batch(batches, device)
    device_s = (time.perf_counter() - t0) / iters
    return host_s, device_s


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--output", help="directory to append the result file to")
    p.add_argument("--sizes", default="512,15000,500000")
    p.add_argument("--drains", default="8,32,128")
    p.add_argument(
        "--platform",
        default="cuda",
        choices=["cuda", "cpu"],
        help="where the device path runs: cuda (the card, the default) or "
        "cpu (the kernel's plain PyTorch version, only when asked for)",
    )
    args = p.parse_args(argv)

    from hotstuff_tpu_torch.utils.device import resolve

    backend = resolve(args.platform).type
    lines = []
    wins = 0
    total = 0
    for size in (int(s) for s in args.sizes.split(",")):
        for k in (int(d) for d in args.drains.split(",")):
            host_s, dev_s = bench(k, size, device=args.platform)
            total += 1
            wins += dev_s < host_s
            lines.append(
                f"digest k={k} size={size}B backend={backend}: "
                f"host {host_s * 1e3:.2f} ms, device {dev_s * 1e3:.2f} ms "
                f"({host_s / dev_s:.2f}x)"
            )
            print(lines[-1], flush=True)
    rec = (
        "RECOMMEND device_batch_digests=True"
        if wins > total / 2
        else "RECOMMEND device_batch_digests=False (host hashing wins here)"
    )
    lines.append(f"{rec} [{wins}/{total} device wins]")
    print(lines[-1])
    if args.output:
        os.makedirs(args.output, exist_ok=True)
        path = os.path.join(args.output, f"digest-bench-{backend}.txt")
        with open(path, "a") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
