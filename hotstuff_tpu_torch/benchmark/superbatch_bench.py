"""Superbatching cost/benefit measurement, on the port.

Port copy of the reference's ``benchmark/superbatch_bench.py``, over the
port's ``crypto/ed25519_ref.py`` and ``crypto/batching.py``. Its flags,
printed lines and result-file name are the reference's. One default
differs: the inner backend is the one ``HOTSTUFF_CRYPTO_BACKEND`` names,
``cuda`` when it is unset (the reference's default is ``cpu``), so a run
that does not name ``cpu`` verifies on the card and raises without one.
``main`` takes ``argv`` and returns the printed lines. Nothing is left out.

Two questions, answered with numbers:

1. **Lone-QC latency**: what does the superbatch wrapper add to a single
   isolated QC verification? (A fixed collection window would add its
   length; the back-pressure design should make it ~zero.)
2. **Contended throughput**: committee-1000 vote-rate regime — many
   concurrent QC verifications from worker threads (the crypto bridge's
   executor). How much does fusion amortize, and what fusion ratio is
   achieved?

Appends to ``<output>/superbatch-bench-<backend>.txt`` with ``--output``.

    python -m hotstuff_tpu_torch.benchmark.superbatch_bench --output results
"""

from __future__ import annotations

import argparse
import os
import random
import time
from concurrent.futures import ThreadPoolExecutor


def make_qc_batches(n_qcs: int, qc_size: int, seed: int = 5):
    from hotstuff_tpu_torch.crypto import ed25519_ref as ref

    rng = random.Random(seed)
    out = []
    for _ in range(n_qcs):
        msgs, pubs, sigs = [], [], []
        digest = rng.randbytes(32)
        for _ in range(qc_size):
            sk = rng.randbytes(32)
            pubs.append(ref.secret_to_public(sk))
            msgs.append(digest)
            sigs.append(ref.sign(sk, digest))
        out.append((msgs, pubs, sigs))
    return out


def main(argv=None) -> list[str]:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--output", help="directory to append the result file to")
    p.add_argument("--qc-size", type=int, default=67, help="2f+1 at N=100")
    p.add_argument("--qcs", type=int, default=24)
    p.add_argument("--threads", type=int, default=8)
    args = p.parse_args(argv)

    from hotstuff_tpu_torch.crypto import get_backend, set_backend
    from hotstuff_tpu_torch.crypto.batching import BatchingBackend

    set_backend(os.environ.get("HOTSTUFF_CRYPTO_BACKEND", "cuda"))
    inner = get_backend()
    wrapped = BatchingBackend(inner)

    lines = [f"qc_size={args.qc_size} qcs={args.qcs} threads={args.threads} inner={inner.name}"]

    # 1. Lone-QC latency, plain vs wrapped (median of 30).
    (lone,) = make_qc_batches(1, args.qc_size, seed=7)
    for name, backend in (("plain", inner), ("superbatch", wrapped)):
        backend.verify_batch(*lone)  # warm
        samples = []
        for _ in range(30):
            t0 = time.perf_counter()
            backend.verify_batch(*lone)
            samples.append(time.perf_counter() - t0)
        med = sorted(samples)[len(samples) // 2]
        lines.append(f"lone-QC {name}: {med * 1e3:.3f} ms median")
        print(lines[-1], flush=True)

    # 2. Contended throughput: N concurrent QC verifications.
    qcs = make_qc_batches(args.qcs, args.qc_size, seed=8)
    for name, backend in (("plain", inner), ("superbatch", wrapped)):
        with ThreadPoolExecutor(args.threads) as ex:
            list(ex.map(lambda q: backend.verify_batch(*q), qcs))  # warm
            t0 = time.perf_counter()
            list(ex.map(lambda q: backend.verify_batch(*q), qcs))
            dt = time.perf_counter() - t0
        total_sigs = args.qcs * args.qc_size
        line = (
            f"contended {name}: {dt * 1e3:.1f} ms for {args.qcs} QCs "
            f"({dt / total_sigs * 1e6:.2f} us/sig)"
        )
        if name == "superbatch":
            line += (
                f" fusion: {wrapped.fused_requests} requests in "
                f"{wrapped.inner_calls} inner calls"
            )
        lines.append(line)
        print(line, flush=True)

    if args.output:
        os.makedirs(args.output, exist_ok=True)
        path = os.path.join(args.output, f"superbatch-bench-{inner.name}.txt")
        with open(path, "a") as f:
            f.write("\n".join(lines) + "\n")
    return lines


if __name__ == "__main__":
    main()
