"""Async bridge between the consensus event loop and the crypto plane.

Port copy of ``hotstuff_tpu/consensus/crypto_bridge.py``, with its
profiler tagging (a worker thread's verification samples under the
``verify`` stage) and, when ``telemetry.stages`` is armed, the spans
``crypto.bridge.queue`` (submission until a worker starts the job) and
``crypto.bridge.resume`` (the worker's return until the awaiting task
resumes). The Core's select loop must never block on signature
verification: a QC verification is a batch crypto call that, on the CUDA
backend, involves a host-to-card round trip. The bridge runs verifications
on a small worker pool and the Core awaits them, so network handling,
timeouts and other protocol work continue while the card (or CPU)
verifies.

One difference from the reference, by design: the reference judges a
backend blocking when its name holds ``"tpu"``; the port's card backends
are named ``"cuda"`` and ``"cuda+superbatch"``, so the port looks for
``"cuda"``. A literal copy would run every small verification (a vote, a
timeout, a proposal at N <= 64) inline on the event loop, card included.
"""

from __future__ import annotations

import asyncio
import os
import time
from concurrent.futures import ThreadPoolExecutor

from hotstuff_tpu_torch.telemetry import profiler as pyprof
from hotstuff_tpu_torch.telemetry import stages

_EXECUTOR: ThreadPoolExecutor | None = None


def _executor() -> ThreadPoolExecutor:
    global _EXECUTOR
    if _EXECUTOR is None:
        # Default 2 workers: one verification in flight while the next
        # batch's host prep runs. Raise HOTSTUFF_CRYPTO_WORKERS when
        # super-batching (crypto/batching.py) should fuse more concurrent
        # requests — e.g. many in-process validators sharing one card.
        raw = os.environ.get("HOTSTUFF_CRYPTO_WORKERS", "2")
        try:
            workers = int(raw)
            if workers < 1:
                raise ValueError(raw)
        except ValueError:
            raise ValueError(
                f"HOTSTUFF_CRYPTO_WORKERS must be a positive integer, got {raw!r}"
            ) from None
        _EXECUTOR = ThreadPoolExecutor(max_workers=workers, thread_name_prefix="crypto")
    return _EXECUTOR


def _backend_blocks() -> bool:
    """True when the active crypto backend can block the loop for long
    (card round trips, super-batching pools)."""
    from hotstuff_tpu_torch.crypto import get_backend

    return "cuda" in getattr(get_backend(), "name", "")


# Below this many signatures a CPU verification is cheap enough (sub-ms)
# that the executor hop (queue + thread wake + GIL churn, straight on the
# vote path) costs more than running it inline. Above it an inline call
# head-of-line-blocks timers, ACK pumps and network reads.
INLINE_SIG_LIMIT = 64


async def verify_off_loop(verify_fn, *args, n_sigs: int = 1):
    """Run a blocking verification callable without head-of-line-blocking
    the event loop; re-raises its exception (ConsensusError/CryptoError) in
    the awaiting task. Card-backed verifications and large CPU batches
    (``n_sigs >= INLINE_SIG_LIMIT``) go to the worker pool; small CPU ones
    run inline (see ``INLINE_SIG_LIMIT``)."""
    if not _backend_blocks() and n_sigs < INLINE_SIG_LIMIT:
        return verify_fn(*args)
    loop = asyncio.get_running_loop()
    armed = stages.ARMED
    submitted = time.perf_counter_ns() if armed else 0
    returned = 0

    def work():
        # On a crypto worker thread: the profiler's ``verify`` tag, so the
        # thread's stack samples join the trace's verify edge instead of
        # landing unstaged, and the bridge's spans when the stages are armed.
        nonlocal returned
        if armed:
            stages.interval("crypto.bridge.queue", submitted, time.perf_counter_ns())
        try:
            if pyprof.TAGGING:
                with pyprof.stage("verify"):
                    return verify_fn(*args)
            return verify_fn(*args)
        finally:
            if armed:
                returned = time.perf_counter_ns()

    try:
        return await loop.run_in_executor(_executor(), work)
    finally:
        if returned:
            stages.interval("crypto.bridge.resume", returned, time.perf_counter_ns())
