"""Diagnostic for the in-process committee protocol benchmark.

Boots the same N-validator committee as ``committee_scale --mode protocol``
but keeps handles on every Core and samples progress every few seconds:
per-node round spread, merged-queue depths, commit counts, and asyncio task
count. Used to triage the N=40 stall (round-2 ROADMAP OPEN item).

    python -m hotstuff_tpu_torch.benchmark.diag_protocol --nodes 40 --seconds 60

Port copy of the reference's ``benchmark/diag_protocol.py``: the same
flags, committee and progress lines. It reads each engine's core as
``Consensus.core``, where the reference digs it out of the core task's
coroutine frame. The committee verifies under ``HOTSTUFF_CRYPTO_BACKEND``,
whose default here is ``cuda``: without a card the script raises before
the committee starts and prints no progress. ``main`` takes ``argv``;
there is no ``sys.path`` edit. On the H100 host pass a ``--base-port``
below 16000 (the committee binds ``--nodes`` ports from it).
"""

from __future__ import annotations

import argparse
import asyncio
import time

from hotstuff_tpu_torch.utils.device import resolve_backend_card



async def run(n: int, seconds: float, base_port: int, timeout_delay: int):
    from hotstuff_tpu_torch.consensus import Authority, Committee, Parameters
    from hotstuff_tpu_torch.consensus.consensus import Consensus
    from hotstuff_tpu_torch.crypto import SignatureService, generate_keypair
    from hotstuff_tpu_torch.store import Store

    keys = [generate_keypair() for _ in range(n)]
    committee = Committee(
        authorities={
            pk: Authority(stake=1, address=("127.0.0.1", base_port + i))
            for i, (pk, _) in enumerate(keys)
        }
    )
    params = Parameters(timeout_delay=timeout_delay, batch_vote_verification=True)

    engines, commit_counts, sinks, cores = [], [], [], []
    t_spawn0 = time.perf_counter()
    for idx, (pk, sk) in enumerate(keys):
        rx_mempool: asyncio.Queue = asyncio.Queue()
        tx_mempool: asyncio.Queue = asyncio.Queue()
        tx_commit: asyncio.Queue = asyncio.Queue()
        counter = [0]

        async def drain_mem(q=tx_mempool):
            while True:
                await q.get()

        async def drain_commit(q=tx_commit, c=counter):
            while True:
                await q.get()
                c[0] += 1

        sinks.append(asyncio.create_task(drain_mem()))
        sinks.append(asyncio.create_task(drain_commit()))
        eng = await Consensus.spawn(
            pk, committee, params, SignatureService(sk), Store(),
            rx_mempool, tx_mempool, tx_commit,
        )
        engines.append(eng)
        commit_counts.append(counter)
    print(f"spawned {n} engines in {time.perf_counter() - t_spawn0:.1f}s", flush=True)

    # The port's engine keeps its Core (the reference's reaches into the
    # coro frame of its core task).
    cores.extend(eng.core for eng in engines)

    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        await asyncio.sleep(5)
        rounds = [c.round if c is not None else -1 for c in cores]
        queues = [c.rx_message.qsize() if c is not None else -1 for c in cores]
        commits = [c[0] for c in commit_counts]
        print(
            f"t={time.perf_counter() - t0:5.1f}s "
            f"round min/med/max={min(rounds)}/{sorted(rounds)[n // 2]}/{max(rounds)} "
            f"queue max={max(queues)} sum={sum(queues)} "
            f"commits min/max={min(commits)}/{max(commits)} "
            f"tasks={len(asyncio.all_tasks())}",
            flush=True,
        )

    for e in engines:
        await e.shutdown()
    for s in sinks:
        s.cancel()


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--nodes", type=int, default=40)
    p.add_argument("--seconds", type=float, default=60)
    p.add_argument("--base-port", type=int, default=19000)
    p.add_argument("--timeout", type=int, default=30_000)
    args = p.parse_args(argv)
    resolve_backend_card()
    asyncio.run(run(args.nodes, args.seconds, args.base_port, args.timeout))


if __name__ == "__main__":
    main()
