"""CPU profile of the protocol plane: run a 4-node in-process committee
plus an in-process load generator under cProfile and print the hottest
functions. This is the latency diagnosis tool for the single-core regime
(every node shares the core, so CPU-per-round IS the round latency).

    python -m hotstuff_tpu_torch.benchmark.profile_protocol --seconds 20 --rate 1000

Port copy of the reference's ``benchmark/profile_protocol.py``: the same
flags, committee (four port ``Node``s in one process, on their own stores,
with the in-process load generator) and printed ``pstats`` table. The
nodes verify under ``HOTSTUFF_CRYPTO_BACKEND``, whose default here is
``cuda``: without a card the script raises before a node starts and prints
no table. ``main`` takes ``argv``; there is no ``sys.path`` edit. On the
H100 host pass a ``--base-port`` below 16000 (the nodes bind base to
base + 3, base + 100 to base + 103 and base + 200 to base + 203).
"""

from __future__ import annotations

import argparse
import asyncio
import cProfile
import io
import os
import pstats
import tempfile

from hotstuff_tpu_torch.utils.device import resolve_backend_card



async def _run(seconds: int, rate: int, tx_size: int, base_port: int) -> None:
    from hotstuff_tpu_torch.consensus import Authority as CAuth
    from hotstuff_tpu_torch.consensus import Committee as CCommittee
    from hotstuff_tpu_torch.consensus import Parameters as CParams
    from hotstuff_tpu_torch.mempool import Authority as MAuth
    from hotstuff_tpu_torch.mempool import Committee as MCommittee
    from hotstuff_tpu_torch.mempool import Parameters as MParams
    from hotstuff_tpu_torch.node.config import Committee, Parameters, Secret
    from hotstuff_tpu_torch.node.node import Node

    nodes = 4
    secrets = [Secret.new() for _ in range(nodes)]
    consensus = CCommittee(
        authorities={
            s.name: CAuth(stake=1, address=("127.0.0.1", base_port + i))
            for i, s in enumerate(secrets)
        }
    )
    mempool = MCommittee(
        authorities={
            s.name: MAuth(
                stake=1,
                transactions_address=("127.0.0.1", base_port + 100 + i),
                mempool_address=("127.0.0.1", base_port + 200 + i),
            )
            for i, s in enumerate(secrets)
        }
    )
    tmp = tempfile.mkdtemp(prefix="hotstuff_prof_")
    committee_file = f"{tmp}/committee.json"
    Committee(consensus, mempool).write(committee_file)
    params_file = f"{tmp}/parameters.json"
    Parameters(
        CParams(timeout_delay=2_000),
        MParams(batch_size=15_000, max_batch_delay=10),
    ).write(params_file)

    started = []
    for i, s in enumerate(secrets):
        key_file = f"{tmp}/node_{i}.json"
        s.write(key_file)
        node = await Node.new(
            committee_file, key_file, f"{tmp}/db_{i}", params_file
        )
        started.append(node)
    sinks = [asyncio.create_task(n.analyze_block()) for n in started]

    # In-process open-loop load generator against every front port.
    async def load(i: int) -> None:
        import random
        import struct

        _, writer = await asyncio.open_connection("127.0.0.1", base_port + 100 + i)
        counter = 0
        per_burst = max(1, rate // nodes // 20)
        while True:
            for _ in range(per_burst):
                tx = struct.pack(">BQ", 1, random.getrandbits(63)).ljust(
                    tx_size, b"\x00"
                )
                writer.write(len(tx).to_bytes(4, "big") + tx)
                counter += 1
            await writer.drain()
            await asyncio.sleep(0.05)

    loaders = [asyncio.create_task(load(i)) for i in range(nodes)]
    await asyncio.sleep(seconds)
    for t in [*loaders, *sinks]:
        t.cancel()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seconds", type=int, default=20)
    p.add_argument("--rate", type=int, default=1_000)
    p.add_argument("--tx-size", type=int, default=512)
    p.add_argument("--base-port", type=int, default=21000)
    p.add_argument("--top", type=int, default=35)
    p.add_argument("--sort", default="cumulative", choices=["cumulative", "tottime"])
    args = p.parse_args(argv)
    resolve_backend_card()

    prof = cProfile.Profile()
    prof.enable()
    try:
        asyncio.run(_run(args.seconds, args.rate, args.tx_size, args.base_port))
    except (KeyboardInterrupt, asyncio.CancelledError):
        pass
    prof.disable()
    out = io.StringIO()
    stats = pstats.Stats(prof, stream=out)
    stats.strip_dirs().sort_stats(args.sort).print_stats(args.top)
    print(out.getvalue())


if __name__ == "__main__":
    main()
