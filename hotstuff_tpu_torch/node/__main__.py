"""Node CLI (reference ``node/src/main.rs:27-163``), port of
``hotstuff_tpu/node/__main__.py``:

- ``keys --filename FILE``: generate a keypair file
- ``run --keys K --committee C --store DIR [--parameters P]``: run one node
- ``deploy --nodes N [--port P]``: in-process local testbed of N >= 4 nodes

The certificate path's backend comes from ``HOTSTUFF_CRYPTO_BACKEND``
(``cuda`` unset; ``cuda-batched``, ``cpu``, ``cpu-batched``). The mempool's
digest kernel runs on the default card when the parameters turn
``device_batch_digests`` on.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import sys

from hotstuff_tpu_torch.utils.logging import setup_logging

from .config import Committee, Parameters, Secret
from .node import Node

log = logging.getLogger("node")


def cmd_keys(args) -> None:
    Secret.new().write(args.filename)


async def _run_node(args) -> None:
    node = await Node.new(
        args.committee,
        args.keys,
        args.store,
        parameters_file=args.parameters,
        benchmark=True,
    )
    await node.analyze_block()


async def _deploy(nodes: int, base_port: int) -> None:
    """In-process local testbed (reference ``main.rs:103-163``): committee of
    N nodes on 127.0.0.1 with consensus/front/mempool port blocks."""
    import tempfile

    from hotstuff_tpu_torch.consensus import Authority as CAuth
    from hotstuff_tpu_torch.consensus import Committee as CCommittee
    from hotstuff_tpu_torch.mempool import Authority as MAuth
    from hotstuff_tpu_torch.mempool import Committee as MCommittee

    if nodes < 4:
        raise SystemExit("local testbeds require at least 4 nodes")
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
    tmp = tempfile.mkdtemp(prefix="hotstuff_deploy_")
    committee_file = f"{tmp}/committee.json"
    Committee(consensus, mempool).write(committee_file)
    started = []
    for i, s in enumerate(secrets):
        key_file = f"{tmp}/node_{i}.json"
        s.write(key_file)
        node = await Node.new(committee_file, key_file, f"{tmp}/db_{i}")
        started.append(node)
        print(f"Node {i} booted on 127.0.0.1:{base_port + 100 + i}")
    await asyncio.gather(*[n.analyze_block() for n in started])


def main() -> None:
    parser = argparse.ArgumentParser(
        prog="hotstuff_tpu_torch.node",
        description="2-chain HotStuff with certificate verification on an NVIDIA card.",
    )
    parser.add_argument("-v", action="count", default=2, dest="verbosity")
    sub = parser.add_subparsers(dest="command", required=True)

    p_keys = sub.add_parser("keys", help="generate a new keypair file")
    p_keys.add_argument("--filename", required=True)

    p_run = sub.add_parser("run", help="run a single node")
    p_run.add_argument("--keys", required=True)
    p_run.add_argument("--committee", required=True)
    p_run.add_argument("--store", required=True)
    p_run.add_argument("--parameters", default=None)

    p_deploy = sub.add_parser("deploy", help="in-process local testbed")
    p_deploy.add_argument("--nodes", type=int, required=True)
    p_deploy.add_argument("--port", type=int, default=25000)

    args = parser.parse_args()
    setup_logging(args.verbosity)

    try:
        if args.command == "keys":
            cmd_keys(args)
        elif args.command == "run":
            asyncio.run(_run_node(args))
        elif args.command == "deploy":
            asyncio.run(_deploy(args.nodes, args.port))
    except KeyboardInterrupt:
        sys.exit(0)


if __name__ == "__main__":
    main()
