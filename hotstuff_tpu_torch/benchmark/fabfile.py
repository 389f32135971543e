"""Harness entry points (reference ``benchmark/fabfile.py``): the same task
set — local, remote, create, destroy, kill, plot, aggregate, logs — exposed
both as plain functions (wrappable by fabric if present) and as a CLI:

    python -m hotstuff_tpu_torch.benchmark.fabfile local --nodes 4 --rate 1000 --duration 20
    python -m hotstuff_tpu_torch.benchmark.fabfile local --nodes 4 --faults 1 --rate 600
    python -m hotstuff_tpu_torch.benchmark.fabfile plot

Port copy of the reference's ``benchmark/fabfile.py``, over the port's
``LocalBench``, ``LogParser``, ``RemoteBench``, ``InstanceManager``,
``LogAggregator`` and ``Ploter``. Its tasks, subcommands, flags, printed
lines and files (``results/bench-<f>-<n>-<rate>-<size>.txt``,
``plots/latency-<size>.pdf``, ``plots/tps-<size>.pdf``, relative to the
working directory) are the reference's. What differs: ``local``'s nodes
verify under ``HOTSTUFF_CRYPTO_BACKEND``, whose default here is ``cuda``,
where the reference runs ``LocalBench``'s default ``cpu`` (without a card
the run raises before it starts a process and prints no SUMMARY); ``main``
takes ``argv``; there is no ``sys.path`` edit. ``remote``, ``create``,
``destroy``, ``kill``, ``aggregate`` and ``plot`` import their modules when
they run, so ``local`` and ``logs`` need no matplotlib. ``local`` binds
``LocalBench``'s ports from 9000 and works in ``.bench`` in the working
directory.
"""

from __future__ import annotations

import argparse
import os

from hotstuff_tpu_torch.benchmark.local import LocalBench
from hotstuff_tpu_torch.benchmark.logs import LogParser
from hotstuff_tpu_torch.benchmark.utils import PathMaker, Print


def local(
    nodes: int = 4,
    rate: int = 1_000,
    tx_size: int = 512,
    duration: int = 20,
    faults: int = 0,
    timeout: int = 1_000,
    batch_size: int = 15_000,
    save: bool = False,
):
    """Local benchmark (reference defaults: 4 nodes, 1k tx/s, 512 B, 20 s,
    1 s timeout, 15 kB batches — ``fabfile.py:12-38``)."""
    bench = LocalBench(
        nodes=nodes,
        rate=rate,
        tx_size=tx_size,
        duration=duration,
        faults=faults,
        timeout_delay=timeout,
        batch_size=batch_size,
        crypto_backend=os.environ.get("HOTSTUFF_CRYPTO_BACKEND", "cuda"),
    )
    parser = bench.run()
    print(parser.result())
    if save:
        os.makedirs(PathMaker.results_path(), exist_ok=True)
        parser.print_to(PathMaker.result_file(faults, nodes, rate, tx_size))
    return parser


def remote(hosts: list[str], rate: int = 10_000, tx_size: int = 512, duration: int = 60, faults: int = 0):
    """Remote benchmark over SSH hosts (reference ``fabfile.py:96-122``)."""
    from hotstuff_tpu_torch.benchmark.remote import RemoteBench
    from hotstuff_tpu_torch.benchmark.settings import Settings

    settings = Settings.load()
    bench = RemoteBench(settings, hosts)
    parser = bench.run(rate=rate, tx_size=tx_size, duration=duration, faults=faults)
    print(parser.result())
    return parser


def create(instances: int = 2):
    """Create AWS testbed instances (requires boto3)."""
    from hotstuff_tpu_torch.benchmark.instance import InstanceManager
    from hotstuff_tpu_torch.benchmark.settings import Settings

    InstanceManager(Settings.load()).create(instances)


def destroy():
    from hotstuff_tpu_torch.benchmark.instance import InstanceManager
    from hotstuff_tpu_torch.benchmark.settings import Settings

    InstanceManager(Settings.load()).terminate()


def kill(hosts: list[str]):
    from hotstuff_tpu_torch.benchmark.remote import RemoteBench
    from hotstuff_tpu_torch.benchmark.settings import Settings

    RemoteBench(Settings.load(), hosts).kill()


def logs(directory: str = "logs", faults: int = 0):
    """Parse an existing log directory into a SUMMARY."""
    parser = LogParser.process(directory, faults=faults)
    print(parser.result())
    return parser


def aggregate(results_dir: str | None = None):
    from hotstuff_tpu_torch.benchmark.aggregate import LogAggregator

    agg = LogAggregator(results_dir)
    for path in agg.print_series():
        Print.info(f"wrote {path}")


def plot(results_dir: str | None = None, tx_size: int = 512):
    from hotstuff_tpu_torch.benchmark.plot import Ploter

    ploter = Ploter(results_dir)
    Print.info(f"wrote {ploter.plot_latency([0, 1, 3], [4, 10, 20, 50], tx_size)}")
    Print.info(f"wrote {ploter.plot_tps([0], tx_size)}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="hotstuff_tpu_torch.benchmark.fabfile")
    sub = p.add_subparsers(dest="task", required=True)

    pl = sub.add_parser("local")
    pl.add_argument("--nodes", type=int, default=4)
    pl.add_argument("--rate", type=int, default=1_000)
    pl.add_argument("--tx-size", type=int, default=512)
    pl.add_argument("--duration", type=int, default=20)
    pl.add_argument("--faults", type=int, default=0)
    pl.add_argument("--timeout", type=int, default=1_000)
    pl.add_argument("--save", action="store_true")

    pr = sub.add_parser("remote")
    pr.add_argument("--hosts", nargs="+", required=True)
    pr.add_argument("--rate", type=int, default=10_000)
    pr.add_argument("--tx-size", type=int, default=512)
    pr.add_argument("--duration", type=int, default=60)
    pr.add_argument("--faults", type=int, default=0)

    pk = sub.add_parser("kill")
    pk.add_argument("--hosts", nargs="+", required=True)

    plog = sub.add_parser("logs")
    plog.add_argument("--dir", default="logs")
    plog.add_argument("--faults", type=int, default=0)

    sub.add_parser("aggregate")
    pp = sub.add_parser("plot")
    pp.add_argument("--tx-size", type=int, default=512)

    args = p.parse_args(argv)
    if args.task == "local":
        local(
            nodes=args.nodes,
            rate=args.rate,
            tx_size=args.tx_size,
            duration=args.duration,
            faults=args.faults,
            timeout=args.timeout,
            save=args.save,
        )
    elif args.task == "remote":
        remote(args.hosts, args.rate, args.tx_size, args.duration, args.faults)
    elif args.task == "kill":
        kill(args.hosts)
    elif args.task == "logs":
        logs(args.dir, args.faults)
    elif args.task == "aggregate":
        aggregate()
    elif args.task == "plot":
        plot(tx_size=args.tx_size)


if __name__ == "__main__":
    main()
