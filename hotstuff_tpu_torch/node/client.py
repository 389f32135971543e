"""Benchmark client: open-loop load generator (reference
``node/src/client.rs``).

Port of ``hotstuff_tpu/node/client.py:37-107`` and ``:413-532``: the legacy
client. It waits for all ``--nodes`` TCP ports, then twice the timeout,
and sends ``rate`` tx/s in 50 ms bursts (PRECISION=20) to one node's
transactions address. Transactions are ``size`` bytes: sample txs start
with byte 0 + a u64 BE counter (one per burst, used for e2e latency);
standard txs start with byte 1 + a random u64. Log lines are the
measurement interface (``client.rs:110,128-131``). Left out: the sharded
(``--shards``, with bundle coalescing) and fleet modes, which feed the
data plane's worker ingress (not ported yet).
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import random
import time

from hotstuff_tpu_torch.network.receiver import write_frame
from hotstuff_tpu_torch.utils.logging import setup_logging

log = logging.getLogger("client")

PRECISION = 20  # bursts per second
BURST_DURATION = 1.0 / PRECISION


async def wait_for_nodes(nodes: list[tuple[str, int]], timeout_ms: int) -> None:
    log.info("Waiting for all nodes to be online...")

    async def probe(addr):
        while True:
            try:
                _, w = await asyncio.open_connection(*addr)
                w.close()
                return
            except OSError:
                await asyncio.sleep(0.01)

    await asyncio.gather(*[probe(a) for a in nodes])
    log.info("Waiting for all nodes to be synchronized...")
    await asyncio.sleep(2 * timeout_ms / 1000)


async def run_client(
    target: tuple[str, int],
    size: int,
    rate: int,
    timeout_ms: int,
    nodes: list[tuple[str, int]],
    duration: float | None = None,
) -> None:
    log.info("Node address: %s:%d", *target)
    # NOTE: these exact log entries are parsed by the benchmark harness.
    log.info("Transactions size: %d B", size)
    log.info("Transactions rate: %d tx/s", rate)
    if size < 9:
        raise ValueError("transaction size must be at least 9 bytes")
    await wait_for_nodes(nodes, timeout_ms)

    _, writer = await asyncio.open_connection(*target)
    burst = max(rate // PRECISION, 1)
    counter = 0
    r = random.getrandbits(64)

    # NOTE: This log entry is used to compute performance.
    log.info("Start sending transactions")

    deadline = time.monotonic() + duration if duration else None
    next_burst = time.monotonic()
    filler = b"\x00" * (size - 9)
    try:
        while deadline is None or time.monotonic() < deadline:
            now = time.monotonic()
            if now < next_burst:
                await asyncio.sleep(next_burst - now)
            burst_start = time.monotonic()
            for x in range(burst):
                if x == counter % burst:
                    # NOTE: This log entry is used to compute performance.
                    log.info("Sending sample transaction %d", counter)
                    tx = b"\x00" + counter.to_bytes(8, "big") + filler
                else:
                    r = (r + 1) & 0xFFFFFFFFFFFFFFFF
                    tx = b"\x01" + r.to_bytes(8, "big") + filler
                write_frame(writer, tx)
            await writer.drain()
            if time.monotonic() - burst_start > BURST_DURATION:
                # NOTE: This log entry is used to compute performance.
                log.warning("Transaction rate too high for this client")
            counter += 1
            next_burst += BURST_DURATION
    except (ConnectionError, OSError) as e:
        log.warning("Failed to send transaction: %s", e)
    finally:
        writer.close()


def _parse_addr(s: str) -> tuple[str, int]:
    host, _, port = s.rpartition(":")
    return (host, int(port))


def main() -> None:
    parser = argparse.ArgumentParser(description="Benchmark client for hotstuff_tpu_torch nodes.")
    parser.add_argument("target", help="node transactions address ip:port")
    parser.add_argument("--size", type=int, required=True, help="tx size in bytes")
    parser.add_argument("--rate", type=int, required=True, help="tx/s to send")
    parser.add_argument("--timeout", type=int, required=True, help="node timeout (ms)")
    parser.add_argument("--nodes", nargs="*", default=[], help="addresses to await")
    parser.add_argument("--duration", type=float, default=None, help="stop after N s")
    args = parser.parse_args()
    setup_logging(2)
    asyncio.run(
        run_client(
            _parse_addr(args.target),
            args.size,
            args.rate,
            args.timeout,
            [_parse_addr(a) for a in args.nodes],
            duration=args.duration,
        )
    )


if __name__ == "__main__":
    main()
