"""Benchmark client: open-loop load generator (reference
``node/src/client.rs``).

The legacy client waits for all ``--nodes`` TCP ports, then twice the timeout,
and sends ``rate`` tx/s in 50 ms bursts (PRECISION=20) to one node's
transactions address. Transactions are ``size`` bytes: sample txs start
with byte 0 + a u64 BE counter (one per burst, used for e2e latency);
standard txs start with byte 1 + a random u64. Log lines are the
measurement interface (``client.rs:110,128-131``).

Port of ``hotstuff_tpu/node/client.py``, whole. Besides the legacy client:

- **sharded mode** (``--shards a:p,b:p,...``) targets the data plane's
  worker ingress ports. Each burst is pre-framed into one BUNDLE per shard
  (header: tx count + sample ids; body: opaque length-prefixed tx blob), so
  the per-transaction Python cost stays on this client. A reader task per
  shard counts the node's client-visible ``b"Shed"`` refusals and logs
  them (``Shed notifications: N``). ``--coalesce-bytes``/``--coalesce-ms``
  pack small bundles per shard into one write;
- **fleet mode** (``--fleet N``): N open-loop connections over the shards
  with Poisson arrivals of small bundles, optional square-wave bursts and
  connection churn.

The log lines are the reference's word for word (``benchmark/logs.py``
parses them).
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


def _make_bundler(size: int):
    """BUNDLE frame builder for worker ingress. Per-tx assembly fast
    path: only the 9 header bytes vary per transaction."""
    from hotstuff_tpu_torch.mempool.dataplane.messages import TAG_TX_BUNDLE

    seq = random.getrandbits(63)
    filler = b"\x01" * (size - 9)
    prefix = size.to_bytes(4, "big") + b"\x01"
    sample_filler = b"\x00" * (size - 9)

    def bundle(n_txs: int, sample_id: int | None) -> bytes:
        nonlocal seq
        parts = []
        if sample_id is not None:
            parts.append(
                prefix[:4] + b"\x00" + sample_id.to_bytes(8, "big") + sample_filler
            )
            n_txs -= 1
        base = seq
        seq += n_txs
        parts.extend(
            prefix + (base + i).to_bytes(8, "big") + filler
            for i in range(n_txs)
        )
        blob = b"".join(parts)
        # Bundle header fields ride the serde codec = little-endian; the
        # per-tx length prefixes INSIDE the blob are big-endian (the
        # split_blob contract). The sample id is a raw u64 field (LE).
        head = (
            bytes([TAG_TX_BUNDLE])
            + (len(parts)).to_bytes(4, "little")
            + (1 if sample_id is not None else 0).to_bytes(4, "little")
            + (sample_id.to_bytes(8, "little") if sample_id is not None else b"")
        )
        return head + len(blob).to_bytes(4, "little") + blob

    return bundle


def _make_shed_counter(shed: list[int]):
    """Reader-task body counting the node's client-visible ``b"Shed"``
    refusals (the back-pressure contract) into the shared ``shed[0]``."""

    async def count_sheds(reader: asyncio.StreamReader) -> None:
        last_logged = 0.0
        try:
            while True:
                hdr = await reader.readexactly(4)
                frame = await reader.readexactly(int.from_bytes(hdr, "big"))
                if frame == b"Shed":
                    shed[0] += 1
                    now = time.monotonic()
                    if now - last_logged > 1.0:
                        last_logged = now
                        # NOTE: measurement interface (shed accounting).
                        log.warning("Shed notifications: %d", shed[0])
        except (asyncio.IncompleteReadError, ConnectionError):
            pass

    return count_sheds


async def run_sharded_client(
    shards: list[tuple[str, int]],
    size: int,
    rate: int,
    timeout_ms: int,
    nodes: list[tuple[str, int]],
    duration: float | None = None,
    coalesce_bytes: int = 0,
    coalesce_ms: float = 5.0,
) -> None:
    log.info("Worker shards: %s", ", ".join(f"{h}:{p}" for h, p in shards))
    # NOTE: these exact log entries are parsed by the benchmark harness.
    log.info("Transactions size: %d B", size)
    log.info("Transactions rate: %d tx/s", rate)
    if size < 9:
        raise ValueError("transaction size must be at least 9 bytes")
    if coalesce_bytes:
        log.info("Coalescing: %d B / %.1f ms", coalesce_bytes, coalesce_ms)
    await wait_for_nodes(nodes, timeout_ms)

    conns = [await asyncio.open_connection(*addr) for addr in shards]
    shed = [0]
    count_sheds = _make_shed_counter(shed)
    readers = [asyncio.create_task(count_sheds(r)) for r, _w in conns]

    burst = max(rate // PRECISION, 1)
    per_shard = max(burst // len(conns), 1)
    counter = 0
    bundle = _make_bundler(size)

    # Bundle coalescing: small bundles are staged per shard and packed
    # into one write, flushed when the staging buffer reaches
    # ``coalesce_bytes`` or its oldest bundle has waited ``coalesce_ms``
    # — the 512 B–1 KB regime stops paying a write (and a node-side
    # wakeup) per bundle. A bundle already at/over the byte bound is
    # written immediately. Off (the historic behavior) at bytes=0.
    coalesce = coalesce_bytes > 0
    coalesce_s = coalesce_ms / 1000.0
    pend: list[bytearray] = [bytearray() for _ in conns]
    pend_ts = [0.0] * len(conns)

    def stage(i: int, frame: bytes) -> None:
        framed = len(frame).to_bytes(4, "big") + frame
        if not coalesce:
            conns[i][1].write(framed)
            return
        if not pend[i]:
            pend_ts[i] = time.monotonic()
        pend[i] += framed
        if len(pend[i]) >= coalesce_bytes:
            conns[i][1].write(bytes(pend[i]))
            pend[i].clear()

    def flush_due(now: float) -> float | None:
        """Flush shards whose oldest staged bundle hit the latency bound;
        return the earliest outstanding deadline (None if none staged)."""
        earliest = None
        for i, p in enumerate(pend):
            if not p:
                continue
            dl = pend_ts[i] + coalesce_s
            if dl <= now:
                conns[i][1].write(bytes(p))
                p.clear()
            elif earliest is None or dl < earliest:
                earliest = dl
        return earliest

    # NOTE: This log entry is used to compute performance.
    log.info("Start sending transactions")
    deadline = time.monotonic() + duration if duration else None
    next_burst = time.monotonic()
    try:
        while deadline is None or time.monotonic() < deadline:
            now = time.monotonic()
            while now < next_burst:
                # Sleep to whichever comes first: the next burst or the
                # earliest coalescing deadline — the latency bound holds
                # even across the inter-burst gap.
                dl = flush_due(now) if coalesce else None
                target = next_burst if dl is None or dl >= next_burst else dl
                await asyncio.sleep(target - now)
                now = time.monotonic()
            burst_start = time.monotonic()
            sample_shard = counter % len(conns)
            for i in range(len(conns)):
                sample_id = counter if i == sample_shard else None
                if sample_id is not None:
                    # NOTE: This log entry is used to compute performance.
                    log.info("Sending sample transaction %d", counter)
                stage(i, bundle(per_shard, sample_id))
            if coalesce:
                flush_due(time.monotonic())
            for _r, writer in conns:
                await writer.drain()
            if time.monotonic() - burst_start > BURST_DURATION:
                # NOTE: This log entry is used to compute performance.
                log.warning("Transaction rate too high for this client")
            counter += 1
            next_burst += BURST_DURATION
    except (ConnectionError, OSError) as e:
        log.warning("Failed to send transaction: %s", e)
    finally:
        for i, p in enumerate(pend):
            if p:
                try:
                    conns[i][1].write(bytes(p))
                except (ConnectionError, OSError):
                    pass
        for t in readers:
            t.cancel()
        for _r, writer in conns:
            writer.close()
        if shed[0]:
            log.warning("Shed notifications: %d", shed[0])


async def run_fleet_client(
    shards: list[tuple[str, int]],
    size: int,
    rate: int,
    timeout_ms: int,
    nodes: list[tuple[str, int]],
    duration: float | None = None,
    fleet: int = 64,
    bundle_txs: int = 8,
    burst_every: float = 0.0,
    burst_len: float = 0.0,
    burst_x: float = 1.0,
    churn_s: float = 0.0,
) -> None:
    """Open-loop fleet: ``fleet`` concurrent connections round-robin over
    the worker shards, each arrival one small bundle of ``bundle_txs``
    transactions, with Poisson (exponential-gap) arrivals at the
    aggregate ``rate``. Unlike the closed-ish burst loop of
    ``run_sharded_client``, arrivals do NOT wait for back-pressure: a
    saturated front door shows up as shedding and tail latency, which is
    the point. Optional square-wave bursts (``burst_every``/``burst_len``
    windows at ``burst_x`` times the base rate) and connection churn
    (every ``churn_s`` seconds one connection is torn down and redialed)
    exercise watermarks under connection-scale dynamics."""
    log.info("Worker shards: %s", ", ".join(f"{h}:{p}" for h, p in shards))
    # NOTE: these exact log entries are parsed by the benchmark harness.
    log.info("Transactions size: %d B", size)
    log.info("Transactions rate: %d tx/s", rate)
    log.info("Fleet connections: %d", fleet)
    log.info("Fleet bundle: %d txs", bundle_txs)
    if size < 9:
        raise ValueError("transaction size must be at least 9 bytes")
    if fleet < 1:
        raise ValueError("fleet size must be at least 1")
    await wait_for_nodes(nodes, timeout_ms)

    shed = [0]
    count_sheds = _make_shed_counter(shed)
    conns: list[tuple[asyncio.StreamReader, asyncio.StreamWriter]] = []
    readers: list[asyncio.Task] = []
    for k in range(fleet):
        r, w = await asyncio.open_connection(*shards[k % len(shards)])
        conns.append((r, w))
        readers.append(asyncio.create_task(count_sheds(r)))

    churns = [0]
    churn_task = None
    if churn_s > 0:

        async def churn_loop() -> None:
            k = 0
            while True:
                await asyncio.sleep(churn_s)
                idx = k % fleet
                k += 1
                readers[idx].cancel()
                conns[idx][1].close()
                try:
                    nr, nw = await asyncio.open_connection(
                        *shards[idx % len(shards)]
                    )
                except OSError:
                    continue  # redial next cycle; sends skip dead conns
                conns[idx] = (nr, nw)
                readers[idx] = asyncio.create_task(count_sheds(nr))
                churns[0] += 1
                # NOTE: measurement interface (cumulative, logged per
                # event — the harness SIGTERMs clients, so an end-of-run
                # summary line would never be written).
                log.info("Connection churns: %d", churns[0])

        churn_task = asyncio.create_task(churn_loop())

    bundle = _make_bundler(size)
    arrival_rate = max(rate / max(bundle_txs, 1), 1e-9)  # bundles/s, fleet-wide
    counter = 0
    k = 0
    late_warned = 0.0
    # NOTE: This log entry is used to compute performance.
    log.info("Start sending transactions")
    start = time.monotonic()
    deadline = start + duration if duration else None
    next_arrival = start
    next_sample = start
    try:
        while deadline is None or time.monotonic() < deadline:
            now = time.monotonic()
            if now < next_arrival:
                await asyncio.sleep(next_arrival - now)
                now = time.monotonic()
            mult = 1.0
            if burst_every > 0 and (now - start) % burst_every < burst_len:
                mult = burst_x
            sample_id = None
            if now >= next_sample:
                sample_id = counter
                # NOTE: This log entry is used to compute performance.
                log.info("Sending sample transaction %d", counter)
                counter += 1
                next_sample += BURST_DURATION
            frame = bundle(bundle_txs, sample_id)
            _r, writer = conns[k % fleet]
            k += 1
            try:
                writer.write(len(frame).to_bytes(4, "big") + frame)
                await writer.drain()
            except (ConnectionError, OSError):
                pass  # mid-churn/broken conn: open-loop drops, never blocks
            if now - next_arrival > BURST_DURATION and now - late_warned > 1.0:
                late_warned = now
                # NOTE: This log entry is used to compute performance.
                log.warning("Transaction rate too high for this client")
            next_arrival += random.expovariate(arrival_rate * mult)
    finally:
        if churn_task is not None:
            churn_task.cancel()
        for t in readers:
            t.cancel()
        for _r, w in conns:
            w.close()
        if shed[0]:
            log.warning("Shed notifications: %d", shed[0])
        if churns[0]:
            log.info("Connection churns: %d", churns[0])


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
    parser.add_argument(
        "--shards",
        default=None,
        help="comma-separated Conveyor worker ingress addresses; switches "
        "to sharded bundle mode (the positional target is ignored)",
    )
    parser.add_argument(
        "--coalesce-bytes",
        type=int,
        default=0,
        help="sharded mode: pack small bundles per shard into one write "
        "up to this many bytes (0 = off)",
    )
    parser.add_argument(
        "--coalesce-ms",
        type=float,
        default=5.0,
        help="sharded mode: max ms a staged bundle may wait before its "
        "coalesced write is flushed",
    )
    parser.add_argument(
        "--fleet",
        type=int,
        default=0,
        help="open-loop fleet mode: number of concurrent connections "
        "round-robin over --shards (0 = off)",
    )
    parser.add_argument(
        "--bundle-txs",
        type=int,
        default=8,
        help="fleet mode: transactions per bundle (arrival granularity)",
    )
    parser.add_argument(
        "--burst-every",
        type=float,
        default=0.0,
        help="fleet mode: burst window period in seconds (0 = steady)",
    )
    parser.add_argument(
        "--burst-len",
        type=float,
        default=0.0,
        help="fleet mode: burst window length in seconds",
    )
    parser.add_argument(
        "--burst-x",
        type=float,
        default=1.0,
        help="fleet mode: rate multiplier inside burst windows",
    )
    parser.add_argument(
        "--churn",
        type=float,
        default=0.0,
        help="fleet mode: redial one connection every N seconds (0 = off)",
    )
    args = parser.parse_args()
    setup_logging(2)
    if args.fleet:
        if not args.shards:
            parser.error("--fleet requires --shards")
        asyncio.run(
            run_fleet_client(
                [_parse_addr(a) for a in args.shards.split(",")],
                args.size,
                args.rate,
                args.timeout,
                [_parse_addr(a) for a in args.nodes],
                duration=args.duration,
                fleet=args.fleet,
                bundle_txs=args.bundle_txs,
                burst_every=args.burst_every,
                burst_len=args.burst_len,
                burst_x=args.burst_x,
                churn_s=args.churn,
            )
        )
        return
    if args.shards:
        asyncio.run(
            run_sharded_client(
                [_parse_addr(a) for a in args.shards.split(",")],
                args.size,
                args.rate,
                args.timeout,
                [_parse_addr(a) for a in args.nodes],
                duration=args.duration,
                coalesce_bytes=args.coalesce_bytes,
                coalesce_ms=args.coalesce_ms,
            )
        )
        return
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
