"""Large-frame transport microbenchmark: asyncio vs native, one edge.

ROADMAP 3a: the sharded dataplane bench under ``HOTSTUFF_NET=native``
measured WORSE than asyncio at large batch frames (9.8k vs 30k tx/s at
60k offered, ~387 KB frames). This isolates exactly that edge — one
reliable sender blasting fixed-size frames at one ACKing receiver over
loopback, the batch-dissemination shape (``mempool/batch_maker.py``
broadcasts via ReliableSender; the QuorumWaiter consumes the ACKs) —
so the two transports can be profiled head-to-head without the rest of
the committee attached.

Usage:
    python -m hotstuff_tpu_torch.benchmark.netplane_frames --sizes 1024,65536,396288 \
        --frames 200 --window 32 [--json results/netplane-frames.json]

Prints frames/s and MB/s per (transport, size) and, for the native
plane, the engine's own counter deltas (writev calls, poll/dispatch ns,
drain bytes) so a regression localizes to a stage instead of a vibe.

Port copy of the reference's ``benchmark/netplane_frames.py``: the same
flags, pump, rows, printed lines and ``--json`` file, over the port's
asyncio ``Receiver``/``ReliableSender`` and its native engine
(``network/native/``, built with g++ at first use). It makes no card call.
``main`` takes ``argv`` as in the reference. On the H100 host pass a
``--base-port`` below 16000 (each row binds the next port above it).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time

from hotstuff_tpu_torch.benchmark.hostinfo import host_meta
from hotstuff_tpu_torch.network.receiver import MessageHandler, Receiver
from hotstuff_tpu_torch.network.reliable_sender import ReliableSender


class _AckHandler(MessageHandler):
    """The mempool helper's shape: store (here: count) then ACK."""

    def __init__(self) -> None:
        self.frames = 0
        self.bytes = 0

    async def dispatch(self, writer, message: bytes) -> None:
        self.frames += 1
        self.bytes += len(message)
        await writer.send(b"Ack")


async def _pump(sender, addr, payload: bytes, frames: int, window: int) -> None:
    """Windowed reliable pipeline: keep ``window`` frames in flight,
    await ACKs as they land (the QuorumWaiter consumes handlers the same
    way; PENDING_CAP back-pressure engages above the window)."""
    inflight: set[asyncio.Future] = set()
    for _ in range(frames):
        handler = await sender.send(addr, payload)
        inflight.add(asyncio.ensure_future(handler))
        if len(inflight) >= window:
            done, inflight = await asyncio.wait(
                inflight, return_when=asyncio.FIRST_COMPLETED
            )
    if inflight:
        await asyncio.wait(inflight)


async def _run_one(transport: str, size: int, frames: int, window: int,
                   port: int) -> dict:
    if transport == "native":
        from hotstuff_tpu_torch.network import native

        receiver_cls, sender_cls = native.NativeReceiver, native.NativeReliableSender
        t = native.NativeTransport.get()
        stats0 = t.stats()
    else:
        receiver_cls, sender_cls = Receiver, ReliableSender
        stats0 = {}
    handler = _AckHandler()
    addr = ("127.0.0.1", port)
    receiver = await receiver_cls.spawn(addr, handler)
    sender = sender_cls()
    payload = b"\xab" * size
    # Warmup (connection establishment, JIT-ish paths) outside the clock.
    await _pump(sender, addr, payload, min(8, frames), window)
    warm = handler.frames
    t0 = time.perf_counter()
    await _pump(sender, addr, payload, frames, window)
    # The clock stops when every ACK is back — ingest AND egress priced.
    elapsed = time.perf_counter() - t0
    result = {
        "transport": transport,
        "host": host_meta(),
        "size": size,
        "frames": frames,
        "window": window,
        "elapsed_s": elapsed,
        "frames_per_s": frames / elapsed,
        "mb_per_s": frames * size / elapsed / 1e6,
        "received": handler.frames - warm,
    }
    if transport == "native":
        stats1 = t.stats()
        result["native_delta"] = {
            k: stats1.get(k, 0) - stats0.get(k, 0)
            for k in (
                "frames_tx", "bytes_tx", "frames_rx", "bytes_rx",
                "writev_calls", "loop_polls", "poll_ns", "dispatch_ns",
                "cmds_serviced", "cmd_service_ns",
            )
        }
    sender.shutdown()
    await receiver.shutdown()
    await asyncio.sleep(0.05)  # let the listener close before reuse
    return result


async def _main(args) -> list[dict]:
    rows = []
    port = args.base_port
    for size in args.sizes:
        for transport in args.transports:
            port += 1
            row = await _run_one(
                transport, size, args.frames, args.window, port
            )
            rows.append(row)
            line = (
                f"{transport:>7} size={size:>8,}B frames={args.frames} "
                f"window={args.window}: {row['frames_per_s']:>9,.1f} fr/s "
                f"{row['mb_per_s']:>9,.1f} MB/s"
            )
            nd = row.get("native_delta")
            if nd:
                per_frame_polls = nd["loop_polls"] / max(1, args.frames)
                line += (
                    f"  [writev={nd['writev_calls']} polls/frame="
                    f"{per_frame_polls:.1f} dispatch_ms="
                    f"{nd['dispatch_ns'] / 1e6:.1f}]"
                )
            print(line, flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--sizes", default="1024,65536,396288",
        help="comma-separated frame payload sizes in bytes",
    )
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--window", type=int, default=32)
    ap.add_argument(
        "--transports", default="asyncio,native",
        help="comma-separated subset of asyncio,native",
    )
    ap.add_argument("--base-port", type=int, default=17480)
    ap.add_argument("--json", default=None, help="write rows to this path")
    args = ap.parse_args(argv)
    args.sizes = [int(s) for s in args.sizes.split(",") if s]
    args.transports = [t for t in args.transports.split(",") if t]
    rows = asyncio.run(_main(args))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(
                {"bench": "netplane_frames", "rows": rows}, f, indent=2
            )
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
