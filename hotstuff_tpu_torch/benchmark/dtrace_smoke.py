"""Lifeline smoke + overhead gate (the dtrace sibling of
``benchmark/watchtower_smoke.py``).

Runs an in-process micro data plane per leg — one REAL Conveyor worker
sealing/certifying production-weight batches against three acking peer
doubles, telemetry streaming throughout — and gates two things:

1. **Attribution fixture check** — the attached leg's stream carries
   ``hotstuff-dtrace-v1`` records and ``hotstuff_tpu_torch/benchmark/dtrace_assemble.py``
   assembles them into batch lifelines with the data-plane edges
   (ingress_wait → seal → disseminate → ack_fanin) populated. The
   consensus-side edges are covered by the full-lifecycle fixtures in
   ``tests/test_dtrace_assemble.py``. A fully env-detached leg must
   conversely leave ZERO dtrace records (the ``HOTSTUFF_DTRACE=0``
   switch works end to end).
2. **Overhead budget** (default <1%) — measured as the median of
   per-batch PAIRED differences: each measurement leg alternates the
   lifeline plane per batch (attached, detached, attached, ...) inside
   one process and reports the median attached-minus-detached CPU delta
   over adjacent pairs. Pairing spans milliseconds, so CPU-frequency
   drift, co-tenant load, and GC pressure cancel instead of swamping a
   sub-1%% signal the way whole-leg wall-clock comparison does on
   shared CI runners. Legs run in FRESH subprocesses (one leg = one
   subprocess, alternating starting parity) and the gate takes the
   median across legs.

Exit 0 on pass, 1 on stream/assembly/switch failure, 2 on budget
failure.

    python -m hotstuff_tpu_torch.benchmark.dtrace_smoke --batches 48 --repeats 3

Port copy of the reference's ``benchmark/dtrace_smoke.py``: the same
flags, legs (each in a fresh ``python -m
hotstuff_tpu_torch.benchmark.dtrace_smoke --one-shot`` process, run from
the repository's root), ``HOTSTUFF_DTRACE`` switch checks, attribution
check through the port's ``dtrace_assemble``, paired-difference overhead,
summary line and exit codes, over the port's data plane and telemetry.
The worker's acks and certificates are checked on the host with the
strict single check, as in the reference, so the script makes no card
call. ``main`` takes ``argv``; there is no ``sys.path`` edit. On the H100
host pass a ``--base-port`` below 16000 (each leg takes 100 ports, of
which it binds base + 40 to base + 63).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time

from hotstuff_tpu_torch.benchmark.hostinfo import host_meta

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

#: the edges the micro data plane can close (no consensus in the loop:
#: queue_wait and later edges stay open by construction).
DATAPLANE_EDGES = ("ingress_wait", "seal", "disseminate", "ack_fanin")


async def _acking_peer(port: int, secret):
    """A peer worker double: acks every batch frame it receives."""
    from hotstuff_tpu_torch.crypto import Signature, sha512_digest
    from hotstuff_tpu_torch.mempool.dataplane import ack_digest
    from hotstuff_tpu_torch.mempool.dataplane import messages as dpm

    async def handle(reader, writer):
        try:
            while True:
                hdr = await reader.readexactly(4)
                (n,) = struct.unpack(">I", hdr)
                frame = await reader.readexactly(n)
                if frame[0] == dpm.TAG_BATCH:
                    digest = sha512_digest(frame)
                    sig = Signature.new(ack_digest(digest), secret)
                    ack = dpm.encode_ack(digest, secret.public_key(), sig)
                    writer.write(struct.pack(">I", len(ack)) + ack)
                    await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError):
            pass

    return await asyncio.start_server(handle, "127.0.0.1", port)


async def _drive(
    batches: int,
    tx_size: int,
    batch_bytes: int,
    base_port: int,
    paired: bool,
    start_attached: bool,
) -> dict:
    """Seal + certify batches of ``batch_bytes`` through one real
    worker. ``batch_bytes`` defaults near the production
    ``Parameters.batch_size`` so the overhead denominator reflects what
    a real batch costs — gating tiny toy batches would overstate the
    constant per-batch trace cost ~100x.

    In ``paired`` mode, drives ``batches`` adjacent (attached, detached)
    batch pairs toggling :func:`telemetry.set_dtrace_detached` between
    them, and reports the median paired CPU delta. Otherwise drives
    ``batches`` batches under whatever the environment configured and
    reports the median per-batch CPU."""
    from hotstuff_tpu_torch import telemetry
    from hotstuff_tpu_torch.crypto import SignatureService, generate_keypair
    from hotstuff_tpu_torch.mempool import Parameters, WorkerEntry
    from hotstuff_tpu_torch.mempool.config import Authority, Committee
    from hotstuff_tpu_torch.mempool.dataplane import Watermark, Worker
    from hotstuff_tpu_torch.mempool.dataplane import messages as dpm
    from hotstuff_tpu_torch.store import Store

    ks = [generate_keypair() for _ in range(4)]
    committee = Committee(
        authorities={
            pk: Authority(
                stake=1,
                transactions_address=("127.0.0.1", base_port + i),
                mempool_address=("127.0.0.1", base_port + 20 + i),
                workers=[
                    WorkerEntry(
                        transactions_address=("127.0.0.1", base_port + 40 + i),
                        worker_address=("127.0.0.1", base_port + 60 + i),
                    )
                ],
            )
            for i, (pk, _) in enumerate(ks)
        }
    )
    name = ks[0][0]
    servers = [
        await _acking_peer(committee.worker_address(pk, 0)[1], sk)
        for pk, sk in ks[1:]
    ]
    txs_per_batch = max(1, batch_bytes // tx_size)
    tx_consensus: asyncio.Queue = asyncio.Queue()
    worker = Worker(
        name,
        0,
        committee,
        Parameters(
            batch_size=txs_per_batch * tx_size,
            max_batch_delay=5_000,
            workers=1,
        ),
        Store(),
        SignatureService(ks[0][1]),
        tx_consensus,
        Watermark(4 * batch_bytes, 2 * batch_bytes),
    )
    await worker.spawn()
    _, writer = await asyncio.open_connection(
        "127.0.0.1", committee.workers_of(name)[0].transactions_address[1]
    )
    seq = 0

    def tx() -> bytes:
        nonlocal seq
        seq += 1
        return b"\x00" + seq.to_bytes(8, "big") + bytes(tx_size - 9)

    async def one_batch() -> float:
        c0 = time.process_time()
        for start in range(0, txs_per_batch, 8):
            n = min(8, txs_per_batch - start)
            frame = dpm.encode_bundle([tx() for _ in range(n)])
            writer.write(struct.pack(">I", len(frame)) + frame)
        await writer.drain()
        await asyncio.wait_for(tx_consensus.get(), 15)
        return time.process_time() - c0

    # Warm the path end to end before the measured window.
    await one_batch()

    if paired:
        diffs: list[float] = []
        offs: list[float] = []
        for _ in range(batches):
            pair = {}
            order = (True, False) if start_attached else (False, True)
            for attached in order:
                telemetry.set_dtrace_detached(not attached)
                pair[attached] = await one_batch()
            start_attached = not start_attached
            diffs.append(pair[True] - pair[False])
            offs.append(pair[False])
        result = {
            "pair_delta": statistics.median(diffs),
            "off_cpu_per_batch": statistics.median(offs),
        }
    else:
        samples = [await one_batch() for _ in range(batches)]
        result = {"cpu_per_batch": statistics.median(samples)}

    writer.close()
    await worker.shutdown()
    for s in servers:
        s.close()
    return result


def _run_once(args) -> dict:
    from hotstuff_tpu_torch import telemetry

    telemetry.reset_for_tests()
    telemetry.enable()
    emitter = telemetry.TelemetryEmitter(
        telemetry.get_registry(),
        args.snap,
        node="dtrace-smoke",
        interval_s=1.0,
        trace=telemetry.trace_buffer(),
        dtrace=telemetry.dtrace_buffer(),
    )
    try:
        dtrace_on = telemetry.dtrace_enabled()
        result = asyncio.run(
            _drive(
                args.batches,
                args.tx_size,
                args.batch_bytes,
                args.base_port,
                args.paired,
                args.start_attached,
            )
        )
    finally:
        emitter.emit(final=True)
        telemetry.disable()
    return dict(result, dtrace_on=dtrace_on)


def _spawn_once(
    args, *, batches: int, port: int, snap_path: str,
    paired: bool = False, attached: bool = True, start_attached: bool = True,
) -> dict:
    """One leg in a fresh subprocess. Non-paired legs configure the
    lifeline plane via ``HOTSTUFF_DTRACE`` so the end-to-end environment
    switch itself is exercised; paired legs toggle it internally."""
    cmd = [
        sys.executable, "-m", "hotstuff_tpu_torch.benchmark.dtrace_smoke", "--one-shot",
        "--batches", str(batches), "--tx-size", str(args.tx_size),
        "--batch-bytes", str(args.batch_bytes),
        "--base-port", str(port), "--snap", snap_path,
    ]
    if paired:
        cmd.append("--paired")
        if start_attached:
            cmd.append("--start-attached")
    env = dict(os.environ)
    env["HOTSTUFF_DTRACE"] = "1" if (attached or paired) else "0"
    proc = subprocess.run(
        cmd, capture_output=True, text=True, env=env,
        cwd=REPO_ROOT,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"one-shot leg failed (rc={proc.returncode}):\n{proc.stderr[-2000:]}"
        )
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _count_dtrace_records(snap_path: str) -> int:
    from hotstuff_tpu_torch.telemetry import DTRACE_SCHEMA

    count = 0
    with open(snap_path) as f:
        for line in f:
            try:
                if json.loads(line).get("schema") == DTRACE_SCHEMA:
                    count += 1
            except json.JSONDecodeError:
                continue
    return count


def _check_attribution(snap_path: str) -> tuple[dict | None, list[str]]:
    """The fixture check: the attached stream must assemble into batch
    lifelines with every data-plane edge populated."""
    from hotstuff_tpu_torch.benchmark.dtrace_assemble import assemble

    problems: list[str] = []
    try:
        report = assemble([snap_path])
    except Exception as e:  # noqa: BLE001 — a crash here IS the failure
        return None, [f"dtrace assembly crashed: {e}"]
    if report["batches"] == 0:
        problems.append("attached stream assembled zero batch lifelines")
    for edge in DATAPLANE_EDGES:
        stats = report["edges"].get(edge)
        if not stats or stats["n"] == 0:
            problems.append(f"edge {edge!r} got no attribution")
    return report, problems


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument(
        "--batches", type=int, default=48,
        help="batch PAIRS per measurement leg",
    )
    p.add_argument("--tx-size", type=int, default=4096)
    p.add_argument(
        "--batch-bytes",
        type=int,
        default=500_000,
        help="sealed batch size; the production Parameters.batch_size "
        "default, so the overhead denominator is what a real batch costs",
    )
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument(
        "--budget",
        type=float,
        default=float(os.environ.get("HOTSTUFF_DTRACE_BUDGET", "0.01")),
        help="max allowed relative overhead (default 0.01 = 1%%)",
    )
    p.add_argument("--base-port", type=int, default=21500)
    p.add_argument("--output", help="file to append the result summary to")
    p.add_argument(
        "--work-dir",
        help="where the legs' telemetry streams land (default: a fresh "
        "temp dir); CI points this at the workspace so failures upload "
        "the evidence",
    )
    # Internal: one measurement leg (see _spawn_once).
    p.add_argument("--one-shot", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--snap", help=argparse.SUPPRESS)
    p.add_argument("--paired", action="store_true", help=argparse.SUPPRESS)
    p.add_argument(
        "--start-attached", action="store_true", help=argparse.SUPPRESS
    )
    args = p.parse_args(argv)

    if args.one_shot:
        print(json.dumps(_run_once(args)))
        return

    if args.work_dir:
        snap_dir = os.path.abspath(args.work_dir)
        os.makedirs(snap_dir, exist_ok=True)
    else:
        snap_dir = tempfile.mkdtemp(prefix="hotstuff_dtrace_smoke_")
    problems: list[str] = []
    port = args.base_port
    fixture_batches = max(8, args.batches // 4)

    # Attached leg: warms every code path AND provides the fully-traced
    # stream for the attribution fixture check.
    attached_snap = os.path.join(snap_dir, "telemetry-attached.jsonl")
    leg = _spawn_once(
        args, batches=fixture_batches, port=port, snap_path=attached_snap,
        attached=True,
    )
    port += 100
    if leg["dtrace_on"] is not True:
        problems.append("HOTSTUFF_DTRACE=1 leg came up detached")
    report, attr_problems = _check_attribution(attached_snap)
    problems.extend(attr_problems)

    # Env-detached leg: the production off-switch must leave no trace.
    detached_snap = os.path.join(snap_dir, "telemetry-detached.jsonl")
    leg = _spawn_once(
        args, batches=fixture_batches, port=port, snap_path=detached_snap,
        attached=False,
    )
    port += 100
    if leg["dtrace_on"] is not False:
        problems.append("HOTSTUFF_DTRACE=0 leg came up attached")
    if (n := _count_dtrace_records(detached_snap)) != 0:
        problems.append(f"HOTSTUFF_DTRACE=0 leg streamed {n} dtrace records")

    # Measurement legs: paired per-batch alternation, fresh subprocess
    # each, starting parity alternating across legs.
    overheads: list[float] = []
    off_ms: list[float] = []
    for rep in range(args.repeats):
        leg = _spawn_once(
            args,
            batches=args.batches,
            port=port,
            snap_path=os.path.join(snap_dir, f"telemetry-paired-{rep}.jsonl"),
            paired=True,
            start_attached=rep % 2 == 0,
        )
        port += 100
        overheads.append(leg["pair_delta"] / leg["off_cpu_per_batch"])
        off_ms.append(leg["off_cpu_per_batch"] * 1e3)

    overhead = statistics.median(overheads)
    result = {
        "metric": f"dtrace_overhead_p{args.batches}x{args.repeats}",
        "host": host_meta(),
        "off_cpu_ms_per_batch": round(statistics.median(off_ms), 3),
        "overhead": round(overhead, 4),
        "leg_overheads": [round(o, 4) for o in overheads],
        "budget": args.budget,
        "batches_assembled": report["batches"] if report else 0,
        "edges": (
            {e: report["edges"][e]["mean_ms"] for e in DATAPLANE_EDGES}
            if report and not attr_problems
            else None
        ),
        "snap_dir": snap_dir,
        "problems": problems,
    }
    print(json.dumps(result))

    if args.output:
        os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
        with open(args.output, "a") as f:
            f.write(json.dumps(result) + "\n")

    if problems:
        print(f"FAIL: {problems}", file=sys.stderr)
        sys.exit(1)
    if overhead > args.budget:
        print(
            f"FAIL: dtrace overhead {overhead:.2%} exceeds the "
            f"{args.budget:.2%} budget",
            file=sys.stderr,
        )
        sys.exit(2)
    print(
        f"PASS: dtrace overhead {overhead:+.2%} within {args.budget:.2%}; "
        f"{result['batches_assembled']} lifeline(s) assembled with all "
        "data-plane edges attributed; HOTSTUFF_DTRACE switch verified "
        "both ways"
    )


if __name__ == "__main__":
    main()
