"""Process-sharded committee engine groups.

Port copy of ``hotstuff_tpu/parallel/engine_groups.py``: the same ring
layout, ops, pricing counters, runtime and ``HOTSTUFF_ENGINE_GROUPS``
switch. Differences, by design:

- The groups start with the ``spawn`` context where the reference forks
  ("inherit keys, no pickling"). CUDA cannot be initialised again in a
  forked child, and a caller that has used the card (``chip_smoke.py``)
  holds a CUDA context. The keys go to each group as raw bytes (public key,
  seed) and are rebuilt there; the environment is inherited as with fork,
  so ``HOTSTUFF_CRYPTO_BACKEND``, ``HOTSTUFF_NET`` and
  ``HOTSTUFF_CRYPTO_WORKERS`` reach every group. A spawned child re-runs
  the caller's main module unless it has neither a file nor a spec; a
  group needs nothing of it (its target and arguments live here), so the
  groups start without it (``_start``).
- The round-1 leader starts last. A spawned group boots in seconds (an
  interpreter, torch and the port) where a forked one takes milliseconds,
  so groups finish starting their engines at different times; the round-1
  leader proposes as it starts, and round 1's votes sent to a round-2
  leader that is not listening yet are lost, so every started node waits
  out round 1's timeout, and at N = 1000 the view change's 10^6 timeout
  checks can keep the committee timing out. So each group starts its
  engines but the round-1 leader, all groups meet at a barrier
  (``multiprocessing.Barrier``, passed at spawn), and only then does the
  leader's group start it.
- A group makes its crypto backend before its engines, so that a backend
  that cannot be built (``cuda`` without a card) ends the group with
  ``OP_ERROR`` and the parent raises ``RuntimeError("group g: ...")``; the
  reference makes it only at the first verification, inside an engine,
  where a failure is logged and the group never commits. A group never
  falls back to the CPU. The parent constructs no engine and
  verifies nothing, as in the reference.
- Each group counts its own kernel launches (``ops/msm_kernels.LAUNCHES``
  and ``ops/sha512.LAUNCHES``, from 0 once its backend is made) and posts
  them in its final snapshot, which ``stop`` merges; ``measure`` keeps its
  timings (``timing``: each group's ready time, the first commit on every
  node, and the longest any node can have gone without a commit while the
  timed rounds ran).

The one-process committee testbed multiplexes every engine through one
GIL; the reference's profiler measured ~59% of N=200 wall as GIL delay while
verify workers idled. This runtime generalizes the native command ring's
batching discipline (``network/native``: fixed-layout LE records, one
flush per loop iteration, pricing counters) across PROCESS boundaries:
the committee is sharded into worker processes ("engine groups"), each
running its slice of consensus engines on its own event loop with its
own crypto plane, native transport and decode arena, while the parent
touches only decisions — commit events, error verdicts, and the merged
telemetry snapshot — carried over shared-memory SPSC rings.

Topology: node i lives in group ``i % n_groups``; the committee's
addresses are plain localhost TCP, so cross-group links are ordinary
socket connections (the ReliableSender's backoff reconnect absorbs boot
skew between groups). Nothing inside an engine changes: the
single-process path (``HOTSTUFF_ENGINE_GROUPS=0``, the default) is
byte-identical for tests and Simulant.

Ring layout (one producer, one consumer, same pricing discipline as the
native command ring): a 16-byte header of u64 little-endian head/tail
cursors, then a power-of-two payload arena of ``op:u8 len:u32le payload``
records. A record that would straddle the arena end is preceded by an
op=0 wrap marker. Counters (pushes, bytes, wraps, polls) mirror into the
telemetry registry as ``parallel.ring.*``.

On a one-core host this buys GIL-crossing avoidance, not parallelism —
the committed N=1000 milestone rows are measured single-process with the
fused aggregate-QC plane; the groups runtime is the architecture for
multi-core hosts and is exercised by ``tests/test_engine_groups.py`` (the
port's: ``tests/test_torch_engine_groups.py``).
"""

from __future__ import annotations

import asyncio
import json
import multiprocessing
import os
import struct
import sys
import time
import types
from multiprocessing import shared_memory

_HDR = 16  # two u64 cursors
_REC = struct.Struct("<BI")  # op, payload length

# Ring record ops (u8). 0 is the wrap marker, never a record.
OP_READY = 1  # worker booted its shard              payload: group:u32
OP_COMMIT = 2  # one engine committed a block         payload: node:u32 seq:u64
OP_TELEMETRY = 3  # final registry snapshot             payload: JSON bytes
OP_ERROR = 4  # worker died                          payload: UTF-8 message
OP_DONE = 5  # worker finished shutdown             payload: group:u32
OP_STOP = 6  # parent -> worker: shut down          payload: empty

_READY = struct.Struct("<I")
# How long a group waits at the start barrier for the others' engines.
_START_TIMEOUT_S = 120.0
_COMMIT = struct.Struct("<IQ")


def groups_from_env(default: int = 0) -> int:
    """``HOTSTUFF_ENGINE_GROUPS``: 0 (default) disables the runtime —
    the kill-switch keeping the single-process path byte-identical."""
    try:
        return max(0, int(os.environ.get("HOTSTUFF_ENGINE_GROUPS", default)))
    except ValueError:
        return 0


class ShmRing:
    """SPSC byte ring over POSIX shared memory.

    One side constructs with ``create=True`` (owner, unlinks on close);
    the peer attaches by name. Exactly one process pushes and exactly one
    pops — cursor stores are 8-byte aligned u64 writes, and each side
    only ever writes its own cursor (producer: tail, consumer: head).
    """

    def __init__(self, name: str | None = None, capacity: int = 1 << 20,
                 create: bool = False) -> None:
        if create:
            assert capacity & (capacity - 1) == 0, "capacity must be 2^k"
            self._shm = shared_memory.SharedMemory(
                name=name, create=True, size=_HDR + capacity
            )
            self._shm.buf[:_HDR] = bytes(_HDR)
        else:
            # Attach: the creator chose the capacity, so derive it from
            # the segment instead of trusting the default (the size may
            # be page-rounded, hence largest power of two that fits).
            self._shm = shared_memory.SharedMemory(name=name)
            capacity = 1 << ((self._shm.size - _HDR).bit_length() - 1)
        self.capacity = capacity
        self.name = self._shm.name
        self._owner = create
        self._cur = self._shm.buf[:_HDR].cast("Q")  # [head, tail]
        self._buf = self._shm.buf[_HDR:]
        # Pricing counters, same discipline as the native command ring
        # (each side counts its own operations; merged via telemetry).
        self.pushes = 0
        self.push_bytes = 0
        self.wraps = 0
        self.polls = 0
        self.pops = 0

    # -- producer side ------------------------------------------------------

    def try_push(self, op: int, payload: bytes = b"") -> bool:
        """Append one record; False when the ring lacks space (caller
        decides whether to spin — commit events may not be dropped)."""
        need = _REC.size + len(payload)
        if need > self.capacity - _REC.size - 1:
            raise ValueError("record exceeds ring capacity")
        head = self._cur[0]
        tail = self._cur[1]
        free = self.capacity - (tail - head)
        pos = tail % self.capacity
        room_to_end = self.capacity - pos
        wrap = room_to_end < need
        if wrap and room_to_end < _REC.size:
            # Not even space for a wrap marker before the edge: treat the
            # trailing sliver as consumed by the wrap.
            if free < room_to_end + need:
                return False
            tail += room_to_end
        elif wrap:
            if free < room_to_end + need:
                return False
            self._buf[pos : pos + _REC.size] = _REC.pack(0, 0)
            tail += room_to_end
        elif free < need:
            return False
        if wrap:
            self.wraps += 1
            pos = tail % self.capacity
        self._buf[pos : pos + _REC.size] = _REC.pack(op, len(payload))
        if payload:
            self._buf[pos + _REC.size : pos + need] = payload
        self._cur[1] = tail + need  # publish after the payload is in place
        self.pushes += 1
        self.push_bytes += need
        return True

    def push(self, op: int, payload: bytes = b"", timeout: float = 30.0) -> None:
        deadline = time.monotonic() + timeout
        while not self.try_push(op, payload):
            if time.monotonic() > deadline:
                raise TimeoutError("ring full: consumer stalled")
            time.sleep(0.0005)

    # -- consumer side ------------------------------------------------------

    def pop_all(self) -> list[tuple[int, bytes]]:
        """Drain every published record (one poll, many records — the
        command-ring flush pattern in reverse)."""
        self.polls += 1
        out: list[tuple[int, bytes]] = []
        head = self._cur[0]
        tail = self._cur[1]
        while head != tail:
            pos = head % self.capacity
            room_to_end = self.capacity - pos
            if room_to_end < _REC.size:
                head += room_to_end  # trailing sliver skipped by producer
                continue
            op, ln = _REC.unpack_from(self._buf, pos)
            if op == 0:
                head += room_to_end  # wrap marker
                continue
            payload = bytes(self._buf[pos + _REC.size : pos + _REC.size + ln])
            head += _REC.size + ln
            out.append((op, payload))
            self.pops += 1
        self._cur[0] = head  # release consumed space
        return out

    # -- lifecycle ----------------------------------------------------------

    def counters(self) -> dict[str, int]:
        return {
            "pushes": self.pushes,
            "push_bytes": self.push_bytes,
            "wraps": self.wraps,
            "polls": self.polls,
            "pops": self.pops,
        }

    def close(self) -> None:
        # Release exported memoryviews before closing the segment.
        self._cur.release()
        self._buf.release()
        self._shm.close()
        if self._owner:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass


class EngineGroup:
    """Parent-side handle for one worker process and its two rings."""

    def __init__(self, group_id: int, node_ids: list[int]) -> None:
        self.group_id = group_id
        self.node_ids = node_ids
        self.events = ShmRing(create=True)  # worker -> parent
        self.commands = ShmRing(create=True, capacity=1 << 12)  # parent -> worker
        self.process: multiprocessing.Process | None = None
        self.ready = False
        self.ready_at: float | None = None  # perf_counter when READY arrived
        self.done = False
        self.error: str | None = None
        self.telemetry: dict | None = None

    def close(self) -> None:
        self.events.close()
        self.commands.close()


def _worker_main(group_id, node_ids, key_bytes, addresses, timeout_delay,
                 evt_name, cmd_name, started=None) -> None:
    """Worker entry: boot this group's engine shard, stream commit events
    to the parent, shut down on OP_STOP, post the telemetry snapshot.
    ``key_bytes`` holds each node's (public key, seed) as bytes;
    ``started``, a barrier of all groups, holds back the round-1 leader
    until every other engine listens."""
    from hotstuff_tpu_torch.crypto import PublicKey, SecretKey

    keys = [(PublicKey(pk), SecretKey(seed)) for pk, seed in key_bytes]
    events = ShmRing(name=evt_name)
    commands = ShmRing(name=cmd_name)
    try:
        asyncio.run(
            _worker_async(
                group_id, node_ids, keys, addresses, timeout_delay,
                events, commands, started,
            )
        )
        events.push(OP_DONE, _READY.pack(group_id))
    except BaseException as e:  # noqa: BLE001 - verdict must reach the parent
        if started is not None:
            started.abort()  # no group waits for this one
        try:
            events.push(OP_ERROR, f"group {group_id}: {e!r}".encode())
        except Exception:
            pass
        raise
    finally:
        events.close()
        commands.close()


async def _worker_async(group_id, node_ids, keys, addresses, timeout_delay,
                        events: ShmRing, commands: ShmRing, started=None) -> None:
    from hotstuff_tpu_torch import telemetry
    from hotstuff_tpu_torch.consensus import Authority, Committee, Consensus, Parameters
    from hotstuff_tpu_torch.consensus.leader import make_elector
    from hotstuff_tpu_torch.crypto import SignatureService, get_backend
    from hotstuff_tpu_torch.ops import msm_kernels, sha512
    from hotstuff_tpu_torch.store import Store

    # BEFORE engines are constructed (they capture metric objects at
    # creation): the final snapshot each group posts is the parent's only
    # view into the shard, so the registry must be live.
    telemetry.enable()
    # The backend HOTSTUFF_CRYPTO_BACKEND names, made now (its counters
    # record into the live registry): one that cannot be built raises here,
    # into the OP_ERROR verdict, before any engine runs.
    get_backend()
    # This group's kernel launches, from here on, go into its snapshot.
    msm_kernels.reset_launches()
    sha512.LAUNCHES["sha512"] = 0
    committee = Committee(
        authorities={
            pk: Authority(stake=1, address=addresses[i])
            for i, (pk, _) in enumerate(keys)
        }
    )
    params = Parameters(
        timeout_delay=timeout_delay, batch_vote_verification=True
    )

    first_leader = make_elector(committee, params.leader_elector).get_leader(1)
    order = [i for i in node_ids if keys[i][0] != first_leader]
    late = [i for i in node_ids if keys[i][0] == first_leader]

    engines, watchers, sinks = [], [], []
    for idx in order + late:
        if idx in late and started is not None:
            # Every other engine of every group listens past this point.
            await asyncio.get_running_loop().run_in_executor(
                None, started.wait, _START_TIMEOUT_S
            )
            started = None
        pk, sk = keys[idx]
        rx_mempool: asyncio.Queue = asyncio.Queue()
        tx_mempool: asyncio.Queue = asyncio.Queue()
        tx_commit: asyncio.Queue = asyncio.Queue()

        async def drain(q=tx_mempool):
            while True:
                await q.get()

        async def watch(q=tx_commit, node=idx):
            seq = 0
            while True:
                await q.get()
                seq += 1
                events.push(OP_COMMIT, _COMMIT.pack(node, seq))

        sinks.append(asyncio.create_task(drain()))
        watchers.append(asyncio.create_task(watch()))
        engines.append(
            await Consensus.spawn(
                pk, committee, params, SignatureService(sk), Store(),
                rx_mempool, tx_mempool, tx_commit,
            )
        )
    if started is not None:
        await asyncio.get_running_loop().run_in_executor(
            None, started.wait, _START_TIMEOUT_S
        )
    events.push(OP_READY, _READY.pack(group_id))

    # Poll the command ring off the loop's natural cadence; OP_STOP ends
    # the shard. The poll interval is latency of SHUTDOWN only — commit
    # events flow the other way without it.
    stopping = False
    while not stopping:
        for op, _payload in commands.pop_all():
            if op == OP_STOP:
                stopping = True
        await asyncio.sleep(0.02)

    for e in engines:
        await e.shutdown()
    for t in (*sinks, *watchers):
        t.cancel()
    # The launches before the counters: a card call still in flight counts
    # its dispatch before it launches, so no launch is read without it.
    launches = {**msm_kernels.LAUNCHES, **sha512.LAUNCHES}
    snap = telemetry.get_registry().snapshot()
    snap["parallel.ring"] = events.counters()
    snap["launches"] = launches
    events.push(OP_TELEMETRY, json.dumps(snap).encode())


class EngineGroupRuntime:
    """Boot a committee sharded over ``n_groups`` worker processes and
    measure commit progress from the parent.

    The parent never constructs an engine, decodes a frame, or verifies a
    signature — it generates the committee identity, spawns the groups,
    and consumes decision records (ready / commit / error / telemetry)
    from the event rings.
    """

    def __init__(self, n: int, n_groups: int, base_port: int = 18000,
                 timeout_delay: int = 30_000) -> None:
        if n_groups < 1:
            raise ValueError("n_groups must be >= 1")
        self.n = n
        self.n_groups = min(n_groups, n)
        self.base_port = base_port
        self.timeout_delay = timeout_delay
        self.groups: list[EngineGroup] = []
        self.commit_counts = [0] * n
        self.commit_at = [0.0] * n  # perf_counter of each node's latest commit
        self.timing: dict = {}  # set by ``measure``
        self._t_start = 0.0
        self._started = None  # the groups' start barrier (see ``start``)

    def start(self) -> None:
        from hotstuff_tpu_torch.crypto import generate_keypair

        keys = [generate_keypair() for _ in range(self.n)]
        key_bytes = [(pk.data, sk.seed) for pk, sk in keys]
        addresses = [("127.0.0.1", self.base_port + i) for i in range(self.n)]
        # spawn, not fork: a CUDA context cannot be re-initialised in a
        # forked child (module docstring). Keys go as bytes.
        ctx = multiprocessing.get_context("spawn")
        # Kept on the runtime: the groups attach its semaphores after
        # start() returns.
        self._started = ctx.Barrier(self.n_groups)
        self._t_start = time.perf_counter()
        for g in range(self.n_groups):
            node_ids = list(range(g, self.n, self.n_groups))
            group = EngineGroup(g, node_ids)
            group.process = ctx.Process(
                target=_worker_main,
                args=(
                    g, node_ids, key_bytes, addresses, self.timeout_delay,
                    group.events.name, group.commands.name, self._started,
                ),
                daemon=True,
            )
            _start(group.process)
            self.groups.append(group)

    def _drain(self) -> None:
        for g in self.groups:
            records = g.events.pop_all()
            now = time.perf_counter()
            for op, payload in records:
                if op == OP_READY:
                    g.ready, g.ready_at = True, now
                elif op == OP_COMMIT:
                    node, seq = _COMMIT.unpack(payload)
                    self.commit_counts[node] = seq
                    self.commit_at[node] = now
                elif op == OP_ERROR:
                    g.error = payload.decode(errors="replace")
                elif op == OP_TELEMETRY:
                    g.telemetry = json.loads(payload.decode())
                elif op == OP_DONE:
                    g.done = True

    def _check_failures(self) -> None:
        for g in self.groups:
            if g.error is not None:
                raise RuntimeError(g.error)
            if g.process is not None and not g.process.is_alive() and not g.done:
                raise RuntimeError(
                    f"group {g.group_id} died (exitcode "
                    f"{g.process.exitcode}) without a verdict"
                )

    def _wait(self, predicate, timeout: float, what: str) -> None:
        deadline = time.monotonic() + timeout
        while True:
            self._drain()
            if predicate():
                return
            self._check_failures()
            if time.monotonic() > deadline:
                raise TimeoutError(f"engine groups: timed out waiting for {what}")
            time.sleep(0.002)

    def measure(self, rounds_target: int, boot_timeout: float = 120.0,
                round_timeout: float = 600.0) -> float:
        """Seconds per round: wait for the first commit on every node
        (the single-process harness's measurement anchor), then time
        ``rounds_target`` more everywhere. ``timing`` keeps, in seconds
        from ``start``, each group's ready time and the first commit on
        every node, and ``stall_s``: from the earliest of the nodes'
        latest commits when the timed rounds began to their end, the
        longest any node can have gone without a commit in them."""
        self._wait(
            lambda: all(g.ready for g in self.groups), boot_timeout, "boot"
        )
        self.timing = {
            "ready_s": {g.group_id: g.ready_at - self._t_start for g in self.groups}
        }
        self._wait(
            lambda: all(c >= 1 for c in self.commit_counts),
            round_timeout, "first commit",
        )
        target = 1 + rounds_target
        t0 = time.perf_counter()
        before = min(self.commit_at)
        self._wait(
            lambda: all(c >= target for c in self.commit_counts),
            round_timeout, f"{rounds_target} rounds",
        )
        t_end = time.perf_counter()
        self.timing.update(first_commit_s=t0 - self._t_start, stall_s=t_end - before)
        return (t_end - t0) / rounds_target

    def stop(self, timeout: float = 60.0) -> dict:
        """Stop every group and merge telemetry: counter sums across the
        groups plus the parent-side ring pricing, keyed per group, and the
        groups' kernel launches summed (``launches``)."""
        for g in self.groups:
            try:
                g.commands.push(OP_STOP)
            except TimeoutError:
                pass
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self._drain()
            if all(g.done or g.error is not None for g in self.groups):
                break
            if all(
                g.process is None or not g.process.is_alive()
                for g in self.groups
            ):
                self._drain()
                break
            time.sleep(0.01)
        merged_counters: dict[str, int] = {}
        launches: dict[str, int] = {}
        rings: dict[str, dict] = {}
        for g in self.groups:
            if g.process is not None:
                g.process.join(timeout=10)
                if g.process.is_alive():
                    g.process.terminate()
                    g.process.join(timeout=10)
            if g.telemetry:
                for name, value in g.telemetry.get("counters", {}).items():
                    merged_counters[name] = merged_counters.get(name, 0) + value
                for name, value in g.telemetry.get("launches", {}).items():
                    launches[name] = launches.get(name, 0) + value
                rings[f"group{g.group_id}"] = g.telemetry.get(
                    "parallel.ring", {}
                )
            rings[f"group{g.group_id}.parent"] = {
                "events": g.events.counters(),
                "commands": g.commands.counters(),
            }
            g.close()
        try:
            from hotstuff_tpu_torch import telemetry

            telemetry.gauge("parallel.groups").set(self.n_groups)
            for name, value in merged_counters.items():
                telemetry.counter("parallel.merged." + name).inc(value)
        except Exception:
            pass
        return {"counters": merged_counters, "rings": rings, "launches": launches}


def _start(process: multiprocessing.Process) -> None:
    """Start a spawned ``process`` without the caller's main module.
    Spawn re-runs ``__main__`` in the child (as ``__mp_main__``) when it
    has a file or a spec; a group's target and arguments live in this
    package, so the child is given a main module with neither, and pays
    for none of the caller's imports and top-level work."""
    main = sys.modules["__main__"]
    sys.modules["__main__"] = types.ModuleType("__main__")
    try:
        process.start()
    finally:
        sys.modules["__main__"] = main


def run_grouped_committee(n: int, rounds_target: int, n_groups: int,
                          base_port: int = 18000,
                          timeout_delay: int = 30_000) -> tuple[float, dict]:
    """Convenience wrapper: boot, measure, stop. Returns
    (seconds_per_round, merged telemetry)."""
    rt = EngineGroupRuntime(
        n, n_groups, base_port=base_port, timeout_delay=timeout_delay
    )
    rt.start()
    try:
        per_round = rt.measure(rounds_target)
    finally:
        merged = rt.stop()
    return per_round, merged
