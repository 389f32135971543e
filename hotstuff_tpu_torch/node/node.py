"""Node composition root (reference ``node/src/node.rs:18-81``): read
committee and secret, open the store, start the signature service, spawn
the Mempool and Consensus wired by their channels, and consume the commit
stream (``analyze_block`` is the application's attach point).

Port of ``hotstuff_tpu/node/node.py``: ``Node.new``, ``analyze_block``,
the supervised ``crash``/``restart`` and ``shutdown``. When the mempool
runs the data plane (``workers > 0``), committed blocks pass through its
``CommitResolver`` before the commit stream (reference ``:121-136``).
``device`` (default ``"cuda"``) goes down to the mempool's processors,
whose SHA-512 kernel it runs when ``device_batch_digests`` is on; the
certificate path's device is the crypto backend's
(``HOTSTUFF_CRYPTO_BACKEND``). With telemetry on, ``new`` installs the
resource collector, starts the sampling profiler under ``HOTSTUFF_PYPROF``
and streams snapshots to ``HOTSTUFF_TELEMETRY[_DIR]`` with the shutdown
flush armed, as the reference does (``:151-192``).
``HOTSTUFF_FAULTLINE=<scenario.json>`` arms faultline before any actor
spawns (reference ``:28-69``, ``:99-102``), and ``crash``/``restart``
count ``faultline.injected.crashes``/``restarts`` and dump the
``node_crash`` flight record (``:245-256``, ``:306``). One departure: in a
process that boots several nodes from the same scenario (each in a task
of its own, so that each keeps its own ``faultline.hooks.NODE``), the
nodes share the one plane the first of them armed, where the reference
arms one plane per process and so one per node.
"""

from __future__ import annotations

import asyncio
import logging
import os

from hotstuff_tpu_torch import telemetry
from hotstuff_tpu_torch.consensus import Consensus
from hotstuff_tpu_torch.crypto import SignatureService, get_backend
from hotstuff_tpu_torch.mempool import Mempool
from hotstuff_tpu_torch.mempool.dataplane import CommitResolver
from hotstuff_tpu_torch.store import Store

from .config import Committee, Parameters, Secret

log = logging.getLogger("node")

CHANNEL_CAPACITY = 1_000

#: (scenario path, plane) armed by ``_install_faultline_from_env`` in this
#: process: later nodes booted from the same scenario share that plane.
_armed: tuple | None = None


def _committee_node_names(committee: Committee) -> dict:
    """Deterministic scenario names for a committee's members: sort by
    consensus address and name positionally (``n000``...). Every process
    reading the same committee file derives the same mapping, so one
    scenario file coordinates a whole LocalBench/netns deployment."""
    ordered = sorted(
        committee.consensus.authorities.items(),
        key=lambda kv: kv[1].address,
    )
    return {pk: f"n{i:03d}" for i, (pk, _) in enumerate(ordered)}


def _install_faultline_from_env(committee: Committee, name) -> None:
    """``HOTSTUFF_FAULTLINE=<scenario.json>`` arms this process's fault
    plane: the scenario compiles against the committee-derived node names
    and the plane starts at process boot (virtual t=0 ≈ node boot; the
    few hundred ms of boot skew between processes is noise at scenario
    timescales). The node's own identity comes from its key, set in the
    caller's context; a node booted later in the same process from the
    same scenario takes the plane already armed."""
    global _armed
    scenario_path = os.environ.get("HOTSTUFF_FAULTLINE")
    if not scenario_path:
        return
    from hotstuff_tpu_torch.faultline import FaultPlane, Scenario, hooks, install

    names = _committee_node_names(committee)
    if _armed is not None and _armed[0] == scenario_path and hooks.plane is _armed[1]:
        hooks.NODE.set(names[name])
        log.info("faultline armed from %s as %s (shared plane)", scenario_path, names[name])
        return
    addr_to_node: dict = {}
    consensus_addrs = set()
    for pk, auth in committee.consensus.authorities.items():
        addr_to_node[tuple(auth.address)] = names[pk]
        consensus_addrs.add(tuple(auth.address))
    for pk, auth in committee.mempool.authorities.items():
        addr_to_node[tuple(auth.mempool_address)] = names[pk]
        for w in auth.workers:
            # Conveyor worker ports: partitions/link faults apply to the
            # data plane's dissemination traffic too.
            addr_to_node[tuple(w.worker_address)] = names[pk]
    scenario = Scenario.load(scenario_path)
    schedule = scenario.compile(sorted(names.values()))
    plane = FaultPlane(schedule, addr_to_node, consensus_addrs)
    install(plane).start()
    _armed = (scenario_path, plane)
    hooks.NODE.set(names[name])
    log.info(
        "faultline armed from %s as %s (seed %d)",
        scenario_path, names[name], scenario.seed,
    )


class Node:
    def __init__(self) -> None:
        self.commit: asyncio.Queue = asyncio.Queue(CHANNEL_CAPACITY)
        self.name = None
        self.mempool: Mempool | None = None
        self.consensus: Consensus | None = None
        self.store: Store | None = None
        self.resolver: CommitResolver | None = None  # the data plane's commit path
        self.resolver_task: asyncio.Task | None = None
        self.telemetry_emitter: telemetry.TelemetryEmitter | None = None
        self.crashed = False
        # The crashed engine's compactor: its background log rewrite may
        # still run, and must end before a restart or the store's close.
        self._crashed_compactor = None
        # What ``restart`` boots from: (secret, committee, parameters,
        # benchmark, device).
        self._boot: tuple | None = None

    @classmethod
    async def new(
        cls,
        committee_file: str,
        key_file: str,
        store_path: str,
        parameters_file: str | None = None,
        benchmark: bool = False,
        device="cuda",
    ) -> "Node":
        self = cls()
        secret = Secret.read(key_file)
        committee = Committee.read(committee_file)
        parameters = (
            Parameters.read(parameters_file) if parameters_file else Parameters.default()
        )
        self.name = secret.name
        # The certificate path's backend is made at boot, not at the first
        # verify: a CpuBackend builds its native engine when it is made.
        get_backend()
        self.store = Store(store_path)
        self._boot = (secret, committee, parameters, benchmark, device)
        # Arm fault injection BEFORE any actor spawns: the faultline node
        # identity is a contextvar, and tasks inherit the context they
        # were created in.
        _install_faultline_from_env(committee, secret.name)
        await self._spawn()

        # Resource observability (RSS, on-disk store size, optional
        # tracemalloc) + the continuous sampling profiler. The resource
        # collector is registered whenever telemetry is on — it costs
        # nothing until a snapshot polls it; the profiler is opt-in via
        # HOTSTUFF_PYPROF=1 (HOTSTUFF_PYPROF_INTERVAL_MS tunes the
        # cadence) and its hotstuff-profile-v1 records ride the node's
        # snapshot stream via the emitter below.
        if telemetry.enabled():
            from hotstuff_tpu_torch.telemetry import profiler as pyprof, resources

            resources.install(store_path=store_path)
            if os.environ.get("HOTSTUFF_PYPROF") and pyprof.active() is None:
                prof = pyprof.SamplingProfiler(
                    interval_ms=pyprof.env_interval_ms()
                )
                prof.start(mode="auto")
                telemetry.register_collector("profile", prof.collector)
                log.info(
                    "sampling profiler armed (%s mode, %.1f ms)",
                    prof.mode, prof.interval_ms,
                )

        # Telemetry snapshot stream (HOTSTUFF_TELEMETRY[_DIR]): periodic
        # JSON-lines snapshots plus a final one at shutdown —
        # benchmark/logs.py reads these alongside the regex log scrape.
        stream_path = telemetry.env_stream_path(str(secret.name))
        if telemetry.enabled() and stream_path is not None:
            self.telemetry_emitter = telemetry.TelemetryEmitter(
                telemetry.get_registry(),
                stream_path,
                node=str(secret.name),
                interval_s=telemetry.env_interval_s(),
                trace=telemetry.trace_buffer(),
                dtrace=telemetry.dtrace_buffer(),
            ).spawn()
            # Unclean teardown (SIGTERM, atexit) still flushes the final
            # snapshot + trace tail and dumps the flight record.
            telemetry.arm_shutdown_flush(
                self.telemetry_emitter,
                flight_path=telemetry.env_flight_path(str(secret.name)),
            )

        log.info("Node %s successfully booted", secret.name)
        return self

    async def _spawn(self) -> None:
        """Spawn the mempool and the consensus engine on ``self.store``,
        wired by their channels (the boot of ``new`` and ``restart``)."""
        secret, committee, parameters, benchmark, device = self._boot
        signature_service = SignatureService(secret.secret)

        tx_consensus_to_mempool: asyncio.Queue = asyncio.Queue(CHANNEL_CAPACITY)
        tx_mempool_to_consensus: asyncio.Queue = asyncio.Queue(CHANNEL_CAPACITY)

        self.mempool = Mempool(
            secret.name,
            committee.mempool,
            parameters.mempool,
            self.store,
            tx_consensus_to_mempool,
            tx_mempool_to_consensus,
            benchmark=benchmark,
            device=device,
            signature_service=signature_service,
        )
        await self.mempool.spawn()

        # The data plane's commit path: consensus ordered digests it could
        # prove available, so committed blocks pass through the resolver
        # (which fetches any batch this node never received) before the
        # application sees them.
        commit_sink = self.commit
        if self.mempool.dataplane is not None:
            commit_sink = asyncio.Queue(CHANNEL_CAPACITY)
            self.resolver = CommitResolver(
                self.store, commit_sink, self.commit, tx_consensus_to_mempool,
                self.mempool.dataplane,
            )
            self.resolver_task = self.resolver.start()

        self.consensus = await Consensus.spawn(
            secret.name,
            committee.consensus,
            parameters.consensus,
            signature_service,
            self.store,
            tx_mempool_to_consensus,
            tx_consensus_to_mempool,
            commit_sink,
            benchmark=benchmark,
        )

    async def analyze_block(self) -> None:
        """Sink committed blocks, the execution engine's attach point
        (reference ``node/src/node.rs:76-80``). Raises what killed a
        mempool actor (a failed digest kernel): the node's run ends with
        it."""
        failed = self.mempool.failed
        while True:
            block = asyncio.ensure_future(self.commit.get())
            await asyncio.wait({block, failed}, return_when=asyncio.FIRST_COMPLETED)
            if failed.done():
                block.cancel()
                failed.result()

    # -- supervised crash/restart --------------------------------------------

    async def crash(self) -> None:
        """Kill the node the UNCLEAN way: cancel every actor task and abort
        the listeners, with no graceful drain, as a process crash would,
        but keep the store open (it is the node's disk, and ``restart``
        recovers from what it persisted). On the native transport
        ``Consensus.crash`` closes the consensus listener and releases its
        id, as the reference's native branch does (``node/node.py:230-231``);
        the mempool's receivers and the data plane shut down through
        ``shutdown`` on both planes."""
        if self.crashed:
            return
        if self.consensus is not None:
            self.consensus.crash()
            self._crashed_compactor = self.consensus.compactor
            self.consensus = None
        if self.mempool is not None:
            for t in self.mempool.tasks:
                t.cancel()
            if self.mempool.dataplane is not None:
                await self.mempool.dataplane.shutdown()
            for r in self.mempool.receivers:
                await r.shutdown()
            self.mempool = None
        if self.resolver_task is not None:
            self.resolver_task.cancel()
            self.resolver, self.resolver_task = None, None
        self.crashed = True
        telemetry.counter("faultline.injected.crashes").inc()
        if telemetry.enabled() and self._boot is not None:
            # Postmortem: the last ring of protocol events at the moment
            # of the (injected) crash, plus the registry state.
            flight_path = telemetry.env_flight_path(str(self._boot[0].name))
            if flight_path is not None:
                telemetry.dump_flight_record(
                    flight_path,
                    "node_crash",
                    telemetry.trace_buffer(),
                    telemetry.get_registry(),
                )
        log.warning("Node crashed (supervised)")

    async def restart(self) -> "Node":
        """Bring a crashed node back on the SAME store: ``Core._restore_state``
        restores the round, the last vote and the high QC, and
        ``StateSync.start`` the snapshot floor, as for a process restarting
        on its disk."""
        if not self.crashed:
            return self
        assert self._boot is not None, "restart() before new()"
        await self._drain_crashed()
        await self._spawn()
        self.crashed = False
        telemetry.counter("faultline.injected.restarts").inc()
        log.info("Node restarted (supervised)")
        return self

    async def _drain_crashed(self) -> None:
        if self._crashed_compactor is not None:
            await self._crashed_compactor.drain()
            self._crashed_compactor = None

    async def shutdown(self) -> None:
        await self._drain_crashed()
        if self.consensus is not None:
            await self.consensus.shutdown()
        if self.mempool is not None:
            await self.mempool.shutdown()
        if self.resolver_task is not None:
            self.resolver_task.cancel()
        if self.telemetry_emitter is not None:
            await self.telemetry_emitter.shutdown()
        if self.store is not None:
            self.store.close()
