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
flush armed, as the reference does (``:151-192``). Left out: the faultline
scenario hook (reference ``:37-64``), and the faultline counters and
flight record of ``crash``/``restart`` (``:245-256``, ``:306``).
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
        the listeners' transports, with no graceful drain, as a process
        crash would, but keep the store open (it is the node's disk, and
        ``restart`` recovers from what it persisted)."""
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
