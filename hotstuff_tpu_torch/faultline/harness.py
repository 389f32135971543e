"""Faultline scenario runner: an in-process committee under scripted faults.

Boots an N-validator committee of full consensus engines over real
localhost TCP (the ``committee_scale --mode protocol`` testbed), installs
a :class:`~.runtime.FaultPlane` compiled from a scenario, enacts the
supervised schedule (engine crash/restart, byzantine actors), collects
every node's commit stream, and returns the checker's machine verdict
plus the canonical replay trace.

Determinism contract: the fault SCHEDULE — what fires, when, against
which node/link — is a pure function of the scenario seed (assert
``result["trace"]`` equality across runs). Wall-clock interleaving of
protocol messages is not replayed; the checker's invariants are exactly
the properties that must hold regardless of interleaving.

Virtual time anchors at the run's first full-committee commit (warm-up —
key generation, crypto backend compile, TCP dial-in — varies by machine
and must not eat the scenario's timeline).

Port copy of ``hotstuff_tpu/faultline/harness.py`` on the port's engines,
under whatever crypto backend is installed (``cuda-batched`` verifies
every QC on the card). Departures: ``_Engine.core()`` reads
``Consensus.core``, which the port's ``Consensus`` keeps, where the
reference digs the Core out of its first task's coroutine frame; and a
crash is ``Consensus.crash()``, the reference's teardown on both planes
(tasks cancelled, nothing shut down in order; an asyncio receiver's
server closed and its connections aborted, a native receiver's listener
closed and its id released before the call returns). The port's senders
close with their owners, so a crashed engine sends nothing until its
restart. The
default ``base_port`` is the reference's 21000; a caller on a host whose
ephemeral range starts lower passes a port below it.
"""

from __future__ import annotations

import asyncio
import logging
import time

from hotstuff_tpu_torch import telemetry

from . import hooks
from .byzantine import ByzantineActor
from .checker import CommitRecord, check
from .policy import Scenario
from .runtime import FaultPlane, install, uninstall

log = logging.getLogger("faultline")

__all__ = ["run_scenario", "ScenarioRun"]

_POLL_S = 0.05  # supervisor cadence; schedule times stay seed-derived
_RECOVERY_POLL_S = 0.2  # recovery-tail probe cadence (wall, not scheduled)


def _node_name(i: int) -> str:
    return f"n{i:03d}"  # zero-padded so sorted() == index order


class _Engine:
    """One seat: key, store, live Consensus handle, commit collector."""

    def __init__(self, index, name, keypair, store):
        self.index = index
        self.name = name
        self.pk, self.sk = keypair
        self.store = store
        self.consensus = None
        self.tasks: list[asyncio.Task] = []
        self.crashed = False

    def core(self):
        """The engine's Core instance (``Consensus.core`` in the port)."""
        if self.consensus is None:
            return None
        return self.consensus.core


class ScenarioRun:
    """Mutable run state; ``execute`` drives it end to end."""

    def __init__(
        self,
        scenario: Scenario,
        n: int,
        *,
        base_port: int = 21000,
        timeout_delay: int = 1_000,
        leader_elector: str = "",
        min_recovery_commits: int = 3,
        recovery_timeout_s: float = 30.0,
        retention_rounds: int = 0,
        clock=time.monotonic,
    ) -> None:
        from hotstuff_tpu_torch.consensus import Authority, Committee, Parameters
        from hotstuff_tpu_torch.crypto import generate_keypair

        self.scenario = scenario
        self.n = n
        # Injectable clock for the harness's OWN deadlines (boot, the
        # recovery tail): defaults to wall time on the real planes; the
        # simulation reuses the checker but supplies virtual deadlines,
        # so no wall-clock value leaks into a simulated verdict.
        self._clock = clock
        self.names = [_node_name(i) for i in range(n)]
        self.schedule = scenario.compile(self.names)
        self.min_recovery_commits = min_recovery_commits
        self.recovery_timeout_s = recovery_timeout_s

        seed_bytes = scenario.seed.to_bytes(8, "little", signed=False)
        keypairs = [
            generate_keypair(seed=bytes([i]) * 24 + seed_bytes)[:2]
            for i in range(n)
        ]
        addresses = [("127.0.0.1", base_port + i) for i in range(n)]
        self.committee = Committee(
            authorities={
                pk: Authority(stake=1, address=addresses[i])
                for i, (pk, _) in enumerate(keypairs)
            }
        )
        self.params = Parameters(
            timeout_delay=timeout_delay,
            batch_vote_verification=True,
            leader_elector=leader_elector,
            retention_rounds=retention_rounds,
        )
        from hotstuff_tpu_torch.store import Store

        self.engines = [
            _Engine(i, self.names[i], keypairs[i], Store())
            for i in range(n)
        ]
        self.plane = FaultPlane(
            self.schedule,
            {addresses[i]: self.names[i] for i in range(n)},
        )
        self.commits: dict[str, list[CommitRecord]] = {
            name: [] for name in self.names
        }
        self.actors: dict[tuple[str, str], ByzantineActor] = {}
        self._aux: list[asyncio.Task] = []

    # -- engine lifecycle ----------------------------------------------------

    async def _spawn_engine(self, eng: _Engine) -> None:
        from hotstuff_tpu_torch.consensus import Consensus
        from hotstuff_tpu_torch.crypto import SignatureService

        rx_mempool: asyncio.Queue = asyncio.Queue()
        tx_mempool: asyncio.Queue = asyncio.Queue()
        tx_commit: asyncio.Queue = asyncio.Queue()

        async def drain(q=tx_mempool):
            while True:
                await q.get()

        async def collect(q=tx_commit, name=eng.name):
            while True:
                blk = await q.get()
                self.commits[name].append(
                    CommitRecord(blk.round, blk.digest().data, self.plane.vnow())
                )

        # Everything the engine spawns inherits its faultline identity
        # (contextvars flow into create_task), so its senders resolve the
        # right source end of every link.
        token = hooks.NODE.set(eng.name)
        try:
            eng.consensus = await Consensus.spawn(
                eng.pk,
                self.committee,
                self.params,
                SignatureService(eng.sk),
                eng.store,
                rx_mempool,
                tx_mempool,
                tx_commit,
            )
            eng.tasks = [
                asyncio.create_task(drain()),
                asyncio.create_task(collect()),
            ]
        finally:
            hooks.NODE.reset(token)
        eng.crashed = False

    async def _crash_engine(self, eng: _Engine) -> None:
        """Unclean kill — cancel the actor tasks and yank the listeners,
        modeling a process crash. The store object survives (it is the
        node's disk), so a later restart exercises real state recovery.
        ``Consensus.crash`` is the reference's teardown: every task
        cancelled, the synchronizer and mempool driver shut, and each
        receiver aborted (``Receiver.abort``: its server closed, its
        connection handlers cancelled and its transports aborted;
        ``NativeReceiver.abort``: its listener closed)."""
        if eng.consensus is None or eng.crashed:
            return
        eng.consensus.crash()
        for t in eng.tasks:
            t.cancel()
        eng.consensus = None
        eng.crashed = True
        telemetry.counter("faultline.injected.crashes").inc()
        log.info("faultline crashed %s", eng.name)

    async def _restart_engine(self, eng: _Engine, wipe: bool = False) -> None:
        if not eng.crashed:
            return
        if wipe:
            # Cold rejoin (Lazarus): the node's disk is lost — replace
            # the store with a fresh empty one; the engine must recover
            # via state sync from its peers.
            from hotstuff_tpu_torch.store import Store

            eng.store = Store()
        await self._spawn_engine(eng)
        telemetry.counter("faultline.injected.restarts").inc()
        log.info(
            "faultline restarted %s%s", eng.name, " (wiped)" if wipe else ""
        )

    # -- byzantine actors ----------------------------------------------------

    def _honest_round(self) -> int:
        rounds = [
            e.core().round
            for e in self.engines
            if not e.crashed and e.core() is not None
        ]
        return max(rounds, default=1)

    async def _enact(self, action: dict) -> None:
        node = action["node"]
        eng = self.engines[self.names.index(node)]
        if action["action"] == "crash":
            await self._crash_engine(eng)
        elif action["action"] == "restart":
            await self._restart_engine(eng, wipe=action.get("wipe", False))
        elif action["action"] == "byzantine_on":
            key = (node, action["behavior"])
            if key not in self.actors:
                token = hooks.NODE.set(node)
                try:
                    self.actors[key] = ByzantineActor(
                        self.committee,
                        eng.pk,
                        eng.sk,
                        action["behavior"],
                        self.scenario.seed,
                        self._honest_round,
                    ).spawn()
                finally:
                    hooks.NODE.reset(token)
                telemetry.counter("faultline.injected.byzantine_actors").inc()
        elif action["action"] == "byzantine_off":
            actor = self.actors.pop((node, action["behavior"]), None)
            if actor is not None:
                await actor.shutdown()

    # -- lazarus frontier probe ----------------------------------------------

    async def _probe_frontier_availability(self) -> dict:
        """Post-run audit for retention-armed runs: every committed
        block must still be servable (block bytes or subsuming snapshot)
        at f+1 honest live stores — truncation may bound disk, never
        availability."""
        from hotstuff_tpu_torch.consensus.statesync import (
            SNAPSHOT_KEY,
            peek_frontier,
        )

        from .checker import check_frontier_availability

        committed: set = set()
        for recs in self.commits.values():
            for rec in recs:
                committed.add((rec.round, rec.digest))
        resolvers: dict = {}
        floors: dict[str, int] = {}
        for eng in self.engines:
            if eng.crashed:
                continue
            snap = await eng.store.read_meta(SNAPSHOT_KEY)
            if snap is not None:
                floors[eng.name] = peek_frontier(snap)[0]
            for _round, digest in committed:
                if await eng.store.read(digest) is not None:
                    resolvers.setdefault(digest, set()).add(eng.name)
        return check_frontier_availability(
            self.schedule, committed, resolvers, floors
        )

    # -- main drive ----------------------------------------------------------

    async def execute(self) -> dict:
        install(self.plane)
        try:
            return await self._execute_inner()
        finally:
            uninstall()
            for actor in self.actors.values():
                await actor.shutdown()
            for eng in self.engines:
                if eng.consensus is not None and not eng.crashed:
                    await eng.consensus.shutdown()
                for t in eng.tasks:
                    t.cancel()
            for t in self._aux:
                t.cancel()

    async def _execute_inner(self) -> dict:
        for eng in self.engines:
            await self._spawn_engine(eng)

        # Warm-up: anchor virtual time at the first full-committee
        # commit. The deadline scales with committee size: N engines in
        # one process dial N*(N-1) connections before the first proposal
        # can quorum (minutes at N=100 on one core).
        boot_deadline = self._clock() + max(120, 3 * self.n)
        while any(not self.commits[name] for name in self.names):
            if self._clock() > boot_deadline:
                raise RuntimeError("committee failed to reach first commit")
            await asyncio.sleep(0.1)
        self.plane.start()
        log.info(
            "faultline scenario %r (seed %d) armed on %d nodes",
            self.scenario.name, self.scenario.seed, self.n,
        )

        # Drive the schedule.
        while self.plane.vnow() < self.scenario.duration_s:
            for action in self.plane.poll_actions():
                await self._enact(action)
            await asyncio.sleep(_POLL_S)

        # Recovery tail: give the committee a bounded window to prove
        # post-heal commit growth before judging.
        heal_t = self.schedule.last_heal_time()
        expected = set(self.names) - self.schedule.crashed_forever() - {
            e.params["node"]
            for e in self.schedule.events
            if e.kind == "byzantine"
        }
        deadline = self._clock() + self.recovery_timeout_s
        while self._clock() < deadline:
            for action in self.plane.poll_actions():  # late heals
                await self._enact(action)
            if all(
                sum(1 for r in self.commits[n] if r.t > heal_t)
                >= self.min_recovery_commits
                for n in expected
            ):
                break
            await asyncio.sleep(_RECOVERY_POLL_S)

        verdict = check(
            self.schedule,
            self.commits,
            min_recovery_commits=self.min_recovery_commits,
            injections=self.plane.injection_summary(),
        )
        if self.params.retention_rounds > 0:
            verdict["frontier_availability"] = (
                await self._probe_frontier_availability()
            )
        flight_path = None
        if not (
            verdict["safety"]["ok"]
            and verdict["liveness"]["recovered"]
            and verdict.get("frontier_availability", {"ok": True})["ok"]
        ):
            # Checker failure => actionable postmortem, not just a
            # verdict: dump the flight recorder (the last ring of
            # protocol trace events across every in-process engine, plus
            # the registry state and the fault injection summary).
            flight_path = _dump_flight_for(self, verdict)
        return {
            "flight_record": flight_path,
            "verdict": verdict,
            "trace": self.schedule.trace(),
            "telemetry": telemetry.get_registry().snapshot(),
            # Raw per-node commit streams in virtual time — tests assert
            # window properties (e.g. silence while partitioned) the
            # aggregate verdict cannot express.
            "commit_streams": {
                name: [(rec.round, rec.t) for rec in recs]
                for name, recs in self.commits.items()
            },
        }


def _dump_flight_for(run: "ScenarioRun", verdict: dict) -> str | None:
    """Write the flight record for a failed run. Destination:
    ``HOTSTUFF_FLIGHT_DIR`` when set, else the system temp dir (a
    failing chaos TEST must not litter the working tree)."""
    if not telemetry.enabled():
        return None
    import os
    import tempfile

    directory = os.environ.get("HOTSTUFF_FLIGHT_DIR", tempfile.gettempdir())
    path = os.path.join(
        directory,
        f"flightrec-{run.scenario.name}-seed{run.scenario.seed}"
        f"-n{run.n}.json",
    )
    return telemetry.dump_flight_record(
        path,
        "checker_failure",
        telemetry.trace_buffer(),
        telemetry.get_registry(),
        extra={
            "verdict": verdict,
            "injections": run.plane.injection_summary(),
        },
    )


async def run_scenario(scenario: Scenario, n: int, **kwargs) -> dict:
    """Execute ``scenario`` on an ``n``-node in-process committee; returns
    ``{"verdict", "trace", "telemetry"}`` (see module docstring)."""
    return await ScenarioRun(scenario, n, **kwargs).execute()
