"""SimWorld: N sans-io consensus machines on one virtual-time event heap.

Port copy of ``hotstuff_tpu/sim/world.py``, whole: the same seeded
committee keys (``_KEYPAIR_CACHE``), link-latency streams and event order,
so a run's verdict and per-node commit sequence equal the reference's.

A fully simulated execution of a faultline :class:`~..faultline.policy.
Scenario`: the same compiled :class:`~..faultline.policy.Schedule`, the
same :class:`~..faultline.runtime.FaultPlane` link filters (driven by
the injected virtual clock), the same :func:`~..faultline.checker.check`
verdict — and zero real sleeping. A 20-virtual-second chaos schedule
with two view changes costs milliseconds of CPU, which is what turns the
seeded sweep from "a handful of pinned seeds" into a search
(the reference's ``benchmark/sim_sweep.py``).

Determinism: every event is ``(time, seq, ...)`` with ``seq`` a
monotonic insertion counter — ties process in scheduling order, so two
runs of the same ``(scenario, n, jitter)`` produce byte-identical commit
streams. Message latency comes from per-directed-link RNG streams
derived from ``(scenario.seed, jitter)``; ``jitter`` perturbs ONLY the
latency draws, giving a cheap way to explore interleavings of one fault
schedule.

Twins support: ``twins`` maps extra node INSTANCES onto an existing
seat (same keypair, same address, separate store/machine). Frames to
that address fan out to every instance, each filtered independently by
the fault plane under its own instance name — the Twins-paper network
model of one equivocating identity living in several partitions at
once (:mod:`hotstuff_tpu_torch.sim.twins` generates the scenarios).
"""

from __future__ import annotations

import heapq
import itertools
import logging

from hotstuff_tpu_torch.consensus.config import Authority, Committee
from hotstuff_tpu_torch.consensus.decode_arena import decode_shared
from hotstuff_tpu_torch.consensus.errors import MalformedMessage
from hotstuff_tpu_torch.consensus.messages import (
    Block,
    QC,
    Vote,
    encode_propose,
    encode_vote,
)
from hotstuff_tpu_torch.crypto import enable_verify_memo, generate_keypair, sha512_digest
from hotstuff_tpu_torch.faultline.checker import CommitRecord, check
from hotstuff_tpu_torch.faultline.policy import Scenario, _seed_stream
from hotstuff_tpu_torch.faultline.runtime import FaultPlane
from hotstuff_tpu_torch.utils.serde import SerdeError

from .clock import VirtualClock
from .machine import CoreStateMachine, _NotifyingStore

log = logging.getLogger("sim")

__all__ = ["SimWorld", "run_sim", "EventHeap"]

#: byzantine-actor burst cadence, mirrored from faultline.byzantine.
_BYZ_PERIOD_S = 0.05

#: epsilon nudging timer checks past float-equal deadlines.
_EPS = 1e-9


def _node_name(i: int) -> str:
    return f"n{i:03d}"  # matches faultline.harness naming


# Committee keypairs are a function of (index) only — NOT of the
# scenario seed — so a sweep over thousands of seeds generates keys
# once and the decode arena can share identical frames across runs.
_KEYPAIR_CACHE: dict[int, tuple] = {}


def _keypair(i: int):
    kp = _KEYPAIR_CACHE.get(i)
    if kp is None:
        kp = _KEYPAIR_CACHE[i] = generate_keypair(
            seed=bytes([i % 251]) * 24 + b"simworld"
        )[:2]
    return kp


class EventHeap:
    """Deterministic (time, seq)-ordered event queue: same-instant events
    pop in push order, whatever their payloads hash to."""

    def __init__(self) -> None:
        self._heap: list = []
        self._seq = itertools.count()

    def push(self, t: float, item) -> None:
        heapq.heappush(self._heap, (t, next(self._seq), item))

    def pop(self):
        t, _, item = heapq.heappop(self._heap)
        return t, item

    def peek_time(self) -> float | None:
        return self._heap[0][0] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)


class _Slot:
    """One node INSTANCE: seat key + address + persistent store, plus the
    current machine incarnation (None while crashed)."""

    __slots__ = (
        "index",
        "name",
        "base",
        "pk",
        "sk",
        "address",
        "engine",
        "machine",
        "incarnation",
        "timer_gen",
        "timer_target",
        "crashed",
    )

    def __init__(self, index, name, base, pk, sk, address) -> None:
        self.index = index
        self.name = name
        self.base = base  # committee seat name (== name except twins)
        self.pk = pk
        self.sk = sk
        self.address = address
        self.engine = None  # survives restarts: the node's "disk"
        self.machine: CoreStateMachine | None = None
        self.incarnation = 0
        self.timer_gen = 0
        self.timer_target = None
        self.crashed = False


class _SimByzantine:
    """Synchronous replay of ``faultline.byzantine.ByzantineActor``'s
    attack bursts (equivocate / stale_vote_flood) on the virtual
    timeline; the same seed-derived RNG stream, the same message
    construction, one burst per scheduled tick."""

    def __init__(self, world: "SimWorld", slot: _Slot, behavior: str) -> None:
        self.world = world
        self.slot = slot
        self.behavior = behavior
        self.rng = _seed_stream(
            world.scenario.seed, "byzantine", behavior, str(slot.pk)
        )
        self.active = True
        self.sent = 0

    def burst(self) -> None:
        committee = self.world.committee
        peers = [a for _, a in committee.broadcast_addresses(self.slot.pk)]
        if self.behavior == "equivocate":
            round_ = self.world._honest_round() + 1
            parent = sha512_digest(b"equivocation-parent", self.rng.randbytes(8))
            fake_qc = QC(hash=parent, round=round_ - 1, votes=[])
            half = len(peers) // 2
            for salt, targets in ((b"a", peers[:half]), (b"b", peers[half:])):
                block = Block.new_from_key(
                    fake_qc,
                    None,
                    self.slot.pk,
                    round_,
                    [sha512_digest(b"equiv-payload-" + salt)],
                    self.slot.sk,
                )
                data = encode_propose(block)
                for addr in targets or peers:
                    self.world._transmit(self.slot, addr, data)
                self.sent += 1
        elif self.behavior == "stale_vote_flood":
            current = self.world._honest_round()
            for _ in range(8):
                stale_round = max(1, current - self.rng.randrange(1, 50))
                vote = Vote.new_from_key(
                    sha512_digest(b"stale", self.rng.randbytes(8)),
                    stale_round,
                    self.slot.pk,
                    self.slot.sk,
                )
                data = encode_vote(vote)
                for addr in peers:
                    self.world._transmit(self.slot, addr, data)
                self.sent += 1
        # silent_leader needs no actor: the plane's send filter drops the
        # node's proposals (identical to the real runtime).


class SimWorld:
    def __init__(
        self,
        scenario: Scenario,
        n: int,
        *,
        timeout_delay: int = 1_000,
        sync_retry_delay: int = 10_000,
        leader_elector: str = "",
        batch_vote_verification: bool = True,
        min_recovery_commits: int = 3,
        recovery_timeout_s: float = 30.0,
        # Per-hop latency draw: (25, 75) ms paces a simulated committee
        # at roughly the round cadence the REAL N=4 localhost plane
        # shows for the same schedules (~100 ms/round), so a scenario's
        # virtual seconds cover comparable protocol ground on both
        # planes. Lower it for more rounds per schedule, at sweep cost.
        link_delay_ms: tuple[float, float] = (25.0, 75.0),
        jitter: int = 0,
        twins: dict[str, str] | None = None,
        base_port: int = 47000,
        verify_memo: bool = True,
        # Lazarus: snapshot/truncate retention depth (0 = no compaction)
        # and the anti-entropy probe loop (opt-in: committed sweep seeds
        # keep byte-identical event streams with it off).
        retention_rounds: int = 0,
        statesync_active: bool = False,
        # Oracle: a sim.streams.StreamRecorder capturing every node's
        # round-trace marks on the virtual clock for rendering into
        # real-shape telemetry streams.
        recorder=None,
        # Twins (per-round adversary controls): a {round: seat_name}
        # leader override, a {round: [group, ...]} network partition
        # keyed on the SENDER's current round, and per-instance proposal
        # salting so a twin pair's blocks conflict by digest.
        leader_schedule: dict[int, str] | None = None,
        round_partitions: dict[int, list] | None = None,
        twin_proposal_salt: bool = False,
    ) -> None:
        self.scenario = scenario
        self.n = n
        self.min_recovery_commits = min_recovery_commits
        self.recovery_timeout_s = recovery_timeout_s
        self.link_delay = (link_delay_ms[0] / 1e3, link_delay_ms[1] / 1e3)
        self.jitter = jitter
        self._verify_memo = verify_memo
        self._mach_kwargs = dict(
            timeout_delay=timeout_delay,
            sync_retry_delay=sync_retry_delay,
            leader_elector=leader_elector,
            batch_vote_verification=batch_vote_verification,
            retention_rounds=retention_rounds,
            statesync_active=statesync_active,
        )

        base_names = [_node_name(i) for i in range(n)]
        twins = dict(twins or {})
        for inst, base in twins.items():
            if base not in base_names:
                raise ValueError(f"twin {inst!r} maps to unknown node {base!r}")
        self.twins = twins
        instance_names = base_names + sorted(twins)
        # The compiled fault schedule ranges over INSTANCES so partitions
        # can separate a twin pair sharing one committee seat.
        self.schedule = scenario.compile(instance_names)

        addresses = {
            name: ("127.0.0.1", base_port + i)
            for i, name in enumerate(base_names)
        }
        keypairs = {name: _keypair(i) for i, name in enumerate(base_names)}
        self.committee = Committee(
            authorities={
                keypairs[name][0]: Authority(stake=1, address=addresses[name])
                for name in base_names
            }
        )

        self.clock = VirtualClock()
        self._recorder = recorder
        if recorder is not None:
            recorder.bind(
                self.clock,
                {repr(keypairs[name][0]): name for name in base_names},
            )
        self._twin_salt = bool(twin_proposal_salt)
        self._round_partitions = None
        if round_partitions:
            self._round_partitions = {
                int(r): [frozenset(g) for g in groups]
                for r, groups in round_partitions.items()
            }
        self._elector_override = None
        if leader_schedule is not None:
            from hotstuff_tpu_torch.consensus.leader import ScheduledLeaderElector

            self._elector_override = ScheduledLeaderElector(
                self.committee,
                {
                    int(r): keypairs[name][0]
                    for r, name in leader_schedule.items()
                },
            )
        self.plane = FaultPlane(
            self.schedule,
            {addresses[name]: name for name in base_names},
            clock=self.clock,
        )

        self.slots: list[_Slot] = []
        self._by_addr: dict[tuple[str, int], list[_Slot]] = {}
        for i, name in enumerate(instance_names):
            base = twins.get(name, name)
            pk, sk = keypairs[base]
            slot = _Slot(i, name, base, pk, sk, addresses[base])
            self.slots.append(slot)
            self._by_addr.setdefault(slot.address, []).append(slot)
        self._by_name = {s.name: s for s in self.slots}

        self.heap = EventHeap()
        self.commits: dict[str, list[CommitRecord]] = {
            s.name: [] for s in self.slots
        }
        self._link_rngs: dict[tuple[str, str], object] = {}
        self._byz: dict[tuple[str, str], _SimByzantine] = {}
        self.events_processed = 0
        self.decode_errors = 0
        self._recovered = False
        self._heal_t = self.schedule.last_heal_time()
        byz_nodes = {
            e.params["node"]
            for e in self.schedule.events
            if e.kind == "byzantine"
        }
        twin_bases = set(twins.values())
        self._expected = (
            {s.name for s in self.slots}
            - self.schedule.crashed_forever()
            - byz_nodes
            - twin_bases
            - set(twins)
        )

    # -- helpers -----------------------------------------------------------

    def _honest_round(self) -> int:
        rounds = [
            s.machine.round
            for s in self.slots
            if s.machine is not None and not s.crashed
        ]
        return max(rounds, default=1)

    def _link_rng(self, src: str, dst: str):
        key = (src, dst)
        rng = self._link_rngs.get(key)
        if rng is None:
            rng = self._link_rngs[key] = _seed_stream(
                self.scenario.seed, "simnet", str(self.jitter), src, dst
            )
        return rng

    def _base_delay(self, src: str, dst: str) -> float:
        lo, hi = self.link_delay
        if hi <= 0.0:
            return 0.0
        return self._link_rng(src, dst).uniform(lo, hi)

    # -- transmission ------------------------------------------------------

    def _transmit(self, src_slot: _Slot, address, data: bytes) -> None:
        """Route one unframed wire message through the fault plane to
        every instance listening on ``address``."""
        now = self.clock.now
        rp = self._round_partitions
        if rp is not None and src_slot.machine is not None:
            # Twins per-round partition: connectivity for a message is
            # decided by the SENDER's current round. Rounds without an
            # assignment are fully connected.
            groups = rp.get(src_slot.machine.round)
        else:
            groups = None
        for dst_slot in self._by_addr.get(address, ()):
            if groups is not None and not any(
                src_slot.name in g and dst_slot.name in g for g in groups
            ):
                continue
            plan = self.plane.filter_send(
                address, data, payload_off=0,
                src=src_slot.name, dst=dst_slot.name,
            )
            delay, copies = 0.0, 1
            if plan is not None:
                action, delay, copies = plan
                if action == "drop":
                    continue
            recv = self.plane.filter_recv(address, dst=dst_slot.name)
            if recv is not None:
                if recv[0] == "drop":
                    continue
                delay += recv[1]
            for _ in range(copies):
                at = now + delay + self._base_delay(src_slot.name, dst_slot.name)
                self.heap.push(
                    at, ("frame", dst_slot.index, dst_slot.incarnation, data)
                )

    def _apply_effects(self, slot: _Slot, effects: list) -> None:
        now = self.clock.now
        for eff in effects:
            tag = eff[0]
            if tag == "send":
                self._transmit(slot, eff[1], eff[2])
            elif tag == "sched":
                self.heap.push(
                    now + eff[1],
                    ("event", slot.index, slot.incarnation, eff[2]),
                )
            elif tag == "commit":
                block = eff[1]
                self.commits[slot.name].append(
                    CommitRecord(
                        block.round, block.digest().data, self.plane.vnow()
                    )
                )
            else:  # pragma: no cover - machine/world contract violation
                raise RuntimeError(f"unknown effect {tag!r}")
        self._arm_timer(slot)

    # -- timers ------------------------------------------------------------

    def _arm_timer(self, slot: _Slot) -> None:
        if slot.machine is None:
            return
        deadline = slot.machine.timer_deadline
        if slot.timer_target == deadline:
            return
        slot.timer_target = deadline
        slot.timer_gen += 1
        self.heap.push(
            max(deadline, self.clock.now),
            ("timer", slot.index, slot.incarnation, slot.timer_gen),
        )

    # -- lifecycle ---------------------------------------------------------

    def _spawn(self, slot: _Slot) -> None:
        store = _NotifyingStore(engine=slot.engine)
        machine = CoreStateMachine(
            slot.pk,
            slot.sk,
            self.committee,
            clock=self.clock,
            store=store,
            **self._mach_kwargs,
        )
        slot.engine = store._engine  # first spawn: adopt the fresh engine
        slot.machine = machine
        slot.crashed = False
        slot.timer_target = None
        if self._elector_override is not None:
            # Per-round Twins control: every instance (twins included)
            # consults the same fixed schedule. Stateless, so shared.
            machine.core.leader_elector = self._elector_override
        if self._twin_salt:
            machine.proposal_salt = slot.name.encode()
            # Every instance must treat every other instance's salted
            # payload digest as available (see _SimMempoolDriver): the
            # Twins model assumes universal batch availability; digest
            # divergence — not data withholding — is what's under test.
            machine.mempool_driver.twin_salts = tuple(
                s.name.encode() for s in self.slots
            )
        if self._recorder is not None:
            # Splice the virtual-clock trace in BEFORE init() so the
            # restored-round proposal of a restarting leader is on tape.
            self._recorder.attach(slot)
        self._apply_effects(slot, machine.init(self.clock.now))

    def _crash(self, slot: _Slot) -> None:
        if slot.crashed or slot.machine is None:
            return
        if self._recorder is not None:
            # SIGKILL semantics: close the writer epoch; events past the
            # last emit boundary die with it at render time.
            self._recorder.crashed(slot.name)
        slot.machine = None
        slot.crashed = True
        slot.incarnation += 1  # drops every in-flight frame/event/timer
        log.info("sim crashed %s at v=%.3f", slot.name, self.plane.vnow())

    def _restart(self, slot: _Slot, wipe: bool = False) -> None:
        if not slot.crashed:
            return
        slot.incarnation += 1
        if wipe:
            # Cold rejoin: the node's "disk" is lost — the next spawn
            # starts on an empty store and must recover via state sync.
            slot.engine = None
        self._spawn(slot)
        log.info(
            "sim restarted %s%s at v=%.3f",
            slot.name,
            " (wiped)" if wipe else "",
            self.plane.vnow(),
        )

    def _enact(self, action: dict) -> None:
        node = action["node"]
        slot = self._by_name.get(node)
        if slot is None:
            return
        kind = action["action"]
        if kind == "crash":
            self._crash(slot)
        elif kind == "restart":
            self._restart(slot, wipe=action.get("wipe", False))
        elif kind == "byzantine_on":
            key = (node, action["behavior"])
            if key not in self._byz and action["behavior"] != "silent_leader":
                actor = _SimByzantine(self, slot, action["behavior"])
                self._byz[key] = actor
                self.heap.push(self.clock.now, ("byz", key))
        elif kind == "byzantine_off":
            actor = self._byz.pop((node, action["behavior"]), None)
            if actor is not None:
                actor.active = False

    # -- main loop ---------------------------------------------------------

    def run(self) -> dict:
        if self._verify_memo:
            # Process-wide, pure-semantics verification memo (see
            # crypto.enable_verify_memo): simulated nodes share one
            # process, so byte-identical re-verifies across nodes — and
            # across a sweep's seeds, signatures are deterministic — are
            # wasted CPU. Left enabled afterwards on purpose: the memo
            # stays warm for the next seed of a sweep.
            enable_verify_memo()
        self.plane.start(t0=0.0)
        for slot in self.slots:
            self._spawn(slot)
        # Supervised transitions (crash/restart/byzantine) become heap
        # events at their scheduled instants; link/partition rules apply
        # lazily inside filter_send as virtual time advances.
        for at, _is_heal, _ev in self.plane._transitions:
            self.heap.push(max(at, 0.0), ("actions",))
        self.heap.push(0.0, ("actions",))

        stop_t = self.scenario.duration_s + self.recovery_timeout_s
        while len(self.heap):
            if self.heap.peek_time() > stop_t:
                break
            t, item = self.heap.pop()
            self.clock.advance_to(t)
            self.events_processed += 1
            self._dispatch(item)
            if self._recovered:
                break

        if self._recorder is not None:
            self._recorder.finish()
        verdict = check(
            self.schedule,
            self.commits,
            honest=self._honest_set(),
            min_recovery_commits=self.min_recovery_commits,
            injections=self.plane.injection_summary(),
        )
        return {
            "verdict": verdict,
            "trace": self.schedule.trace(),
            "commit_streams": {
                name: [(rec.round, rec.t) for rec in recs]
                for name, recs in self.commits.items()
            },
            "events": self.events_processed,
            "virtual_end": self.clock.now,
            "decode_errors": self.decode_errors,
        }

    def _honest_set(self) -> set[str]:
        byz = {
            e.params["node"]
            for e in self.schedule.events
            if e.kind == "byzantine"
        }
        # A twinned seat equivocates by construction: neither instance of
        # the pair is honest.
        return (
            {s.name for s in self.slots}
            - byz
            - set(self.twins)
            - set(self.twins.values())
        )

    def _dispatch(self, item) -> None:
        kind = item[0]
        if kind == "frame":
            _, idx, incarnation, data = item
            slot = self.slots[idx]
            if slot.machine is None or slot.incarnation != incarnation:
                return
            try:
                event = decode_shared(data, slot.machine.seats)
            except (SerdeError, MalformedMessage, ValueError) as e:
                self.decode_errors += 1
                log.debug("sim decode error: %s", e)
                return
            self._step(slot, event)
        elif kind == "event":
            _, idx, incarnation, event = item
            slot = self.slots[idx]
            if slot.machine is None or slot.incarnation != incarnation:
                return
            self._step(slot, event)
        elif kind == "timer":
            _, idx, incarnation, gen = item
            slot = self.slots[idx]
            if (
                slot.machine is None
                or slot.incarnation != incarnation
                or slot.timer_gen != gen
            ):
                return
            deadline = slot.machine.timer_deadline
            if deadline <= self.clock.now + _EPS:
                self._step(slot, ("timer", slot.machine.round))
            else:  # reset since armed: chase the new deadline
                slot.timer_gen += 1
                slot.timer_target = deadline
                self.heap.push(
                    deadline, ("timer", idx, slot.incarnation, slot.timer_gen)
                )
        elif kind == "actions":
            for action in self.plane.poll_actions():
                self._enact(action)
        elif kind == "byz":
            _, key = item
            actor = self._byz.get(key)
            if actor is None or not actor.active:
                return
            actor.burst()
            self.heap.push(self.clock.now + _BYZ_PERIOD_S, ("byz", key))

    def _step(self, slot: _Slot, event) -> None:
        effects = slot.machine.step(event, self.clock.now)
        self._apply_effects(slot, effects)
        if event[0] == "timer" or self._effects_had_commit(effects):
            self._check_recovery()

    @staticmethod
    def _effects_had_commit(effects) -> bool:
        return any(eff[0] == "commit" for eff in effects)

    def _check_recovery(self) -> None:
        """Early exit once every expected-alive node proved post-heal
        commit growth AND the whole schedule has been applied — mirrors
        the harness's recovery tail, minus the wall-clock waiting."""
        if self._recovered:
            return
        if self.clock.now < self.scenario.duration_s:
            return
        if not self.plane.schedule_exhausted():
            return
        for name in self._expected:
            count = 0
            for rec in self.commits[name]:
                if rec.t > self._heal_t:
                    count += 1
                    if count >= self.min_recovery_commits:
                        break
            else:
                return
        self._recovered = True


def run_sim(scenario: Scenario, n: int, **kwargs) -> dict:
    """Execute ``scenario`` on an ``n``-node simulated committee; returns
    the harness-shaped result dict (verdict / trace / commit_streams)."""
    return SimWorld(scenario, n, **kwargs).run()
