"""Simulant model of the Conveyor data plane: the availability invariant
under thousands of seeded fault schedules, in milliseconds.

Port copy of ``hotstuff_tpu/sim/dataplane.py``, whole. It runs no crypto.

Per the ROADMAP's sim-first rule, the data-plane mechanism is
model-checked here BEFORE it is trusted on the real planes: N simulated
nodes seal batches on a virtual clock, disseminate them through the real
:class:`~..faultline.runtime.FaultPlane` link filters (partitions,
drops, delays, crash/restart, ``batch_withhold`` byzantine nodes), ack
what they hold, form availability certificates at 2f+1 stake, and only
then order the digest. The run's verdict is
:func:`~..faultline.checker.check_availability`: every ordered digest
must be resolvable at f+1 honest nodes.

Two protocol modes make the check falsifiable:

- ``require_certs=True`` — the Conveyor rule. The invariant holds by
  quorum intersection; a violation would mean the implementation logic
  (not the math) is wrong.
- ``require_certs=False`` — the naive pre-Conveyor rule (order the
  digest as soon as the batch is SENT, no proof anyone holds it). Under
  withholding + crash schedules the checker must FIND violations — the
  regression test pins that this harness can actually catch the bug
  class it exists for.
"""

from __future__ import annotations

import logging

from hotstuff_tpu_torch.faultline.checker import check_availability
from hotstuff_tpu_torch.faultline.policy import Scenario, _seed_stream
from hotstuff_tpu_torch.faultline.runtime import FaultPlane

from .clock import VirtualClock
from .world import EventHeap

log = logging.getLogger("sim")

__all__ = ["DataPlaneSim", "run_dataplane_sim"]


def _name(i: int) -> str:
    return f"n{i:03d}"


class _SimNode:
    __slots__ = ("index", "name", "store", "acks", "ordered", "crashed", "sealed")

    def __init__(self, index: int, name: str) -> None:
        self.index = index
        self.name = name
        self.store: set[str] = set()  # digests held (persists across crash)
        self.acks: dict[str, set[str]] = {}  # own batches: digest -> ackers
        self.ordered: list[str] = []
        self.crashed = False
        self.sealed = 0


class DataPlaneSim:
    """See module docstring. ``workers`` shards only the seal cadence
    (each shard seals independently); the invariant is per-digest and
    does not depend on shard count, but sharded runs exercise
    interleaved dissemination."""

    def __init__(
        self,
        scenario: Scenario,
        n: int,
        *,
        workers: int = 1,
        seal_interval_s: float = 0.05,
        link_delay_ms: tuple[float, float] = (5.0, 20.0),
        require_certs: bool = True,
        jitter: int = 0,
    ) -> None:
        self.scenario = scenario
        self.n = n
        self.workers = workers
        self.seal_interval = seal_interval_s
        self.link_delay = (link_delay_ms[0] / 1e3, link_delay_ms[1] / 1e3)
        self.require_certs = require_certs
        self.jitter = jitter
        names = [_name(i) for i in range(n)]
        self.schedule = scenario.compile(names)
        self.clock = VirtualClock()
        addresses = {("sim", i): names[i] for i in range(n)}
        self.plane = FaultPlane(self.schedule, addresses, clock=self.clock)
        self.nodes = [_SimNode(i, names[i]) for i in range(n)]
        self._by_name = {node.name: node for node in self.nodes}
        self.heap = EventHeap()
        self.committed: set[str] = set()
        self.events_processed = 0
        self.quorum = 2 * ((n - 1) // 3) + 1
        self._link_rngs: dict[tuple[str, str], object] = {}

    # -- helpers -------------------------------------------------------------

    def _delay(self, src: str, dst: str) -> float:
        key = (src, dst)
        rng = self._link_rngs.get(key)
        if rng is None:
            rng = self._link_rngs[key] = _seed_stream(
                self.scenario.seed, "dpsim", str(self.jitter), src, dst
            )
        lo, hi = self.link_delay
        return rng.uniform(lo, hi) if hi > 0 else 0.0

    def _withholding(self, name: str) -> bool:
        return self.plane.behavior_active(name, "batch_withhold")

    def _transmit(self, src: _SimNode, dst: _SimNode, item) -> None:
        plan = self.plane.filter_send(
            ("sim", dst.index), b"\xff", src=src.name, dst=dst.name
        )
        delay = 0.0
        copies = 1
        if plan is not None:
            action, delay, copies = plan
            if action == "drop":
                return
        for _ in range(copies):
            at = self.clock.now + delay + self._delay(src.name, dst.name)
            self.heap.push(at, item)

    # -- events --------------------------------------------------------------

    def _seal(self, node: _SimNode, worker: int) -> None:
        digest = f"{node.name}/w{worker}/b{node.sealed}"
        node.sealed += 1
        node.store.add(digest)
        node.acks[digest] = {node.name}  # own stake counts toward quorum
        for peer in self.nodes:
            if peer is node:
                continue
            self._transmit(node, peer, ("batch", peer.index, digest, node.index))
        if not self.require_certs:
            # Naive rule: ordered the moment it is sent — no availability
            # proof. The checker must catch what this breaks.
            self._order(node, digest)
        elif len(node.acks[digest]) >= self.quorum:
            self._order(node, digest)  # degenerate single-node committee

    def _order(self, node: _SimNode, digest: str) -> None:
        if digest in self.committed:
            return
        node.ordered.append(digest)
        self.committed.add(digest)

    def _dispatch(self, item) -> None:
        kind = item[0]
        if kind == "seal":
            _, idx, worker = item
            node = self.nodes[idx]
            if not node.crashed:
                self._seal(node, worker)
            if self.clock.now + self.seal_interval <= self.scenario.duration_s:
                self.heap.push(
                    self.clock.now + self.seal_interval, ("seal", idx, worker)
                )
        elif kind == "batch":
            _, idx, digest, author_idx = item
            node = self.nodes[idx]
            if node.crashed:
                return  # frame lost at the dead listener
            node.store.add(digest)
            if self._withholding(node.name):
                return  # holds the bytes, withholds the attestation
            author = self.nodes[author_idx]
            self._transmit(
                node, author, ("ack", author_idx, digest, node.name)
            )
        elif kind == "ack":
            _, idx, digest, signer = item
            node = self.nodes[idx]
            if node.crashed or digest not in node.acks:
                return
            acks = node.acks[digest]
            already = len(acks) >= self.quorum
            acks.add(signer)
            if (
                self.require_certs
                and not already
                and len(acks) >= self.quorum
            ):
                self._order(node, digest)
        elif kind == "actions":
            for action in self.plane.poll_actions():
                target = self._by_name.get(action["node"])
                if target is None:
                    continue
                if action["action"] == "crash":
                    target.crashed = True
                elif action["action"] == "restart":
                    target.crashed = False

    # -- run -----------------------------------------------------------------

    def run(self) -> dict:
        self.plane.start(t0=0.0)
        for at, _is_heal, _ev in self.plane._transitions:
            self.heap.push(max(at, 0.0), ("actions",))
        self.heap.push(0.0, ("actions",))
        for node in self.nodes:
            for w in range(self.workers):
                # Stagger shards so seals interleave across the committee.
                self.heap.push(
                    (w + 1) * self.seal_interval / (self.workers + 1),
                    ("seal", node.index, w),
                )
        stop_t = self.scenario.duration_s + 5.0
        while len(self.heap):
            if self.heap.peek_time() > stop_t:
                break
            t, item = self.heap.pop()
            self.clock.advance_to(t)
            self.events_processed += 1
            self._dispatch(item)

        crashed_forever = self.schedule.crashed_forever()
        holders = {
            digest: {
                node.name
                for node in self.nodes
                if digest in node.store and node.name not in crashed_forever
            }
            for digest in self.committed
        }
        verdict = check_availability(self.schedule, self.committed, holders)
        return {
            "verdict": verdict,
            "trace": self.schedule.trace(),
            "committed": len(self.committed),
            "digests": sorted(self.committed),
            "sealed": sum(node.sealed for node in self.nodes),
            "events": self.events_processed,
            "virtual_end": self.clock.now,
        }


def run_dataplane_sim(scenario: Scenario, n: int, **kwargs) -> dict:
    return DataPlaneSim(scenario, n, **kwargs).run()
