"""Faultline runtime: the FaultPlane that enacts a compiled Schedule.

The plane owns three things:

- **link filters** consulted by the network plane through
  :mod:`hotstuff_tpu_torch.faultline.hooks` (one global load when disabled):
  partitions and per-link drop/delay/duplicate/reorder rules are applied
  on the SEND side (both endpoints of an in-process committee share the
  plane; per-process deployments each filter their own egress), plus an
  optional receive-side filter for ingress-NIC-style loss;
- **supervised actions** (crash, restart, byzantine on/off) which the
  plane cannot enact itself: the scenario runner polls
  :meth:`FaultPlane.poll_actions` and performs them against real engines
  / processes — the plane just keeps the deterministic clock and trace;
- **the replay trace + telemetry**: every applied transition is recorded
  with its SCHEDULED virtual time (never wall clock), and every injected
  message-level effect counts into ``faultline.injected.*`` metrics — a
  namespace reserved for the injection plane, so snapshots distinguish
  injected faults from organically occurring ones.

Message-level coin flips use per-link RNG streams derived from the
scenario seed (``policy.link_rng``): deterministic given the same message
sequence on a link.
"""

from __future__ import annotations

import logging
import time

from hotstuff_tpu_torch import telemetry

from . import hooks
from .policy import Schedule, link_rng

log = logging.getLogger("faultline")

__all__ = ["FaultPlane", "install", "uninstall"]

#: wire tag of consensus proposals (consensus/messages.py TAG_PROPOSE) —
#: the frame class a silent leader suppresses. Kept as a literal so this
#: module never imports the consensus package (a test holds it equal to
#: the port's ``TAG_PROPOSE``).
_TAG_PROPOSE = 0


class _LinkRule:
    __slots__ = ("src", "dst", "drop", "delay_lo", "delay_hi", "duplicate",
                 "reorder", "side")

    def __init__(self, params: dict) -> None:
        self.src = params["src"]
        self.dst = params["dst"]
        self.drop = params.get("drop", 0.0)
        lo, hi = params.get("delay_ms", (0.0, 0.0))
        self.delay_lo = lo / 1e3
        self.delay_hi = hi / 1e3
        self.duplicate = params.get("duplicate", 0.0)
        self.reorder = params.get("reorder", 0.0)
        self.side = params.get("side", "send")

    def matches(self, src: str | None, dst: str | None) -> bool:
        if self.src != "*" and self.src != src:
            return False
        return self.dst == "*" or self.dst == dst


class FaultPlane:
    """Enacts one compiled :class:`~.policy.Schedule` against a committee.

    ``addr_to_node`` maps every network address fault injection should
    recognize to its node name; ``consensus_addrs`` is the subset whose
    frames carry consensus wire tags (silent-leader suppression only
    inspects those). The plane is inert until :meth:`start` anchors the
    virtual clock.
    """

    def __init__(
        self,
        schedule: Schedule,
        addr_to_node: dict[tuple[str, int], str],
        consensus_addrs: set[tuple[str, int]] | None = None,
        clock=time.monotonic,
    ) -> None:
        self.schedule = schedule
        # Injectable clock: virtual time is ``clock() - t0``. The real
        # planes keep the default monotonic clock; the simulation plane
        # passes its virtual clock so the SAME schedule machinery (and
        # the same per-link RNG streams) enacts faults at simulated
        # timestamps with zero real sleeping.
        self._clock = clock
        self.addr_to_node = dict(addr_to_node)
        self.consensus_addrs = (
            set(addr_to_node) if consensus_addrs is None else set(consensus_addrs)
        )
        self._t0: float | None = None
        self.started_wall: float | None = None
        # (time, is_heal, event) transitions in virtual-time order; heals
        # sort after activations at the same instant.
        self._transitions: list[tuple[float, int, object]] = []
        for ev in schedule.events:
            self._transitions.append((ev.at, 0, ev))
            if ev.until is not None:
                self._transitions.append((ev.until, 1, ev))
        self._transitions.sort(key=lambda t: (t[0], t[1]))
        self._cursor = 0
        # Active state.
        self._partitions: list[dict[str, int]] = []  # node -> group index
        self._links: list[_LinkRule] = []
        self._behaviors: dict[str, set[str]] = {}  # node -> active behaviors
        self._pending_actions: list[dict] = []  # for the supervisor
        self.applied: list[dict] = []  # replay-trace of applied transitions
        self._rngs: dict[tuple[str, str], object] = {}
        # Injection counters (plain ints for the verdict; telemetry
        # counters for the observability plane — no-ops when disabled).
        self.counts = {
            "send_drops": 0, "recv_drops": 0, "delays": 0, "duplicates": 0,
            "reorders": 0, "proposals_suppressed": 0, "events_applied": 0,
        }
        self._m = {
            k: telemetry.counter(f"faultline.injected.{k}") for k in self.counts
        }
        self._g_active = telemetry.gauge("faultline.active_faults")

    # -- clock / schedule ----------------------------------------------------

    def start(self, t0: float | None = None) -> "FaultPlane":
        self._t0 = self._clock() if t0 is None else t0
        # Wall-clock anchor of virtual time 0: consumers that correlate
        # schedule times with wall-stamped telemetry (the watchtower's
        # detector bench measures time-to-detection against fault
        # activation) read this instead of guessing.
        self.started_wall = time.time()
        return self

    def vnow(self) -> float:
        return 0.0 if self._t0 is None else self._clock() - self._t0

    def any_active(self) -> bool:
        """True while any fault is currently active (drives the
        RoundTrace fault annotation)."""
        return bool(self._partitions or self._links or self._behaviors)

    def _advance(self) -> None:
        if self._t0 is None:
            return
        now = self.vnow()
        while self._cursor < len(self._transitions):
            at, is_heal, ev = self._transitions[self._cursor]
            if at > now:
                break
            self._cursor += 1
            self._apply(ev, heal=bool(is_heal))

    def _apply(self, ev, heal: bool) -> None:
        kind = ev.kind
        self.counts["events_applied"] += 1
        self._m["events_applied"].inc()
        self.applied.append(
            {
                "t": ev.until if heal else ev.at,  # scheduled, not wall
                "kind": kind,
                "phase": "heal" if heal else "inject",
                **ev.params,
            }
        )
        if kind == "partition":
            membership = {
                node: gi
                for gi, group in enumerate(ev.params["groups"])
                for node in group
            }
            if heal:
                if membership in self._partitions:
                    self._partitions.remove(membership)
            else:
                self._partitions.append(membership)
        elif kind == "link":
            if heal:
                self._links = [
                    r for r in self._links
                    if (r.src, r.dst) != (ev.params["src"], ev.params["dst"])
                ]
            else:
                self._links.append(_LinkRule(ev.params))
        elif kind == "byzantine":
            node, behavior = ev.params["node"], ev.params["behavior"]
            if heal:
                self._behaviors.get(node, set()).discard(behavior)
                if not self._behaviors.get(node):
                    self._behaviors.pop(node, None)
            else:
                self._behaviors.setdefault(node, set()).add(behavior)
            # Attack-task behaviors need the supervisor; silent_leader is
            # enacted right here in the send filter and batch_withhold
            # inside the Conveyor worker handler.
            if behavior not in ("silent_leader", "batch_withhold"):
                self._pending_actions.append(
                    {"action": "byzantine_" + ("off" if heal else "on"),
                     "node": node, "behavior": behavior}
                )
        elif kind in ("crash", "restart"):
            action = {"action": kind, "node": ev.params["node"]}
            if ev.params.get("wipe"):
                action["wipe"] = True  # cold rejoin: restart on empty store
            self._pending_actions.append(action)
        self._g_active.set(
            len(self._partitions) + len(self._links)
            + sum(len(b) for b in self._behaviors.values())
        )
        # Flight-recorder context: injected transitions interleave with
        # the protocol events in the trace ring, so a postmortem shows
        # WHAT the committee was doing when each fault landed.
        telemetry.trace_event(
            "faultline", 0, f"{'heal' if heal else 'inject'}:{kind}"
        )
        log.info(
            "faultline %s %s %s (v=%.3fs)",
            "healed" if heal else "injected", kind, ev.params,
            ev.until if heal else ev.at,
        )

    def behavior_active(self, node: str, behavior: str) -> bool:
        """True while ``node`` is currently marked with ``behavior`` —
        the query surface for behaviors enacted at their call site
        (silent_leader in the send filter, batch_withhold in the
        Conveyor worker handler)."""
        self._advance()
        active = self._behaviors.get(node)
        return bool(active and behavior in active)

    def schedule_exhausted(self) -> bool:
        """True once every scheduled transition (activations AND heals)
        has been applied — i.e. virtual time has passed the whole
        schedule. The sim plane gates its early-exit on this so a run
        can never skip late faults by recovering quickly."""
        return self._cursor >= len(self._transitions)

    def poll_actions(self) -> list[dict]:
        """Supervised actions due now (crash/restart/byzantine on-off),
        in schedule order. The runner enacts them against real engines or
        processes; draining is destructive."""
        self._advance()
        due, self._pending_actions = self._pending_actions, []
        return due

    # -- link filters --------------------------------------------------------

    def _rng(self, src: str, dst: str):
        key = (src, dst)
        rng = self._rngs.get(key)
        if rng is None:
            rng = self._rngs[key] = link_rng(self.schedule.seed, src, dst)
        return rng

    def _partitioned(self, src: str, dst: str) -> bool:
        for membership in self._partitions:
            gs, gd = membership.get(src), membership.get(dst)
            if gs is not None and gd is not None and gs != gd:
                return True
        return False

    def filter_send(
        self,
        address: tuple[str, int],
        frame: bytes,
        payload_off: int = 0,
        src: str | None = None,
        dst: str | None = None,
    ):
        """Decide the fate of one outbound frame to ``address``.

        Returns None to deliver untouched (the fast path), or
        ``(action, delay_s, copies)`` with action ``"drop"``/``"deliver"``
        — the sender drops, or sends ``copies`` copies after ``delay_s``.
        ``frame`` begins its payload at ``payload_off`` (senders that
        pre-frame pass 4 to skip the length prefix); only the first
        payload byte is ever inspected (silent-leader suppression).

        ``src``/``dst`` override endpoint resolution (default: the
        contextvar sender identity and the address map). The simulation
        plane passes both explicitly — it has no sender tasks to carry a
        contextvar, and Twins runs route one address to several node
        INSTANCES that partition independently.
        """
        self._advance()
        if src is None:
            src = hooks.current_node()
        if src is None:
            return None  # external senders (clients) are never faulted
        if dst is None:
            dst = self.addr_to_node.get(address)
        if dst is None:
            return None
        behaviors = self._behaviors.get(src)
        if (
            behaviors
            and "silent_leader" in behaviors
            and address in self.consensus_addrs
            and len(frame) > payload_off
            and frame[payload_off] == _TAG_PROPOSE
        ):
            self.counts["proposals_suppressed"] += 1
            self._m["proposals_suppressed"].inc()
            return ("drop", 0.0, 0)
        if self._partitioned(src, dst):
            self.counts["send_drops"] += 1
            self._m["send_drops"].inc()
            return ("drop", 0.0, 0)
        if not self._links:
            return None
        delay = 0.0
        copies = 1
        touched = False
        for rule in self._links:
            if rule.side != "send" or not rule.matches(src, dst):
                continue
            rng = self._rng(src, dst)
            if rule.drop and rng.random() < rule.drop:
                self.counts["send_drops"] += 1
                self._m["send_drops"].inc()
                return ("drop", 0.0, 0)
            if rule.delay_hi > 0.0:
                delay += rng.uniform(rule.delay_lo, rule.delay_hi)
                touched = True
            if rule.duplicate and rng.random() < rule.duplicate:
                copies += 1
                touched = True
            if rule.reorder and rng.random() < rule.reorder:
                # Reordering on an in-order transport = holding this frame
                # past its successors: one extra delay quantum.
                delay += rule.delay_hi if rule.delay_hi > 0 else 0.01
                self.counts["reorders"] += 1
                self._m["reorders"].inc()
                touched = True
        if not touched:
            return None
        if delay > 0.0:
            self.counts["delays"] += 1
            self._m["delays"].inc()
        if copies > 1:
            self.counts["duplicates"] += copies - 1
            self._m["duplicates"].inc(copies - 1)
        return ("deliver", delay, copies)

    def filter_recv(self, address: tuple[str, int], dst: str | None = None):
        """Receive-side filter for the listener bound to ``address``:
        applies ``side: "recv"`` link rules whose dst is this node
        (ingress loss where the sender cannot be instrumented). Returns
        None (deliver) or ``("drop"|"deliver", delay_s)``. ``dst``
        overrides address-map resolution (see ``filter_send``)."""
        self._advance()
        if not self._links:
            return None
        if dst is None:
            dst = self.addr_to_node.get(address)
        if dst is None:
            return None
        for rule in self._links:
            if rule.side != "recv":
                continue
            if rule.dst != "*" and rule.dst != dst:
                continue
            rng = self._rng("*", dst)
            if rule.drop and rng.random() < rule.drop:
                self.counts["recv_drops"] += 1
                self._m["recv_drops"].inc()
                return ("drop", 0.0)
            if rule.delay_hi > 0.0:
                return ("deliver", rng.uniform(rule.delay_lo, rule.delay_hi))
        return None

    # -- verdict support -----------------------------------------------------

    def injection_summary(self) -> dict:
        return {"applied": list(self.applied), "counts": dict(self.counts)}


def install(plane: FaultPlane) -> FaultPlane:
    """Make ``plane`` the process's active fault plane (and annotate
    RoundTrace spans that close while faults are active)."""
    hooks.plane = plane
    telemetry.RoundTrace.fault_flag = staticmethod(plane.any_active)
    return plane


def uninstall() -> None:
    hooks.plane = None
    telemetry.RoundTrace.fault_flag = None
