"""Faultline policy plane: declarative, JSON-serializable fault scenarios.

A ``Scenario`` is data — a seed plus a virtual-time schedule of fault
*templates* (crash/restart of named nodes, partitions with healing,
per-link impairments, byzantine behaviors). ``Scenario.compile`` resolves
it against a concrete committee into a ``Schedule`` of fully-determined
``FaultEvent``s: every free choice a template leaves open (which node to
crash, which groups a partition cuts, how long an impairment lasts) is
drawn from an RNG derived ONLY from the scenario seed, so the same seed
always yields byte-identical schedules — ``Schedule.trace()`` is the
canonical replay trace whose equality across runs is the reproducibility
contract the chaos harness asserts.

Two layers of determinism:

- the SCHEDULE (what fires, when, against whom) is a pure function of
  ``(seed, node names)`` — replay-trace equality checks this;
- per-message coin flips (does THIS frame drop?) come from per-link RNG
  streams also derived from the seed (``link_rng``). They are
  deterministic given the same message sequence, but message counts vary
  run to run, so they are recorded as counters, not in the trace.

Virtual time: every event's ``at``/``until`` are seconds from scenario
start; the runtime anchors them to the loop clock at activation. No
wall-clock value ever enters the schedule.

Port copy of ``hotstuff_tpu/faultline/policy.py``, byte for byte in its
hashing, its ``random.Random`` seeding and its JSON, so that a scenario
compiles to the same ``Schedule.trace()`` and the same ``link_rng`` draws
in both packages.
"""

from __future__ import annotations

import hashlib
import json
import random
from dataclasses import dataclass, field

__all__ = [
    "FaultEvent",
    "Scenario",
    "Schedule",
    "chaos_scenario",
    "link_rng",
    "BYZANTINE_BEHAVIORS",
]

#: behaviors the runtime/byzantine module knows how to drive.
#: ``batch_withhold`` is a DATA-PLANE behavior: the node receives worker
#: batches but never signs availability acks and never serves batch
#: requests — enacted inside the Conveyor worker handler (like
#: silent_leader, it needs no attack actor).
BYZANTINE_BEHAVIORS = (
    "equivocate",
    "stale_vote_flood",
    "silent_leader",
    "batch_withhold",
)

#: the pool seeded "?"-behavior draws come from. Frozen at the original
#: three: committed chaos seeds (3, 7, the detector ground-truth corpus)
#: must keep compiling to byte-identical schedules — new behaviors are
#: opt-in by name, never by lottery.
SEEDED_BEHAVIORS = BYZANTINE_BEHAVIORS[:3]

_KINDS = ("crash", "restart", "partition", "link", "byzantine")


def _seed_stream(seed: int, *tags: str) -> random.Random:
    """An RNG stream keyed by the scenario seed plus a string tag —
    independent streams for independent choices, all reproducible."""
    h = hashlib.sha256(
        ("%d|" % seed + "|".join(tags)).encode()
    ).digest()
    return random.Random(int.from_bytes(h[:8], "little"))


def link_rng(seed: int, src: str, dst: str) -> random.Random:
    """Per-directed-link RNG stream for message-level coin flips."""
    return _seed_stream(seed, "link", src, dst)


@dataclass(frozen=True)
class FaultEvent:
    """One fully-resolved fault action on the virtual timeline.

    ``at`` is the activation time (s from scenario start); ``until`` is
    the healing time for interval faults (None = never heals inside the
    scenario). ``params`` carries the kind-specific payload:

    - crash/restart: ``{"node": name}``
    - partition: ``{"groups": [[names...], ...]}``
    - link: ``{"src": name|"*", "dst": name|"*", "drop": p,
      "delay_ms": [lo, hi], "duplicate": p, "reorder": p}``
    - byzantine: ``{"node": name, "behavior": one of
      BYZANTINE_BEHAVIORS}``
    """

    at: float
    kind: str
    params: dict
    until: float | None = None

    def to_json(self) -> dict:
        d = {"at": self.at, "kind": self.kind, **self.params}
        if self.until is not None:
            d["until"] = self.until
        return d


@dataclass
class Schedule:
    """The compiled, deterministic fault sequence for one scenario run."""

    scenario: str
    seed: int
    nodes: list[str]
    events: list[FaultEvent] = field(default_factory=list)

    def trace(self) -> str:
        """Canonical JSON replay trace: identical seeds must produce
        identical traces (the harness asserts string equality)."""
        return json.dumps(
            {
                "schema": "faultline-trace-v1",
                "scenario": self.scenario,
                "seed": self.seed,
                "nodes": self.nodes,
                "events": [e.to_json() for e in self.events],
            },
            sort_keys=True,
            separators=(",", ":"),
        )

    def last_heal_time(self) -> float:
        """Virtual time after which the network is fault-free: liveness
        recovery is measured from here. Events that never heal (crash
        without restart) don't extend it — the checker instead excludes
        permanently-crashed nodes from the recovery set."""
        t = 0.0
        restarts: dict[str, float] = {}
        for e in self.events:
            if e.kind == "restart":
                restarts[e.params["node"]] = max(
                    restarts.get(e.params["node"], 0.0), e.at
                )
        for e in self.events:
            if e.kind == "crash":
                healed = restarts.get(e.params["node"])
                if healed is not None and healed >= e.at:
                    t = max(t, healed)
            elif e.until is not None:
                t = max(t, e.until)
            elif e.kind in ("partition", "link", "byzantine"):
                # Un-healing interval fault: treat activation as the last
                # disturbance; permanently-degraded links are the
                # scenario author's explicit choice.
                t = max(t, e.at)
        return t

    def crashed_forever(self) -> set[str]:
        """Nodes crashed and never restarted — excluded from liveness."""
        down: set[str] = set()
        for e in sorted(self.events, key=lambda e: e.at):
            if e.kind == "crash":
                down.add(e.params["node"])
            elif e.kind == "restart":
                down.discard(e.params["node"])
        return down


@dataclass
class Scenario:
    """Declarative scenario: JSON round-trippable, compiled per committee.

    ``events`` entries are dicts mirroring ``FaultEvent.to_json`` except
    that node-valued fields may be omitted or set to ``"?"`` — compile()
    then draws the target from the seed stream (seeded chaos). ``nodes``
    in templates are INDICES-or-names: integers index into the committee's
    sorted node-name list so scenarios stay committee-agnostic.
    """

    name: str
    seed: int
    duration_s: float
    events: list[dict] = field(default_factory=list)

    # -- (de)serialization ---------------------------------------------------

    def to_json(self) -> dict:
        return {
            "schema": "faultline-scenario-v1",
            "name": self.name,
            "seed": self.seed,
            "duration_s": self.duration_s,
            "events": self.events,
        }

    @classmethod
    def from_json(cls, data: dict) -> "Scenario":
        if data.get("schema") not in (None, "faultline-scenario-v1"):
            raise ValueError(f"unknown scenario schema {data.get('schema')!r}")
        return cls(
            name=data["name"],
            seed=int(data["seed"]),
            duration_s=float(data["duration_s"]),
            events=list(data.get("events", [])),
        )

    @classmethod
    def load(cls, path: str) -> "Scenario":
        with open(path) as f:
            return cls.from_json(json.load(f))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
            f.write("\n")

    # -- compilation ---------------------------------------------------------

    def _resolve_node(self, value, nodes: list[str], rng: random.Random) -> str:
        if value is None or value == "?":
            return rng.choice(nodes)
        if isinstance(value, int):
            return nodes[value % len(nodes)]
        if value == "*":
            return "*"
        if value not in nodes:
            raise ValueError(f"scenario names unknown node {value!r}")
        return value

    def compile(self, nodes: list[str]) -> Schedule:
        """Resolve templates against a concrete committee. All free
        choices come from seed-derived streams, so the result — including
        ``trace()`` — is a pure function of ``(scenario, nodes)``."""
        nodes = sorted(nodes)
        events: list[FaultEvent] = []
        for i, ev in enumerate(self.events):
            kind = ev.get("kind")
            if kind not in _KINDS:
                raise ValueError(f"unknown fault kind {kind!r}")
            # One independent stream per template slot: inserting an event
            # never re-rolls the choices of the events after it.
            rng = _seed_stream(self.seed, "event", str(i), str(kind))
            at = float(ev.get("at", 0.0))
            until = ev.get("until")
            until = None if until is None else float(until)
            if kind in ("crash", "restart"):
                params = {"node": self._resolve_node(ev.get("node"), nodes, rng)}
                if kind == "restart" and ev.get("wipe"):
                    # Cold rejoin (Lazarus): the node restarts with an
                    # EMPTY store and must recover via state sync. A
                    # plain boolean rider — no RNG draw — so committed
                    # scenarios keep byte-identical schedules.
                    params["wipe"] = True
            elif kind == "partition":
                groups = ev.get("groups")
                if groups is None:
                    # Seeded minority cut: isolate f = (n-1)//3 nodes.
                    f = max(1, (len(nodes) - 1) // 3)
                    cut = sorted(rng.sample(nodes, f))
                    groups = [cut, sorted(set(nodes) - set(cut))]
                else:
                    groups = [
                        sorted(
                            self._resolve_node(m, nodes, rng) for m in group
                        )
                        for group in groups
                    ]
                params = {"groups": groups}
            elif kind == "link":
                src = self._resolve_node(ev.get("src", "*"), nodes, rng)
                dst = self._resolve_node(ev.get("dst", "*"), nodes, rng)
                params = {
                    "src": src,
                    "dst": dst,
                    "drop": float(ev.get("drop", 0.0)),
                    "delay_ms": [
                        float(x) for x in ev.get("delay_ms", [0.0, 0.0])
                    ],
                    "duplicate": float(ev.get("duplicate", 0.0)),
                    "reorder": float(ev.get("reorder", 0.0)),
                    "side": str(ev.get("side", "send")),
                }
            else:  # byzantine
                behavior = ev.get("behavior") or rng.choice(SEEDED_BEHAVIORS)
                if behavior not in BYZANTINE_BEHAVIORS:
                    raise ValueError(f"unknown byzantine behavior {behavior!r}")
                params = {
                    "node": self._resolve_node(ev.get("node"), nodes, rng),
                    "behavior": behavior,
                }
            events.append(FaultEvent(at=at, kind=kind, params=params, until=until))
        events.sort(key=lambda e: (e.at, e.kind, json.dumps(e.params, sort_keys=True)))
        return Schedule(
            scenario=self.name, seed=self.seed, nodes=nodes, events=events
        )


def chaos_scenario(
    seed: int,
    duration_s: float = 20.0,
    *,
    crashes: int = 1,
    partitions: int = 1,
    byzantine: int = 1,
    links: int = 1,
    name: str | None = None,
) -> Scenario:
    """Seeded chaos: generate a scenario whose entire event list is drawn
    from the seed — the "one integer describes the whole storm" entry
    point. Faults activate inside the middle 60% of the run (warm-up and
    recovery tails stay clean so the checker can judge liveness), and
    every interval fault heals before ``0.8 * duration_s``."""
    rng = _seed_stream(seed, "chaos")
    lo, hi = 0.2 * duration_s, 0.6 * duration_s
    heal_by = 0.8 * duration_s
    events: list[dict] = []
    for _ in range(crashes):
        at = rng.uniform(lo, hi)
        down = rng.uniform(0.1, 0.3) * duration_s
        # The pair must hit the SAME node: draw one integer index here
        # (compile maps it modulo committee size) instead of two
        # independent "?" choices that would strand a crash unrestarted.
        victim = rng.randrange(1 << 16)
        events.append({"kind": "crash", "node": victim, "at": round(at, 3)})
        events.append(
            {"kind": "restart", "node": victim, "at": round(min(at + down, heal_by), 3)}
        )
    for _ in range(partitions):
        at = rng.uniform(lo, hi)
        events.append(
            {
                "kind": "partition",
                "at": round(at, 3),
                "until": round(min(at + rng.uniform(0.1, 0.25) * duration_s, heal_by), 3),
            }
        )
    for _ in range(links):
        at = rng.uniform(lo, hi)
        events.append(
            {
                "kind": "link",
                "src": "?",
                "dst": "*",
                "at": round(at, 3),
                "until": round(min(at + rng.uniform(0.1, 0.3) * duration_s, heal_by), 3),
                "drop": round(rng.uniform(0.05, 0.4), 3),
                "delay_ms": [5.0, round(rng.uniform(20.0, 80.0), 1)],
                "duplicate": round(rng.uniform(0.0, 0.1), 3),
                "reorder": round(rng.uniform(0.0, 0.1), 3),
            }
        )
    for _ in range(byzantine):
        at = rng.uniform(lo, hi)
        events.append(
            {
                "kind": "byzantine",
                "node": "?",
                "behavior": None,
                "at": round(at, 3),
                "until": round(min(at + rng.uniform(0.2, 0.4) * duration_s, heal_by), 3),
            }
        )
    # Drop the null behavior key (from_json/compile treat missing == None).
    for ev in events:
        if ev.get("behavior", "x") is None:
            del ev["behavior"]
    return Scenario(
        name=name or f"chaos-{seed}",
        seed=seed,
        duration_s=duration_s,
        events=events,
    )
