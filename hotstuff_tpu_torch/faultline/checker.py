"""Faultline's safety/liveness checker: machine-checked verdicts.

Consumes the per-node commit streams a scenario run collected and the
compiled schedule, and emits a machine-readable verdict:

- **safety** — no two honest nodes committed different blocks at the same
  round (quorum intersection must hold under every injected fault), and
  no single node ever committed two different blocks at one round.
  Streams are NOT required to be round-monotonic: commit progress is
  persisted lazily (with the vote state), so a node crash-restarted
  between a commit and its next vote legitimately REPLAYS recent
  commits — at-least-once delivery the execution layer must absorb.
  What replay may never do is change a digest;
- **liveness** — commit height resumes growing after the last fault
  heals: every honest node that is still supposed to be alive gains at
  least ``min_recovery_commits`` commits with virtual time past the
  schedule's ``last_heal_time()``. Nodes crashed and never restarted are
  excluded (the scenario author chose to lose them).

The verdict is plain data (JSON-serializable) so CI lanes can gate on
``verdict["safety"]["ok"] and verdict["liveness"]["recovered"]`` without
parsing human text.

Port copy of ``hotstuff_tpu/faultline/checker.py``: the same verdict
fields (``VERDICT_SCHEMA``), so that either package's verdicts compare.
"""

from __future__ import annotations

from .policy import Schedule

__all__ = [
    "CommitRecord",
    "check",
    "check_availability",
    "check_frontier_availability",
    "VERDICT_SCHEMA",
]

VERDICT_SCHEMA = "faultline-verdict-v1"


class CommitRecord:
    """One committed block as observed by one node: ``(round, digest,
    t)`` with ``t`` in virtual scenario time."""

    __slots__ = ("round", "digest", "t")

    def __init__(self, round_: int, digest: bytes, t: float) -> None:
        self.round = round_
        self.digest = digest
        self.t = t


def check_availability(
    schedule: Schedule,
    committed: set,
    holders: dict,
    *,
    honest: set[str] | None = None,
) -> dict:
    """The Conveyor data-plane invariant: consensus never commits a
    batch digest lacking an availability certificate RESOLVABLE at f+1
    honest nodes — i.e. after the run, every committed batch digest must
    be held (store-resolvable) by at least f+1 honest nodes, so the
    2f+1-signed cert it was ordered under can always be honored.

    ``committed`` is the set of committed batch digests (any hashable
    form, typically hex); ``holders`` maps each digest to the set of
    node names whose store resolves it. ``honest`` defaults to every
    node the schedule never marked byzantine. Returns a plain-data
    verdict section (``{"ok", "f", "checked", "violations"}``) that
    harnesses merge into their run verdicts.
    """
    byzantine = {
        e.params["node"] for e in schedule.events if e.kind == "byzantine"
    }
    if honest is None:
        honest = set(schedule.nodes) - byzantine
    n = len(schedule.nodes)
    f = (n - 1) // 3
    required = f + 1
    violations = []
    for digest in sorted(committed):
        holding = sorted(h for h in holders.get(digest, ()) if h in honest)
        if len(holding) < required:
            violations.append(
                {
                    "type": "unresolvable_commit",
                    "digest": digest if isinstance(digest, str) else str(digest),
                    "honest_holders": holding,
                    "required": required,
                }
            )
    return {
        "ok": not violations,
        "f": f,
        "required_holders": required,
        "checked": len(committed),
        "violations": violations,
    }


def check_frontier_availability(
    schedule: Schedule,
    committed: set,
    resolvers: dict,
    floors: dict,
    *,
    honest: set[str] | None = None,
) -> dict:
    """The Lazarus truncation invariant: log compaction must never make
    a committed block unservable to a catching-up replica. After the
    run, every committed ``(round, digest)`` must be SERVABLE by at
    least f+1 honest nodes, where node X serves it iff

    - X's store still resolves ``digest`` (the block survives below or
      above X's truncation horizon), or
    - X's snapshot frontier round >= ``round`` (X truncated it, but its
      snapshot subsumes the block's state — a joiner syncing from X
      lands at or past the block and never needs it individually).

    ``committed`` is a set of ``(round, digest)`` pairs (digest in any
    hashable form); ``resolvers`` maps each digest to the set of node
    names whose store resolves it; ``floors`` maps node name to its
    snapshot frontier round (0/absent when the node never compacted).
    Returns a plain-data verdict section harnesses merge into their run
    verdicts.
    """
    byzantine = {
        e.params["node"] for e in schedule.events if e.kind == "byzantine"
    }
    if honest is None:
        honest = set(schedule.nodes) - byzantine
    n = len(schedule.nodes)
    f = (n - 1) // 3
    required = f + 1
    violations = []
    for round_, digest in sorted(
        committed, key=lambda rd: (rd[0], str(rd[1]))
    ):
        servers = sorted(
            node
            for node in honest
            if node in resolvers.get(digest, ())
            or floors.get(node, 0) >= round_
        )
        if len(servers) < required:
            violations.append(
                {
                    "type": "unservable_commit",
                    "round": round_,
                    "digest": (
                        digest.hex()
                        if isinstance(digest, (bytes, bytearray))
                        else str(digest)
                    ),
                    "honest_servers": servers,
                    "required": required,
                }
            )
    return {
        "ok": not violations,
        "f": f,
        "required_servers": required,
        "checked": len(committed),
        "floors": {k: floors[k] for k in sorted(floors)},
        "violations": violations,
    }


def check(
    schedule: Schedule,
    commits: dict[str, list[CommitRecord]],
    *,
    honest: set[str] | None = None,
    min_recovery_commits: int = 3,
    injections: dict | None = None,
) -> dict:
    """Judge one finished scenario run. ``commits`` maps node name to its
    commit stream in arrival order; ``honest`` defaults to every node the
    schedule never marked byzantine."""
    byzantine = {
        e.params["node"] for e in schedule.events if e.kind == "byzantine"
    }
    if honest is None:
        honest = set(schedule.nodes) - byzantine
    violations: list[dict] = []

    # Intra-node consistency: crash-recovery replay may repeat rounds
    # (see module docstring) but never with a different digest.
    for node in sorted(honest):
        seen: dict[int, bytes] = {}
        for rec in commits.get(node, []):
            prev = seen.get(rec.round)
            if prev is not None and prev != rec.digest:
                violations.append(
                    {
                        "type": "intra_node_conflict",
                        "node": node,
                        "round": rec.round,
                        "digests": [prev.hex(), rec.digest.hex()],
                    }
                )
            seen[rec.round] = rec.digest

    # Cross-node agreement: same round => same digest among honest nodes.
    by_round: dict[int, dict[bytes, list[str]]] = {}
    for node in sorted(honest):
        for rec in commits.get(node, []):
            by_round.setdefault(rec.round, {}).setdefault(
                rec.digest, []
            ).append(node)
    for round_, digests in sorted(by_round.items()):
        if len(digests) > 1:
            violations.append(
                {
                    "type": "conflicting_commit",
                    "round": round_,
                    "digests": {
                        d.hex(): sorted(nodes) for d, nodes in digests.items()
                    },
                }
            )

    # Liveness: commit growth after the last heal.
    heal_t = schedule.last_heal_time()
    expected_alive = sorted(
        (honest - schedule.crashed_forever())
    )
    post_heal = {
        node: sum(1 for rec in commits.get(node, []) if rec.t > heal_t)
        for node in expected_alive
    }
    laggards = sorted(
        n for n, c in post_heal.items() if c < min_recovery_commits
    )
    recovered = not laggards
    # Measured recovery cost: how long past the heal the SLOWEST
    # recovering node took to reach min_recovery_commits post-heal
    # commits (None unless every expected node got there). This is the
    # view-change/recovery number benchmarks report.
    recovery_s = None
    if recovered and expected_alive:
        per_node = []
        for node in expected_alive:
            times = sorted(
                rec.t for rec in commits.get(node, []) if rec.t > heal_t
            )
            k = max(min_recovery_commits, 1)
            if len(times) < k:
                per_node = []
                break
            per_node.append(times[k - 1] - heal_t)
        if per_node:
            recovery_s = round(max(per_node), 3)

    return {
        "schema": VERDICT_SCHEMA,
        "scenario": schedule.scenario,
        "seed": schedule.seed,
        "nodes": schedule.nodes,
        "byzantine": sorted(byzantine),
        "safety": {"ok": not violations, "violations": violations},
        "liveness": {
            "ok": recovered,
            "recovered": recovered,
            "heal_t": heal_t,
            "recovery_s": recovery_s,
            "min_recovery_commits": min_recovery_commits,
            "post_heal_commits": post_heal,
            "laggards": laggards,
        },
        "commits": {
            node: len(commits.get(node, [])) for node in sorted(schedule.nodes)
        },
        "injections": injections or {},
    }
