"""Leader election.

Port copy of ``hotstuff_tpu/consensus/leader.py``, whole.

``RRLeaderElector`` is the reference behavior: round-robin over sorted
public keys (reference ``consensus/src/leader.rs:16-20``).

``ReputationLeaderElector`` is an opt-in pacemaker variant beyond the
reference (``Parameters.leader_elector = "reputation"``), in the style
of DiemBFT v4's leader reputation: leaders are drawn from validators
that recently PARTICIPATED — authors and QC signers of the last
``window`` committed blocks — with the most recent authors excluded
(spread the load), chosen by a deterministic hash of the round. A
crashed or partitioned validator stops appearing in committed QCs and
drops out of the candidate set after ``window`` commits, so the
committee stops burning timeout rounds electing it — round-robin pays
one ``timeout_delay`` every N rounds per crashed node, forever.

Determinism caveat (why this is opt-in, and why ``lenient``): the
candidate set derives from each node's local committed prefix. Honest
nodes commit identical blocks, but transiently one may lag a commit
behind; during that lag two nodes disagree on a round's leader. If the
lagging node simply REJECTED the proposal (the round-robin code path),
the divergence would be sticky: commits only advance by processing
proposals, so its window could never catch up. Reputation mode
therefore marks itself ``lenient``: the Core verifies and processes a
valid proposal's CERTIFICATES regardless of the local leader opinion —
QCs advance rounds and commits, which updates the window and heals the
divergence — and only the VOTE is withheld for an unexpected author.
Safety is untouched either way (it rests on quorum intersection and the
voting rules, not on leader agreement); the lag costs at most some
withheld votes, covered by the 2f+1 quorum of converged nodes. The boot
window is empty (and empty again after restart — the window is not
persisted), so a fresh node elects round-robin; while its window is
empty the storage gate is lifted entirely (``has_window``) so it can
commit running peers' proposals, rebuild the window, and converge —
withholding votes, not blocking progress, along the way.
"""

from __future__ import annotations

import hashlib
import struct
from collections import deque

from hotstuff_tpu_torch.crypto import PublicKey

from .config import Committee, Round

_U64 = struct.Struct("<Q")


class RRLeaderElector:
    #: strict leader check: unexpected authors are rejected outright
    #: (reference behavior; round-robin needs no committed state, so all
    #: honest nodes always agree and rejection cannot wedge anyone).
    lenient = False

    def __init__(self, committee: Committee) -> None:
        self.committee = committee
        self._sorted = committee.sorted_keys()

    def get_leader(self, round_: Round) -> PublicKey:
        return self._sorted[round_ % len(self._sorted)]

    def update(self, block) -> None:
        """Committed-block feed; round-robin keeps no state."""

    def note_round_entry(self, round_: Round, via_tc: bool) -> None:
        """Round-entry feed (see ReputationLeaderElector); round-robin is
        already window-free and keeps no state."""

    def gate_active(self, round_: Round) -> bool:
        """Elector protocol (see ReputationLeaderElector.gate_active);
        unreachable for round-robin — strict mode rejects mismatched
        authors before the gate."""
        return True


class ReputationLeaderElector:
    """Active-set leader election over a ROUND-LAGGED committed window.

    The lag is the agreement mechanism: a commit lands on different
    nodes at different wall-times, so an election that read the latest
    window would diverge for rounds already in flight — observed live as
    a timeout every commit-lag rounds. Electing round ``r`` only from
    committed blocks with round <= r - LAG means the deciding entries
    are commits every honest participant made many rounds ago; a fresh
    commit influences only elections >= LAG rounds ahead, long after the
    whole committee has it. Nodes that advanced via a TC without the
    underlying blocks withhold votes until they sync (certificates heal
    them — see ``lenient``), costing at most one timeout, not a wedge.
    """

    #: see module docstring: certificate processing must not depend on
    #: the (window-derived, transiently divergent) leader opinion.
    lenient = True

    #: elections for round r use only commits with round <= r - LAG.
    #: Must exceed the 2-chain commit lag (2) plus processing skew.
    LAG = 6

    #: TC-entered rounds remembered for the round-robin fallback (old
    #: entries expire FIFO; the set only needs to cover rounds the core
    #: still elects for — current, next, and recent block rounds).
    TC_MEMORY = 64

    def __init__(
        self, committee: Committee, window: int = 10, exclude: int = 1
    ) -> None:
        self.committee = committee
        self._sorted = committee.sorted_keys()
        self.exclude = exclude
        self.window = window
        # Retain LAG extra entries: the electing set is "the last
        # `window` commits with round <= horizon", and a node that has
        # committed up to LAG blocks PAST the horizon must not have
        # evicted entries a less-advanced node still selects — identical
        # committed prefixes must yield identical electing sets.
        self._window: deque = deque(maxlen=window + self.LAG)
        # Rounds entered through a TimeoutCertificate (timeout-grind
        # killer — see note_round_entry).
        self._tc_rounds: deque = deque(maxlen=self.TC_MEMORY)
        self._tc_set: set = set()

    def _anchored(self, round_: Round) -> list:
        horizon = round_ - self.LAG
        entries = [e for e in self._window if e[0] <= horizon]
        return entries[-self.window :]

    def gate_active(self, round_: Round) -> bool:
        """True only when this node's election for ``round_`` rests on a
        FULL anchored window — the regime where honest nodes provably
        agree (identical committed prefixes => identical last-`window`
        anchored entries). A sparse or empty anchored set (boot; the
        first rounds after a restart — the window is not persisted)
        means the node's opinion is round-robin-ish and likely diverges
        from running peers: the Core then lifts the solicited-block
        storage gate so the node can still process and COMMIT peers'
        proposals, rebuild its window, and converge. Gating storage in
        that regime wedged a committee into a timeout grind: every
        proposal skipped, no commits, windows frozen, disagreement
        permanent."""
        return len(self._anchored(round_)) >= self.window

    def update(self, block) -> None:
        """Feed committed blocks in commit order (Core.commit calls this).

        Non-members are filtered out: the genesis block's author (and its
        empty QC) are placeholders, not electable validators."""
        members = self.committee.authorities
        author = block.author if block.author in members else None
        signers = tuple(
            pk for pk, _ in block.qc.votes if pk in members
        )
        if author is None and not signers:
            return  # genesis: nothing electable
        self._window.append((block.round, author, signers))

    def note_round_entry(self, round_: Round, via_tc: bool) -> None:
        """Round-entry feed from the Core (``advance_round``): whether
        ``round_`` was reached through a QC or a TimeoutCertificate.

        Why this exists — the residual "timeout grind" root cause: when
        honest nodes' windows transiently DIVERGE (a straggler that
        TC-advanced past its commit progress; the boot transition from
        round-robin to window election under a vote split), rounds can
        reach a regime where no candidate is self-elected AND endorsed
        by a quorum. Nothing commits in a timeout round, so the windows
        that caused the disagreement stay FROZEN — convergence waited on
        a hash(round) coincidence, burning a full ``timeout_delay`` per
        miss (observed as multi-second stalls with rounds advancing,
        ~2/30 e2e runs). A round entered via TC therefore falls back to
        ROUND-ROBIN election: window-free, so every honest node that saw
        the round time out agrees on the next leader deterministically
        — one wasted timeout is the worst case, the first post-TC
        commit refills the windows, and window election resumes. (The
        DiemBFT/Jolteon pacemakers use the same escape hatch.) Safety is
        untouched: leader choice only gates votes and storage, never
        quorum intersection.
        """
        if not via_tc:
            return
        if round_ not in self._tc_set:
            if len(self._tc_rounds) == self._tc_rounds.maxlen:
                self._tc_set.discard(self._tc_rounds[0])
            self._tc_rounds.append(round_)
            self._tc_set.add(round_)

    def get_leader(self, round_: Round) -> PublicKey:
        if round_ in self._tc_set:
            # TC-entered round: deterministic window-free fallback (see
            # note_round_entry).
            return self._sorted[round_ % len(self._sorted)]
        anchored = self._anchored(round_)
        active: set[PublicKey] = set()
        recent_authors: list[PublicKey] = []
        for _blk_round, author, signers in anchored:
            if author is not None:
                active.add(author)
                recent_authors.append(author)
            active.update(signers)
        if not active:
            # Boot (or post-restart) fallback: deterministic everywhere.
            return self._sorted[round_ % len(self._sorted)]
        excluded = (
            set(recent_authors[-self.exclude :]) if self.exclude else set()
        )
        eligible = sorted(
            (pk for pk in active if pk not in excluded),
            key=lambda pk: pk.data,
        )
        if not eligible:  # degenerate single-participant window
            eligible = sorted(active, key=lambda pk: pk.data)
        h = hashlib.sha512(_U64.pack(round_)).digest()
        return eligible[int.from_bytes(h[:8], "little") % len(eligible)]


class ScheduledLeaderElector:
    """A fixed ``{round: leader}`` override with round-robin fallback —
    the per-round leader-assignment control of the Twins methodology
    (Bano et al.): the adversary scripts exactly who leads each round,
    instead of waiting for rotation to land where the attack needs it.

    Strict like round-robin (the schedule is global and deterministic,
    so all instances consulting it agree), stateless (``update`` /
    ``note_round_entry`` are no-ops), and safe to share across the
    simulated instances of one world. Not reachable from production
    config on purpose: it exists for ``sim.twins`` adversary
    enumeration, where ``SimWorld(leader_schedule=...)`` installs it.
    """

    lenient = False

    def __init__(
        self, committee: Committee, schedule: dict[Round, PublicKey]
    ) -> None:
        self.committee = committee
        self._sorted = committee.sorted_keys()
        self._schedule = dict(schedule)

    def get_leader(self, round_: Round) -> PublicKey:
        pk = self._schedule.get(round_)
        if pk is not None:
            return pk
        return self._sorted[round_ % len(self._sorted)]

    def update(self, block) -> None:
        pass

    def note_round_entry(self, round_: Round, via_tc: bool) -> None:
        pass

    def gate_active(self, round_: Round) -> bool:
        return True


def make_elector(committee: Committee, kind: str):
    if kind == "reputation":
        return ReputationLeaderElector(committee)
    if kind in ("round-robin", "rr", ""):
        return RRLeaderElector(committee)
    raise ValueError(f"unknown leader_elector {kind!r}")


LeaderElector = RRLeaderElector
