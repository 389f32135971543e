"""Process-wide certificate-verdict arena: each distinct certificate is
fully verified once per process per committee.

Port copy of ``hotstuff_tpu/consensus/cert_arena.py``, with its telemetry
counters (``consensus.cert_arena.{hits,misses}``; ``hits``/``misses`` stay
as attributes too). The super-batching
backend already prices the in-process copies of one rebroadcast
certificate at one inner call when they pool in one flush, but only when
they happen to pool; the arena makes that dedup deterministic: the first
verifier pays, every later in-process arrival of the same cert under the
same committee hits. ``HOTSTUFF_CERT_ARENA=0`` is the kill switch for runs
where every verify must pay (read per call).

Success-only: a failed cert is never cached, so a byzantine cert re-raises
on every arrival. Keyed by (committee fingerprint, canonical cert key):
the same bytes under different committees never alias, and the canonical
key is the v1 encoding, so a v1 and a v2 copy of one cert share an entry.
"""

from __future__ import annotations

import hashlib
import os
import threading
from collections import OrderedDict

from hotstuff_tpu_torch import telemetry


def enabled() -> bool:
    """Read per call so tests and operators can flip the switch live."""
    return os.environ.get("HOTSTUFF_CERT_ARENA", "1") != "0"


def committee_fp(committee) -> bytes:
    """Fingerprint of a committee's verification state: sorted (key, stake)
    pairs plus the quorum threshold. Memoized on the committee object
    (membership is fixed per epoch)."""
    fp = getattr(committee, "_cert_arena_fp", None)
    if fp is None:
        h = hashlib.sha256()
        for pk in sorted(committee.authorities):
            h.update(pk.data)
            h.update(committee.authorities[pk].stake.to_bytes(8, "little"))
        h.update(committee.quorum_threshold().to_bytes(8, "little"))
        fp = h.digest()
        try:
            committee._cert_arena_fp = fp
        except AttributeError:
            pass  # slotted or frozen committee variants just re-hash
    return fp


class CertArena:
    """Bounded LRU of successfully verified certificate identities."""

    def __init__(self, cap: int = 8192) -> None:
        self.cap = cap
        self.hits = 0
        self.misses = 0
        self._seen: "OrderedDict[tuple, None]" = OrderedDict()
        # hit()/add() run on every verifying thread.
        self._lock = threading.Lock()
        self._m_hits = telemetry.counter("consensus.cert_arena.hits")
        self._m_misses = telemetry.counter("consensus.cert_arena.misses")

    def hit(self, key: tuple) -> bool:
        with self._lock:
            if key in self._seen:
                self._seen.move_to_end(key)
                self.hits += 1
                self._m_hits.inc()
                return True
            self.misses += 1
            self._m_misses.inc()
            return False

    def add(self, key: tuple) -> None:
        with self._lock:
            self._seen[key] = None
            self._seen.move_to_end(key)
            while len(self._seen) > self.cap:
                self._seen.popitem(last=False)


_ARENA: CertArena | None = None
_ARENA_LOCK = threading.Lock()


def get_arena() -> CertArena | None:
    """The process singleton, or None when disabled."""
    if not enabled():
        return None
    global _ARENA
    if _ARENA is None:
        with _ARENA_LOCK:
            if _ARENA is None:
                _ARENA = CertArena()
    return _ARENA


def reset() -> None:
    """Drop the singleton (isolates arena state between runs)."""
    global _ARENA
    with _ARENA_LOCK:
        _ARENA = None
