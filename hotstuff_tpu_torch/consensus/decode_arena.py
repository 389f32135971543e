"""Shared decode arena: parse each distinct consensus frame once per
process.

Port copy of ``hotstuff_tpu/consensus/decode_arena.py``, less its
telemetry counters and gauge collector (the counts stay as attributes and
in ``stats()``). In a one-process committee every broadcast frame (a
proposal carrying a 2f+1-signature QC, a view-change timeout, a TC) is
delivered to N engines; the codec is deterministic and the decoded objects
are immutable, so byte-identical frames share ONE decode.

Only broadcast-shaped kinds are cached (``propose``, ``timeout``, ``tc``).
Failed parses are not cached: a malformed frame re-raises on every
arrival. Keyed by (seat-table fingerprint, frame bytes), bounded by
entries and bytes with LRU eviction. ``HOTSTUFF_DECODE_ARENA=0`` (read at
import) turns the arena off.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict

from .messages import SeatTable, decode_message

_CACHEABLE = frozenset(("propose", "timeout", "tc"))


class DecodeArena:
    """Content-addressed cache of decoded consensus frames."""

    def __init__(self, max_entries: int = 2048, max_bytes: int = 64 << 20) -> None:
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self.hits = 0
        self.misses = 0
        self.bytes_saved = 0
        self._bytes = 0
        # (fingerprint, frame) -> (kind, payload, nbytes)
        self._entries: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._lock = threading.Lock()

    def decode(self, data: bytes, seats: SeatTable | None = None):
        key = (seats.fingerprint if seats is not None else None, bytes(data))
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                self.bytes_saved += entry[2]
                return entry[0], entry[1]
        kind, payload = decode_message(data, seats)
        with self._lock:
            self.misses += 1
            if kind in _CACHEABLE and key not in self._entries:
                nbytes = len(key[1])
                self._entries[key] = (kind, payload, nbytes)
                self._bytes += nbytes
                while self._entries and (
                    len(self._entries) > self.max_entries or self._bytes > self.max_bytes
                ):
                    _, (_, _, evicted) = self._entries.popitem(last=False)
                    self._bytes -= evicted
        return kind, payload

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "hits": self.hits,
                "misses": self.misses,
                "bytes_saved": self.bytes_saved,
            }


_ENABLED = os.environ.get("HOTSTUFF_DECODE_ARENA", "1") != "0"
_ARENA = DecodeArena()


def arena() -> DecodeArena:
    return _ARENA


def decode_shared(data: bytes, seats: SeatTable | None = None):
    """Arena-backed :func:`decode_message`: identical results and identical
    exceptions, minus the repeated parses."""
    if not _ENABLED:
        return decode_message(data, seats)
    return _ARENA.decode(data, seats)
