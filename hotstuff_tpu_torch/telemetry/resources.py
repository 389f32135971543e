"""Resource observability: RSS, on-disk store/MetaLog size, and
tracemalloc growth, surfaced as snapshot gauges.

Long soaks fail in a mode the protocol metrics cannot see: memory or
disk grows without bound until the box dies hours later (snapshot and
truncate of the MetaLog exist for exactly this reason). The
collector registered here is polled once per telemetry snapshot — the
gauges land in every ``hotstuff-telemetry-v1`` line, so the SLO
engine's ``gauge_growth`` kind (``telemetry/slo.py``) can gate a soak
on "RSS grows slower than X bytes/s in every window" instead of
somebody eyeballing ``ps`` output.

Gauges (all under the ``resource.`` collector prefix):

- ``rss_bytes``: resident set from ``/proc/self/statm`` (Linux; falls
  back to ``resource.getrusage`` elsewhere).
- ``store_bytes``: recursive on-disk size of the registered store
  directory (data log + ``meta.log`` + native WAL). Absent when the
  node runs an in-memory store.
- ``open_fds``: ``/proc/self/fd`` entry count (socket/file leaks show
  up here long before accept() starts failing).
- ``tracemalloc_total_bytes`` / ``tracemalloc_top_growth_bytes``: only
  when tracing is on (``HOTSTUFF_TRACEMALLOC=1`` or ``install(
  tracemalloc_on=True)``) — total traced size and the single largest
  per-site growth since the previous poll, with the top sites logged at
  DEBUG. Tracing costs real memory/CPU, so it is opt-in; RSS is the
  always-on signal.

Port copy of ``hotstuff_tpu/telemetry/resources.py``; only comments differ.
"""

from __future__ import annotations

import logging
import os

log = logging.getLogger("telemetry")

_PAGE_SIZE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def rss_bytes() -> int | None:
    """Resident set size of this process, or None when unmeasurable."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * _PAGE_SIZE
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource as _resource

        # ru_maxrss is KiB on Linux (peak, not current — still monotone
        # enough for growth gating when /proc is unavailable).
        return _resource.getrusage(_resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:  # noqa: BLE001 — observability must not raise
        return None


def dir_bytes(path: str) -> int:
    """Recursive apparent size of ``path`` (0 for a missing path —
    a store not yet created is empty, not an error)."""
    total = 0
    try:
        for root, _dirs, files in os.walk(path):
            for name in files:
                try:
                    total += os.path.getsize(os.path.join(root, name))
                except OSError:
                    pass  # file vanished mid-walk (compaction)
    except OSError:
        return 0
    return total


def open_fds() -> int | None:
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return None


class _TracemallocWatch:
    """Per-site growth between collector polls: keeps the previous poll's
    top sites (keyed file:lineno) and reports the largest positive
    delta. Bounded: only the top ``keep`` sites by size are remembered."""

    def __init__(self, keep: int = 50) -> None:
        self.keep = keep
        self._prev: dict[str, int] = {}

    def poll(self) -> tuple[int, int]:
        """(total traced bytes, largest per-site growth since last poll)."""
        import tracemalloc

        snap = tracemalloc.take_snapshot()
        stats = snap.statistics("lineno")
        total = sum(s.size for s in stats)
        current: dict[str, int] = {}
        for s in stats[: self.keep]:
            frame = s.traceback[0]
            current[f"{os.path.basename(frame.filename)}:{frame.lineno}"] = s.size
        growth = [
            (size - self._prev.get(site, 0), site)
            for site, size in current.items()
        ]
        growth.sort(reverse=True)
        top_growth = max(0, growth[0][0]) if growth else 0
        if growth and growth[0][0] > 0:
            log.debug(
                "tracemalloc top growth: %s",
                ", ".join(f"{site} +{delta}" for delta, site in growth[:3]),
            )
        self._prev = current
        return total, top_growth


_STORE_PATH: str | None = None
_TM_WATCH: _TracemallocWatch | None = None


def _collect() -> dict[str, float]:
    out: dict[str, float] = {}
    rss = rss_bytes()
    if rss is not None:
        out["rss_bytes"] = rss
    fds = open_fds()
    if fds is not None:
        out["open_fds"] = fds
    if _STORE_PATH:
        out["store_bytes"] = dir_bytes(_STORE_PATH)
    if _TM_WATCH is not None:
        import tracemalloc

        if tracemalloc.is_tracing():
            total, top_growth = _TM_WATCH.poll()
            out["tracemalloc_total_bytes"] = total
            out["tracemalloc_top_growth_bytes"] = top_growth
    return out


def install(store_path: str | None = None, tracemalloc_on: bool | None = None) -> None:
    """Register the ``resource`` collector on the process registry
    (idempotent — re-registration replaces; the last store path wins).
    ``tracemalloc_on=None`` defers to ``HOTSTUFF_TRACEMALLOC``."""
    global _STORE_PATH, _TM_WATCH
    from . import register_collector

    if store_path is not None:
        _STORE_PATH = store_path
    if tracemalloc_on is None:
        tracemalloc_on = bool(os.environ.get("HOTSTUFF_TRACEMALLOC"))
    if tracemalloc_on:
        import tracemalloc

        if not tracemalloc.is_tracing():
            tracemalloc.start()
        if _TM_WATCH is None:
            _TM_WATCH = _TracemallocWatch()
    register_collector("resource", _collect)


def reset_for_tests() -> None:
    global _STORE_PATH, _TM_WATCH
    _STORE_PATH = None
    _TM_WATCH = None
