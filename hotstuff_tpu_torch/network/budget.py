"""Process-wide budget for outgoing sender connections.

Port copy of ``hotstuff_tpu/network/budget.py``, whole.

A full validator mesh is O(N^2) sockets, and every in-process TCP
connection costs TWO file descriptors (the client end plus the accepted
end). The reference sidesteps this by running one validator per machine
(`benchmark/benchmark/remote.py`); our single-host committee testbed
(`node deploy`, `benchmark.committee_scale --mode protocol`) materializes
the whole mesh in one process and hits RLIMIT_NOFILE near N=100:
connects fail with EMFILE, votes and proposals are lost, every node
times out, and the resulting Timeout broadcasts open even MORE
connections — a self-sustaining storm.

The budget caps live outgoing connections per process. Senders register
each connection and touch it on use; when the cap is exceeded the
least-recently-used IDLE connection (nothing queued, nothing un-ACKed)
is closed. Its owner transparently reconnects on next use, so above the
cap the mesh degrades to connection churn (~100 us/connect on loopback)
instead of collapsing. Round-robin leadership makes the working set —
recent leaders' broadcast fans plus current vote edges — much smaller
than the full mesh, so steady state stays under the cap with no churn
in practice.

The default cap leaves the other half of the fd space for the accepted
ends (worst case: every peer is in-process) plus stores, logs, and
listening sockets. Override with ``HOTSTUFF_CONN_BUDGET``.
"""

from __future__ import annotations

import asyncio
import logging
import os
from collections import OrderedDict
from typing import Protocol

log = logging.getLogger("network")


class _Evictable(Protocol):
    def evictable(self) -> bool: ...

    def evict(self) -> None: ...


def _default_cap() -> int:
    env = os.environ.get("HOTSTUFF_CONN_BUDGET")
    if env:
        try:
            return max(16, int(env))
        except ValueError:
            raise ValueError(
                f"HOTSTUFF_CONN_BUDGET must be an integer, got {env!r}"
            ) from None
    try:
        import resource

        soft, _ = resource.getrlimit(resource.RLIMIT_NOFILE)
    except Exception:  # pragma: no cover - non-POSIX
        return 4096
    if soft == getattr(resource, "RLIM_INFINITY", -1) or soft <= 0:
        return 16384
    # 35% outgoing; x2 for in-process accepted ends = 70% of the limit,
    # leaving headroom for stores, logs, listeners, and the interpreter.
    return max(128, int(soft * 0.35))


class ConnectionBudget:
    def __init__(self, cap: int | None = None) -> None:
        self.cap = cap if cap is not None else _default_cap()
        self._lru: OrderedDict[_Evictable, None] = OrderedDict()
        self._evictions = 0
        self._sweep_handle = None

    def __len__(self) -> int:
        return len(self._lru)

    @property
    def evictions(self) -> int:
        return self._evictions

    def register(self, conn: _Evictable) -> None:
        self._lru[conn] = None
        # A connection registers from its constructor, BEFORE its first
        # message is queued — its empty queue makes it look idle. Excluding
        # it from its own reap prevents self-eviction (which would strand
        # the message the caller is about to queue on a dead connection).
        self._reap(exclude=conn)

    def touch(self, conn: _Evictable) -> None:
        if conn in self._lru:
            self._lru.move_to_end(conn)

    def unregister(self, conn: _Evictable) -> None:
        self._lru.pop(conn, None)

    def _reap(self, exclude: _Evictable | None = None) -> None:
        if len(self._lru) <= self.cap:
            return
        # Oldest-first scan for idle victims. Busy connections (queued or
        # un-ACKed messages) are never evicted — over-budget operation is
        # transient and resolves as ACKs land.
        #
        # Evict a BATCH (the excess plus cap/8 slack), not just back to
        # the cap: a mesh whose potential connection count sits far above
        # the cap (N=100 one-process committee ≈ 20k sender ends vs a 7k
        # cap) otherwise re-enters this scan on EVERY register, and the
        # oldest-first walk over thousands of busy long-lived peers made
        # the scan itself the protocol's biggest CPU line (~30% of a
        # round, measured). With slack, one O(n) sweep buys cap/8
        # scan-free registers — amortized O(8) per connect.
        victims = []
        excess = len(self._lru) - self.cap + self.cap // 8
        for conn in self._lru:
            if conn is not exclude and conn.evictable():
                victims.append(conn)
                if len(victims) >= excess:
                    break
        for conn in victims:
            self._lru.pop(conn, None)
            conn.evict()
            self._evictions += 1
        if victims:
            log.debug(
                "connection budget: evicted %d idle (cap %d, evictions %d)",
                len(victims),
                self.cap,
                self._evictions,
            )
        if len(self._lru) > self.cap:
            # Everything over budget is currently busy (e.g. a burst of
            # sends queued before any delivery). Sweep again shortly —
            # connections become evictable as their queues drain and ACKs
            # land.
            self._schedule_sweep()

    def _schedule_sweep(self) -> None:
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return
        if self._sweep_handle is not None:
            pending_loop, handle = self._sweep_handle
            # A handle from a CLOSED loop (the budget is process-global;
            # asyncio.run creates a fresh loop per benchmark/test run)
            # never fires — treating it as live would disable sweeps for
            # the rest of the process.
            if pending_loop is loop and not handle.cancelled():
                return
            handle.cancel()
            self._sweep_handle = None

        def sweep() -> None:
            self._sweep_handle = None
            self._reap()

        self._sweep_handle = (loop, loop.call_later(0.05, sweep))


#: Process-wide instance used by SimpleSender and ReliableSender.
BUDGET = ConnectionBudget()
