"""Stage spans of the certificate path: where a verification's time goes
below the crypto bridge.

The core's ``consensus.stage.<kind>.{ns,calls}`` counters price each
protocol handler; these spans split what one handler waits for: the
frame's decode, the bridge's hand-offs, a certificate's accounting, the
backend call and, inside it, the host prep, the launches and the host's
wait for the card's verdict. Each armed span

- adds its wall time (``time.perf_counter_ns``) and one call to the
  registry counters ``<name>.ns`` and ``<name>.calls``;
- appends ``(seq, name, thread ident, start ns, end ns)`` to one bounded
  ring (a ``TraceBuffer``; evictions counted in its ``evicted``).

The clock is the one ``RoundTrace`` and the benchmark's device-trace
markers read, so a span's interval maps onto the card's timeline as
theirs do. A span that crosses threads (the bridge's queue and resume)
is recorded from its two ends with ``interval``.

Stages record only between ``arm()`` and ``disarm()``. Unarmed, a site
reads ``ARMED`` and does nothing else (no clock read, no counter lookup)::

    t = stages.begin() if stages.ARMED else None
    ...
    if t is not None:
        stages.end("crypto.backend", t)
"""

from __future__ import annotations

import threading
import time

from .trace import TraceBuffer

#: the one switch every site reads.
ARMED = False

#: the spans, innermost first: the order in which a reader of the ring
#: names an instant that nested spans cover.
NESTING = (
    "crypto.launch",
    "crypto.prep.ensure",
    "crypto.prep.scalars",
    "crypto.prep.recode",
    "crypto.prep.pack",
    "crypto.wait",
    "crypto.single",
    "crypto.batch.wait",
    "crypto.backend",
    "crypto.cert",
    "crypto.bridge.queue",
    "crypto.bridge.resume",
    "consensus.decode",
)

#: ring capacity: a 30 s window at N = 1008 records about 16,000 spans.
CAPACITY = 65_536

_RING = TraceBuffer(CAPACITY)
_COUNTERS: dict[str, tuple] = {}  # name -> (ns, calls) counters

#: a span's start, in wall ns.
begin = time.perf_counter_ns


def arm() -> None:
    global ARMED
    ARMED = True


def disarm() -> None:
    global ARMED
    ARMED = False


def ring() -> TraceBuffer:
    return _RING


def intervals() -> list[tuple[str, int, int, int]]:
    """The ring's spans as ``(name, thread ident, start ns, end ns)``,
    oldest first."""
    return [e[1:] for e in _RING.snapshot_events()]


def _counters(name: str) -> tuple:
    c = _COUNTERS.get(name)
    if c is None:
        from . import get_registry

        reg = get_registry()
        c = _COUNTERS[name] = (reg.counter(f"{name}.ns"), reg.counter(f"{name}.calls"))
    return c


def end(name: str, start: int) -> None:
    """Close a span that ``begin()`` opened on this thread."""
    interval(name, start, time.perf_counter_ns())


def interval(name: str, start: int, end_ns: int) -> None:
    """Record a wall interval, also one whose ends were read on different
    threads."""
    ns, calls = _counters(name)
    ns.inc(end_ns - start)
    calls.inc()
    _RING.record(name, threading.get_ident(), start, t=end_ns)


def reset_for_tests() -> None:
    global ARMED
    ARMED = False
    _COUNTERS.clear()
    _RING.clear()
