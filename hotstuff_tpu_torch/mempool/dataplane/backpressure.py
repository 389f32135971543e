"""Conveyor back-pressure: bounded ingress with client-visible shedding
and a store-depth watermark that throttles batch sealing.

Port copy of ``hotstuff_tpu/mempool/dataplane/backpressure.py``, with its
telemetry gauge and counter beside the plain attributes ``depth`` and
``transitions``.

Under overload the system degrades GRACEFULLY (latency rises, throughput
plateaus, clients see explicit shed signals) instead of queues growing
until the process collapses. Two mechanisms compose end to end:

- :class:`BoundedIngress`: the edge. Each worker's client-facing queue
  is bounded in BUNDLES; a full queue sheds the arriving bundle and the
  ingress handler replies ``b"Shed"`` on the client connection, so a
  load generator can observe exactly which portion of its offer was
  refused.
- :class:`Watermark`: the interior signal. Worker store depth (sealed
  batches not yet committed) crossing the HIGH watermark gates sealing;
  the ingress then fills and sheds at the edge. Sealing resumes only at
  the LOW watermark (hysteresis: no flapping at the boundary). The
  depth rides the ``mempool.worker.store_depth`` gauge and every
  transition into the gated state counts into
  ``mempool.worker.throttle_events``.
"""

from __future__ import annotations

import asyncio

from hotstuff_tpu_torch import telemetry

__all__ = ["BoundedIngress", "Watermark"]


class BoundedIngress:
    """Bounded FIFO with a non-blocking producer side.

    ``offer`` never blocks the receive loop: it either enqueues or sheds
    (returns False). The consumer side is the usual awaitable ``get``.
    """

    def __init__(self, capacity: int) -> None:
        self._q: asyncio.Queue = asyncio.Queue(capacity)
        self.shed = 0  # bundles refused

    def offer(self, item) -> bool:
        try:
            self._q.put_nowait(item)
            return True
        except asyncio.QueueFull:
            self.shed += 1
            return False

    async def get(self):
        return await self._q.get()

    def get_nowait(self):
        return self._q.get_nowait()

    def qsize(self) -> int:
        return self._q.qsize()

    @property
    def capacity(self) -> int:
        return self._q.maxsize


class Watermark:
    """High/low hysteresis gate over a depth counter.

    States: ``ok`` (sealing allowed) and ``high`` (sealing gated).
    ``ok -> high`` at depth >= high; ``high -> ok`` at depth <= low.
    ``wait_ok`` parks the caller while gated.
    """

    def __init__(self, high: int, low: int, name: str = "mempool.worker") -> None:
        if low > high:
            raise ValueError(f"low watermark {low} above high {high}")
        self.high = high
        self.low = low
        self.depth = 0
        self.transitions = 0
        self._ok = asyncio.Event()
        self._ok.set()
        self._g_depth = telemetry.gauge(f"{name}.store_depth")
        self._m_throttle = telemetry.counter(f"{name}.throttle_events")

    @property
    def gated(self) -> bool:
        return not self._ok.is_set()

    def update(self, depth: int) -> None:
        self.depth = depth
        self._g_depth.set(depth)
        if not self.gated and depth >= self.high:
            self._ok.clear()
            self.transitions += 1
            self._m_throttle.inc()
        elif self.gated and depth <= self.low:
            self._ok.set()
            self.transitions += 1

    def adjust(self, delta: int) -> None:
        self.update(self.depth + delta)

    async def wait_ok(self) -> None:
        await self._ok.wait()
