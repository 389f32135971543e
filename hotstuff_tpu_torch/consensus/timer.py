"""Resettable timeout timer (reference ``consensus/src/timer.rs:10-34``).

Port copy of ``hotstuff_tpu/consensus/timer.py``, whole.

``wait()`` completes when the deadline passes; ``reset()`` pushes the
deadline forward — an in-flight ``wait()`` observes the new deadline and
keeps sleeping, matching the reference's resettable ``Sleep``.

The clock is injectable: the real stack uses ``time.monotonic`` (the
default — behavior unchanged), while the deterministic simulation plane
of the reference (``hotstuff_tpu/sim``) passes a virtual clock and never calls
``wait()`` — it reads ``deadline`` and fires expiries from its event
heap, making the Timer a thin state holder over the injected clock.
"""

from __future__ import annotations

import asyncio
import time


class Timer:
    def __init__(self, duration_ms: int, clock=time.monotonic) -> None:
        self.duration = duration_ms / 1000.0
        self._clock = clock
        self._deadline = clock() + self.duration

    @property
    def deadline(self) -> float:
        """The instant (on the injected clock) the timer next expires."""
        return self._deadline

    def reset(self) -> None:
        self._deadline = self._clock() + self.duration

    async def wait(self) -> None:
        while True:
            remaining = self._deadline - self._clock()
            if remaining <= 0:
                return
            await asyncio.sleep(remaining)
