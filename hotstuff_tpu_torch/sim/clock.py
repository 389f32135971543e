"""Virtual clock for deterministic simulation.

Port copy of ``hotstuff_tpu/sim/clock.py``, whole.

A ``VirtualClock`` is a float the scheduler advances. It is CALLABLE so
it drops into every ``clock=`` seam the real stack exposes
(``consensus.Timer``, ``consensus.Synchronizer``,
``faultline.FaultPlane``): code written against ``time.monotonic``
semantics reads simulated seconds instead, and nothing ever sleeps.

Monotonicity is enforced — an event heap that tried to move time
backwards has a scheduling bug, and silently accepting it would
desynchronize every timer deadline derived from the clock.
"""

from __future__ import annotations

__all__ = ["VirtualClock"]


class VirtualClock:
    __slots__ = ("_now",)

    def __init__(self, start: float = 0.0) -> None:
        self._now = float(start)

    def __call__(self) -> float:
        return self._now

    @property
    def now(self) -> float:
        return self._now

    def advance_to(self, t: float) -> None:
        if t < self._now:
            raise ValueError(
                f"virtual time cannot move backwards: {t} < {self._now}"
            )
        self._now = t

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"VirtualClock({self._now:.6f})"
