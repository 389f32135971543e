"""Simulant: deterministic simulation of the consensus protocol.

Port copy of ``hotstuff_tpu/sim/`` (all nine files), over the port's own
consensus core, faultline and telemetry. Its contract is the reference's:
every handler runs to completion without suspending, so verification must
be inline. The port's crypto bridge sends every verification to its worker
pool when the backend's name holds ``cuda`` (as the reference's does for
``tpu``), so under the port's default backend a run fails before anything
is verified: the bridge's ``asyncio.get_running_loop()`` finds no loop
inside the sim's handlers and raises ``RuntimeError("no running event
loop")``, as the reference's does under ``tpu``. The caller runs the
sim plane under the ``cpu`` backend; ``run_sim`` and ``SimWorld`` never
switch it themselves. The plane launches no kernel.

FoundationDB-style deterministic simulation testing for this codebase:
the sans-io :class:`CoreStateMachine` (the REAL ``Core`` handlers behind
effect-collecting IO seams) runs N-node committees on a single
virtual-time event heap (:class:`SimWorld`), enacting the existing
faultline scenario schema through the existing :class:`FaultPlane` and
judging with the existing checker — thousands of seeded fault schedules
per CI minute instead of wall-clock minutes per seed.

Entry points:

- :func:`run_sim` — one scenario, one verdict (harness-shaped result);
- :mod:`~hotstuff_tpu_torch.sim.twins` — Twins-style systematic equivocation
  scenario generation (duplicate identity across partitions);
- :mod:`~hotstuff_tpu_torch.sim.shrink` — minimize a failing schedule to a
  pinned reproducer;
- :mod:`hotstuff_tpu_torch.benchmark.sim_sweep` (the reference's
  ``benchmark/sim_sweep.py``) is the checker-gated seed-range sweep;
  ``chip_smoke.py`` phase 17c runs it from its command line.
"""

from .clock import VirtualClock
from .machine import CoreStateMachine, SimSuspended
from .world import EventHeap, SimWorld, run_sim

__all__ = [
    "CoreStateMachine",
    "EventHeap",
    "SimSuspended",
    "SimWorld",
    "VirtualClock",
    "run_sim",
]
