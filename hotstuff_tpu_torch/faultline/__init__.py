"""Faultline: deterministic fault injection with machine-checked verdicts.

Three planes:

- **policy** — declarative, JSON-serializable scenarios whose entire
  fault schedule derives from one seed (``Scenario``, ``chaos_scenario``,
  ``Schedule.trace()`` as the replay-equality contract);
- **runtime** — the ``FaultPlane`` enacting partitions / per-link
  drop-delay-duplicate-reorder / byzantine behaviors through hooks in the
  network plane, plus supervised crash/restart, every injection counted
  in ``faultline.injected.*`` telemetry and recorded to a replay trace;
- **checker** — post-run safety (no conflicting commits at a round across
  honest nodes) and liveness (commit growth resumes after the last heal)
  verdicts as plain JSON.

Entry points: ``faultline.run_scenario`` on an in-process committee of
port engines, and ``HOTSTUFF_FAULTLINE=<scenario.json>`` on a port node
(``node/node.py``).

Import discipline: the network plane imports ``faultline.hooks`` on its
own hot path, so this package initializer must stay dependency-light —
the harness/byzantine/checker layers (which import consensus, which
imports network) load lazily on first attribute access (PEP 562).

Port copy of ``hotstuff_tpu/faultline/`` (``docs/faultline.md`` describes
the reference's): the same scenarios, schedules, link decisions and
verdicts. Left out: the native transport's ``hs_net_faults`` hook, which
waits for that transport's port.
"""

from .policy import (
    BYZANTINE_BEHAVIORS,
    FaultEvent,
    Scenario,
    Schedule,
    chaos_scenario,
    link_rng,
)
from .runtime import FaultPlane, install, uninstall

__all__ = [
    "BYZANTINE_BEHAVIORS",
    "CommitRecord",
    "FaultEvent",
    "FaultPlane",
    "Scenario",
    "ScenarioRun",
    "Schedule",
    "VERDICT_SCHEMA",
    "chaos_scenario",
    "check",
    "check_availability",
    "install",
    "link_rng",
    "run_scenario",
    "uninstall",
]

_LAZY = {
    "CommitRecord": ("checker", "CommitRecord"),
    "check": ("checker", "check"),
    "check_availability": ("checker", "check_availability"),
    "VERDICT_SCHEMA": ("checker", "VERDICT_SCHEMA"),
    "ScenarioRun": ("harness", "ScenarioRun"),
    "run_scenario": ("harness", "run_scenario"),
    "ByzantineActor": ("byzantine", "ByzantineActor"),
}


def __getattr__(name: str):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    module = importlib.import_module(f".{target[0]}", __name__)
    value = getattr(module, target[1])
    globals()[name] = value
    return value
