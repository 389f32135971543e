"""Shrink a failing fault schedule to a minimal pinned reproducer.

Port copy of ``hotstuff_tpu/sim/shrink.py``, whole; its artifacts are the
reference's schema (``simulant-repro-v1``).

When a sweep seed produces a checker violation, the raw chaos scenario
is a poor artifact: half its fault events are irrelevant, and "seed
84321" tells the next engineer nothing. ``shrink`` applies
delta-debugging-style reduction — entirely at the SCENARIO level, so
the output replays through either plane:

1. **drop fault entries** — greedy event removal to a fixpoint (each
   removal re-runs the sim and keeps the candidate only if the SAME
   violation class reproduces);
2. **shorten durations** — interval faults' heal times are pulled
   toward their activations, then the scenario's total duration is
   bisected down;
3. **interleaving** — the sim's ``jitter`` knob re-draws message
   latencies without touching the fault schedule; the shrinker records
   the jitter under which the minimal scenario reproduces, pinning one
   concrete interleaving.

The reproducer artifact (``write_reproducer``) is a single JSON file
carrying the scenario, the world configuration, the verdict, and the
canonical schedule trace — drop it in ``benchmark/scenarios/`` or feed
it back to ``run_sim``/``run_scenario`` to replay.
"""

from __future__ import annotations

import json
import os

from hotstuff_tpu_torch.faultline.policy import Scenario

from .world import run_sim

__all__ = ["ShrinkResult", "shrink", "sim_failure_probe", "write_reproducer"]

REPRO_SCHEMA = "simulant-repro-v1"


def _violation_class(verdict: dict) -> str | None:
    """The coarse failure fingerprint shrinking preserves: safety
    violations and liveness violations are different bugs — a shrink
    step must not "simplify" one into the other."""
    if not verdict["safety"]["ok"]:
        return "safety"
    if not verdict["liveness"]["recovered"]:
        return "liveness"
    return None


def sim_failure_probe(n: int, **world_kwargs):
    """A ``probe(scenario) -> (violation_class | None, verdict)`` that
    runs the scenario on the sim plane with fixed world parameters."""

    def probe(scenario: Scenario):
        verdict = run_sim(scenario, n, **world_kwargs)["verdict"]
        return _violation_class(verdict), verdict

    return probe


class ShrinkResult:
    __slots__ = ("scenario", "verdict", "violation", "runs", "steps")

    def __init__(self, scenario, verdict, violation, runs, steps) -> None:
        self.scenario = scenario
        self.verdict = verdict
        self.violation = violation
        self.runs = runs
        self.steps = steps


def shrink(
    scenario: Scenario,
    probe,
    *,
    max_runs: int = 200,
) -> ShrinkResult:
    """Minimize ``scenario`` while ``probe`` keeps reporting the same
    violation class. ``probe(scenario) -> (violation | None, verdict)``;
    the initial scenario MUST fail (ValueError otherwise, so a flaky
    report can't silently shrink to nothing)."""
    violation, verdict = probe(scenario)
    runs = 1
    if violation is None:
        raise ValueError("shrink() requires a failing scenario")
    steps: list[str] = []
    current = scenario

    def attempt(candidate: Scenario, note: str):
        nonlocal current, verdict, runs
        if runs >= max_runs:
            return False
        got, v = probe(candidate)
        runs += 1
        if got == violation:
            current = candidate
            verdict = v
            steps.append(note)
            return True
        return False

    # Pass 1: greedy single-event drops to a fixpoint. Dropping never
    # re-rolls sibling events' seeded choices (policy.compile derives
    # one RNG stream per ORIGINAL template slot index — which shifts on
    # removal, so re-probe rather than assume).
    changed = True
    while changed and runs < max_runs:
        changed = False
        i = 0
        while i < len(current.events):
            events = current.events[:i] + current.events[i + 1 :]
            if not events:
                break
            candidate = Scenario(
                name=current.name,
                seed=current.seed,
                duration_s=current.duration_s,
                events=events,
            )
            if attempt(candidate, f"drop event {i}"):
                changed = True  # list shifted: retry same index
            else:
                i += 1

    # Pass 2: shorten interval faults (heal sooner).
    for i, ev in enumerate(list(current.events)):
        until = ev.get("until")
        if until is None:
            continue
        at = float(ev.get("at", 0.0))
        for frac in (0.25, 0.5):
            shorter = at + (float(until) - at) * frac
            if shorter >= float(until):
                continue
            events = [dict(e) for e in current.events]
            events[i]["until"] = round(shorter, 3)
            candidate = Scenario(
                name=current.name,
                seed=current.seed,
                duration_s=current.duration_s,
                events=events,
            )
            if attempt(candidate, f"shorten event {i} until -> {shorter:.3f}"):
                break

    # Pass 3: trim total duration (the recovery tail judges liveness, so
    # the scenario only needs to outlive its last event).
    last_event_t = max(
        (
            max(float(e.get("at", 0.0)), float(e.get("until") or 0.0))
            for e in current.events
        ),
        default=0.0,
    )
    for frac in (0.4, 0.6, 0.8):
        duration = max(last_event_t + 0.5, current.duration_s * frac)
        if duration >= current.duration_s:
            continue
        candidate = Scenario(
            name=current.name,
            seed=current.seed,
            duration_s=round(duration, 3),
            events=current.events,
        )
        if attempt(candidate, f"duration -> {duration:.3f}"):
            break

    return ShrinkResult(current, verdict, violation, runs, steps)


def write_reproducer(
    directory: str,
    scenario: Scenario,
    n: int,
    verdict: dict,
    *,
    trace: str | None = None,
    world: dict | None = None,
    steps: list[str] | None = None,
    tag: str = "repro",
) -> str:
    """Write a replayable reproducer artifact; returns its path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(
        directory, f"{tag}-{scenario.name}-seed{scenario.seed}-n{n}.json"
    )
    with open(path, "w") as f:
        json.dump(
            {
                "schema": REPRO_SCHEMA,
                "scenario": scenario.to_json(),
                "n": n,
                "world": world or {},
                "verdict": verdict,
                "trace": trace,
                "shrink_steps": steps or [],
            },
            f,
            indent=2,
            sort_keys=True,
        )
        f.write("\n")
    return path
