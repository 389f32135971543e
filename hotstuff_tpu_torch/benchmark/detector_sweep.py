"""Oracle: detector tuning as search — score every Watchtower detector
against thousands of labeled Simulant schedules, then tune
``WatchtowerConfig`` thresholds by coordinate-descent grid search.

The fault plan IS the label set: a compiled faultline schedule says
exactly which peer misbehaved, how, and when, and the sim→stream bridge
(``hotstuff_tpu_torch.sim.streams``) renders the run into the same telemetry
streams the real emitters write — so ``Watchtower.feed`` replays a whole
schedule in milliseconds and precision/recall/time-to-detect become
measurable at corpus scale instead of two seeded wall-clock schedules
per minute (``hotstuff_tpu_torch/benchmark/detector_bench.py``).

Corpus (all virtual-clock, all labeled):

- **chaos** schedules (``chaos_scenario``): 4 overlapping incidents each
  — the precision/stress set. Overlapping faults routinely mask each
  other (a crash during another node's link fault is a global stall with
  no contrast to attribute), so chaos incidents are scored but only a
  subset is *pinned*.
- **single-fault** schedules (one seeded fault per run, duration drawn
  ≥ ``PIN_MIN_DURATION_S``): the recall floor. Every one of these is a
  pinned incident — missing any is a gate failure.
- **controls** (fault-free): any alert is a false alarm; the gate
  requires zero.

Pinned incident classes (the recall-1.0 constraint of the search):
``crash``, ``partition``, ``byzantine:silent_leader`` — when the
incident lasts ≥ ``PIN_MIN_DURATION_S`` *and* no other fault overlaps it
(contrast-based detectors cannot attribute a jointly-caused stall) — and
``byzantine:equivocate`` whenever it lasts ≥ ``PIN_MIN_DURATION_S``
(conflicting-digest evidence is direct and survives overlap).
``byzantine:stale_vote_flood`` is labeled but never pinned: the core
drops stale votes before any trace mark, so the flood is invisible to
stream detectors by design (rate-limit territory, not accountability).
``link`` faults are degradation, not misbehavior; labeled, not pinned.

Usage::

    # full tuned-vs-default scorecard + tuned preset (the committed run)
    python -m hotstuff_tpu_torch.benchmark.detector_sweep --search \\
        --out results/detector-scorecard-n4.json \\
        --preset-out hotstuff_tpu_torch/telemetry/presets/tuned-n4.json

    # CI gate: evaluate the committed preset, fail on any pinned miss
    # or control false alarm
    python -m hotstuff_tpu_torch.benchmark.detector_sweep --seeds 0:500 \\
        --config preset:tuned-n4 --gate --out sweep-ci.json

Port copy of the reference's ``benchmark/detector_sweep.py``, over the
port's ``sim``, ``faultline.policy``, watchtower and ``detector_bench``
(``preset:tuned-n4`` reads the port's copy of the preset). Its flags,
scoring, log lines, scorecard and preset schemas are the reference's.
What differs:

- ``main`` runs under the ``cpu`` backend, set for this process and put
  back after it: the sim verifies inline and fails under a ``cuda``-named
  backend (no running event loop) as the reference's does under ``tpu``,
  and the port's default backend is ``cuda``. Neither package has a
  device path on the sim plane, so this is not a fallback. Callers of
  ``run_schedule`` set the backend themselves;
- the scorecard's ``generated_by`` and the preset's ``provenance.tool``
  name this module;
- ``main`` takes ``argv``; there is no ``sys.path`` edit.

``--out`` and ``--preset-out`` write where they are told: pass paths of
your own, not the repository's ``results/`` or presets.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import random
import sys
import time

from hotstuff_tpu_torch import crypto
from hotstuff_tpu_torch.benchmark.detector_bench import EXPECTED_DETECTORS, _incidents
from hotstuff_tpu_torch.benchmark.hostinfo import host_meta
from hotstuff_tpu_torch.faultline.policy import Scenario, chaos_scenario
from hotstuff_tpu_torch.sim.streams import StreamRecorder
from hotstuff_tpu_torch.sim.world import SimWorld
from hotstuff_tpu_torch.telemetry.watchtower import (
    DETECTOR_CATALOG_VERSION,
    Watchtower,
    WatchtowerConfig,
)

SWEEP_SCHEMA = "hotstuff-detector-sweep-v1"
PRESET_SCHEMA = "hotstuff-watchtower-preset-v1"

#: incident classes the tuned config must reach recall 1.0 on.
PINNED_CLASSES = (
    "crash",
    "partition",
    "byzantine:equivocate",
    "byzantine:silent_leader",
)
#: detectability horizon: incidents shorter than this may begin and end
#: inside one evidence window and are reported, not gated.
PIN_MIN_DURATION_S = 5.0
#: alert-to-incident matching window (virtual seconds): an alert counts
#: for an incident from just before injection to slack past heal
#: (laggard/silent evidence legitimately closes a window or two after).
MATCH_LEAD_S = 1.0
MATCH_SLACK_S = 15.0

#: single-fault scenario kinds (the pinned recall floor).
SINGLE_FAULT_KINDS = (
    "crash",
    "partition",
    "byzantine:equivocate",
    "byzantine:silent_leader",
)

#: coordinate-descent dimensions, in descent order. Window geometry
#: first (it moves recall), score cutoffs and backoffs after (they move
#: precision). The resource-slope budgets (rss/store/digest-queue) are
#: NOT searched: sim streams carry no resource gauges, so those
#: detectors never fire here — they are wall-plane detectors and keep
#: their hand-tuned defaults.
SEARCH_GRID: tuple[tuple[str, tuple], ...] = (
    ("window_s", (2.0, 3.0, 5.0)),
    ("window_rounds", (8, 12, 16)),
    ("min_rounds", (3, 4, 6)),
    ("settle_s", (0.5, 1.0)),
    ("settle_multiplier", (1.0, 1.2, 1.6)),
    ("silent_windows", (1, 2, 3)),
    ("silent_participation_max", (0.05, 0.10, 0.20)),
    ("laggard_windows", (1, 2)),
    ("laggard_min_lag", (4, 6, 8)),
    ("laggard_stale_s", (4.0, 8.0, 12.0)),
    ("grind_timeout_rate", (0.25, 0.4, 0.6)),
    ("grind_min_proposals", (2, 3)),
    ("grind_proposal_stale_s", (0.0, 2.5, 3.0, 4.0)),
    ("alert_min_confidence", (0.0, 0.55, 0.65)),
    ("cooldown_s", (10.0, 15.0, 30.0)),
)

log = logging.getLogger("hotstuff_tpu_torch.benchmark.detector_sweep")


# -- corpus ----------------------------------------------------------------


def single_fault_scenario(kind: str, seed: int) -> Scenario:
    """One isolated fault of a pinned class, seeded timing, duration
    drawn comfortably above ``PIN_MIN_DURATION_S``."""
    if kind not in SINGLE_FAULT_KINDS:
        raise ValueError(f"unknown single-fault kind {kind!r}")
    rng = random.Random(f"oracle-single:{kind}:{seed}")
    at = round(rng.uniform(1.5, 2.5), 3)
    hold = round(rng.uniform(5.5, 6.5), 3)
    victim = rng.randrange(1 << 16)
    if kind == "crash":
        events = [
            {"kind": "crash", "node": victim, "at": at},
            {"kind": "restart", "node": victim, "at": round(at + hold, 3)},
        ]
    elif kind == "partition":
        events = [
            {"kind": "partition", "at": at, "until": round(at + hold, 3)}
        ]
    else:
        behavior = kind.split(":", 1)[1]
        events = [
            {
                "kind": "byzantine",
                "behavior": behavior,
                "node": victim,
                "at": at,
                "until": round(at + hold, 3),
            }
        ]
    return Scenario(
        name=f"oracle-{kind.replace(':', '-')}-{seed}",
        seed=seed,
        duration_s=round(at + hold + 3.0, 3),
        events=events,
    )


def control_scenario(seed: int, duration_s: float = 8.0) -> Scenario:
    return Scenario(
        name=f"oracle-control-{seed}",
        seed=seed,
        duration_s=duration_s,
        events=[],
    )


def incident_class(inc: dict) -> str:
    if inc["kind"] == "byzantine":
        return f"byzantine:{inc['behavior']}"
    return inc["kind"]


def _mark_pinned(incidents: list[dict]) -> None:
    """Annotate each incident with its class and pinned flag (see module
    docstring for the pinning rules)."""
    for inc in incidents:
        inc["class"] = incident_class(inc)
        dur = inc["until"] - inc["t"]
        if inc["class"] not in PINNED_CLASSES or dur < PIN_MIN_DURATION_S:
            inc["pinned"] = False
            continue
        if inc["class"] == "byzantine:equivocate":
            inc["pinned"] = True
            continue
        overlapped = any(
            other is not inc
            and other["t"] - 1.0 < inc["until"]
            and other["until"] + 1.0 > inc["t"]
            for other in incidents
        )
        inc["pinned"] = not overlapped


def run_schedule(
    scenario: Scenario,
    *,
    nodes: int = 4,
    interval_s: float = 0.5,
) -> tuple[list, list[dict], dict]:
    """Simulate one scenario with the stream bridge attached; returns
    ``(timeline, incidents, sim_result)``."""
    recorder = StreamRecorder(interval_s=interval_s)
    world = SimWorld(scenario, nodes, recorder=recorder)
    result = world.run()
    incidents = _incidents(world.schedule, scenario.duration_s)
    _mark_pinned(incidents)
    return recorder.timeline(), incidents, result


# -- scoring ---------------------------------------------------------------


def replay_config(timeline: list, config: WatchtowerConfig) -> list[dict]:
    watch = Watchtower(config, label="oracle")
    alerts = watch.feed((obj, node) for _, node, obj in timeline)
    alerts += watch.flush()
    return alerts


def match_alerts(incidents: list[dict], alerts: list[dict]) -> None:
    """Annotate incidents with detection results and alerts with their
    matched flag, in place."""
    for a in alerts:
        a["matched"] = False
    for inc in incidents:
        expected = EXPECTED_DETECTORS.get(inc["kind"], ())
        hits = [
            a
            for a in alerts
            if inc["peer"] in a["accused"]
            and a["detector"] in expected
            and inc["t"] - MATCH_LEAD_S
            <= a["ts"]
            <= inc["until"] + MATCH_SLACK_S
        ]
        for a in hits:
            a["matched"] = True
        inc["detected"] = bool(hits)
        if hits:
            first = min(hits, key=lambda a: a["ts"])
            inc["detected_by"] = first["detector"]
            inc["ttd_s"] = round(max(0.0, first["ts"] - inc["t"]), 3)


class ScoreAccumulator:
    """Streaming metrics over (incidents, alerts) pairs — one instance
    per evaluated config, fed one schedule at a time."""

    def __init__(self) -> None:
        self.schedules = 0
        self.alerts = 0
        self.matched_alerts = 0
        self.control_runs = 0
        self.control_alerts = 0
        self.per_detector: dict[str, dict] = {}
        self.per_class: dict[str, dict] = {}
        self.pinned_misses: list[dict] = []

    def add(self, tag: str, incidents: list[dict], alerts: list[dict],
            *, control: bool = False) -> None:
        self.schedules += 1
        if control:
            self.control_runs += 1
            self.control_alerts += len(alerts)
        match_alerts(incidents, alerts)
        self.alerts += len(alerts)
        self.matched_alerts += sum(a["matched"] for a in alerts)
        for a in alerts:
            d = self.per_detector.setdefault(
                a["detector"], {"alerts": 0, "true_positive": 0, "ttds": []}
            )
            d["alerts"] += 1
            d["true_positive"] += 1 if a["matched"] else 0
        for inc in incidents:
            c = self.per_class.setdefault(
                inc["class"],
                {
                    "incidents": 0,
                    "detected": 0,
                    "pinned": 0,
                    "pinned_detected": 0,
                    "ttds": [],
                    "detected_by": {},
                },
            )
            c["incidents"] += 1
            if inc["detected"]:
                c["detected"] += 1
                c["ttds"].append(inc["ttd_s"])
                by = inc["detected_by"]
                c["detected_by"][by] = c["detected_by"].get(by, 0) + 1
                d = self.per_detector.setdefault(
                    by, {"alerts": 0, "true_positive": 0, "ttds": []}
                )
                d["ttds"].append(inc["ttd_s"])
            if inc["pinned"]:
                c["pinned"] += 1
                if inc["detected"]:
                    c["pinned_detected"] += 1
                else:
                    self.pinned_misses.append(
                        {
                            "schedule": tag,
                            "class": inc["class"],
                            "peer": inc["peer"],
                            "t": round(inc["t"], 3),
                            "duration_s": round(inc["until"] - inc["t"], 3),
                        }
                    )

    # -- derived -----------------------------------------------------------

    @property
    def incidents(self) -> int:
        return sum(c["incidents"] for c in self.per_class.values())

    @property
    def pinned(self) -> int:
        return sum(c["pinned"] for c in self.per_class.values())

    @property
    def pinned_detected(self) -> int:
        return sum(c["pinned_detected"] for c in self.per_class.values())

    @property
    def recall_pinned(self) -> float:
        return self.pinned_detected / self.pinned if self.pinned else 1.0

    @property
    def recall_all(self) -> float:
        n = self.incidents
        return (
            sum(c["detected"] for c in self.per_class.values()) / n
            if n
            else 1.0
        )

    @property
    def precision(self) -> float:
        return self.matched_alerts / self.alerts if self.alerts else 1.0

    @property
    def mean_ttd(self) -> float:
        ttds = [t for c in self.per_class.values() for t in c["ttds"]]
        return sum(ttds) / len(ttds) if ttds else 0.0

    def objective(self) -> tuple:
        """Lexicographic search objective: reach pinned recall, kill
        control false alarms, then precision, recall on everything,
        and finally time-to-detect."""
        return (
            round(self.recall_pinned, 6),
            -self.control_alerts,
            round(self.precision, 6),
            round(self.recall_all, 6),
            -round(self.mean_ttd, 3),
        )

    def feasible(self) -> bool:
        return self.recall_pinned >= 1.0 and self.control_alerts == 0

    def report(self) -> dict:
        def _ttd_stats(ttds):
            if not ttds:
                return None
            s = sorted(ttds)
            return {
                "mean_s": round(sum(s) / len(s), 3),
                "p50_s": round(s[len(s) // 2], 3),
                "max_s": round(s[-1], 3),
            }

        per_detector = {}
        for name, d in sorted(self.per_detector.items()):
            per_detector[name] = {
                "alerts": d["alerts"],
                "true_positive": d["true_positive"],
                "precision": (
                    round(d["true_positive"] / d["alerts"], 3)
                    if d["alerts"]
                    else None
                ),
                "ttd": _ttd_stats(d["ttds"]),
            }
        per_class = {}
        for name, c in sorted(self.per_class.items()):
            per_class[name] = {
                "incidents": c["incidents"],
                "detected": c["detected"],
                "recall": round(c["detected"] / c["incidents"], 3),
                "pinned": c["pinned"],
                "pinned_detected": c["pinned_detected"],
                "detected_by": dict(sorted(c["detected_by"].items())),
                "ttd": _ttd_stats(c["ttds"]),
            }
        return {
            "schedules": self.schedules,
            "incidents": self.incidents,
            "alerts": self.alerts,
            "precision": round(self.precision, 4),
            "recall_all": round(self.recall_all, 4),
            "pinned_incidents": self.pinned,
            "pinned_detected": self.pinned_detected,
            "recall_pinned": round(self.recall_pinned, 4),
            "control_runs": self.control_runs,
            "control_alerts": self.control_alerts,
            "mean_ttd_s": round(self.mean_ttd, 3),
            "per_detector": per_detector,
            "per_class": per_class,
            "pinned_misses": self.pinned_misses[:32],
        }


def score_corpus(
    corpus: list[tuple[str, bool, list, list[dict]]],
    config: WatchtowerConfig,
) -> ScoreAccumulator:
    """Replay a cached corpus (``(tag, is_control, timeline, incidents)``
    tuples) against one config."""
    acc = ScoreAccumulator()
    for tag, is_control, timeline, incidents in corpus:
        alerts = replay_config(timeline, config)
        acc.add(tag, incidents, alerts, control=is_control)
    return acc


# -- search ----------------------------------------------------------------


def coordinate_descent(
    corpus: list,
    base: WatchtowerConfig,
    *,
    grid=SEARCH_GRID,
    max_passes: int = 3,
    progress=None,
) -> tuple[WatchtowerConfig, dict]:
    """Greedy per-dimension grid search: sweep each knob holding the
    rest fixed, keep the best objective, repeat until a full pass makes
    no move (or ``max_passes``)."""
    current = dict(base.__dict__)
    best = score_corpus(corpus, WatchtowerConfig(**current)).objective()
    evaluations = 1
    trajectory = []
    for sweep_pass in range(max_passes):
        moved = False
        for knob, values in grid:
            for value in values:
                if value == current[knob]:
                    continue
                trial = dict(current, **{knob: value})
                obj = score_corpus(corpus, WatchtowerConfig(**trial)).objective()
                evaluations += 1
                if obj > best:
                    best = obj
                    current = trial
                    moved = True
                    trajectory.append(
                        {"pass": sweep_pass, "set": {knob: value},
                         "objective": list(obj)}
                    )
                    if progress:
                        progress(
                            f"pass {sweep_pass}: {knob}={value} -> "
                            f"recall_pinned={obj[0]} controls={-obj[1]} "
                            f"precision={obj[2]}"
                        )
        if not moved:
            break
    return WatchtowerConfig(**current), {
        "evaluations": evaluations,
        "passes": sweep_pass + 1,
        "objective": list(best),
        "trajectory": trajectory,
        "dimensions": [k for k, _ in grid],
    }


# -- evaluation passes -----------------------------------------------------


def _parse_range(spec: str) -> range:
    if ":" in spec:
        lo, hi = spec.split(":", 1)
        return range(int(lo), int(hi))
    return range(0, int(spec))


def corpus_specs(args) -> list[tuple[str, bool, Scenario]]:
    """The full evaluation corpus as (tag, is_control, scenario)."""
    specs: list[tuple[str, bool, Scenario]] = []
    for seed in _parse_range(args.seeds):
        specs.append(
            (
                f"chaos-{seed}",
                False,
                chaos_scenario(seed=seed, duration_s=args.duration),
            )
        )
    for seed in range(args.labeled_seeds):
        for kind in SINGLE_FAULT_KINDS:
            scn = single_fault_scenario(kind, seed)
            specs.append((scn.name, False, scn))
    for seed in range(args.controls):
        specs.append(
            (f"control-{seed}", True, control_scenario(90_000 + seed))
        )
    return specs


def evaluate_streaming(
    specs: list,
    config: WatchtowerConfig,
    *,
    nodes: int,
    interval_s: float,
) -> tuple[ScoreAccumulator, dict]:
    """The timed scoring pass: simulate + render + replay + match every
    schedule, nothing cached — the honest schedules/min number."""
    acc = ScoreAccumulator()
    t0 = time.time()
    for tag, is_control, scenario in specs:
        timeline, incidents, _ = run_schedule(
            scenario, nodes=nodes, interval_s=interval_s
        )
        alerts = replay_config(timeline, config)
        acc.add(tag, incidents, alerts, control=is_control)
    wall = time.time() - t0
    timing = {
        "wall_s": round(wall, 2),
        "schedules": len(specs),
        "schedules_per_min": round(len(specs) / wall * 60.0, 1) if wall else None,
    }
    return acc, timing


def _quiet_sim_logs() -> None:
    for name in ("consensus", "network", "faultline", "sim", "store"):
        logging.getLogger(name).setLevel(logging.CRITICAL)


def _load_config(spec: str | None) -> WatchtowerConfig:
    if not spec:
        return WatchtowerConfig()
    if spec.startswith("preset:"):
        return WatchtowerConfig.preset(spec.split(":", 1)[1])
    with open(spec) as f:
        doc = json.load(f)
    return WatchtowerConfig.from_dict(doc.get("config", doc))


def main(argv=None) -> None:
    """The sweep under the ``cpu`` backend; the backend before it is put
    back after it."""
    saved = crypto._BACKEND
    crypto.set_backend("cpu")
    try:
        _sweep(argv)
    finally:
        crypto.set_backend(saved)


def _sweep(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seeds", default="0:500",
                   help="chaos seed range lo:hi (the precision corpus)")
    p.add_argument("--labeled-seeds", type=int, default=30,
                   help="seeds per single-fault class (x4 classes: the "
                   "pinned recall floor)")
    p.add_argument("--controls", type=int, default=50,
                   help="fault-free control schedules (zero-alert gate)")
    p.add_argument("--duration", type=float, default=11.0,
                   help="chaos schedule virtual seconds (fault durations "
                   "scale with it: at 11s chaos faults run 1-4.4s, below "
                   "the pin horizon — chaos is the precision set, the "
                   "single-fault families are the recall floor)")
    p.add_argument("--nodes", type=int, default=4)
    p.add_argument("--interval", type=float, default=0.5,
                   help="bridge emit interval (matches the real default)")
    p.add_argument("--search", action="store_true",
                   help="coordinate-descent threshold search before the "
                   "evaluation passes (else evaluate --config only)")
    p.add_argument("--train-seeds", default="0:120",
                   help="chaos seeds for the search corpus")
    p.add_argument("--train-labeled-seeds", type=int, default=15)
    p.add_argument("--train-controls", type=int, default=20)
    p.add_argument("--config", default=None,
                   help="config to evaluate: JSON file or preset:<name>")
    p.add_argument("--out", default=None, help="scorecard JSON path")
    p.add_argument("--preset-out", default=None,
                   help="write the tuned config as a loadable preset")
    p.add_argument("--gate", action="store_true",
                   help="exit 1 unless the evaluated config reaches "
                   "recall 1.0 on pinned incidents with zero control "
                   "alerts")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    _quiet_sim_logs()

    report: dict = {
        "schema": SWEEP_SCHEMA,
        "generated_by": "hotstuff_tpu_torch.benchmark.detector_sweep",
        "host": host_meta(),
        "detector_catalog": DETECTOR_CATALOG_VERSION,
        "corpus": {
            "nodes": args.nodes,
            "chaos_seeds": args.seeds,
            "chaos_duration_s": args.duration,
            "single_fault_seeds_per_class": args.labeled_seeds,
            "single_fault_classes": list(SINGLE_FAULT_KINDS),
            "controls": args.controls,
            "emit_interval_s": args.interval,
            "pin_min_duration_s": PIN_MIN_DURATION_S,
            "pinned_classes": list(PINNED_CLASSES),
            "match_lead_s": MATCH_LEAD_S,
            "match_slack_s": MATCH_SLACK_S,
        },
    }

    tuned_cfg = _load_config(args.config)
    if args.search:
        log.info("building search corpus (train seeds %s) ...",
                 args.train_seeds)
        train_specs = corpus_specs(
            argparse.Namespace(
                seeds=args.train_seeds,
                labeled_seeds=args.train_labeled_seeds,
                controls=args.train_controls,
                duration=args.duration,
            )
        )
        t0 = time.time()
        train_corpus = []
        for tag, is_control, scenario in train_specs:
            timeline, incidents, _ = run_schedule(
                scenario, nodes=args.nodes, interval_s=args.interval
            )
            train_corpus.append((tag, is_control, timeline, incidents))
        log.info("search corpus: %d schedules in %.1fs",
                 len(train_corpus), time.time() - t0)
        t0 = time.time()
        tuned_cfg, search_meta = coordinate_descent(
            train_corpus, tuned_cfg, progress=log.info
        )
        search_meta["search_wall_s"] = round(time.time() - t0, 1)
        search_meta["train_schedules"] = len(train_corpus)
        report["search"] = search_meta
        log.info("search: %d evaluations in %.0fs",
                 search_meta["evaluations"], search_meta["search_wall_s"])

    specs = corpus_specs(args)
    default_cfg = WatchtowerConfig()

    log.info("evaluating tuned config over %d schedules ...", len(specs))
    tuned_acc, tuned_timing = evaluate_streaming(
        specs, tuned_cfg, nodes=args.nodes, interval_s=args.interval
    )
    log.info("tuned pass: %.1fs (%s schedules/min)",
             tuned_timing["wall_s"], tuned_timing["schedules_per_min"])
    log.info("evaluating default config over %d schedules ...", len(specs))
    default_acc, default_timing = evaluate_streaming(
        specs, default_cfg, nodes=args.nodes, interval_s=args.interval
    )

    report["default"] = {
        "config": dict(default_cfg.__dict__),
        "config_hash": default_cfg.fingerprint(),
        "timing": default_timing,
        **default_acc.report(),
    }
    report["tuned"] = {
        "config": dict(tuned_cfg.__dict__),
        "config_hash": tuned_cfg.fingerprint(),
        "timing": tuned_timing,
        **tuned_acc.report(),
    }
    report["gate"] = {
        "recall_pinned": round(tuned_acc.recall_pinned, 4),
        "control_alerts": tuned_acc.control_alerts,
        "precision_vs_default": [
            round(tuned_acc.precision, 4),
            round(default_acc.precision, 4),
        ],
        "ok": tuned_acc.feasible(),
    }

    if args.preset_out:
        preset = {
            "schema": PRESET_SCHEMA,
            "name": os.path.splitext(os.path.basename(args.preset_out))[0],
            "config": dict(tuned_cfg.__dict__),
            "config_hash": tuned_cfg.fingerprint(),
            "detector_catalog": DETECTOR_CATALOG_VERSION,
            "provenance": {
                "tool": "hotstuff_tpu_torch.benchmark.detector_sweep",
                "corpus": report["corpus"],
                "recall_pinned": round(tuned_acc.recall_pinned, 4),
                "precision": round(tuned_acc.precision, 4),
                "control_alerts": tuned_acc.control_alerts,
            },
        }
        os.makedirs(os.path.dirname(args.preset_out) or ".", exist_ok=True)
        with open(args.preset_out, "w") as f:
            json.dump(preset, f, indent=2, sort_keys=True)
            f.write("\n")
        log.info("tuned preset written to %s", args.preset_out)

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
            f.write("\n")
        log.info("scorecard written to %s", args.out)

    summary = report["gate"]
    log.info(
        "sweep: %d schedules, %d incidents (%d pinned) | tuned: "
        "precision=%.3f recall_pinned=%.3f controls=%d | default: "
        "precision=%.3f recall_pinned=%.3f",
        tuned_acc.schedules, tuned_acc.incidents, tuned_acc.pinned,
        tuned_acc.precision, tuned_acc.recall_pinned,
        tuned_acc.control_alerts, default_acc.precision,
        default_acc.recall_pinned,
    )
    if args.gate and not summary["ok"]:
        log.error("GATE FAIL: recall_pinned=%.4f control_alerts=%d "
                  "(pinned misses: %s)",
                  tuned_acc.recall_pinned, tuned_acc.control_alerts,
                  tuned_acc.pinned_misses[:5])
        sys.exit(1)


if __name__ == "__main__":
    main()
