"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration is the ``file`` of its ``configs`` entry, its traffic mix is
``traffic/<traffic>.json``, the part of the program it drives is
``entries/<entry>.py`` for the traffic file's ``"entry"`` (``proposal``
where it names none), and each metric is read by ``metrics/<name>.py``.
A cell whose entry exists is added with data files: a configuration, a
traffic file and their entries in ``BENCHMARK.json``. A new entry, mix or
metric is added as new files and entries; none of them edits a file that
is there."""

from __future__ import annotations

import importlib
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]  # the metric entries this cell reports, trace 0
    per_layer: list[dict]  # and with trace 1


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r}; there are {sorted(work)}")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    with open(root / "perfbench" / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    layer = [m for m in bench["per_layer"] if _applies(m, name)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, layer)


def reader(metric: str):
    """The ``read(run)`` of ``metrics/<metric>.py``."""
    return importlib.import_module(f"perfbench.metrics.{metric}").read
