"""Aggregate benchmark result files into plot-ready series (reference
``benchmark/benchmark/aggregate.py``).

Result ``.txt`` files contain one or more SUMMARY blocks (repeated runs of
the same setup are appended to the same file); aggregation computes
mean ± stdev over the runs and emits series:

- latency-vs-rate (L-graph) per (faults, nodes, tx_size)
- tps-vs-nodes (scalability) per (faults, rate, tx_size)

Port copy of the reference's ``benchmark/aggregate.py``, unchanged but for
its import of the port's ``utils.PathMaker``: the same SUMMARY parsing, the
same series and the same ``agg-l-*.txt`` files from the same result files
(``bench-*.txt``, as ``run_local`` and ``local`` write them). The port's
``plot.Ploter`` draws these series.
"""

from __future__ import annotations

import glob
import os
from collections import defaultdict
from dataclasses import dataclass, field
from re import search
from statistics import mean, stdev

from .utils import PathMaker


@dataclass(frozen=True)
class Setup:
    faults: int
    nodes: int
    rate: int
    tx_size: int

    @classmethod
    def from_block(cls, raw: str) -> "Setup":
        return cls(
            faults=int(search(r"Faults: (\d+)", raw).group(1)),
            nodes=int(search(r"Committee size: (\d+)", raw).group(1)),
            rate=int(search(r"Input rate: ([\d,]+)", raw).group(1).replace(",", "")),
            tx_size=int(
                search(r"Transaction size: ([\d,]+)", raw).group(1).replace(",", "")
            ),
        )


@dataclass
class Measurement:
    tps: list[int] = field(default_factory=list)
    latency: list[int] = field(default_factory=list)

    def add(self, raw: str) -> None:
        self.tps.append(
            int(search(r"End-to-end TPS: ([\d,]+)", raw).group(1).replace(",", ""))
        )
        self.latency.append(
            int(
                search(r"End-to-end latency: ([\d,]+)", raw).group(1).replace(",", "")
            )
        )

    def mean_tps(self) -> float:
        return mean(self.tps) if self.tps else 0

    def std_tps(self) -> float:
        return stdev(self.tps) if len(self.tps) > 1 else 0

    def mean_latency(self) -> float:
        return mean(self.latency) if self.latency else 0

    def std_latency(self) -> float:
        return stdev(self.latency) if len(self.latency) > 1 else 0


class LogAggregator:
    def __init__(self, results_dir: str | None = None) -> None:
        self.data: dict[Setup, Measurement] = defaultdict(Measurement)
        directory = results_dir or PathMaker.results_path()
        for fn in sorted(glob.glob(os.path.join(directory, "bench-*.txt"))):
            with open(fn) as f:
                raw = f.read()
            # One SUMMARY block per run; repeated runs append to the file.
            for block in raw.split(" SUMMARY:")[1:]:
                setup = Setup.from_block(block)
                self.data[setup].add(block)

    def latency_vs_rate(self, faults: int, nodes: int, tx_size: int):
        """[(rate, mean_tps, std_tps, mean_latency, std_latency)] sorted by
        input rate — the L-graph series."""
        rows = [
            (s.rate, m.mean_tps(), m.std_tps(), m.mean_latency(), m.std_latency())
            for s, m in self.data.items()
            if s.faults == faults and s.nodes == nodes and s.tx_size == tx_size
        ]
        return sorted(rows)

    def tps_vs_nodes(self, faults: int, tx_size: int, max_latency: float | None = None):
        """Best achievable TPS per committee size (optionally under a
        latency cap) — the scalability series."""
        best: dict[int, tuple] = {}
        for s, m in self.data.items():
            if s.faults != faults or s.tx_size != tx_size:
                continue
            if max_latency is not None and m.mean_latency() > max_latency:
                continue
            cur = best.get(s.nodes)
            if cur is None or m.mean_tps() > cur[1]:
                best[s.nodes] = (s.nodes, m.mean_tps(), m.std_tps())
        return sorted(best.values())

    def print_series(self, out_dir: str | None = None) -> list[str]:
        """Write agg files per setup family; returns the paths."""
        out_dir = out_dir or PathMaker.plots_path()
        os.makedirs(out_dir, exist_ok=True)
        written = []
        families = {(s.faults, s.nodes, s.tx_size) for s in self.data}
        for faults, nodes, tx_size in sorted(families):
            path = os.path.join(
                out_dir,
                os.path.basename(PathMaker.agg_file("l", faults, nodes, "x", tx_size)),
            )
            with open(path, "w") as f:
                f.write("rate tps tps_std latency latency_std\n")
                for row in self.latency_vs_rate(faults, nodes, tx_size):
                    f.write(" ".join(str(round(x)) for x in row) + "\n")
            written.append(path)
        return written
