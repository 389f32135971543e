"""Harness utilities (reference ``benchmark/benchmark/utils.py``):
file-naming conventions, colored printing, progress.

Port copy of the reference's ``benchmark/utils.py``, unchanged: the same
``PathMaker`` names (``results/bench-<faults>-<nodes>-<rate>-<size>.txt``,
``plots/agg-...``), ``Print`` and ``progress_bar``. ``aggregate``, ``plot``,
``fabfile``, ``remote`` and ``instance`` use it.
"""

from __future__ import annotations

import os
import sys
from datetime import datetime


class PathMaker:
    """All benchmark file-naming conventions (reference ``utils.py:57-62``)."""

    @staticmethod
    def results_path() -> str:
        return "results"

    @staticmethod
    def plots_path() -> str:
        return "plots"

    @staticmethod
    def logs_path() -> str:
        return "logs"

    @staticmethod
    def result_file(faults: int, nodes: int, rate: int, tx_size: int) -> str:
        return os.path.join(
            PathMaker.results_path(), f"bench-{faults}-{nodes}-{rate}-{tx_size}.txt"
        )

    @staticmethod
    def agg_file(kind: str, faults, nodes, rate, tx_size) -> str:
        """Aggregated-series file; 'x' marks the swept dimension (e.g. the
        L-graph sweeps rate: ``agg-l-0-4-x-512.txt``)."""
        return os.path.join(
            PathMaker.plots_path(), f"agg-{kind}-{faults}-{nodes}-{rate}-{tx_size}.txt"
        )

    @staticmethod
    def plot_file(name: str, ext: str = "pdf") -> str:
        return os.path.join(PathMaker.plots_path(), f"{name}.{ext}")

    @staticmethod
    def node_log_file(i: int) -> str:
        return os.path.join(PathMaker.logs_path(), f"node-{i}.log")

    @staticmethod
    def client_log_file(i: int) -> str:
        return os.path.join(PathMaker.logs_path(), f"client-{i}.log")


class Print:
    @staticmethod
    def heading(message: str) -> None:
        print(f"\033[1m{message}\033[0m")

    @staticmethod
    def info(message: str) -> None:
        print(message)

    @staticmethod
    def warn(message: str) -> None:
        print(f"\033[93mWARN: {message}\033[0m", file=sys.stderr)

    @staticmethod
    def error(message: str) -> None:
        print(f"\033[91mERROR: {message}\033[0m", file=sys.stderr)


def progress_bar(iterable, prefix: str = "", size: int = 30):
    total = len(iterable)
    for i, item in enumerate(iterable, 1):
        filled = size * i // total
        sys.stdout.write(
            f"\r{prefix}[{'#' * filled}{'.' * (size - filled)}] {i}/{total}"
        )
        sys.stdout.flush()
        yield item
    sys.stdout.write("\n")


def timestamp() -> str:
    return datetime.now().strftime("%Y-%m-%d %H:%M:%S")
