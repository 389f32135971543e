"""Plot aggregated benchmark series (reference
``benchmark/benchmark/plot.py``): matplotlib errorbar L-graphs
(latency vs throughput) with a tx/s <-> MB/s twin axis, and scalability
plots (best TPS vs committee size).

Port copy of the reference's ``benchmark/plot.py``, unchanged: ``Ploter``
over the port's ``LogAggregator``, with the reference's figures, axes,
labels and file names (``plots/latency-<size>.pdf``,
``plots/tps-<size>.pdf``); from the same result files it writes the same
bytes as the reference's under one matplotlib and a fixed
``SOURCE_DATE_EPOCH``. It needs matplotlib, which nothing else of the port
needs, and reaches no card.
"""

from __future__ import annotations

import os

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import matplotlib.ticker as ticker  # noqa: E402

from .aggregate import LogAggregator
from .utils import PathMaker


class Ploter:
    def __init__(self, results_dir: str | None = None) -> None:
        self.agg = LogAggregator(results_dir)

    @staticmethod
    def _tx_to_mb(rate: float, tx_size: int) -> float:
        return rate * tx_size / 1e6

    def plot_latency(
        self, faults: list[int], nodes: list[int], tx_size: int, out: str | None = None
    ) -> str:
        """Latency vs throughput, one curve per (faults, committee size)."""
        fig, ax = plt.subplots(figsize=(6.4, 3.6))
        for f in faults:
            for n in nodes:
                rows = self.agg.latency_vs_rate(f, n, tx_size)
                if not rows:
                    continue
                xs = [r[1] for r in rows]  # achieved tps
                ys = [r[3] for r in rows]
                yerr = [r[4] for r in rows]
                label = f"{n} nodes" + (f" ({f} faulty)" if f else "")
                ax.errorbar(xs, ys, yerr=yerr, marker="o", capsize=3, label=label)
        ax.set_xlabel("Throughput (tx/s)")
        ax.set_ylabel("Latency (ms)")
        ax.xaxis.set_major_formatter(ticker.StrMethodFormatter("{x:,.0f}"))
        ax.legend(loc="upper left", fontsize=8)

        # Twin axis in MB/s (reference ``plot.py:56-88``).
        sec = ax.secondary_xaxis(
            "top",
            functions=(
                lambda x: x * tx_size / 1e6,
                lambda x: x * 1e6 / tx_size,
            ),
        )
        sec.set_xlabel("Throughput (MB/s)")
        out = out or PathMaker.plot_file(f"latency-{tx_size}")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        fig.tight_layout()
        fig.savefig(out)
        plt.close(fig)
        return out

    def plot_tps(
        self,
        faults: list[int],
        tx_size: int,
        max_latency: float | None = None,
        out: str | None = None,
    ) -> str:
        """Best TPS vs committee size (scalability)."""
        fig, ax = plt.subplots(figsize=(6.4, 3.6))
        for f in faults:
            rows = self.agg.tps_vs_nodes(f, tx_size, max_latency)
            if not rows:
                continue
            xs = [r[0] for r in rows]
            ys = [r[1] for r in rows]
            yerr = [r[2] for r in rows]
            label = f"{f} faulty" if f else "no faults"
            ax.errorbar(xs, ys, yerr=yerr, marker="s", capsize=3, label=label)
        ax.set_xlabel("Committee size")
        ax.set_ylabel("Throughput (tx/s)")
        ax.yaxis.set_major_formatter(ticker.StrMethodFormatter("{x:,.0f}"))
        ax.legend(loc="upper right", fontsize=8)
        out = out or PathMaker.plot_file(f"tps-{tx_size}")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        fig.tight_layout()
        fig.savefig(out)
        plt.close(fig)
        return out
