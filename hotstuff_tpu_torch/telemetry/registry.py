"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms.

Hot-path design: every counter/histogram write touches only the calling
thread's private shard (a plain Python list reached through
``threading.local``) — no lock, no cross-thread cache traffic — so the
consensus event loop, the C-extension crypto workers, and the superbatch
flusher thread can all record without contending. Shards are merged only
at SNAPSHOT time (read-side pays, write-side never does). Merged reads
are not a linearizable cut across threads — fine for telemetry, where a
snapshot races in-flight increments by design.

Gauges are last-write-wins scalars (plus ``set_min``/``set_max`` for
watermark timestamps); they carry no shards because a gauge is a single
current value, not an accumulation.

Collectors bridge state that lives OUTSIDE this registry — the C++
engines' internal counters (``hs_net_stats_ex``, ``hs_ed25519_stats``),
the superbatch backend's totals — behind one snapshot call: a collector
is polled once per ``snapshot()`` and its values appear as gauges.

Port copy of ``hotstuff_tpu/telemetry/registry.py``, unchanged.
"""

from __future__ import annotations

import logging
import threading
from bisect import bisect_left

log = logging.getLogger("telemetry")

# Default bucket boundaries (upper-inclusive edges; the implicit last
# bucket is +Inf). Chosen to cover the observed dynamic range of this
# system: sub-ms handler stages up to multi-second view changes, bytes
# from single transactions to the 64 MiB frame cap, occupancies from a
# lone request to a full fused window.
DURATION_MS_BUCKETS = (
    0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500,
    1_000, 2_500, 5_000, 10_000, 30_000,
)
# Fine-grained duration buckets: the crypto plane's per-signature regime
# is 22-26 µs (0.022-0.026 ms) and native-path spans at small committees
# sit under DURATION_MS_BUCKETS' 0.1 ms floor — both collapsed into one
# bucket there. These edges resolve 1 µs .. 1 s; metrics pick their scale
# per name (``Registry.histogram(name, buckets)``).
FINE_DURATION_MS_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 1_000,
)
SIZE_BYTES_BUCKETS = (
    64, 256, 1_024, 4_096, 16_384, 65_536, 262_144, 1_048_576, 16_777_216,
)
COUNT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1_024)

_NAME_OK = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789._-"
)


def _check_name(name: str) -> str:
    if not name or not set(name) <= _NAME_OK:
        raise ValueError(f"bad metric name {name!r}")
    return name


class Counter:
    """Monotonic counter, thread-sharded (see module docstring)."""

    __slots__ = ("name", "_local", "_cells", "_lock")

    def __init__(self, name: str) -> None:
        self.name = _check_name(name)
        self._local = threading.local()
        self._cells: list[list[int]] = []
        self._lock = threading.Lock()

    def _cell(self) -> list[int]:
        cell = getattr(self._local, "cell", None)
        if cell is None:
            cell = [0]
            self._local.cell = cell
            with self._lock:  # registration only: once per thread
                self._cells.append(cell)
        return cell

    def inc(self, n: int = 1) -> None:
        self._cell()[0] += n

    def value(self) -> int:
        with self._lock:
            return sum(cell[0] for cell in self._cells)


class Gauge:
    """Last-write-wins scalar; ``None`` until first set (unset gauges are
    omitted from snapshots)."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str) -> None:
        self.name = _check_name(name)
        self._value: float | None = None

    def set(self, v: float) -> None:
        self._value = v

    def set_min(self, v: float) -> None:
        cur = self._value
        if cur is None or v < cur:
            self._value = v

    def set_max(self, v: float) -> None:
        cur = self._value
        if cur is None or v > cur:
            self._value = v

    def value(self) -> float | None:
        return self._value


class _HistCell:
    __slots__ = ("counts", "sum", "n")

    def __init__(self, n_buckets: int) -> None:
        self.counts = [0] * n_buckets
        self.sum = 0.0
        self.n = 0


class Histogram:
    """Fixed-bucket histogram, thread-sharded. ``buckets`` are the
    upper-inclusive edges; one implicit overflow bucket is appended."""

    __slots__ = ("name", "buckets", "_local", "_cells", "_lock")

    def __init__(self, name: str, buckets=DURATION_MS_BUCKETS) -> None:
        self.name = _check_name(name)
        edges = tuple(float(b) for b in buckets)
        if not edges or list(edges) != sorted(set(edges)):
            raise ValueError(f"histogram buckets must be sorted/unique: {buckets}")
        self.buckets = edges
        self._local = threading.local()
        self._cells: list[_HistCell] = []
        self._lock = threading.Lock()

    def _cell(self) -> _HistCell:
        cell = getattr(self._local, "cell", None)
        if cell is None:
            cell = _HistCell(len(self.buckets) + 1)
            self._local.cell = cell
            with self._lock:
                self._cells.append(cell)
        return cell

    def observe(self, v: float) -> None:
        cell = self._cell()
        # bisect_left: a value equal to an edge lands in that edge's
        # bucket — edges are upper-INCLUSIVE ("le", Prometheus-style).
        cell.counts[bisect_left(self.buckets, v)] += 1
        cell.sum += v
        cell.n += 1

    def merged(self) -> tuple[list[int], float, int]:
        """(bucket counts incl. overflow, value sum, observation count)."""
        counts = [0] * (len(self.buckets) + 1)
        total = 0.0
        n = 0
        with self._lock:
            cells = list(self._cells)
        for cell in cells:
            for i, c in enumerate(cell.counts):
                counts[i] += c
            total += cell.sum
            n += cell.n
        return counts, total, n

    def mean(self) -> float:
        _, total, n = self.merged()
        return total / n if n else 0.0


class Registry:
    """Name -> metric, with collector callbacks polled at snapshot time."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}
        self._collectors: dict[str, object] = {}  # name -> callable

    def _get(self, name: str, factory):
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = self._metrics[name] = factory()
            return metric

    def counter(self, name: str) -> Counter:
        metric = self._get(name, lambda: Counter(name))
        if not isinstance(metric, Counter):
            raise TypeError(f"{name!r} is already a {type(metric).__name__}")
        return metric

    def gauge(self, name: str) -> Gauge:
        metric = self._get(name, lambda: Gauge(name))
        if not isinstance(metric, Gauge):
            raise TypeError(f"{name!r} is already a {type(metric).__name__}")
        return metric

    def histogram(self, name: str, buckets=DURATION_MS_BUCKETS) -> Histogram:
        metric = self._get(name, lambda: Histogram(name, buckets))
        if not isinstance(metric, Histogram):
            raise TypeError(f"{name!r} is already a {type(metric).__name__}")
        return metric

    def register_collector(self, name: str, fn) -> None:
        """``fn() -> dict[str, number]``: polled once per snapshot, values
        merged into the gauge section under their own names. Re-registering
        ``name`` replaces the previous collector (process-wide singletons
        re-created across test event loops must not accumulate)."""
        with self._lock:
            self._collectors[name] = fn

    def snapshot(self) -> dict:
        """Plain-data view of every metric (JSON-serializable)."""
        with self._lock:
            metrics = dict(self._metrics)
            collectors = dict(self._collectors)
        counters: dict[str, int] = {}
        gauges: dict[str, float] = {}
        histograms: dict[str, dict] = {}
        for name, metric in sorted(metrics.items()):
            if isinstance(metric, Counter):
                counters[name] = metric.value()
            elif isinstance(metric, Gauge):
                v = metric.value()
                if v is not None:
                    gauges[name] = v
            else:
                counts, total, n = metric.merged()
                histograms[name] = {
                    "le": list(metric.buckets),
                    "counts": counts,
                    "sum": total,
                    "count": n,
                }
        for cname, fn in sorted(collectors.items()):
            try:
                for k, v in fn().items():
                    gauges[f"{cname}.{k}"] = v
            except Exception as e:  # noqa: BLE001 — telemetry must not kill
                log.warning("telemetry collector %s failed: %s", cname, e)
        return {"counters": counters, "gauges": gauges, "histograms": histograms}

    def reset(self) -> None:
        """Drop every metric and collector (tests)."""
        with self._lock:
            self._metrics.clear()
            self._collectors.clear()


def diff_counters(before: dict, after: dict) -> dict[str, int]:
    """Per-name deltas of two ``snapshot()['counters']`` maps (new names
    count from zero) — the measured-window primitive benchmarks use."""
    return {
        name: value - before.get(name, 0)
        for name, value in after.items()
        if value != before.get(name, 0)
    }
