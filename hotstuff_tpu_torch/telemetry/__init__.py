"""Unified telemetry plane: metrics registry, round-trace spans, and
JSON-lines snapshot emission.

Every plane of the system records here — consensus core/synchronizer,
mempool, network (asyncio and the C++ engine via its stats collector),
crypto superbatching and the native ed25519 engine — and one
``snapshot()`` (or a running ``TelemetryEmitter``) serializes the whole
process's state. ``benchmark/logs.py`` reads the emitted streams;
``docs/telemetry.md`` is the metric catalog.

Enablement: telemetry is OFF by default; recording sites then go through
shared no-op metric objects (one attribute call, no state) so the
disabled cost is a cheap method dispatch on already-hot paths and zero
memory. Enable explicitly with ``telemetry.enable()`` BEFORE spawning
actors (they capture their metric objects at construction), or via the
environment:

- ``HOTSTUFF_TELEMETRY_DIR=<dir>``: enable + each node process writes
  ``<dir>/telemetry-<node>.jsonl`` (the local-bench layout).
- ``HOTSTUFF_TELEMETRY=<file>``: enable + write snapshots to one file.
- ``HOTSTUFF_TELEMETRY_INTERVAL=<seconds>``: snapshot period (default 5).

The benchmark-interface tables (``record_created`` / ``record_sealed`` /
``record_commit``) mirror the regex measurement contract of
``benchmark/logs.py`` at the exact code sites that emit the regex-scraped
log lines, so the telemetry stream and the log scrape measure the same
events. Sharing one process-wide table across in-process testbed nodes
reproduces the parser's cross-node merge (earliest proposal, first
commit wins) automatically.

Port copy of ``hotstuff_tpu/telemetry/__init__.py``: the same schema
strings, environment switches, metric names and no-op objects, so the
reference harness's readers (``benchmark/logs.py``'s ``TelemetryParser``,
the ``validate`` CLI of either package) read the port's streams, and the
watchtower's re-exports (``ALERT_SCHEMA``, ``AlertCapture``,
``Watchtower``, ``WatchtowerConfig``, ``validate_alert_record``).
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict

from .emitter import (
    DEFAULT_INTERVAL_S,
    META_SCHEMA,
    SCHEMA,
    TelemetryEmitter,
    arm_shutdown_flush,
    build_meta_record,
    build_snapshot,
    validate_meta_record,
    validate_snapshot,
)
from .profiler import (
    PROFILE_SCHEMA,
    SamplingProfiler,
    validate_profile_record,
)
from .registry import (
    COUNT_BUCKETS,
    DURATION_MS_BUCKETS,
    FINE_DURATION_MS_BUCKETS,
    SIZE_BYTES_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    Registry,
    diff_counters,
)
from .dtrace import (
    DTRACE_SCHEMA,
    build_dtrace_record,
    intern_label,
    validate_dtrace_record,
)
from .spans import RoundTrace
from .trace import (
    FLIGHT_SCHEMA,
    TRACE_SCHEMA,
    TraceBuffer,
    build_trace_record,
    dump_flight_record,
    validate_trace_record,
)
from .watchtower import (
    ALERT_SCHEMA,
    AlertCapture,
    Watchtower,
    WatchtowerConfig,
    validate_alert_record,
)

__all__ = [
    "COUNT_BUCKETS",
    "DURATION_MS_BUCKETS",
    "FINE_DURATION_MS_BUCKETS",
    "SIZE_BYTES_BUCKETS",
    "SCHEMA",
    "META_SCHEMA",
    "TRACE_SCHEMA",
    "DTRACE_SCHEMA",
    "FLIGHT_SCHEMA",
    "PROFILE_SCHEMA",
    "ALERT_SCHEMA",
    "AlertCapture",
    "Watchtower",
    "WatchtowerConfig",
    "validate_alert_record",
    "build_meta_record",
    "validate_meta_record",
    "SamplingProfiler",
    "validate_profile_record",
    "DEFAULT_INTERVAL_S",
    "Counter",
    "Gauge",
    "Histogram",
    "NULL_COUNTER",
    "NULL_GAUGE",
    "NULL_HISTOGRAM",
    "Registry",
    "RoundTrace",
    "TelemetryEmitter",
    "TraceBuffer",
    "arm_shutdown_flush",
    "build_snapshot",
    "build_trace_record",
    "build_dtrace_record",
    "intern_label",
    "validate_snapshot",
    "validate_trace_record",
    "validate_dtrace_record",
    "diff_counters",
    "dump_flight_record",
    "counter",
    "gauge",
    "histogram",
    "get_registry",
    "register_collector",
    "enable",
    "disable",
    "enabled",
    "env_interval_s",
    "env_stream_path",
    "env_flight_path",
    "record_created",
    "record_sealed",
    "record_commit",
    "round_trace",
    "trace_buffer",
    "trace_event",
    "dtrace_buffer",
    "dtrace_enabled",
    "dtrace_event",
    "set_dtrace_detached",
    "reset_for_tests",
]

_REGISTRY = Registry()
_TRACE_BUFFER = TraceBuffer()
_DTRACE_BUFFER = TraceBuffer()
_ENABLED = bool(
    os.environ.get("HOTSTUFF_TELEMETRY") or os.environ.get("HOTSTUFF_TELEMETRY_DIR")
)
# ``HOTSTUFF_DTRACE=0`` detaches ONLY the batch-lifecycle plane while the
# rest of telemetry stays armed — the CI overhead gate's control leg.
_DTRACE_DETACHED = os.environ.get("HOTSTUFF_DTRACE", "") == "0"


class _NullCounter:
    __slots__ = ()

    def inc(self, n: int = 1) -> None:
        pass

    def value(self) -> int:
        return 0


class _NullGauge:
    __slots__ = ()

    def set(self, v: float) -> None:
        pass

    set_min = set_max = set

    def value(self):
        return None


class _NullHistogram:
    __slots__ = ()

    def observe(self, v: float) -> None:
        pass

    def merged(self):
        return [], 0.0, 0

    def mean(self) -> float:
        return 0.0


# Public no-op singletons: what counter()/gauge()/histogram() return when
# disabled, and safe class-level defaults for state-only instances (tests
# construct actors via __new__ without running __init__).
NULL_COUNTER = _NullCounter()
NULL_GAUGE = _NullGauge()
NULL_HISTOGRAM = _NullHistogram()
_NULL_COUNTER = NULL_COUNTER
_NULL_GAUGE = NULL_GAUGE
_NULL_HISTOGRAM = NULL_HISTOGRAM


def enable() -> Registry:
    """Turn recording on (idempotent). Call BEFORE spawning actors: they
    capture their metric objects at construction time."""
    global _ENABLED
    _ENABLED = True
    return _REGISTRY


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def enabled() -> bool:
    return _ENABLED


def get_registry() -> Registry:
    """The process registry (live even when recording is disabled, so
    benchmarks can enable/diff around a measurement window)."""
    return _REGISTRY


def counter(name: str):
    return _REGISTRY.counter(name) if _ENABLED else _NULL_COUNTER


def gauge(name: str):
    return _REGISTRY.gauge(name) if _ENABLED else _NULL_GAUGE


def histogram(name: str, buckets=DURATION_MS_BUCKETS):
    return _REGISTRY.histogram(name, buckets) if _ENABLED else _NULL_HISTOGRAM


def register_collector(name: str, fn) -> None:
    """Register unconditionally (registration is one-time and cheap);
    collectors only run when something snapshots the registry."""
    _REGISTRY.register_collector(name, fn)


def env_interval_s() -> float:
    try:
        return float(os.environ.get("HOTSTUFF_TELEMETRY_INTERVAL", ""))
    except ValueError:
        return DEFAULT_INTERVAL_S


def env_stream_path(node: str = "") -> str | None:
    """Where this process should stream snapshots per the environment, or
    None when no stream is configured (metrics may still be enabled
    programmatically for in-process snapshots)."""
    path = os.environ.get("HOTSTUFF_TELEMETRY")
    if path:
        return path
    directory = os.environ.get("HOTSTUFF_TELEMETRY_DIR")
    if directory:
        safe = "".join(c if c.isalnum() else "-" for c in node) or str(os.getpid())
        return os.path.join(directory, f"telemetry-{safe}.jsonl")
    return None


def env_flight_path(node: str = "") -> str | None:
    """Where this process should dump flight records: HOTSTUFF_FLIGHT_DIR
    explicitly, else next to the telemetry stream when one is configured,
    else None (flight recording stays in-memory only)."""
    safe = "".join(c if c.isalnum() else "-" for c in node) or str(os.getpid())
    directory = os.environ.get("HOTSTUFF_FLIGHT_DIR")
    if not directory:
        stream = env_stream_path(node)
        if stream is None:
            return None
        directory = os.path.dirname(os.path.abspath(stream))
    return os.path.join(directory, f"flightrec-{safe}.json")


# ---------------------------------------------------------------------------
# Benchmark-interface tables (the regex contract, telemetry-side).
#
# ``benchmark/logs.py`` measures from three log families: "Created B -> d"
# (proposer, per payload digest), "Batch d contains N B" (batch creator),
# "Committed B -> d" (every node). The same code sites call the three
# recorders below. Cross-site joins happen here: a commit pops the
# digest's proposal timestamp (commit latency) and its sealed size
# (committed bytes) exactly once — the pop IS the parser's
# earliest-commit-wins merge when testbed nodes share this process.
# ---------------------------------------------------------------------------

_TABLE_CAP = 16_384
_tables_lock = threading.Lock()
_proposed: OrderedDict[bytes, float] = OrderedDict()
_sealed: OrderedDict[bytes, int] = OrderedDict()


def _bounded_put(table: OrderedDict, key: bytes, value) -> None:
    if len(table) >= _TABLE_CAP:
        table.popitem(last=False)
    table[key] = value


def record_created(digest: bytes, ts: float | None = None) -> None:
    """A proposer put batch ``digest`` into a block (one call per payload
    digest, at the "Created B -> d" log site)."""
    if not _ENABLED:
        return
    ts = time.time() if ts is None else ts
    with _tables_lock:
        _bounded_put(_proposed, digest, ts)
    _REGISTRY.counter("consensus.batches_proposed").inc()
    _REGISTRY.gauge("consensus.first_proposal_ts").set_min(ts)


def record_sealed(digest: bytes, nbytes: int) -> None:
    """The mempool sealed a batch (the "Batch d contains N B" log site)."""
    if not _ENABLED:
        return
    with _tables_lock:
        _bounded_put(_sealed, digest, nbytes)
    _REGISTRY.counter("mempool.batches_sealed").inc()
    _REGISTRY.counter("mempool.sealed_bytes").inc(nbytes)
    _REGISTRY.histogram("mempool.batch_bytes", SIZE_BYTES_BUCKETS).observe(nbytes)


def record_commit(digest: bytes, ts: float | None = None) -> None:
    """A node committed a block containing batch ``digest`` (the
    "Committed B -> d" log site; every node calls this for every
    committed payload digest)."""
    if not _ENABLED:
        return
    ts = time.time() if ts is None else ts
    with _tables_lock:
        created = _proposed.pop(digest, None)
        size = _sealed.pop(digest, None)
    _REGISTRY.counter("consensus.commit_events").inc()
    if created is not None or size is not None:
        # Only the digest's FIRST newsworthy commit moves the window end —
        # the pop semantics give exactly the regex parser's
        # earliest-commit-wins merge when testbed nodes share a process.
        _REGISTRY.gauge("consensus.last_commit_ts").set_max(ts)
    if created is not None:
        _REGISTRY.counter("consensus.batches_committed").inc()
        _REGISTRY.histogram(
            "consensus.commit_latency_ms", DURATION_MS_BUCKETS
        ).observe((ts - created) * 1e3)
    if size is not None:
        _REGISTRY.counter("consensus.committed_bytes").inc(size)


def round_trace(node: str = "") -> RoundTrace | None:
    """A RoundTrace bound to the process registry and the process trace
    buffer, or None when disabled (cores hold the None and skip marking
    entirely). ``node`` labels this core's events in the cross-node
    trace stream — in-process committees share one buffer, so the label
    is what keeps each engine's timeline separable."""
    if not _ENABLED:
        return None
    return RoundTrace(_REGISTRY, node=node, events=_TRACE_BUFFER)


def trace_buffer() -> TraceBuffer:
    """The process trace ring (live even when disabled, so emitters and
    the flight recorder can be wired up before/without enablement)."""
    return _TRACE_BUFFER


def trace_event(
    node: str, round_: int, stage: str, detail: str | None = None
) -> None:
    """Record one protocol trace event into the process ring (no-op when
    telemetry is disabled). For sites without a RoundTrace — the
    proposer's broadcast mark, faultline injections."""
    if _ENABLED:
        _TRACE_BUFFER.record(node, round_, stage, detail=detail)


def dtrace_buffer() -> TraceBuffer:
    """The process batch-lifecycle ring (live even when disabled, so the
    emitter can be wired up before/without enablement)."""
    return _DTRACE_BUFFER


def dtrace_enabled() -> bool:
    """Whether the batch-lifecycle plane records: telemetry must be on
    AND ``HOTSTUFF_DTRACE=0`` must not have detached it. Instrumentation
    sites gate label interning on this, so a detached run pays nothing
    dtrace-specific."""
    return _ENABLED and not _DTRACE_DETACHED


def set_dtrace_detached(detached: bool) -> None:
    """Runtime override of the ``HOTSTUFF_DTRACE=0`` detach switch.
    This is the overhead smoke's paired-measurement hook (it alternates
    the lifeline plane per batch inside one process); production code
    configures the plane via the environment instead.
    ``reset_for_tests`` recomputes the flag from the environment."""
    global _DTRACE_DETACHED
    _DTRACE_DETACHED = detached


def dtrace_event(
    node: str, digest, stage: str,
    t: float | None = None, detail: str | None = None,
) -> None:
    """Record one batch-lifecycle event into the dtrace ring (no-op when
    telemetry is disabled or the dtrace plane is detached). ``digest`` is
    the batch digest's raw bytes (interned to the shared ``base64[:16]``
    label) or an already-interned label string. ``t`` overrides the
    timestamp — the seal site back-dates the ``ingress`` event to the
    bundle's recorded arrival instant."""
    if _ENABLED and not _DTRACE_DETACHED:
        label = digest if isinstance(digest, str) else intern_label(digest)
        _DTRACE_BUFFER.record(node, label, stage, t=t, detail=detail)


def reset_for_tests() -> None:
    """Clear registry, tables, trace ring, and enablement (isolation)."""
    global _ENABLED, _DTRACE_DETACHED
    from . import dtrace as _dtrace, profiler as _profiler, resources as _resources
    from . import stages as _stages

    _profiler.reset_for_tests()
    _resources.reset_for_tests()
    _dtrace.reset_for_tests()
    _stages.reset_for_tests()
    _REGISTRY.reset()
    _TRACE_BUFFER.clear()
    _DTRACE_BUFFER.clear()
    with _tables_lock:
        _proposed.clear()
        _sealed.clear()
    _ENABLED = bool(
        os.environ.get("HOTSTUFF_TELEMETRY")
        or os.environ.get("HOTSTUFF_TELEMETRY_DIR")
    )
    _DTRACE_DETACHED = os.environ.get("HOTSTUFF_DTRACE", "") == "0"
