"""Port copy of the reference's ``benchmark/logs.py``, whole: ``LogParser``,
``TelemetryParser``, ``ParseError``, ``StreamFollower``,
``read_stream_records``, ``read_telemetry_stream`` and ``_to_posix``. The
schemas and validators come from the port's ``hotstuff_tpu_torch.telemetry``,
which writes the same records. Nothing is left out.

Log parser — the measurement system (reference
``benchmark/benchmark/logs.py``).

Scrapes client + node logs with the same regex contract as the reference
harness (our nodes emit the identical line formats):

- consensus TPS/BPS: committed batch bytes over [first proposal, last commit]
- consensus latency: commit_ts - proposal_ts per batch digest
- e2e TPS: committed batch bytes over [client start, last commit]
- e2e latency: commit_ts - client_send_ts per sample transaction

Multi-node timestamps are merged keeping the earliest (``logs.py:64-71``);
the parser doubles as the correctness oracle: tracebacks/errors in any log
raise ParseError (``logs.py:74-75,91-92``).

``TelemetryParser`` is the regex path's structured sibling: it reads the
JSON-lines snapshot streams nodes emit when telemetry is enabled
(``HOTSTUFF_TELEMETRY_DIR``, see ``hotstuff_tpu_torch/telemetry``) and computes
the consensus TPS/latency measurements from the registry's counters and
histograms instead of scraping log lines. The telemetry recorders run at
the exact code sites that emit the regex-scraped lines, so both paths
measure the same events; small deltas remain (telemetry credits a batch
at its proposer's/creator's local observations when nodes run in
separate processes, while the regex path merges earliest-across-nodes) —
see docs/telemetry.md.
"""

from __future__ import annotations

import glob
import json
import math
import os
from datetime import datetime
from re import findall, search
from statistics import mean

from hotstuff_tpu_torch.telemetry import (
    ALERT_SCHEMA,
    DTRACE_SCHEMA,
    META_SCHEMA,
    PROFILE_SCHEMA,
    SCHEMA as SNAPSHOT_SCHEMA,
    TRACE_SCHEMA,
    validate_alert_record,
    validate_dtrace_record,
    validate_meta_record,
    validate_profile_record,
    validate_snapshot,
    validate_trace_record,
)


class ParseError(Exception):
    pass


def _to_posix(ts: str) -> float:
    return datetime.fromisoformat(ts.replace("Z", "+00:00")).timestamp()


def _merge_earliest(dicts) -> dict:
    merged: dict = {}
    for d in dicts:
        for k, v in d.items():
            if k not in merged or merged[k] > v:
                merged[k] = v
    return merged


class LogParser:
    def __init__(self, clients: list[str], nodes: list[str], faults: int = 0) -> None:
        if not clients or not nodes:
            raise ParseError("missing client or node logs")
        self.faults = faults
        self.committee_size = len(nodes) + faults

        results = [self._parse_client(log) for log in clients]
        (
            self.sizes_cfg,
            self.rate,
            self.start,
            misses,
            self.sent_samples,
            sheds,
        ) = zip(*results)
        self.misses = sum(misses)
        self.sheds = sum(sheds)

        results = [self._parse_node(log) for log in nodes]
        proposals, commits, sizes, received, timeouts, self.configs = zip(*results)
        self.proposals = _merge_earliest(proposals)
        self.commits = _merge_earliest(commits)
        self.batch_sizes = {
            k: v for x in sizes for k, v in x.items() if k in self.commits
        }
        self.received_samples = received
        self.timeouts = max(timeouts)

        if self.misses:
            print(f"WARN: clients missed their target rate {self.misses:,} time(s)")
        if self.timeouts > 2:
            print(f"WARN: nodes timed out {self.timeouts:,} time(s)")

    def _parse_client(self, log: str):
        if search(r"Traceback|ERROR", log) is not None:
            raise ParseError("client(s) panicked")
        size = int(search(r"Transactions size: (\d+)", log).group(1))
        rate = int(search(r"Transactions rate: (\d+)", log).group(1))
        start = _to_posix(search(r"\[(.*Z) .* Start ", log).group(1))
        misses = len(findall(r"rate too high", log))
        samples = {
            int(s): _to_posix(t)
            for t, s in findall(r"\[(.*Z) .* sample transaction (\d+)", log)
        }
        # Cumulative counter: the last line per client is its total.
        shed_lines = findall(r"Shed notifications: (\d+)", log)
        sheds = int(shed_lines[-1]) if shed_lines else 0
        return size, rate, start, misses, samples, sheds

    def _parse_node(self, log: str):
        if search(r"Traceback|panic", log) is not None:
            raise ParseError("node(s) panicked")

        proposals = _merge_earliest(
            [
                {d: _to_posix(t)}
                for t, d in findall(r"\[(.*Z) .* Created B\d+ -> ([^ ]+=)", log)
            ]
        )
        commits = _merge_earliest(
            [
                {d: _to_posix(t)}
                for t, d in findall(r"\[(.*Z) .* Committed B\d+ -> ([^ ]+=)", log)
            ]
        )
        sizes = {
            d: int(s) for d, s in findall(r"Batch ([^ ]+) contains (\d+) B", log)
        }
        samples = {
            int(s): d
            for d, s in findall(r"Batch ([^ ]+) contains sample tx (\d+)", log)
        }
        timeouts = len(findall(r".* WARN .* Timeout", log))

        configs = {
            "consensus": {
                "timeout_delay": int(search(r"Timeout delay .* (\d+)", log).group(1)),
                "sync_retry_delay": int(
                    search(r"consensus.* Sync retry delay .* (\d+)", log).group(1)
                ),
            },
            "mempool": {
                "gc_depth": int(search(r"Garbage collection .* (\d+)", log).group(1)),
                "sync_retry_delay": int(
                    search(r"mempool.* Sync retry delay .* (\d+)", log).group(1)
                ),
                "sync_retry_nodes": int(
                    search(r"Sync retry nodes .* (\d+)", log).group(1)
                ),
                "batch_size": int(search(r"Batch size .* (\d+)", log).group(1)),
                "max_batch_delay": int(
                    search(r"Max batch delay .* (\d+)", log).group(1)
                ),
            },
        }
        return proposals, commits, sizes, samples, timeouts, configs

    # -- measurements -------------------------------------------------------

    def _consensus_throughput(self):
        if not self.commits:
            return 0, 0, 0
        start, end = min(self.proposals.values()), max(self.commits.values())
        duration = end - start
        nbytes = sum(self.batch_sizes.values())
        bps = nbytes / duration if duration else 0
        tps = bps / self.sizes_cfg[0]
        return tps, bps, duration

    def _consensus_latency(self):
        lat = [c - self.proposals[d] for d, c in self.commits.items() if d in self.proposals]
        return mean(lat) if lat else 0

    def _end_to_end_throughput(self):
        if not self.commits:
            return 0, 0, 0
        start, end = min(self.start), max(self.commits.values())
        duration = end - start
        nbytes = sum(self.batch_sizes.values())
        bps = nbytes / duration if duration else 0
        tps = bps / self.sizes_cfg[0]
        return tps, bps, duration

    def _e2e_latency_samples(self) -> list[float]:
        lat = []
        for sent, received in zip(self.sent_samples, self.received_samples):
            for tx_id, batch_id in received.items():
                if batch_id in self.commits and tx_id in sent:
                    lat.append(self.commits[batch_id] - sent[tx_id])
        return lat

    def _end_to_end_latency(self):
        lat = self._e2e_latency_samples()
        return mean(lat) if lat else 0

    def e2e_latency_tail(self, q: float) -> float:
        """Order-statistic percentile (q in (0,1]) of sample-tx e2e
        latency in seconds. With one sample per 50 ms burst a p99.9
        needs a multi-minute run to be meaningful; shorter runs degrade
        toward the max, which is still the honest tail bound."""
        lat = sorted(self._e2e_latency_samples())
        if not lat:
            return 0.0
        return lat[max(0, math.ceil(q * len(lat)) - 1)]

    def result(self) -> str:
        consensus_latency = self._consensus_latency() * 1000
        consensus_tps, consensus_bps, _ = self._consensus_throughput()
        e2e_tps, e2e_bps, duration = self._end_to_end_throughput()
        e2e_latency = self._end_to_end_latency() * 1000
        cfg_c = self.configs[0]["consensus"]
        cfg_m = self.configs[0]["mempool"]
        return (
            "\n"
            "-----------------------------------------\n"
            " SUMMARY:\n"
            "-----------------------------------------\n"
            " + CONFIG:\n"
            f" Faults: {self.faults} nodes\n"
            f" Committee size: {self.committee_size} nodes\n"
            f" Input rate: {sum(self.rate):,} tx/s\n"
            f" Transaction size: {self.sizes_cfg[0]:,} B\n"
            f" Execution time: {round(duration):,} s\n"
            "\n"
            f" Consensus timeout delay: {cfg_c['timeout_delay']:,} ms\n"
            f" Consensus sync retry delay: {cfg_c['sync_retry_delay']:,} ms\n"
            f" Mempool GC depth: {cfg_m['gc_depth']:,} rounds\n"
            f" Mempool sync retry delay: {cfg_m['sync_retry_delay']:,} ms\n"
            f" Mempool sync retry nodes: {cfg_m['sync_retry_nodes']:,} nodes\n"
            f" Mempool batch size: {cfg_m['batch_size']:,} B\n"
            f" Mempool max batch delay: {cfg_m['max_batch_delay']:,} ms\n"
            "\n"
            " + RESULTS:\n"
            f" Consensus TPS: {round(consensus_tps):,} tx/s\n"
            f" Consensus BPS: {round(consensus_bps):,} B/s\n"
            f" Consensus latency: {round(consensus_latency):,} ms\n"
            "\n"
            f" End-to-end TPS: {round(e2e_tps):,} tx/s\n"
            f" End-to-end BPS: {round(e2e_bps):,} B/s\n"
            f" End-to-end latency: {round(e2e_latency):,} ms\n"
            f" End-to-end latency p99: "
            f"{round(self.e2e_latency_tail(0.99) * 1000):,} ms\n"
            f" End-to-end latency p99.9: "
            f"{round(self.e2e_latency_tail(0.999) * 1000):,} ms\n"
            f" Shed notifications: {self.sheds:,}\n"
            "-----------------------------------------\n"
        )

    def print_to(self, filename: str) -> None:
        with open(filename, "a") as f:
            f.write(self.result())

    @classmethod
    def process(cls, directory: str, faults: int = 0) -> "LogParser":
        clients, nodes = [], []
        for fn in sorted(glob.glob(os.path.join(directory, "client-*.log"))):
            with open(fn) as f:
                clients.append(f.read())
        for fn in sorted(glob.glob(os.path.join(directory, "node-*.log"))):
            with open(fn) as f:
                nodes.append(f.read())
        return cls(clients, nodes, faults)


# ---------------------------------------------------------------------------
# Telemetry-stream reader (the structured path).
# ---------------------------------------------------------------------------


class StreamRecords:
    """One parsed telemetry stream, by record schema.

    ``snapshots`` are the ``hotstuff-telemetry-v1`` lines, ``traces`` the
    interleaved ``hotstuff-trace-v1`` lines, ``dtraces`` the
    ``hotstuff-dtrace-v1`` batch-lifecycle lines, ``profiles`` the
    ``hotstuff-profile-v1`` sampling-profiler lines, ``meta`` the
    ``hotstuff-meta-v1`` stream self-descriptions (one per writer; a
    restart of the same node appends another), ``alerts`` any
    ``hotstuff-alert-v1`` watchtower records, ``skipped`` counts lines
    that could not be used: a truncated FINAL line (a node crashed or
    was SIGKILLed mid-write — expected under chaos, never fatal) and
    lines of unknown schema (forward compatibility). Malformed JSON
    anywhere but the last line still raises — mid-file corruption is a
    real bug, not crash fallout."""

    __slots__ = (
        "snapshots", "traces", "dtraces", "profiles", "meta", "alerts",
        "skipped",
    )

    def __init__(self) -> None:
        self.snapshots: list[dict] = []
        self.traces: list[dict] = []
        self.dtraces: list[dict] = []
        self.profiles: list[dict] = []
        self.meta: list[dict] = []
        self.alerts: list[dict] = []
        self.skipped = 0


def read_stream_records(path: str) -> StreamRecords:
    with open(path) as f:
        lines = [
            (i, line.strip()) for i, line in enumerate(f, 1) if line.strip()
        ]
    records = StreamRecords()
    for pos, (lineno, line) in enumerate(lines):
        try:
            obj = json.loads(line)
        except json.JSONDecodeError as e:
            if pos == len(lines) - 1:
                # Truncated final line: the writer died mid-append.
                records.skipped += 1
                continue
            raise ParseError(f"{path}:{lineno}: bad JSON: {e}") from e
        schema = obj.get("schema") if isinstance(obj, dict) else None
        if schema == SNAPSHOT_SCHEMA:
            problems = validate_snapshot(obj)
            if problems:
                raise ParseError(f"{path}:{lineno}: {'; '.join(problems)}")
            records.snapshots.append(obj)
        elif schema == TRACE_SCHEMA:
            problems = validate_trace_record(obj)
            if problems:
                raise ParseError(f"{path}:{lineno}: {'; '.join(problems)}")
            records.traces.append(obj)
        elif schema == DTRACE_SCHEMA:
            problems = validate_dtrace_record(obj)
            if problems:
                raise ParseError(f"{path}:{lineno}: {'; '.join(problems)}")
            records.dtraces.append(obj)
        elif schema == PROFILE_SCHEMA:
            problems = validate_profile_record(obj)
            if problems:
                raise ParseError(f"{path}:{lineno}: {'; '.join(problems)}")
            records.profiles.append(obj)
        elif schema == META_SCHEMA:
            problems = validate_meta_record(obj)
            if problems:
                raise ParseError(f"{path}:{lineno}: {'; '.join(problems)}")
            records.meta.append(obj)
        elif schema == ALERT_SCHEMA:
            problems = validate_alert_record(obj)
            if problems:
                raise ParseError(f"{path}:{lineno}: {'; '.join(problems)}")
            records.alerts.append(obj)
        else:
            records.skipped += 1
    return records


class StreamFollower:
    """Tail-follow reader for one live telemetry stream: yields each
    record (validated, any known schema) as the file grows — the
    watchtower's ingestion primitive, and independently useful for any
    ``--telemetry`` consumer that wants records before the run ends.

    Live-stream realities it handles:

    - the file may not exist yet (a node still booting): polls quietly;
    - a **partial final line** (writer mid-append): buffered until its
      newline arrives — a record is only parsed once complete;
    - **rotation by truncation** (file size shrinks): reopens from the
      start and counts ``truncations``;
    - malformed or unknown-schema lines: counted in ``skipped`` and
      skipped — a live follower cannot tell mid-file corruption from a
      crash tail, and dying on it would kill monitoring exactly when
      something is going wrong (the post-hoc ``read_stream_records``
      stays strict).

    Iterate it directly (blocking, ``poll_s`` between growth checks)
    until ``stop()`` is called or ``stop_when`` returns True — both
    finish with one final drain so nothing already on disk is lost —
    or call :meth:`drain` for a non-blocking sweep of what's new.
    """

    def __init__(
        self,
        path: str,
        *,
        poll_s: float = 0.2,
        stop_when=None,
    ) -> None:
        self.path = path
        self.poll_s = poll_s
        self.stop_when = stop_when
        self.skipped = 0
        self.truncations = 0
        self.records_read = 0
        self._offset = 0
        self._buf = b""
        self._stopped = False

    def stop(self) -> None:
        self._stopped = True

    def _should_stop(self) -> bool:
        return self._stopped or (
            self.stop_when is not None and self.stop_when()
        )

    def drain(self) -> list[dict]:
        """Non-blocking: parse and return every complete new record."""
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return []  # not created yet (or vanished): keep polling
        if size < self._offset:
            # Rotation by truncation: the writer started the file over.
            self._offset = 0
            self._buf = b""
            self.truncations += 1
        if size == self._offset:
            return []
        with open(self.path, "rb") as f:
            f.seek(self._offset)
            chunk = f.read()
            self._offset = f.tell()
        self._buf += chunk
        out: list[dict] = []
        while True:
            nl = self._buf.find(b"\n")
            if nl < 0:
                break  # partial final line: wait for the newline
            line, self._buf = self._buf[:nl], self._buf[nl + 1:]
            line = line.strip()
            if not line:
                continue
            record = self._parse(line)
            if record is not None:
                self.records_read += 1
                out.append(record)
        return out

    def _parse(self, line: bytes) -> dict | None:
        try:
            obj = json.loads(line)
        except json.JSONDecodeError:
            self.skipped += 1
            return None
        schema = obj.get("schema") if isinstance(obj, dict) else None
        validator = {
            SNAPSHOT_SCHEMA: validate_snapshot,
            TRACE_SCHEMA: validate_trace_record,
            DTRACE_SCHEMA: validate_dtrace_record,
            PROFILE_SCHEMA: validate_profile_record,
            META_SCHEMA: validate_meta_record,
            ALERT_SCHEMA: validate_alert_record,
        }.get(schema)
        if validator is None or validator(obj):
            self.skipped += 1
            return None
        return obj

    def __iter__(self):
        import time as _time

        while not self._should_stop():
            got = self.drain()
            if got:
                yield from got
            else:
                _time.sleep(self.poll_s)
        # Final drain: records appended between the last poll and the
        # stop signal (e.g. a final snapshot flushed at teardown).
        yield from self.drain()


class SnapshotStream(list):
    """A list of snapshots that remembers how many lines were skipped
    (kept a list subclass so existing callers stay source-compatible)."""

    skipped = 0


def read_telemetry_stream(path: str) -> SnapshotStream:
    """Parse one JSON-lines stream; returns the snapshot lines (trace
    lines are separated out — use ``read_stream_records`` for those),
    tolerating a truncated final line. Raises ParseError on mid-stream
    corruption or schema-invalid records."""
    records = read_stream_records(path)
    stream = SnapshotStream(records.snapshots)
    stream.skipped = records.skipped
    return stream


class TelemetryParser:
    """Consensus TPS/latency from telemetry snapshot streams.

    ``streams`` is one list of parsed snapshots per source (file / node);
    only each stream's LAST snapshot matters (counters are cumulative).
    Cross-stream merge mirrors the regex parser's: the measurement window
    is [min first-proposal, max last-commit] across streams, committed
    bytes sum (each batch is credited exactly once, by its creator), and
    latency histograms merge by bucket addition.
    """

    def __init__(self, streams: list[list[dict]], tx_size: int | None = None):
        finals = [s[-1] for s in streams if s]
        if not finals:
            raise ParseError("no telemetry snapshots")
        self.snapshots = finals
        self.tx_size = tx_size
        # Lines the lenient reader had to drop (truncated final writes of
        # crashed nodes); surfaced so measurements know their provenance.
        self.skipped_lines = sum(
            getattr(s, "skipped", 0) for s in streams
        )

        def gauge(snap, name):
            return snap["gauges"].get(name)

        starts = [
            g
            for s in finals
            if (g := gauge(s, "consensus.first_proposal_ts")) is not None
        ]
        ends = [
            g
            for s in finals
            if (g := gauge(s, "consensus.last_commit_ts")) is not None
        ]
        self.start = min(starts) if starts else None
        self.end = max(ends) if ends else None
        self.committed_bytes = sum(
            s["counters"].get("consensus.committed_bytes", 0) for s in finals
        )
        self.committed_batches = sum(
            s["counters"].get("consensus.batches_committed", 0) for s in finals
        )
        self.latency_sum_ms = 0.0
        self.latency_count = 0
        for s in finals:
            h = s["histograms"].get("consensus.commit_latency_ms")
            if h is not None:
                self.latency_sum_ms += h["sum"]
                self.latency_count += h["count"]

    def counter_total(self, name: str) -> int:
        return sum(s["counters"].get(name, 0) for s in self.snapshots)

    def consensus_throughput(self) -> tuple[float, float, float]:
        """(tps, bps, duration_s); tps is 0 unless ``tx_size`` was given."""
        if self.start is None or self.end is None or self.end <= self.start:
            return 0.0, 0.0, 0.0
        duration = self.end - self.start
        bps = self.committed_bytes / duration
        tps = bps / self.tx_size if self.tx_size else 0.0
        return tps, bps, duration

    def consensus_latency_ms(self) -> float:
        if not self.latency_count:
            return 0.0
        return self.latency_sum_ms / self.latency_count

    def result(self) -> str:
        tps, bps, duration = self.consensus_throughput()
        return (
            "\n"
            "-----------------------------------------\n"
            " TELEMETRY SUMMARY:\n"
            "-----------------------------------------\n"
            f" Snapshot streams: {len(self.snapshots)}\n"
            f" Measured window: {duration:.1f} s\n"
            f" Committed batches: {self.committed_batches:,}\n"
            "\n"
            f" Consensus TPS: {round(tps):,} tx/s\n"
            f" Consensus BPS: {round(bps):,} B/s\n"
            f" Consensus latency: {round(self.consensus_latency_ms()):,} ms\n"
            "-----------------------------------------\n"
        )

    @classmethod
    def process(cls, directory: str, tx_size: int | None = None) -> "TelemetryParser":
        streams = [
            read_telemetry_stream(fn)
            for fn in sorted(
                glob.glob(os.path.join(directory, "telemetry-*.jsonl"))
            )
        ]
        if not streams:
            raise ParseError(f"no telemetry-*.jsonl streams in {directory}")
        return cls(streams, tx_size=tx_size)
