"""Twin of ``tests/test_telemetry.py``, run against the port's copy
(``hotstuff_tpu_torch.telemetry``).

Telemetry plane tests: registry primitives (thread-shard merge,
histogram bucketing), snapshot schema round-trips, round-trace spans, and
the measurement-parity contract — a real in-process 4-node run whose
telemetry stream must agree with the regex log parser on TPS/latency."""

from __future__ import annotations

import asyncio
import io
import json
import logging
import threading
import time
from datetime import datetime, timezone

import pytest

from hotstuff_tpu_torch import telemetry
from hotstuff_tpu_torch.telemetry import (
    Registry,
    RoundTrace,
    TelemetryEmitter,
    build_snapshot,
    validate_snapshot,
)

from .common import async_test

# Sockets: 22800-22829 (the regex-parity testbed) and 22840-22869 (the
# streaming testbed).

BASE = 22800


@pytest.fixture(autouse=True)
def _isolated_telemetry():
    telemetry.reset_for_tests()
    yield
    telemetry.reset_for_tests()


# -- registry primitives ----------------------------------------------------


def test_counter_thread_shard_merge():
    r = Registry()
    c = r.counter("t.hits")
    n_threads, per_thread = 8, 10_000

    def worker():
        for _ in range(per_thread):
            c.inc()

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value() == n_threads * per_thread


def test_histogram_bucketing_and_shard_merge():
    r = Registry()
    h = r.histogram("t.lat", buckets=(1, 10, 100))
    # Edges are upper-INCLUSIVE; above the last edge goes to overflow.
    observations = {0.5: 0, 1.0: 0, 1.5: 1, 10.0: 1, 99.0: 2, 100.5: 3}

    def worker(items):
        for v in items:
            h.observe(v)

    items = list(observations)
    threads = [
        threading.Thread(target=worker, args=(items,)) for _ in range(4)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    counts, total, n = h.merged()
    assert n == 4 * len(items)
    assert total == pytest.approx(4 * sum(items))
    expected = [0] * 4
    for bucket in observations.values():
        expected[bucket] += 4
    assert counts == expected
    assert h.mean() == pytest.approx(sum(items) / len(items))


def test_histogram_rejects_unsorted_buckets():
    with pytest.raises(ValueError):
        Registry().histogram("t.bad", buckets=(10, 1))


def test_gauge_watermarks():
    r = Registry()
    g = r.gauge("t.g")
    assert g.value() is None
    g.set_min(5.0)
    g.set_min(7.0)  # not smaller: ignored
    assert g.value() == 5.0
    g2 = r.gauge("t.g2")
    g2.set_max(5.0)
    g2.set_max(3.0)
    assert g2.value() == 5.0


def test_registry_name_type_conflicts():
    r = Registry()
    r.counter("t.x")
    with pytest.raises(TypeError):
        r.gauge("t.x")
    with pytest.raises(ValueError):
        r.counter("bad name!")


def test_counter_identity_is_stable():
    r = Registry()
    assert r.counter("t.same") is r.counter("t.same")


def test_collector_values_appear_as_gauges():
    r = Registry()
    r.register_collector("engine", lambda: {"alpha": 3, "beta": 4.5})
    gauges = r.snapshot()["gauges"]
    assert gauges["engine.alpha"] == 3
    assert gauges["engine.beta"] == 4.5
    # A failing collector degrades to absence, never an exception.
    r.register_collector("engine", lambda: 1 / 0)
    assert "engine.alpha" not in r.snapshot()["gauges"]


# -- snapshot schema --------------------------------------------------------


def test_snapshot_schema_roundtrip(tmp_path):
    r = Registry()
    r.counter("c.events").inc(7)
    r.gauge("g.depth").set(3)
    r.histogram("h.ms", buckets=(1, 10)).observe(5)
    emitter = TelemetryEmitter(r, str(tmp_path / "telemetry-x.jsonl"), node="x")
    emitter.emit()
    r.counter("c.events").inc()
    emitter.emit(final=True)

    from benchmark.logs import TelemetryParser, read_telemetry_stream

    snaps = read_telemetry_stream(str(tmp_path / "telemetry-x.jsonl"))
    assert [s["seq"] for s in snaps] == [0, 1]
    assert snaps[-1]["final"] is True
    assert snaps[-1]["counters"]["c.events"] == 8
    for s in snaps:
        assert validate_snapshot(s) == []
    parser = TelemetryParser.process(str(tmp_path))
    assert parser.counter_total("c.events") == 8


def test_validate_snapshot_rejects_malformed():
    good = build_snapshot(Registry(), node="n")
    assert validate_snapshot(good) == []
    assert validate_snapshot([]) != []
    bad = dict(good, schema="other")
    assert any("schema" in p for p in validate_snapshot(bad))
    bad = json.loads(json.dumps(good))
    bad["histograms"]["h"] = {"le": [1, 2], "counts": [1, 2], "sum": 0, "count": 3}
    problems = validate_snapshot(bad)
    assert problems, "edges+1 counts invariant not enforced"


def test_read_telemetry_stream_raises_on_garbage(tmp_path):
    from benchmark.logs import ParseError, read_telemetry_stream

    # Mid-stream corruption still raises (a real bug, not crash fallout):
    # the garbage line is followed by a valid snapshot.
    good = json.dumps(build_snapshot(Registry(), node="n"))
    path = tmp_path / "telemetry-bad.jsonl"
    path.write_text(f"not json\n{good}\n")
    with pytest.raises(ParseError):
        read_telemetry_stream(str(path))


def test_read_telemetry_stream_tolerates_truncated_final_line(tmp_path):
    """A node SIGKILLed mid-write leaves a truncated last line; the
    reader must keep the valid prefix and count the loss."""
    from benchmark.logs import TelemetryParser, read_telemetry_stream

    r = Registry()
    r.counter("c.events").inc(3)
    path = tmp_path / "telemetry-crash.jsonl"
    emitter = TelemetryEmitter(r, str(path), node="crash")
    emitter.emit()
    emitter.emit()
    with open(path, "a") as f:
        f.write('{"schema": "hotstuff-telemetry-v1", "node": "crash", "coun')
    snaps = read_telemetry_stream(str(path))
    assert len(snaps) == 2
    assert snaps.skipped == 1
    parser = TelemetryParser([list(snaps)])
    assert parser.counter_total("c.events") == 3
    parser = TelemetryParser([snaps])
    assert parser.skipped_lines == 1


def test_stream_interleaves_trace_records(tmp_path):
    """Trace lines ride the same stream; the snapshot reader separates
    them and read_stream_records hands both out."""
    from benchmark.logs import read_stream_records, read_telemetry_stream

    telemetry.enable()
    r = telemetry.get_registry()
    buf = telemetry.trace_buffer()
    path = tmp_path / "telemetry-t.jsonl"
    emitter = TelemetryEmitter(r, str(path), node="t", trace=buf)
    telemetry.trace_event("n0", 1, "propose")
    telemetry.trace_event("n0", 1, "commit")
    emitter.emit()
    telemetry.trace_event("n0", 2, "propose")
    emitter.emit(final=True)

    records = read_stream_records(str(path))
    assert len(records.snapshots) == 2
    assert len(records.traces) == 2
    # Delta semantics: each trace line carries only NEW events.
    assert len(records.traces[0]["events"]) == 2
    assert len(records.traces[1]["events"]) == 1
    assert records.traces[0]["anchor"]["wall"] > 0
    snaps = read_telemetry_stream(str(path))  # trace lines separated out
    assert len(snaps) == 2 and snaps.skipped == 0


def test_emitter_final_flush_is_idempotent(tmp_path):
    """arm_shutdown_flush's atexit/SIGTERM paths and a graceful shutdown
    can all race to emit the final snapshot; exactly one must land."""
    from benchmark.logs import read_telemetry_stream

    r = Registry()
    path = tmp_path / "telemetry-f.jsonl"
    emitter = TelemetryEmitter(r, str(path), node="f")
    emitter.emit(final=True)
    emitter.emit(final=True)  # duplicate flush: swallowed
    snaps = read_telemetry_stream(str(path))
    assert len(snaps) == 1
    assert snaps[0]["final"] is True


def test_superbatch_per_sig_histogram_resolves_microseconds():
    """The fine buckets must separate a 25 µs/sig flush from a 60 µs one
    (both sat in DURATION_MS_BUCKETS' first 0.1 ms bucket)."""
    from hotstuff_tpu_torch.telemetry import FINE_DURATION_MS_BUCKETS

    r = Registry()
    h = r.histogram("crypto.superbatch.per_sig_ms", FINE_DURATION_MS_BUCKETS)
    h.observe(0.025)
    h.observe(0.060)
    counts, _, n = h.merged()
    assert n == 2
    assert sum(1 for c in counts if c) == 2, "µs regimes share a bucket"


# -- round-trace spans ------------------------------------------------------


def test_round_trace_spans_record_and_gc():
    r = Registry()
    trace = RoundTrace(r)
    trace.mark_propose(5)
    trace.mark_vote(5)
    trace.mark_qc(5)
    trace.mark_commit(5)
    for name, want in (
        ("consensus.span.propose_to_first_vote_ms", 1),
        ("consensus.span.first_vote_to_qc_ms", 1),
        ("consensus.span.qc_to_commit_ms", 1),
        ("consensus.span.propose_to_commit_ms", 1),
    ):
        _, _, n = r.histogram(name).merged()
        assert n == want, name
    assert trace.open_rounds() == 0  # commit GC'd the round

    # Partial marks never crash and never record bogus spans.
    trace.mark_qc(9)
    trace.mark_commit(9)
    _, _, n = r.histogram("consensus.span.qc_to_commit_ms").merged()
    assert n == 2
    _, _, n = r.histogram("consensus.span.propose_to_commit_ms").merged()
    assert n == 1  # round 9 had no propose mark

    # Bounded table: far more rounds than the cap never grow state.
    for round_ in range(10_000):
        trace.mark_propose(round_)
    assert trace.open_rounds() <= 512


def test_round_trace_none_when_disabled():
    assert telemetry.round_trace() is None
    telemetry.enable()
    assert telemetry.round_trace() is not None


# -- benchmark-interface tables --------------------------------------------


def test_record_tables_join_on_first_commit():
    telemetry.enable()
    r = telemetry.get_registry()
    telemetry.record_sealed(b"d1", 1_000)
    telemetry.record_created(b"d1", ts=100.0)
    telemetry.record_commit(b"d1", ts=100.5)
    telemetry.record_commit(b"d1", ts=107.0)  # later duplicate: no effect
    snap = r.snapshot()
    assert snap["counters"]["consensus.committed_bytes"] == 1_000
    assert snap["counters"]["consensus.batches_committed"] == 1
    assert snap["gauges"]["consensus.first_proposal_ts"] == 100.0
    assert snap["gauges"]["consensus.last_commit_ts"] == 100.5
    h = snap["histograms"]["consensus.commit_latency_ms"]
    assert h["count"] == 1 and h["sum"] == pytest.approx(500.0)


def test_record_tables_noop_when_disabled():
    telemetry.record_sealed(b"d1", 1_000)
    telemetry.record_commit(b"d1")
    assert "consensus.committed_bytes" not in telemetry.get_registry().snapshot()["counters"]


# -- native ed25519 engine counters ----------------------------------------


def test_native_ed25519_stats_export():
    from hotstuff_tpu_torch.crypto import native_ed25519

    if not native_ed25519.native_available():
        pytest.skip("native ed25519 engine unavailable")
    before = native_ed25519.native_stats()
    from hotstuff_tpu_torch.crypto import ed25519_ref as ref

    seed = bytes(range(32))
    pub = ref.secret_to_public(seed)
    msg = b"m" * 32
    sig = ref.sign(seed, msg)
    assert native_ed25519.verify_batch_native([msg] * 2, [pub] * 2, [sig] * 2)
    after = native_ed25519.native_stats()
    assert after["msm_calls"] > before["msm_calls"]
    assert after["msm_points"] >= before["msm_points"] + 5  # 2n+1 lanes


# -- measurement parity: telemetry stream vs regex log scrape ---------------


def _iso(ts: float) -> str:
    dt = datetime.fromtimestamp(ts, tz=timezone.utc)
    return dt.strftime("%Y-%m-%dT%H:%M:%S.") + f"{dt.microsecond // 1000:03d}Z"


@async_test(timeout=120)
async def test_telemetry_agrees_with_regex_parser(tmp_path, monkeypatch):
    """Boot the 4-node in-process testbed with benchmark logging AND
    telemetry enabled, drive real transactions, then compute TPS/latency
    twice — regex-scraping the captured logs (LogParser) and reading the
    telemetry snapshot (TelemetryParser) — and require agreement."""
    from benchmark.logs import LogParser, TelemetryParser
    from hotstuff_tpu_torch.node import Node
    from hotstuff_tpu_torch.network.receiver import write_frame
    from hotstuff_tpu_torch.utils.logging import _EnvLoggerFormatter

    from hotstuff_tpu_torch import crypto as t_crypto
    from hotstuff_tpu_torch.consensus import cert_arena

    from .test_torch_node import write_testbed

    telemetry.enable()
    # The port's node takes the process backend (the serial CPU one here)
    # and hashes on the host; a fresh cert arena takes live counters.
    monkeypatch.setattr(t_crypto, "_BACKEND", None)
    t_crypto.set_backend("cpu")
    cert_arena.reset()

    buf = io.StringIO()
    handler = logging.StreamHandler(buf)
    handler.setFormatter(_EnvLoggerFormatter())
    handler.setLevel(logging.INFO)
    root = logging.getLogger()
    old_level = root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)

    nodes = []
    writer = None
    tx_size = 512
    n_txs = 20
    try:
        committee_file, params_file, key_files = write_testbed(
            tmp_path, BASE, n=4
        )
        for i, kf in enumerate(key_files):
            nodes.append(
                await Node.new(
                    committee_file,
                    kf,
                    str(tmp_path / f"db_{i}"),
                    parameters_file=params_file,
                    benchmark=True,
                    device="cpu",
                )
            )

        _, writer = await asyncio.open_connection("127.0.0.1", BASE + 10)
        start_ts = time.time()
        for i in range(n_txs):
            # 0x01 lead byte: standard transaction (not a latency sample).
            write_frame(writer, b"\x01" + i.to_bytes(8, "big") + b"\xab" * (tx_size - 9))
            await writer.drain()
            await asyncio.sleep(0.1)

        # Drain commits until the committee went quiet — no PAYLOAD commit
        # anywhere for a while (empty blocks keep flowing forever; only
        # payload commits move the measured window).
        async def drain_until_quiet(node):
            last_payload = time.monotonic()
            while time.monotonic() - last_payload < 1.5:
                try:
                    blk = await asyncio.wait_for(node.commit.get(), timeout=0.5)
                    if blk.payload:
                        last_payload = time.monotonic()
                except asyncio.TimeoutError:
                    pass

        await asyncio.gather(*[drain_until_quiet(n) for n in nodes])
    finally:
        if writer is not None:
            writer.close()
        for node in nodes:
            await node.shutdown()
        cert_arena.reset()
        root.removeHandler(handler)
        root.setLevel(old_level)

    node_log = buf.getvalue()
    assert "Committed B" in node_log, f"no commits in captured log:\n{node_log[-2000:]}"
    client_log = (
        f"[{_iso(start_ts)} INFO client] Transactions size: {tx_size} B\n"
        f"[{_iso(start_ts)} INFO client] Transactions rate: 10 tx/s\n"
        f"[{_iso(start_ts)} INFO client] Start sending transactions\n"
    )
    regex = LogParser([client_log], [node_log])
    tele = TelemetryParser(
        [[build_snapshot(telemetry.get_registry(), node="testbed", final=True)]],
        tx_size=tx_size,
    )

    # Committed bytes must agree EXACTLY: both paths credit each batch
    # once, at the same seal-site size.
    assert tele.committed_bytes == sum(regex.batch_sizes.values())

    r_tps, r_bps, r_duration = regex._consensus_throughput()
    t_tps, t_bps, t_duration = tele.consensus_throughput()
    assert t_duration == pytest.approx(r_duration, abs=0.05)
    assert t_tps == pytest.approx(r_tps, rel=0.10)

    r_latency_ms = regex._consensus_latency() * 1e3
    t_latency_ms = tele.consensus_latency_ms()
    assert t_latency_ms == pytest.approx(r_latency_ms, abs=10.0)

    # The parity run doubles as wiring coverage: every plane recorded.
    snap = tele.snapshots[0]
    assert snap["counters"]["consensus.qcs_formed"] > 0
    assert snap["counters"]["mempool.batches_sealed"] > 0
    assert snap["counters"]["net.frames_in"] > 0
    assert snap["histograms"]["consensus.span.propose_to_commit_ms"]["count"] > 0


# -- the port's node streams (port-only: the environment switches) ------------


@async_test(timeout=120)
async def test_port_node_streams_pass_both_validators(tmp_path, monkeypatch):
    """Four port nodes under ``HOTSTUFF_TELEMETRY_DIR`` and
    ``HOTSTUFF_PYPROF``, as a bench runs them: each writes its own stream,
    every line of which passes the port's validator and the reference's;
    the final snapshot shows every plane recorded, and the profiler's
    records ride the stream."""
    import signal

    from hotstuff_tpu.telemetry.validate import validate_stream as reference_validate
    from hotstuff_tpu_torch import crypto as t_crypto
    from hotstuff_tpu_torch.consensus import cert_arena
    from hotstuff_tpu_torch.node import Node
    from hotstuff_tpu_torch.network.receiver import write_frame
    from hotstuff_tpu_torch.telemetry import profiler as pyprof
    from hotstuff_tpu_torch.telemetry.validate import main as validate_main
    from hotstuff_tpu_torch.telemetry.validate import validate_stream

    from .test_torch_node import next_payload_commit, write_testbed

    stream_dir = tmp_path / "telemetry"
    stream_dir.mkdir()
    monkeypatch.setenv("HOTSTUFF_TELEMETRY_DIR", str(stream_dir))
    monkeypatch.setenv("HOTSTUFF_TELEMETRY_INTERVAL", "0.2")
    monkeypatch.setenv("HOTSTUFF_PYPROF", "1")
    telemetry.reset_for_tests()  # enablement follows the environment
    assert telemetry.enabled()
    monkeypatch.setattr(t_crypto, "_BACKEND", None)
    t_crypto.set_backend("cpu")
    cert_arena.reset()
    sigterm = signal.getsignal(signal.SIGTERM)  # the nodes chain a flush on it
    committee_file, params_file, key_files = write_testbed(tmp_path, BASE + 40)
    nodes = []
    try:
        for i, kf in enumerate(key_files):
            nodes.append(await Node.new(committee_file, kf, str(tmp_path / f"db_{i}"),
                                        parameters_file=params_file, device="cpu"))
        assert pyprof.active() is not None
        _, writer = await asyncio.open_connection("127.0.0.1", BASE + 40 + 10)
        write_frame(writer, b"\x01" + (3).to_bytes(8, "big") + b"\xab" * 300)
        await writer.drain()
        await asyncio.wait_for(asyncio.gather(*[next_payload_commit(n) for n in nodes]), 60)
        await asyncio.sleep(0.5)  # a periodic snapshot or two
        writer.close()
    finally:
        for node in nodes:
            await node.shutdown()
        telemetry.reset_for_tests()  # stops the profiler
        cert_arena.reset()
        signal.signal(signal.SIGTERM, sigterm)

    streams = sorted(stream_dir.glob("telemetry-*.jsonl"))
    assert len(streams) == 4
    for path in streams:
        for validate in (validate_stream, reference_validate):
            report = validate(str(path))
            assert report["ok"] is True, (path, report["problems"])
            assert report["self_described"] and report["unknown_schema"] == 0
        assert report["counts"]["hotstuff-telemetry-v1"] >= 2
        assert report["counts"]["hotstuff-trace-v1"] >= 1
        lines = [json.loads(line) for line in path.read_text().splitlines()]
        final = [r for r in lines if r.get("schema") == "hotstuff-telemetry-v1"][-1]
        assert final["final"] is True
        for name in ("consensus.qcs_formed", "mempool.batches_sealed", "net.frames_in"):
            assert final["counters"][name] > 0, name
        assert final["gauges"]["resource.rss_bytes"] > 0
    assert any(report["counts"]["hotstuff-profile-v1"] for report in
               (validate_stream(str(p)) for p in streams))
    assert validate_main([str(p) for p in streams]) == 0


def test_validate_cli_names_the_port(capsys):
    from hotstuff_tpu_torch.telemetry.validate import main

    with pytest.raises(SystemExit):
        main(["--help"])
    assert "python -m hotstuff_tpu_torch.telemetry.validate" in capsys.readouterr().out
