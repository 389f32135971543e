"""The port's telemetry held against the reference's.

- The schema strings, bucket tables and record fields are the reference's
  byte for byte, and each record kind one package builds passes the other
  package's validator (snapshot, meta, trace, dtrace, profile), as does a
  whole emitted stream through the other package's ``validate`` CLI.
- The same sequence of counter, gauge and histogram operations gives equal
  ``snapshot()`` dicts in both packages (wall stamps and pids aside).
- A 4-engine in-process committee of each package on the CPU backend, with
  telemetry enabled, emits the same counter names. The only differences
  allowed are the reference's ``tpu`` names, which the port calls
  ``cuda``, and the data plane's and faultline's names, whose call sites
  wait for their slices.
- ``profile=True`` yields ``consensus.stage.<kind>.{ns,calls}`` only for
  kinds in ``Core.HANDLERS``, and the profiler's ``frame_id`` names a port
  file as ``hotstuff_tpu_torch/...``.
- Disabled, every metric of a port core is the shared no-op object.

Ports 22850-22869.
"""

from __future__ import annotations

import asyncio
import json
import sys

import pytest

import hotstuff_tpu.crypto as j_crypto
import hotstuff_tpu.telemetry as j_tm
import hotstuff_tpu_torch.crypto as t_crypto
import hotstuff_tpu_torch.telemetry as t_tm
from hotstuff_tpu.consensus import cert_arena as j_arena
from hotstuff_tpu.telemetry import profiler as j_prof
from hotstuff_tpu.telemetry import slo as j_slo
from hotstuff_tpu.telemetry import validate as j_validate
from hotstuff_tpu_torch.consensus import cert_arena as t_arena
from hotstuff_tpu_torch.consensus.core import Core
from hotstuff_tpu_torch.telemetry import profiler as t_prof
from hotstuff_tpu_torch.telemetry import slo as t_slo
from hotstuff_tpu_torch.telemetry import validate as t_validate

from .common import async_test
from .test_torch_committee import run_committee

BASE = 22850
PKG = {
    "port": (t_tm, t_arena, t_prof, t_validate),
    "reference": (j_tm, j_arena, j_prof, j_validate),
}
# Metric-name prefixes whose call sites wait for later slices of the port
# (the sim plane's verdict memo).
DEFERRED = ("crypto.verify_memo.",)


@pytest.fixture(autouse=True)
def isolated(monkeypatch):
    monkeypatch.delenv("HOTSTUFF_WIRE_V2", raising=False)
    for tm in (t_tm, j_tm):
        tm.reset_for_tests()
    monkeypatch.setattr(t_crypto, "_BACKEND", None)
    monkeypatch.setattr(j_crypto, "_BACKEND", None)
    t_crypto.set_backend(t_crypto.CpuBackend())
    j_crypto.set_backend("cpu")
    yield
    for tm in (t_tm, j_tm):
        tm.reset_for_tests()
    t_arena.reset()
    j_arena.reset()


# -- names, tables, records ---------------------------------------------------


@pytest.mark.parametrize("name", [
    "SCHEMA", "META_SCHEMA", "TRACE_SCHEMA", "DTRACE_SCHEMA", "FLIGHT_SCHEMA",
    "PROFILE_SCHEMA", "DURATION_MS_BUCKETS", "FINE_DURATION_MS_BUCKETS", "COUNT_BUCKETS",
    "SIZE_BYTES_BUCKETS", "DEFAULT_INTERVAL_S",
])
def test_schema_strings_and_bucket_tables_are_the_references(name):
    assert getattr(t_tm, name) == getattr(j_tm, name)


def test_slo_verdict_schema_and_default_specs_are_the_references():
    assert t_slo.SLO_VERDICT_SCHEMA == j_slo.SLO_VERDICT_SCHEMA
    for specs in ("default_slos", "memory_slos", "dataplane_slos"):
        port = [s.to_dict() for s in getattr(t_slo, specs)()]
        assert port == [s.to_dict() for s in getattr(j_slo, specs)()], specs


def test_meta_record_lists_the_references_schemas():
    port = t_tm.build_meta_record(node="n", interval_s=5.0)
    ref = j_tm.build_meta_record(node="n", interval_s=5.0)
    assert port["schemas"] == ref["schemas"]
    assert sorted(port) == sorted(ref)


def make_record(tm, prof_mod, kind: str) -> dict:
    """One record of ``kind`` built by ``tm``'s package."""
    tm.enable()
    if kind == "snapshot":
        r = tm.get_registry()
        r.counter("c.events").inc(3)
        r.gauge("g.depth").set(2.5)
        r.histogram("h.ms", tm.FINE_DURATION_MS_BUCKETS).observe(0.04)
        return tm.build_snapshot(r, node="n", seq=1, final=True)
    if kind == "meta":
        return tm.build_meta_record(node="n", interval_s=1.0)
    if kind == "trace":
        tm.trace_event("n", 3, "propose", detail="a|b")
        tm.trace_event("n", 3, "commit")
        buf = tm.trace_buffer()
        return tm.build_trace_record(buf, buf.events_since(0), node="n")
    if kind == "dtrace":
        tm.dtrace_event("n", b"\x07" * 32, "seal", detail="w0|1tx|9B")
        buf = tm.dtrace_buffer()
        return tm.build_dtrace_record(buf, buf.events_since(0), node="n")
    assert kind == "profile"
    prof = prof_mod.SamplingProfiler()
    prof.sample({1: sys._getframe()})
    return prof.drain_record(node="n")


VALIDATE = {
    "snapshot": "validate_snapshot", "meta": "validate_meta_record",
    "trace": "validate_trace_record", "dtrace": "validate_dtrace_record",
    "profile": "validate_profile_record",
}


@pytest.mark.parametrize("kind", sorted(VALIDATE))
@pytest.mark.parametrize("writer, reader", [("port", "reference"), ("reference", "port")])
def test_each_record_passes_the_other_packages_validator(kind, writer, reader):
    tm, prof = PKG[writer][0], PKG[writer][2]
    record = json.loads(json.dumps(make_record(tm, prof, kind)))
    check = getattr(PKG[reader][0], VALIDATE[kind])
    assert check(record) == []
    assert getattr(PKG[writer][0], VALIDATE[kind])(record) == []
    # A record of another kind is refused, so the check is not vacuous.
    other = "meta" if kind != "meta" else "snapshot"
    assert check(json.loads(json.dumps(make_record(tm, prof, other)))) != []


@pytest.mark.parametrize("writer, reader", [("port", "reference"), ("reference", "port")])
def test_an_emitted_stream_passes_the_other_packages_validate_cli(tmp_path, writer, reader):
    tm, prof_mod = PKG[writer][0], PKG[writer][2]
    tm.enable()
    prof = prof_mod.SamplingProfiler()
    prof.sample({1: sys._getframe()})
    path = tmp_path / "telemetry-n.jsonl"
    emitter = tm.TelemetryEmitter(
        tm.get_registry(), str(path), node="n", trace=tm.trace_buffer(),
        dtrace=tm.dtrace_buffer(), profiler=prof,
    )
    tm.get_registry().counter("c.events").inc()
    tm.trace_event("n", 1, "propose")
    tm.dtrace_event("n", b"\x01" * 32, "seal")
    emitter.emit()
    emitter.emit(final=True)
    report = PKG[reader][3].validate_stream(str(path))
    assert report["ok"] is True, report["problems"]
    assert report["self_described"] is True
    counts = {k: v for k, v in report["counts"].items() if v}
    assert counts == {
        tm.META_SCHEMA: 1, tm.SCHEMA: 2, tm.TRACE_SCHEMA: 1, tm.DTRACE_SCHEMA: 1,
        tm.PROFILE_SCHEMA: 1,
    }
    assert report["unknown_schema"] == 0


def apply_ops(registry, ops) -> None:
    for op, name, *args in ops:
        if op == "hist":
            registry.histogram(name, args[0]).observe(args[1])
        elif op == "inc":
            registry.counter(name).inc(*args)
        else:
            getattr(registry.gauge(name), op)(*args)


OPS = {
    "counters": [("inc", "c.a"), ("inc", "c.a", 41), ("inc", "c.b", 0), ("inc", "c.z", 7)],
    "gauges": [("set", "g.x", 3), ("set_min", "g.lo", 5.0), ("set_min", "g.lo", 7.0),
               ("set_max", "g.hi", 2.0), ("set_max", "g.hi", 9.5), ("set", "g.x", -1.25)],
    "histograms": [("hist", "h.ms", j_tm.DURATION_MS_BUCKETS, v) for v in (0.05, 1.0, 250, 1e9)]
    + [("hist", "h.fine", j_tm.FINE_DURATION_MS_BUCKETS, 0.025),
       ("hist", "h.count", j_tm.COUNT_BUCKETS, 17)],
    "mixed": [("inc", "m.c", 2), ("set", "m.g", 1), ("hist", "m.h", (1, 10, 100), 10),
              ("hist", "m.h", (1, 10, 100), 10.5), ("inc", "m.c")],
}


@pytest.mark.parametrize("case", sorted(OPS))
def test_same_operations_give_equal_snapshots(case):
    port, ref = t_tm.Registry(), j_tm.Registry()
    apply_ops(port, OPS[case])
    apply_ops(ref, OPS[case])
    port.register_collector("k", lambda: {"v": 4})
    ref.register_collector("k", lambda: {"v": 4})
    assert port.snapshot() == ref.snapshot()
    strip = ("ts", "pid")
    a = {k: v for k, v in t_tm.build_snapshot(port, node="n", seq=2).items() if k not in strip}
    b = {k: v for k, v in j_tm.build_snapshot(ref, node="n", seq=2).items() if k not in strip}
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def test_frame_id_names_a_port_file_under_the_ports_package():
    code = Core.run.__code__
    frame = type("Frame", (), {"f_code": code, "f_back": None})()
    assert t_prof.frame_id(frame) == f"hotstuff_tpu_torch/consensus/core.py:{code.co_firstlineno}:run"
    # The reference's marker does not reach the port's files.
    assert j_prof.frame_id(frame) == f"core.py:{code.co_firstlineno}:run"


# -- engines -------------------------------------------------------------------


async def committee_snapshot(package: str, base_port: int, blocks: int, profile: bool = False):
    """Four engines of ``package`` with its telemetry enabled commit
    ``blocks`` blocks; returns the package's registry snapshot."""
    tm, arena = PKG[package][:2]
    tm.enable()
    arena.reset()  # a fresh arena takes live counters
    rounds, _ = await run_committee(base_port, [package] * 4, blocks, profile=profile)
    assert all(len(set(got)) == 1 for got in rounds)
    return tm.get_registry().snapshot()


def normalized(names) -> set[str]:
    return {n.replace(".tpu", ".cuda") for n in names if not n.startswith(DEFERRED)}


@async_test(timeout=90)
async def test_committees_of_both_packages_emit_the_same_counter_names():
    ref = await committee_snapshot("reference", BASE, blocks=4)
    port = await committee_snapshot("port", BASE + 10, blocks=4)
    assert normalized(port["counters"]) == normalized(ref["counters"])
    for name in ("consensus.qcs_formed", "consensus.rounds_advanced", "consensus.blocks_committed",
                 "consensus.votes_received", "crypto.dispatch.cpu_cert", "net.frames_in",
                 "net.frames_out", "consensus.arena.hits"):
        assert port["counters"][name] > 0, name
    assert port["histograms"]["consensus.span.propose_to_commit_ms"]["count"] > 0
    assert set(port["histograms"]) == set(ref["histograms"])


@async_test(timeout=90)
async def test_profile_counts_stages_only_for_the_cores_handler_kinds():
    snap = await committee_snapshot("port", BASE + 10, blocks=3, profile=True)
    stages = {n for n in snap["counters"] if n.startswith("consensus.stage.")}
    kinds = {n.split(".")[2] for n in stages}
    assert kinds <= set(Core.HANDLERS), kinds - set(Core.HANDLERS)
    assert {"propose", "vote", "loopback"} <= kinds
    for kind in kinds:
        assert {f"consensus.stage.{kind}.ns", f"consensus.stage.{kind}.calls"} <= stages
        assert snap["counters"][f"consensus.stage.{kind}.calls"] > 0


def test_a_core_with_telemetry_disabled_holds_the_shared_null_objects():
    assert not t_tm.enabled()
    core = Core(*[None] * 7, 1_000, *[asyncio.Queue()] * 4, network=object(), timer=object())
    for name in ("_m_proposals", "_m_votes", "_m_timeouts_rx", "_m_timeouts", "_m_qcs",
                 "_m_tcs", "_m_rounds", "_m_blocks"):
        assert getattr(core, name) is t_tm.NULL_COUNTER, name
    assert core._g_round is t_tm.NULL_GAUGE and core._g_committed_round is t_tm.NULL_GAUGE
    assert core._trace is None
    assert t_tm.counter("x") is t_tm.NULL_COUNTER
    assert t_tm.gauge("x") is t_tm.NULL_GAUGE
    assert t_tm.histogram("x") is t_tm.NULL_HISTOGRAM
    assert t_tm.round_trace() is None
    assert Core._m_votes is t_tm.NULL_COUNTER and Core._g_round is t_tm.NULL_GAUGE
    assert t_tm.get_registry().snapshot()["counters"] == {}


def test_card_committees_bind_below_the_hosts_ephemeral_range():
    """The card test's four engines and ``chip_smoke.py``'s profiled N = 100
    committee bind below the H100 host's ephemeral range (16000-65535),
    clear of each other and of the ranges taken before them."""
    import ast
    from pathlib import Path

    from . import test_torch_telemetry_card as card

    tree = ast.parse((Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text())
    consts = {t.id: ast.literal_eval(node.value) for node in tree.body
              if isinstance(node, ast.Assign) for t in node.targets
              if isinstance(t, ast.Name) and t.id in ("COMMITTEE_PORTS", "COMMITTEE_N")}
    profiled = range(consts["COMMITTEE_PORTS"][3], consts["COMMITTEE_PORTS"][3] + consts["COMMITTEE_N"])
    engines = range(card.BASE, card.BASE + 4)
    taken = [range(10000, 10600), range(10600, 10700), range(10700, 10728)]
    for ports in (profiled, engines):
        assert max(ports) < 16000
        assert not any(set(ports) & set(r) for r in taken)
    assert not set(profiled) & set(engines)
    assert engines.start >= 10740 and engines.stop <= 10748
