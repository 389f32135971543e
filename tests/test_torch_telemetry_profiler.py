"""Twin of ``tests/test_profiler.py``, run against the port's copy
(``hotstuff_tpu_torch.telemetry``).

Sampling-profiler tests: deterministic synthetic frame stacks →
stable folded output, stage-tagging contextvar semantics across await
points, ctypes boundary accounting, and the drain-record schema."""

from __future__ import annotations

import asyncio
import threading
import time

import pytest

from hotstuff_tpu_torch import telemetry
from hotstuff_tpu_torch.telemetry import profiler as pyprof


@pytest.fixture(autouse=True)
def _isolated_profiler():
    pyprof.reset_for_tests()
    yield
    pyprof.reset_for_tests()


# -- synthetic frames --------------------------------------------------------


class FakeCode:
    """Hashable stand-in for a code object (frame_id caches on it)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


class FakeFrame:
    """Just enough of a frame for fold_stack/frame_id: f_code + f_back."""

    def __init__(self, filename, lineno, name, back=None):
        self.f_code = FakeCode(
            co_filename=filename, co_firstlineno=lineno, co_name=name,
            co_flags=0,
        )
        self.f_back = back


def _chain(*specs):
    """Build a frame chain root-first; returns the LEAF frame."""
    frame = None
    for filename, lineno, name in specs:
        frame = FakeFrame(filename, lineno, name, back=frame)
    return frame


def test_frame_id_compresses_repo_paths():
    f = FakeFrame("/x/y/hotstuff_tpu_torch/consensus/core.py", 101, "handle_vote")
    assert pyprof.frame_id(f) == "hotstuff_tpu_torch/consensus/core.py:101:handle_vote"
    f = FakeFrame("/usr/lib/python3.12/asyncio/events.py", 7, "run")
    assert pyprof.frame_id(f) == "events.py:7:run"


def test_fold_stack_is_root_to_leaf_and_stable():
    leaf = _chain(
        ("/r/hotstuff_tpu_torch/a.py", 1, "main"),
        ("/r/hotstuff_tpu_torch/b.py", 2, "middle"),
        ("/r/hotstuff_tpu_torch/c.py", 3, "leaf"),
    )
    folded = pyprof.fold_stack(leaf)
    assert folded == (
        "hotstuff_tpu_torch/a.py:1:main;hotstuff_tpu_torch/b.py:2:middle;"
        "hotstuff_tpu_torch/c.py:3:leaf"
    )
    # Determinism: the same chain folds identically every time.
    assert pyprof.fold_stack(leaf) == folded


def test_fold_stack_truncates_deep_stacks_keeping_the_leaf():
    specs = [("/r/hotstuff_tpu_torch/f.py", i, f"fn{i}") for i in range(100)]
    leaf = _chain(*specs)
    folded = pyprof.fold_stack(leaf, max_depth=10)
    frames = folded.split(";")
    assert frames[0] == "..."
    assert len(frames) <= 11
    assert frames[-1].endswith(":fn99")  # self-time blame survives


def test_synthetic_samples_produce_stable_folded_output():
    prof = pyprof.SamplingProfiler(interval_ms=2.0)
    leaf_a = _chain(
        ("/r/hotstuff_tpu_torch/a.py", 1, "loop"), ("/r/hotstuff_tpu_torch/b.py", 2, "work")
    )
    leaf_b = _chain(("/r/hotstuff_tpu_torch/a.py", 1, "loop"))
    pyprof._THREAD_STAGE[111] = "verify"
    pyprof._THREAD_STAGE[222] = "ingress"
    for _ in range(3):
        prof.sample({111: leaf_a, 222: leaf_b})
    prof.sample({111: leaf_a})
    rec = prof.drain_record(node="t")
    assert rec is not None
    assert pyprof.validate_profile_record(rec) == []
    assert rec["samples"] == 4
    stacks = {(s, f): c for s, f, c in rec["stacks"]}
    assert stacks[
        ("verify", "hotstuff_tpu_torch/a.py:1:loop;hotstuff_tpu_torch/b.py:2:work")
    ] == 4
    assert stacks[("ingress", "hotstuff_tpu_torch/a.py:1:loop")] == 3
    # Drain is destructive: a second drain has nothing new.
    assert prof.drain_record() is None


def test_untagged_threads_sample_with_empty_stage():
    prof = pyprof.SamplingProfiler()
    prof.sample({999: _chain(("/r/hotstuff_tpu_torch/x.py", 5, "f"))})
    rec = prof.drain_record()
    assert rec["stacks"][0][0] == ""


def test_stack_table_overflow_is_counted_not_silent():
    prof = pyprof.SamplingProfiler(max_stacks=2)
    for i in range(5):
        prof.sample({1: _chain(("/r/hotstuff_tpu_torch/x.py", i, f"f{i}"))})
    assert prof.truncated == 3
    rec = prof.drain_record()
    overflow = [c for s, f, c in rec["stacks"] if f == "..."]
    assert overflow == [3]


def test_aggregate_self_cum_dedupes_recursion():
    self_c, cum_c = pyprof.aggregate_self_cum(
        [["", "a;b;a", 5], ["", "a;c", 2]]
    )
    assert self_c["a"] == 5  # leaf of the first stack
    assert self_c["c"] == 2
    assert cum_c["a"] == 7  # once per stack, not once per occurrence
    assert cum_c["b"] == 5


# -- stage tagging -----------------------------------------------------------


def test_stage_contextvar_survives_await_points():
    """The satellite contract: a task's stage (contextvar) is preserved
    across awaits and isolated from concurrently-running tasks."""

    seen: dict[str, list[str]] = {"a": [], "b": []}

    async def worker(name: str, stage_name: str):
        with pyprof.stage(stage_name):
            seen[name].append(pyprof.current_stage())
            await asyncio.sleep(0.01)  # the other task runs here
            seen[name].append(pyprof.current_stage())
        seen[name].append(pyprof.current_stage())

    async def main():
        await asyncio.gather(worker("a", "verify"), worker("b", "ingress"))

    asyncio.run(main())
    assert seen["a"] == ["verify", "verify", ""]
    assert seen["b"] == ["ingress", "ingress", ""]


def test_thread_stage_mirror_follows_set_stage():
    tid = threading.get_ident()
    token = pyprof.set_stage("fanin")
    assert pyprof._THREAD_STAGE[tid] == "fanin"
    pyprof.reset_stage(token)
    assert pyprof._THREAD_STAGE[tid] == ""


def test_core_marks_set_thread_stage(monkeypatch):
    """RoundTrace marks drive the per-thread tag (what the sampler
    reads) — the join key against the trace edges."""
    telemetry.reset_for_tests()
    telemetry.enable()
    try:
        trace = telemetry.round_trace(node="n0")
        monkeypatch.setattr(pyprof, "TAGGING", True)
        tid = threading.get_ident()
        trace.mark_propose(1)
        assert pyprof._THREAD_STAGE[tid] == "verify"
        trace.mark_verified(1)
        assert pyprof._THREAD_STAGE[tid] == "vote"
        trace.mark_vote(1)
        assert pyprof._THREAD_STAGE[tid] == "fanin"
        trace.mark_qc(1)
        assert pyprof._THREAD_STAGE[tid] == "qc_to_commit"
        trace.mark_commit(1)
        assert pyprof._THREAD_STAGE[tid] == "idle"
    finally:
        telemetry.reset_for_tests()


# -- live sessions -----------------------------------------------------------


def test_thread_mode_session_samples_all_threads():
    ready = threading.Event()
    stop = threading.Event()

    def busy():
        ready.set()
        while not stop.is_set():
            sum(range(200))

    t = threading.Thread(target=busy, daemon=True)
    t.start()
    ready.wait(1.0)
    prof = pyprof.SamplingProfiler(interval_ms=1.0)
    prof.start(mode="thread")
    assert pyprof.active() is prof
    assert pyprof.TAGGING
    time.sleep(0.08)
    prof.stop()
    stop.set()
    t.join(1.0)
    assert pyprof.active() is None
    assert not pyprof.TAGGING
    assert prof.samples >= 5
    rec = prof.drain_record(node="x")
    assert rec is not None and pyprof.validate_profile_record(rec) == []
    # The busy worker's frames must appear (all-thread sampling).
    assert any("busy" in folded for _s, folded, _c in rec["stacks"])


def test_second_session_is_rejected():
    prof = pyprof.SamplingProfiler()
    prof.start(mode="thread")
    try:
        with pytest.raises(RuntimeError):
            pyprof.SamplingProfiler().start(mode="thread")
    finally:
        prof.stop()


def test_ctypes_accounting_wraps_and_restores():
    calls = []

    class FakeLib:
        def hs_net_send(self, *args):  # pragma: no cover - replaced below
            raise AssertionError

    lib = FakeLib()

    def original(*args):
        calls.append(args)
        return 7

    lib.hs_net_send = original
    pyprof.register_ctypes_lib(lib, "hs_net", ["hs_net_send"])
    # Not wrapped until a session starts.
    assert lib.hs_net_send is original

    prof = pyprof.SamplingProfiler()
    prof.start(mode="thread", ctypes_accounting=True)
    try:
        assert lib.hs_net_send is not original
        assert lib.hs_net_send(1, 2) == 7
        assert lib.hs_net_send("x") == 7
    finally:
        prof.stop()
    # Restored, and the account kept.
    assert lib.hs_net_send is original
    stats = pyprof.ctypes_stats()
    assert stats["hs_net.hs_net_send"][0] == 2
    assert stats["hs_net.hs_net_send"][1] > 0
    assert calls == [(1, 2), ("x",)]
    # Collector view surfaces the same numbers.
    gauges = prof.collector()
    assert gauges["ctypes.hs_net.hs_net_send.calls"] == 2


def test_gil_delay_accumulates_on_late_ticks():
    prof = pyprof.SamplingProfiler(interval_ms=1.0)
    frame = _chain(("/r/hotstuff_tpu_torch/x.py", 1, "f"))
    prof.sample({1: frame}, now_ns=0)
    prof.sample({1: frame}, now_ns=5_000_000)  # 5 ms later: 4 ms late
    assert prof.gil_delay_ns == 4_000_000
    prof.sample({1: frame}, now_ns=6_000_000)  # on time: no growth
    assert prof.gil_delay_ns == 4_000_000


def test_emitter_interleaves_profile_records(tmp_path):
    from benchmark.logs import read_stream_records

    telemetry.reset_for_tests()
    telemetry.enable()
    try:
        prof = pyprof.SamplingProfiler()
        prof.sample({1: _chain(("/r/hotstuff_tpu_torch/x.py", 1, "f"))})
        path = tmp_path / "telemetry-x.jsonl"
        emitter = telemetry.TelemetryEmitter(
            telemetry.get_registry(), str(path), node="x", profiler=prof
        )
        emitter.emit()
        records = read_stream_records(str(path))
        assert len(records.snapshots) == 1
        assert len(records.profiles) == 1
        assert records.profiles[0]["node"] == "x"
    finally:
        telemetry.reset_for_tests()
