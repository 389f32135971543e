"""Continuous in-process sampling profiler: function-level attribution
joined onto the round-trace stages.

Causal tracing (``spans.py``) attributes milliseconds to cross-node *edges*
(ingress, vote_wire, qc_to_commit, ...); this module answers the next
question — WHICH FUNCTIONS burn that time — without the tracing
overhead multiplying asyncio's per-event cost the way cProfile does
(a traced N=40 committee cannot even form its mesh inside a CI window;
a 2 ms sampler costs ~0.3%).

One :class:`SamplingProfiler` per process walks **every** thread's stack
via ``sys._current_frames()`` on a ~2 ms cadence, driven either by
``SIGPROF``/``ITIMER_PROF`` (CPU-time ticks, main thread only holds the
handler) or by a daemon sampler thread (the fallback when signals are
unavailable — non-main-thread start, Windows, nested samplers). Each
sample is tagged with the sampled thread's **currently-active
round-trace stage**: ``consensus/core.py``'s event dispatch and the
RoundTrace marks set a contextvar (task-correct for ``current_stage()``
queries) mirrored into a thread-keyed table (what the sampler, running
on a different thread, can actually read). Folded stacks accumulate per
(stage, stack) and drain into the telemetry JSON-lines streams as
``hotstuff-profile-v1`` records alongside snapshots and traces;
``benchmark/profile_assemble.py`` joins them onto the trace edges.

Two boundary accounts ride along:

- **ctypes accounting**: the native planes register their CDLLs here
  (``register_ctypes_lib``); while a profiler session is active every
  ``hs_net_*``/``hs_ed25519_*`` entry point is wrapped to count calls
  and cumulative wall nanoseconds (the call itself releases the GIL;
  the measured span includes the GIL reacquisition on return — exactly
  the per-call toll a batched command ring would amortize).
  Zero cost when no session is active: the original function pointers
  are restored on ``stop()``.
- **GIL-delay proxy**: the sampler records how much later than
  scheduled each tick fired (``gil_delay_ns``). The handler/sampler
  thread can only run once it holds the GIL, so accumulated excess
  delay is a direct, if coarse, measure of how contended the GIL was —
  per-call ctypes wall time tells you *where*, this tells you *how
  much* overall.

Stage semantics on a shared event-loop thread (the one-process
committee): the thread-keyed tag is last-writer-wins across interleaved
engine tasks, so a sample taken during engine A's await may be tagged
by engine B's most recent mark. All engines do the same kind of work in
the same protocol phase, so per-stage attribution stays statistically
sound; per-task queries (``current_stage()``) use the contextvar and
are exact across await points.

Port copy of ``hotstuff_tpu/telemetry/profiler.py``. ``frame_id`` shortens
the port's own files to ``hotstuff_tpu_torch/...`` (the reference's marker
is its own package's).
"""

from __future__ import annotations

import os
import signal
import sys
import threading
import time
from collections import Counter
from contextlib import contextmanager
from contextvars import ContextVar

PROFILE_SCHEMA = "hotstuff-profile-v1"

DEFAULT_INTERVAL_MS = 2.0
DEFAULT_MAX_DEPTH = 48
#: distinct (stage, folded-stack) keys kept between drains; past this the
#: sample lands in the per-stage ``truncated`` bucket (counted, never
#: silent) so a pathological stack explosion cannot eat the heap.
DEFAULT_MAX_STACKS = 16_384

# -- stage tagging -----------------------------------------------------------

#: task-correct stage (exact across await points — contextvars follow the
#: asyncio task). Readable only from the owning task/thread.
_STAGE_VAR: ContextVar[str] = ContextVar("hotstuff_profile_stage", default="")
#: thread-keyed mirror the sampler reads cross-thread. Plain dict writes
#: are GIL-atomic; stale entries for dead threads are pruned at sample
#: time against sys._current_frames()'s live set.
_THREAD_STAGE: dict[int, str] = {}

#: module-level fast flag: tagging call sites in hot paths read this ONE
#: attribute and skip the set entirely when no profiler session is live.
TAGGING = False


def set_thread_stage(stage: str) -> None:
    """Point-set the calling thread's stage (the run-loop/mark hot path:
    no token, no restore — the next set wins)."""
    _THREAD_STAGE[threading.get_ident()] = stage


def set_stage(stage: str):
    """Scoped set: updates both the contextvar (task-correct) and the
    thread mirror; returns a token for :func:`reset_stage`."""
    token = _STAGE_VAR.set(stage)
    _THREAD_STAGE[threading.get_ident()] = stage
    return token


def reset_stage(token) -> None:
    _STAGE_VAR.reset(token)
    _THREAD_STAGE[threading.get_ident()] = _STAGE_VAR.get()


def current_stage() -> str:
    """The calling task's stage (contextvar — survives await points and
    is isolated between concurrently-running tasks)."""
    return _STAGE_VAR.get()


@contextmanager
def stage(name: str):
    token = set_stage(name)
    try:
        yield
    finally:
        reset_stage(token)


# -- frame folding -----------------------------------------------------------


#: code object -> rendered frame id. Code objects are stable for loaded
#: code and hashable; caching skips the string formatting on every
#: sampled frame (the sampler's hottest inner loop). Bounded defensively
#: against pathological code churn (exec-generated functions).
_CODE_ID_CACHE: dict[object, str] = {}
_CODE_ID_CACHE_CAP = 65_536


def frame_id(frame) -> str:
    """Compact stable id: repo-relative (or stdlib basename) file, first
    line of the function, function name."""
    code = frame.f_code
    fid = _CODE_ID_CACHE.get(code)
    if fid is not None:
        return fid
    fn = code.co_filename
    for marker in ("/hotstuff_tpu_torch/", "/benchmark/", "/tests/"):
        if marker in fn:
            fn = marker.strip("/") + "/" + fn.split(marker, 1)[1]
            break
    else:
        fn = os.path.basename(fn)
    fid = f"{fn}:{code.co_firstlineno}:{code.co_name}"
    if len(_CODE_ID_CACHE) < _CODE_ID_CACHE_CAP:
        _CODE_ID_CACHE[code] = fid
    return fid


def fold_stack(frame, max_depth: int = DEFAULT_MAX_DEPTH) -> str:
    """Root→leaf semicolon-folded stack (the flamegraph convention).
    Stacks deeper than ``max_depth`` keep the LEAF end (self-time blame
    must survive truncation) behind a ``...`` root marker."""
    names: list[str] = []
    f = frame
    while f is not None:
        names.append(frame_id(f))
        f = f.f_back
    # names is leaf→root; reverse to root→leaf.
    if len(names) > max_depth:
        return ";".join(["..."] + names[max_depth - 1 :: -1][-max_depth:])
    return ";".join(reversed(names))


# -- ctypes boundary accounting ---------------------------------------------

#: (lib, plane, names) registered by the native wrappers at load time.
_CTYPES_LIBS: list[tuple[object, str, tuple[str, ...]]] = []
#: name -> [calls, cumulative wall ns]; cells mutated GIL-atomically.
_CTYPES_STATS: dict[str, list[int]] = {}
_CTYPES_WRAPPED: list[tuple[object, str, object]] = []  # (lib, name, original)


def register_ctypes_lib(lib, plane: str, names: list[str]) -> None:
    """Called by the native wrappers (`network/native`, `crypto/
    native_ed25519`) after a CDLL loads: makes its entry points
    instrumentable. No wrapping happens here — only an active profiler
    session (``SamplingProfiler.start``) pays the per-call toll."""
    _CTYPES_LIBS.append((lib, plane, tuple(names)))
    if _ACTIVE is not None and _ACTIVE._ctypes:
        _wrap_lib(lib, plane, tuple(names))


def _make_ctypes_wrapper(name, fn, cell):
    def wrapper(*args):
        t0 = time.perf_counter_ns()
        try:
            return fn(*args)
        finally:
            cell[0] += 1
            cell[1] += time.perf_counter_ns() - t0

    # Rename the code object so stack samples taken INSIDE the native
    # call (C frames are invisible to the sampler; the wrapper is the
    # visible leaf) blame the named boundary — "ctypes:hs_net_send" —
    # instead of an anonymous "wrapper".
    wrapper.__code__ = wrapper.__code__.replace(co_name=f"ctypes:{name}")
    wrapper.__name__ = f"ctypes:{name}"
    wrapper.__wrapped__ = fn
    return wrapper


def _wrap_lib(lib, plane: str, names: tuple[str, ...]) -> None:
    for name in names:
        fn = getattr(lib, name, None)
        if fn is None or hasattr(fn, "__wrapped__"):
            continue
        cell = _CTYPES_STATS.setdefault(f"{plane}.{name}", [0, 0])
        setattr(lib, name, _make_ctypes_wrapper(name, fn, cell))
        _CTYPES_WRAPPED.append((lib, name, fn))


def _wrap_all_libs() -> None:
    for lib, plane, names in _CTYPES_LIBS:
        _wrap_lib(lib, plane, names)


def _unwrap_all_libs() -> None:
    while _CTYPES_WRAPPED:
        lib, name, fn = _CTYPES_WRAPPED.pop()
        setattr(lib, name, fn)


def ctypes_stats() -> dict[str, list[int]]:
    """``{plane.fn: [calls, wall_ns]}`` accumulated across sessions."""
    return {k: list(v) for k, v in _CTYPES_STATS.items() if v[0]}


# -- the sampler -------------------------------------------------------------

_ACTIVE: "SamplingProfiler | None" = None


def active() -> "SamplingProfiler | None":
    """The process's running profiler session, or None (what emitters
    attach to when asked to stream profile records)."""
    return _ACTIVE


def env_interval_ms() -> float:
    try:
        return float(os.environ.get("HOTSTUFF_PYPROF_INTERVAL_MS", ""))
    except ValueError:
        return DEFAULT_INTERVAL_MS


class SamplingProfiler:
    """All-thread sampling profiler with stage tagging. One instance may
    be active per process (``start`` raises otherwise)."""

    def __init__(
        self,
        interval_ms: float = DEFAULT_INTERVAL_MS,
        max_depth: int = DEFAULT_MAX_DEPTH,
        max_stacks: int = DEFAULT_MAX_STACKS,
    ) -> None:
        self.interval_ms = max(float(interval_ms), 0.1)
        self.max_depth = max_depth
        self.max_stacks = max_stacks
        self.mode: str | None = None
        # (stage, folded) -> samples, flushed to _drained on drain().
        self._counts: Counter[tuple[str, str]] = Counter()
        self._lock = threading.Lock()
        self.samples = 0
        self.truncated = 0  # samples folded into the overflow bucket
        self.contended = 0  # samples dropped: aggregation lock was held
        self.gil_delay_ns = 0
        self.threads_seen = 0  # thread count at the last sample
        self._last_tick_ns: int | None = None
        self._ctypes = False
        self._sampler_tid: int | None = None
        # tid -> (leaf frame object, folded stack). A frame's f_back
        # chain is fixed at creation, so an IDENTICAL leaf frame object
        # means an identical stack: blocked threads (crypto workers
        # parked on the fused-batch wait, the flusher between windows)
        # re-walk nothing — without this, sampling ~35 mostly-idle
        # threads per tick cost ~6% of an N=100 round instead of <1%.
        # Holding the frame ref is what makes the `is` check sound
        # (the object cannot be freed/reused while cached).
        self._frame_cache: dict[int, tuple] = {}
        self._stop_evt = threading.Event()
        self._thread: threading.Thread | None = None
        self._prev_handler = None
        self._drain_seq = 0
        self.started_ts: float | None = None

    # -- lifecycle --

    def start(self, mode: str = "auto", ctypes_accounting: bool = True) -> "SamplingProfiler":
        """Begin sampling. ``mode``: ``signal`` (ITIMER_PROF — CPU-time
        ticks, needs the main thread), ``thread`` (wall-clock daemon
        thread), or ``auto`` (signal when possible, else thread)."""
        global _ACTIVE, TAGGING
        if _ACTIVE is not None:
            raise RuntimeError("a SamplingProfiler session is already active")
        if mode == "auto":
            mode = (
                "signal"
                if threading.current_thread() is threading.main_thread()
                and hasattr(signal, "setitimer")
                else "thread"
            )
        if mode not in ("signal", "thread"):
            raise ValueError(f"unknown profiler mode {mode!r}")
        self.mode = mode
        self.started_ts = time.time()
        self._stop_evt.clear()
        self._last_tick_ns = None
        _ACTIVE = self
        TAGGING = True
        self._ctypes = ctypes_accounting
        if ctypes_accounting:
            _wrap_all_libs()
        if mode == "signal":
            self._prev_handler = signal.signal(signal.SIGPROF, self._on_sigprof)
            signal.setitimer(
                signal.ITIMER_PROF, self.interval_ms / 1e3, self.interval_ms / 1e3
            )
        else:
            self._thread = threading.Thread(
                target=self._run_thread, name="hotstuff-pyprof", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        global _ACTIVE, TAGGING
        if _ACTIVE is not self:
            return
        if self.mode == "signal":
            signal.setitimer(signal.ITIMER_PROF, 0, 0)
            if self._prev_handler is not None:
                signal.signal(signal.SIGPROF, self._prev_handler)
                self._prev_handler = None
        elif self.mode == "thread" and self._thread is not None:
            self._stop_evt.set()
            self._thread.join(timeout=2.0)
            self._thread = None
        _unwrap_all_libs()
        self._frame_cache.clear()  # release the held frame refs
        _ACTIVE = None
        TAGGING = False

    # -- sampling --

    def _on_sigprof(self, signum, frame) -> None:
        # ITIMER_PROF ticks on process CPU time — the delay proxy must
        # measure on the same clock or idle wall time masquerades as
        # GIL contention.
        now = time.process_time_ns()
        frames = sys._current_frames()
        main_tid = threading.main_thread().ident
        if frame is not None and main_tid is not None:
            # The interrupted frame, not the handler's own frames.
            frames[main_tid] = frame
        elif main_tid is not None:
            # Signal delivered with no Python frame current on the main
            # thread (inside a C call): _current_frames would show the
            # handler itself — drop the main thread from this sample.
            frames.pop(main_tid, None)
        self.sample(frames, now_ns=now)

    def _run_thread(self) -> None:
        self._sampler_tid = threading.get_ident()
        interval_s = self.interval_ms / 1e3
        while not self._stop_evt.wait(interval_s):
            self.sample(sys._current_frames(), now_ns=time.perf_counter_ns())

    def sample(self, frames: dict[int, object], now_ns: int | None = None) -> None:
        """Record one sample from ``frames`` (thread id -> top frame).
        Public and deterministic: tests drive it with synthetic frames.
        ``now_ns`` feeds the GIL-delay account; None skips it."""
        if now_ns is not None:
            if self._last_tick_ns is not None:
                gap = now_ns - self._last_tick_ns
                expected = int(self.interval_ms * 1e6)
                if gap > expected:
                    self.gil_delay_ns += gap - expected
            self._last_tick_ns = now_ns
        own = self._sampler_tid
        live: list[tuple[str, str]] = []
        cache = self._frame_cache
        for tid, frame in frames.items():
            if tid == own:
                continue
            cached = cache.get(tid)
            # Identity reuse is only sound for plain-function leaves: a
            # generator/coroutine frame (CO_GENERATOR|CO_COROUTINE|
            # CO_ASYNC_GENERATOR) keeps its identity across suspensions
            # but gets a NEW f_back on every resume.
            if (
                cached is not None
                and cached[0] is frame
                and not (frame.f_code.co_flags & 0x2A0)
            ):
                folded = cached[1]
            else:
                folded = fold_stack(frame, self.max_depth)
                cache[tid] = (frame, folded)
            live.append((_THREAD_STAGE.get(tid, ""), folded))
        # Prune stage tags / frame cache of exited threads (bounded by
        # live thread ids).
        if len(_THREAD_STAGE) > 4 * max(1, len(frames)):
            for tid in list(_THREAD_STAGE):
                if tid not in frames:
                    _THREAD_STAGE.pop(tid, None)
        if len(cache) > 4 * max(1, len(frames)):
            for tid in list(cache):
                if tid not in frames:
                    del cache[tid]
        # NEVER block here: in signal mode this runs in a SIGPROF handler
        # on the main thread, and the main thread may hold the lock in
        # drain_record — a blocking acquire would deadlock the process.
        # A contended tick is dropped and counted instead.
        if not self._lock.acquire(blocking=False):
            self.contended += 1
            return
        try:
            self.samples += 1
            self.threads_seen = len(live)
            for key in live:
                if key not in self._counts and len(self._counts) >= self.max_stacks:
                    self.truncated += 1
                    key = (key[0], "...")
                self._counts[key] += 1
        finally:
            self._lock.release()

    # -- output --

    def drain_record(self, node: str = "") -> dict | None:
        """One ``hotstuff-profile-v1`` line: the folded stacks recorded
        since the previous drain (delta — stacks are large and
        append-only, like trace events) plus cumulative session gauges.
        None when nothing was sampled since the last drain."""
        with self._lock:
            if not self._counts:
                return None
            stacks = [[s, f, c] for (s, f), c in self._counts.items()]
            self._counts.clear()
            seq = self._drain_seq
            self._drain_seq += 1
            samples = self.samples
            truncated = self.truncated
            gil_delay = self.gil_delay_ns
            threads = self.threads_seen
        stacks.sort(key=lambda e: (-e[2], e[0], e[1]))
        return {
            "schema": PROFILE_SCHEMA,
            "node": node,
            "pid": os.getpid(),
            "seq": seq,
            "ts": time.time(),
            "mode": self.mode,
            "interval_ms": self.interval_ms,
            "samples": samples,
            "truncated": truncated,
            "threads": threads,
            "gil_delay_ns": gil_delay,
            "ctypes": ctypes_stats(),
            "stacks": stacks,
        }

    def collector(self) -> dict[str, float]:
        """Registry-collector view (``telemetry.register_collector``):
        cumulative session gauges surfaced in every snapshot."""
        out: dict[str, float] = {
            "samples": self.samples,
            "truncated": self.truncated,
            "gil_delay_ns": self.gil_delay_ns,
        }
        for name, (calls, ns) in ctypes_stats().items():
            out[f"ctypes.{name}.calls"] = calls
            out[f"ctypes.{name}.ns"] = ns
        return out

    def stage_totals(self) -> dict[str, int]:
        """Undrained samples per stage tag (CLI breakdown tables)."""
        with self._lock:
            out: dict[str, int] = {}
            for (stage_name, _folded), c in self._counts.items():
                out[stage_name] = out.get(stage_name, 0) + c
        return out

    def self_cum(self) -> tuple[Counter, Counter, int]:
        """(self-sample counts, cumulative-sample counts, total samples)
        aggregated over the UNdrained stacks — the one aggregation the
        CLI report and tests share. A function appearing multiple times
        in one stack is counted once toward its cumulative total."""
        with self._lock:
            counts = dict(self._counts)
            total = self.samples
        return aggregate_self_cum(
            [(s, f, c) for (s, f), c in counts.items()]
        ) + (total,)


def aggregate_self_cum(stacks: list) -> tuple[Counter, Counter]:
    """Fold ``[stage, "a;b;c", count]`` records into per-function self
    (leaf) and cumulative (anywhere-on-stack, deduped) sample counts."""
    self_c: Counter[str] = Counter()
    cum_c: Counter[str] = Counter()
    for _stage, folded, count in stacks:
        frames = folded.split(";")
        self_c[frames[-1]] += count
        for name in set(frames):
            cum_c[name] += count
    return self_c, cum_c


def validate_profile_record(obj) -> list[str]:
    """Schema check mirroring ``validate_snapshot``; returns problems."""
    problems: list[str] = []
    if not isinstance(obj, dict):
        return [f"profile record is {type(obj).__name__}, not an object"]
    if obj.get("schema") != PROFILE_SCHEMA:
        problems.append(
            f"schema is {obj.get('schema')!r}, want {PROFILE_SCHEMA!r}"
        )
    for key, types in (
        ("node", str), ("pid", int), ("seq", int), ("ts", (int, float)),
        ("interval_ms", (int, float)), ("samples", int),
        ("gil_delay_ns", int), ("stacks", list),
    ):
        if not isinstance(obj.get(key), types):
            problems.append(f"field {key!r} missing or mistyped")
    for i, entry in enumerate(obj.get("stacks") or []):
        if (
            not isinstance(entry, (list, tuple))
            or len(entry) != 3
            or not isinstance(entry[0], str)
            or not isinstance(entry[1], str)
            or not isinstance(entry[2], int)
        ):
            problems.append(f"stack entry {i} malformed: {entry!r}")
            break
    return problems


def reset_for_tests() -> None:
    """Stop any session and clear module state (test isolation)."""
    global TAGGING
    if _ACTIVE is not None:
        _ACTIVE.stop()
    _unwrap_all_libs()
    _CTYPES_STATS.clear()
    _THREAD_STAGE.clear()
    TAGGING = False
