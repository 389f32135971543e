"""ctypes binding for the native C++ transport (``netcore.cpp``).

Port copy of ``hotstuff_tpu/network/native/__init__.py``, with the same
three abstractions as the asyncio implementation (Receiver +
MessageHandler, SimpleSender, ReliableSender) and identical wire behavior
(4-byte BE frames, handler-written ACKs, FIFO ACK pairing, backoff replay;
reference ``network/src/{receiver,simple_sender,reliable_sender}.rs``).
The hot path (socket IO, framing, reconnects) runs on one C++ epoll
thread; Python drains BATCHES of inbound events through a packed buffer
signalled by an eventfd that asyncio watches with ``loop.add_reader``.
It holds ``NativeTransport`` (the process-wide context, with the command
ring, ``HOTSTUFF_CMD_RING``, and the resolver worker), ``NativeReceiver``
(the vote pre-stage, ``dispatch_votes``/``dispatch_frames`` delivery and
the high/low water marks), ``NativeSimpleSender`` and
``NativeReliableSender``.

Selection: ``HOTSTUFF_NET=native`` routes the package-level
``Receiver``/``SimpleSender``/``ReliableSender`` names here (see
``network/__init__``). Where the reference falls back to asyncio when the
library cannot be built, the port raises.

The engine's source is the port's copy, ``network/native/netcore.cpp``,
built with g++ at first use into ``hotstuff_tpu_torch/_build/native-<key>/``
(``utils/kernel_build.build_native``), where the reference builds beside
its source. It reads the port's faultline plane
(``faultline.hooks.plane``) and reports to the port's telemetry (the
``net.native`` collector, the command ring's gauges and counters, and the
``hs_net`` entry points registered with the sampling profiler).
Left out: nothing. ``NativeReceiver.abort`` is the port's: the
synchronous teardown that ``Consensus.crash`` calls.
"""

from __future__ import annotations

import asyncio
import ctypes
import ipaddress
import logging
import os
import random
import socket
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from hotstuff_tpu_torch import telemetry
from hotstuff_tpu_torch.faultline import hooks as _faultline
from hotstuff_tpu_torch.telemetry import profiler as _pyprof
from hotstuff_tpu_torch.utils import kernel_build

log = logging.getLogger("network")

_SRC = Path(__file__).resolve().parent / "netcore.cpp"
_GXX_EXTRA = ("-pthread",)

PENDING_CAP = 1_000  # live reliable messages per peer before back-pressure
# Per-listener budget of frames emitted by the C++ loop but not yet
# dispatched by Python: past HIGH the loop stops reading the listener's
# sockets (kernel-buffer back-pressure reaches the peer, like the asyncio
# receiver's one-frame-per-dispatch bound); once dispatch progress brings
# it back to LOW it resumes. Enforced loop-side because a local flood is
# fully in the kernel before the Python loop even runs. Bounds
# Python-side memory against a flooding peer; read at spawn time.
RECV_HIGH_WATER = 4_096
RECV_LOW_WATER = 512
# Dispatch-progress report granularity (frames per hs_net_consumed call).
_CONSUMED_BATCH = 32

# How long a failed hostname lookup suppresses further getaddrinfo
# attempts before the next send retries it. Doubles per consecutive
# failure up to the cap. Lookups run on a dedicated worker thread (the
# event loop never blocks on the resolver), so the cap can be SHORT: a
# peer whose name resolves again is back within a minute, not ten
# (round-5 advisor finding — the old 600 s cap meant a transient
# resolver outage cost a correct peer for up to 10 minutes).
_RESOLVE_RETRY_S = 15.0
_RESOLVE_RETRY_MAX_S = 60.0
# Sends parked per unresolved hostname while its lookup is in flight;
# beyond this they drop (best-effort semantics, same as a down peer).
_RESOLVE_PARK_CAP = 1024

_EV_RECV = 1
_EV_ACKED = 2
_EV_GONE = 3
_EV_VOTE_BATCH = 4
_EV_RECV_BATCH = 5

# EV_RECV_BATCH payload record header: u64 LE conn_id | u32 LE frame len
# (followed by the frame bytes). One batch event carries every frame a
# listener's connections produced during one C++ poll cycle.
_BATCH_REC = struct.Struct("<QI")

# Command-ring record layouts (hs_net_cmds_flush). Little-endian, fixed
# headers; see netcore.cpp for the authoritative spec.
_RING_LID_U64 = struct.Struct("<BQQ")  # op 1 (set_round) / 2 (consumed)
_RING_SEND_HDR = struct.Struct("<BHBI")  # op 3: port, host_len, payload_len
_RING_BCAST_HDR = struct.Struct("<BHI")  # op 4: addrs_len, payload_len
_RING_VF_HDR = struct.Struct("<BQI")  # op 5: listener_id, payload_len
_RING_REPLY_HDR = struct.Struct("<BQI")  # op 6: conn_id, payload_len
_RING_RSEND_HDR = struct.Struct("<BHBQI")  # op 7: port, host_len, msg_id, plen
_RING_OP_SET_ROUND = 1
_RING_OP_CONSUMED = 2
_RING_OP_SEND = 3
_RING_OP_BROADCAST = 4
_RING_OP_VOTE_FILTER = 5
_RING_OP_REPLY = 6
_RING_OP_SEND_RELIABLE = 7
# Payloads above this ride the direct ctypes call even when the ring is
# on: the ring buys one crossing per loop iteration, but every ring byte
# is copied twice more (Python append + C++ parse), so for bulk frames
# (dataplane batches, ~387 KB) the copies dominate the crossing saved.
# ACKs and votes/proposals sit far below it.
_RING_PAYLOAD_MAX = 64 * 1024

# Fixed Vote wire frame length (consensus/messages.py layout) — the unit
# EV_VOTE_BATCH payloads are sliced into.
VOTE_WIRE_LEN = 137

_HDR = struct.Struct("<BQQI")  # type, a, b, payload_len


def _ensure_built() -> str:
    return str(kernel_build.build_native(_SRC, _GXX_EXTRA))


_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(_ensure_built())
        lib.hs_net_create.restype = ctypes.c_void_p
        lib.hs_net_create.argtypes = []
        lib.hs_net_destroy.restype = None
        lib.hs_net_destroy.argtypes = [ctypes.c_void_p]
        lib.hs_net_event_fd.restype = ctypes.c_int
        lib.hs_net_event_fd.argtypes = [ctypes.c_void_p]
        lib.hs_net_listen.restype = ctypes.c_int64
        lib.hs_net_listen.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint16, ctypes.c_int,
            ctypes.c_uint32, ctypes.c_uint32,
        ]
        lib.hs_net_consumed.restype = None
        lib.hs_net_consumed.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64
        ]
        lib.hs_net_set_vote_filter.restype = None
        lib.hs_net_set_vote_filter.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint32
        ]
        lib.hs_net_set_round.restype = None
        lib.hs_net_set_round.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64
        ]
        lib.hs_net_broadcast.restype = None
        lib.hs_net_broadcast.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
            ctypes.c_char_p, ctypes.c_uint32,
        ]
        lib.hs_net_faults.restype = None
        lib.hs_net_faults.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32
        ]
        lib.hs_net_close_listener.restype = None
        lib.hs_net_close_listener.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.hs_net_send.restype = None
        lib.hs_net_send.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint16,
            ctypes.c_char_p, ctypes.c_uint32, ctypes.c_int, ctypes.c_uint64,
        ]
        lib.hs_net_cancel.restype = None
        lib.hs_net_cancel.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.hs_net_pause_listener.restype = None
        lib.hs_net_pause_listener.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int
        ]
        lib.hs_net_reply.restype = None
        lib.hs_net_reply.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint32
        ]
        lib.hs_net_drain.restype = ctypes.c_int64
        lib.hs_net_drain.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32
        ]
        lib.hs_net_stats.restype = None
        lib.hs_net_stats.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)
        ]
        lib.hs_net_stats_ex.restype = ctypes.c_int
        lib.hs_net_stats_ex.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int
        ]
        lib.hs_net_cmds_flush.restype = ctypes.c_int64
        lib.hs_net_cmds_flush.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32
        ]
        # Make the hs_net_* boundary instrumentable: an active profiler
        # session wraps these entry points to count calls + wall ns (the
        # per-call ctypes/GIL toll); zero cost otherwise.
        _pyprof.register_ctypes_lib(
            lib,
            "hs_net",
            [
                "hs_net_send", "hs_net_broadcast", "hs_net_set_round",
                "hs_net_consumed", "hs_net_reply", "hs_net_cancel",
                "hs_net_drain", "hs_net_set_vote_filter",
                "hs_net_cmds_flush",
            ],
        )
        _lib = lib
    return _lib


# hs_net_stats_ex field order (new fields append; indices never move).
# The last six are the poll-loop timing account (cumulative; snapshot
# deltas give rates/means): time inside epoll_wait vs dispatching
# events, and how long commands sat in the queue before the loop
# serviced them — the C++ half of the ctypes-boundary latency the
# sampling profiler measures on the Python side.
STATS_FIELDS = (
    "pending", "inflight", "cancelled", "out_conns", "in_conns",
    "votes_batched", "votes_dropped", "votes_dropped_dup",
    "frames_rx", "bytes_rx", "frames_tx", "bytes_tx",
    "writev_calls", "send_drops", "faults_dropped", "faults_delayed",
    "loop_polls", "poll_ns", "dispatch_ns",
    "cmds_serviced", "cmd_service_ns", "cmd_service_max_ns",
    # Batched-ingress account — dotted names so the stats collector
    # surfaces them as net.native.ingress.* gauges (docs/telemetry.md):
    # reads = recv() syscalls, frames = frames via EV_RECV_BATCH,
    # batches = batch events (frames/batches = frames per wakeup).
    "ingress.reads", "ingress.frames", "ingress.batches",
)

# Rate limit for the loop-side drop warnings (satellite: silent filtering
# must be diagnosable without a debugger, but a flood of drops must not
# become a flood of log lines).
_DROP_WARN_INTERVAL_S = 10.0


class NativeTransport:
    """Process-wide bridge to one C++ epoll context.

    Listener registrations and outgoing connections live for the process;
    the eventfd reader rebinds to whichever event loop is currently
    running (tests run many short loops)."""

    _instance: "NativeTransport | None" = None

    def __init__(self) -> None:
        self._lib = _load()
        self._ctx = self._lib.hs_net_create()
        self._efd = self._lib.hs_net_event_fd(self._ctx)
        self._buf = ctypes.create_string_buffer(4 * 1024 * 1024)
        self._loop: asyncio.AbstractEventLoop | None = None
        self._next_msg_id = 1
        # listener_id -> (queue of (conn_id, frame), dispatch task owner)
        self._listeners: dict[int, "NativeReceiver"] = {}
        self._acks: dict[int, asyncio.Future] = {}
        # Bumped whenever the reader rebinds to a new event loop: senders
        # compare against it to reset per-peer back-pressure counters
        # whose futures were dropped with the old loop.
        self.generation = 0
        self._resolved: dict[str, str] = {}  # hostname -> IPv4 literal
        # hostname -> (monotonic deadline to retry a failed lookup,
        # backoff used for the NEXT failure). Negative results must not
        # be permanent — a resolver down at boot would cost a correct
        # peer for the whole process lifetime — but retries back off so
        # a persistently-bad name isn't looked up on every send.
        self._resolve_retry_at: dict[str, tuple[float, float]] = {}
        # getaddrinfo runs on this worker, NEVER on the event-loop thread
        # (a dropping resolver blocks ~10 s per call — with the short
        # 60 s retry cap that would stall the loop every minute). Sends
        # to a not-yet-resolved name park here and are flushed by the
        # worker (hs_net_send is thread-safe: the C++ command queue is
        # mutex-guarded).
        self._resolve_lock = threading.Lock()
        self._resolve_pool: ThreadPoolExecutor | None = None
        self._parked_sends: dict[str, list[tuple[int, bytes, bool, int]]] = {}
        # Drop diagnosability: last counters the rate-limited warning saw,
        # and the next time _on_events may poll stats for it.
        self._drop_warn_seen = {"filtered": 0, "send_drops": 0}
        self._drop_warn_at = 0.0
        self._drop_poll_at = time.monotonic() + _DROP_WARN_INTERVAL_S
        # Command ring: loop-thread callers append fixed-layout records
        # here instead of making one ctypes crossing (with its GIL
        # release/reacquire) per command; ONE hs_net_cmds_flush per
        # event-loop iteration ships the lot. At N=200 the per-round
        # hs_net_set_round/hs_net_send crossings alone were 85% of the
        # vote edge (results/profile-attribution-200.json) — the ring
        # collapses ~N crossings per round into one. Off-loop callers
        # (resolver worker, telemetry threads) keep the direct calls.
        self._ring_enabled = os.environ.get("HOTSTUFF_CMD_RING", "1") != "0"
        self._ring = bytearray()
        self._ring_records = 0
        self._ring_scheduled = False
        self._ring_metrics_live = None
        # Plain lifetime totals (tests/diagnostics; the telemetry mirror
        # only records when the plane is enabled).
        self.ring_flushes = 0
        self.ring_total_records = 0
        # Telemetry: the engine's counters surface as gauges behind the
        # registry's one snapshot call (collector polls stats() lazily).
        telemetry.register_collector("net.native", self.stats)

    @classmethod
    def get(cls) -> "NativeTransport":
        if cls._instance is None:
            cls._instance = cls()
        inst = cls._instance
        inst._bind_loop()
        return inst

    @classmethod
    def get_if_live(cls) -> "NativeTransport | None":
        """The process transport if one exists, WITHOUT binding it to a
        loop — safe to call outside any event loop (tests/diagnostics)."""
        return cls._instance

    def _bind_loop(self) -> None:
        loop = asyncio.get_running_loop()
        if self._loop is loop:
            return
        prev = self._loop
        if prev is not None and not prev.is_closed():
            try:
                prev.remove_reader(self._efd)
            except Exception:  # noqa: BLE001 — loop may be tearing down
                pass
        # Records parked behind a dead loop's never-run flush callback
        # must not be lost (tests run many short loops): ship them now.
        if self._ring_records:
            self._flush_cmd_ring()
        # A previous loop is gone (tests): its futures can never be
        # awaited again. Cancel their ids in the C++ layer — otherwise the
        # orphaned inflight entries would FIFO-consume ACKs meant for new
        # messages on the same connection — and drop them here.
        for mid in self._acks:
            self._lib.hs_net_cancel(self._ctx, ctypes.c_uint64(mid))
        self._acks.clear()
        self.generation += 1
        self._loop = loop
        loop.add_reader(self._efd, self._on_events)

    # -- called by senders/receivers --

    def alloc_msg_id(self) -> int:
        mid = self._next_msg_id
        self._next_msg_id += 1
        return mid

    # -- command ring --

    def _ring_push(self, rec: bytes) -> bool:
        """Append one record to the command ring and make sure a flush is
        scheduled for the next event-loop iteration. Returns False when
        the caller must fall back to its direct ctypes call: ring
        disabled, no bound loop, or the calling thread is not the loop's
        (the ring buffer is loop-thread-only by design — a lock here
        would reintroduce the contention the ring removes)."""
        loop = self._loop
        if not self._ring_enabled or loop is None or loop.is_closed():
            return False
        try:
            if asyncio.get_running_loop() is not loop:
                return False
        except RuntimeError:
            return False
        self._ring += rec
        self._ring_records += 1
        if not self._ring_scheduled:
            self._ring_scheduled = True
            # call_soon lands AFTER the currently-draining ready batch:
            # every command appended during this loop iteration rides the
            # same flush.
            loop.call_soon(self._flush_cmd_ring)
        return True

    def _flush_cmd_ring(self) -> None:
        self._ring_scheduled = False
        n = self._ring_records
        if not n:
            return
        buf = bytes(self._ring)
        self._ring.clear()
        self._ring_records = 0
        self._lib.hs_net_cmds_flush(self._ctx, buf, len(buf))
        self.ring_flushes += 1
        self.ring_total_records += n
        if self._ring_metrics_live != telemetry.enabled():
            self._ring_metrics_live = telemetry.enabled()
            self._g_ring_depth = telemetry.gauge("net.native.cmd_ring_depth")
            self._m_ring_flushes = telemetry.counter(
                "net.native.cmd_ring.flushes"
            )
            self._m_ring_records = telemetry.counter(
                "net.native.cmd_ring.records"
            )
        self._g_ring_depth.set(n)
        self._m_ring_flushes.inc()
        self._m_ring_records.inc(n)

    def _resolve_fast(self, host: str) -> str | None:
        """Non-blocking resolution: IPv4 literals and cached names only.
        Returns the literal, or None when the name is unknown (caller
        decides whether to park the send and kick the worker)."""
        cached = self._resolved.get(host)
        if cached is not None:
            return cached
        try:
            ipaddress.IPv4Address(host)
        except ValueError:
            return None
        self._resolved[host] = host
        return host

    def _resolve_blocking(self, host: str) -> str | None:
        """One getaddrinfo for ``host``, honoring the negative-cache
        backoff. BLOCKING — runs on the resolver worker (or synchronously
        at listen/startup time, where a stalled loop cannot exist yet).
        Failed lookups are cached only for ``_RESOLVE_RETRY_S`` seconds
        (doubling per consecutive failure, capped at 60 s): a transient
        resolver outage must not permanently cost a correct peer."""
        fast = self._resolve_fast(host)
        if fast is not None:
            return fast
        deadline, _ = self._resolve_retry_at.get(host, (0.0, 0.0))
        if time.monotonic() < deadline:
            return None  # negative entry still fresh: don't re-query
        try:
            infos = socket.getaddrinfo(
                host, None, socket.AF_INET, socket.SOCK_STREAM
            )
            addr = infos[0][4][0]
        except OSError as exc:
            _, backoff = self._resolve_retry_at.get(
                host, (0.0, _RESOLVE_RETRY_S)
            )
            log.warning(
                "native transport cannot resolve %r (%s): "
                "dropping sends to it for the next %ds", host, exc,
                int(backoff),
            )
            self._resolve_retry_at[host] = (
                time.monotonic() + backoff,
                min(backoff * 2, _RESOLVE_RETRY_MAX_S),
            )
            return None
        self._resolved[host] = addr
        self._resolve_retry_at.pop(host, None)  # reset failure backoff
        return addr

    def _park_send(
        self, host: str, port: int, data: bytes, reliable: bool, msg_id: int
    ) -> None:
        """Queue a send behind its hostname's in-flight lookup and make
        sure a worker lookup is scheduled. The worker flushes (or drops)
        the parked sends when the lookup settles."""
        with self._resolve_lock:
            parked = self._parked_sends.get(host)
            first = parked is None
            if first:
                parked = self._parked_sends[host] = []
            if len(parked) < _RESOLVE_PARK_CAP:
                parked.append((port, data, reliable, msg_id))
            if self._resolve_pool is None:
                self._resolve_pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="hsnet-dns"
                )
        if first:
            self._resolve_pool.submit(self._resolve_and_flush, host)

    def _resolve_and_flush(self, host: str) -> None:
        # Worker thread. A still-backing-off name resolves to None and
        # its parked sends drop — observably a down peer, exactly the
        # asyncio transport's retry-forever behavior from the caller's
        # side (reliable ACK futures stay pending until cancelled).
        try:
            addr = self._resolve_blocking(host)
        except Exception:  # noqa: BLE001 — never kill the worker
            log.exception("resolver worker failed for %r", host)
            addr = None
        with self._resolve_lock:
            parked = self._parked_sends.pop(host, [])
        if addr is None:
            return
        for port, data, reliable, msg_id in parked:
            self._lib.hs_net_send(
                self._ctx, addr.encode(), ctypes.c_uint16(port),
                data, len(data), int(reliable), ctypes.c_uint64(msg_id),
            )

    def listen(
        self, receiver: "NativeReceiver", host: str, port: int, auto_ack: bool
    ) -> int:
        # Startup path: blocking resolution is fine (no live loop traffic
        # behind us) and listen errors must be synchronous.
        resolved = self._resolve_blocking(host)
        if resolved is None:
            raise OSError(f"cannot resolve listen address {host!r}")
        lid = self._lib.hs_net_listen(
            self._ctx, resolved.encode(), ctypes.c_uint16(port),
            int(auto_ack),
            ctypes.c_uint32(RECV_HIGH_WATER), ctypes.c_uint32(RECV_LOW_WATER),
        )
        if lid < 0:
            raise OSError(-lid, os.strerror(-lid))
        self._listeners[lid] = receiver
        return lid

    def consumed(self, lid: int, n: int) -> None:
        if self._ring_push(_RING_LID_U64.pack(_RING_OP_CONSUMED, lid, n)):
            return
        self._lib.hs_net_consumed(
            self._ctx, ctypes.c_uint64(lid), ctypes.c_uint64(n)
        )

    def close_listener(self, lid: int) -> None:
        self._listeners.pop(lid, None)
        self._lib.hs_net_close_listener(self._ctx, ctypes.c_uint64(lid))

    def pause_listener(self, lid: int, paused: bool) -> None:
        self._lib.hs_net_pause_listener(
            self._ctx, ctypes.c_uint64(lid), int(paused)
        )

    def set_vote_filter(self, lid: int, authors: list[bytes]) -> None:
        """Push the committee table down to the C++ vote pre-stage."""
        packed = b"".join(authors)
        assert len(packed) == 32 * len(authors), "authors must be 32-byte keys"
        if self._ring_push(
            _RING_VF_HDR.pack(_RING_OP_VOTE_FILTER, lid, len(packed)) + packed
        ):
            return
        self._lib.hs_net_set_vote_filter(
            self._ctx, ctypes.c_uint64(lid), packed, len(authors)
        )

    def set_round(self, lid: int, round_: int) -> None:
        if self._ring_push(_RING_LID_U64.pack(_RING_OP_SET_ROUND, lid, round_)):
            return
        self._lib.hs_net_set_round(
            self._ctx, ctypes.c_uint64(lid), ctypes.c_uint64(round_)
        )

    def set_faults(self, rules, seed: int = 0) -> None:
        """Install the engine's test-only per-peer fault table
        (``hs_net_faults``): ``rules`` maps ``(host, port)`` to
        ``(drop_ppm, delay_ms)``; an empty mapping clears it. Applies to
        best-effort frames only — the chaos plane's hook into the native
        egress path (broadcast coalescing, writev pump, vote fan-in)."""
        tokens = [f"seed:{seed}"] if seed else []
        for (host, port), (drop_ppm, delay_ms) in rules.items():
            resolved = self._resolve_fast(host) or host
            tokens.append(f"{resolved}:{port}:{int(drop_ppm)}:{int(delay_ms)}")
        spec = " ".join(tokens).encode()
        self._lib.hs_net_faults(self._ctx, spec, len(spec))

    def stats(self) -> dict[str, int]:
        """Loop-thread state snapshot (tests / telemetry / ops). One call
        exports every engine counter; also drives the rate-limited drop
        warnings (any periodic reader — telemetry emitter, event pump —
        keeps drop diagnosability alive)."""
        out = (ctypes.c_uint64 * len(STATS_FIELDS))()
        n = self._lib.hs_net_stats_ex(self._ctx, out, len(STATS_FIELDS))
        result = {name: out[i] for i, name in enumerate(STATS_FIELDS[:n])}
        self._warn_on_drops(result)
        return result

    def _warn_on_drops(self, stats: dict[str, int]) -> None:
        """Log (rate-limited) when the vote pre-stage starts FILTERING
        votes (seat/round rejections — dedup of identical resends is
        routine and only reported alongside) or per-peer back-pressure
        starts dropping best-effort sends. Without this, a misconfigured
        committee table or saturated peer silently eats frames that only
        a debugger attached to the C++ loop would reveal."""
        filtered = stats.get("votes_dropped", 0) - stats.get(
            "votes_dropped_dup", 0
        )
        send_drops = stats.get("send_drops", 0)
        seen = self._drop_warn_seen
        d_filtered = filtered - seen["filtered"]
        d_sends = send_drops - seen["send_drops"]
        if d_filtered <= 0 and d_sends <= 0:
            return
        now = time.monotonic()
        if now - self._drop_warn_at < _DROP_WARN_INTERVAL_S:
            return
        self._drop_warn_at = now
        seen["filtered"] = filtered
        seen["send_drops"] = send_drops
        if d_filtered > 0:
            log.warning(
                "native vote pre-stage filtered %d vote frame(s) since the "
                "last report (unknown seat or out-of-window round; %d "
                "identical-resend dedups total): check committee table / "
                "round sync if unexpected",
                d_filtered,
                stats.get("votes_dropped_dup", 0),
            )
        if d_sends > 0:
            log.warning(
                "native transport dropped %d best-effort send(s) at "
                "per-peer back-pressure caps since the last report "
                "(slow or dead peer)",
                d_sends,
            )

    def send(
        self, address: tuple[str, int], data: bytes,
        reliable: bool = False, msg_id: int = 0,
    ) -> None:
        host, port = address
        resolved = self._resolve_fast(host)
        if resolved is None:
            # Unknown hostname: park behind a worker-thread lookup (the
            # event loop must never block on getaddrinfo). If the name
            # stays bad the parked sends drop — observably a down peer;
            # reliable ACK futures stay pending until the caller cancels.
            self._park_send(host, port, data, reliable, msg_id)
            return
        if len(data) <= _RING_PAYLOAD_MAX:
            # Small frames ride the command ring — best-effort AND
            # reliable. Reliable sends were originally kept direct
            # ("proposals are one frame per round"), but the dataplane's
            # batch dissemination is reliable at rate: at large-frame
            # load the per-send crossing + loop wake was the measured
            # gap vs asyncio (benchmark/netplane_frames.py). The ACK
            # future is registered by the caller before this returns,
            # and ring flushes run before any subsequent drain of the
            # ACK event, so pairing is unchanged. Bulk frames above
            # _RING_PAYLOAD_MAX keep the direct call (copy-dominated).
            rhost = resolved.encode()
            if not reliable and msg_id == 0:
                rec = (
                    _RING_SEND_HDR.pack(
                        _RING_OP_SEND, port, len(rhost), len(data)
                    )
                    + rhost
                    + data
                )
            else:
                rec = (
                    _RING_RSEND_HDR.pack(
                        _RING_OP_SEND_RELIABLE, port, len(rhost),
                        msg_id, len(data),
                    )
                    + rhost
                    + data
                )
            if self._ring_push(rec):
                return
        self._lib.hs_net_send(
            self._ctx, resolved.encode(), ctypes.c_uint16(port),
            data, len(data), int(reliable), ctypes.c_uint64(msg_id),
        )

    def broadcast(
        self, addresses: list[tuple[str, int]], data: bytes
    ) -> None:
        """Best-effort fan-out: ONE command into the loop thread; the C++
        side builds the frame once and queues it per peer."""
        tokens = []
        for host, port in addresses:
            resolved = self._resolve_fast(host)
            if resolved is None:
                self._park_send(host, port, data, False, 0)
                continue
            tokens.append(f"{resolved}:{port}")
        if not tokens:
            return
        packed = " ".join(tokens).encode()
        # Ring record caps the address list at u16 (fits ~2,900 resolved
        # IPv4 peers); anything larger takes the direct call.
        if len(packed) <= 0xFFFF and self._ring_push(
            _RING_BCAST_HDR.pack(_RING_OP_BROADCAST, len(packed), len(data))
            + packed
            + data
        ):
            return
        self._lib.hs_net_broadcast(
            self._ctx, packed, len(packed), data, len(data)
        )

    def cancel(self, msg_id: int) -> None:
        self._lib.hs_net_cancel(self._ctx, ctypes.c_uint64(msg_id))

    def reply(self, conn_id: int, data: bytes) -> None:
        # ACKs are tiny and per-frame — the highest-frequency crossing on
        # a busy receiver; ride the ring (one flush per loop iteration).
        if len(data) <= _RING_PAYLOAD_MAX and self._ring_push(
            _RING_REPLY_HDR.pack(_RING_OP_REPLY, conn_id, len(data)) + data
        ):
            return
        self._lib.hs_net_reply(
            self._ctx, ctypes.c_uint64(conn_id), data, len(data)
        )

    # -- event pump --

    def _on_events(self) -> None:
        try:
            os.read(self._efd, 8)  # clear the signal
        except BlockingIOError:
            pass
        # Periodic drop check even when nothing else reads stats(): one
        # loop-thread round trip (microseconds) at most once per warning
        # interval, piggybacked on event activity.
        now = time.monotonic()
        if now >= self._drop_poll_at:
            self._drop_poll_at = now + _DROP_WARN_INTERVAL_S
            self.stats()
        while True:
            n = self._lib.hs_net_drain(self._ctx, self._buf, len(self._buf))
            if n < 0:
                # One event larger than the buffer: grow to fit and retry.
                self._buf = ctypes.create_string_buffer(-n)
                continue
            if n == 0:
                break
            view = memoryview(self._buf)[:n]
            off = 0
            while off < n:
                etype, a, b, plen = _HDR.unpack_from(view, off)
                off += _HDR.size
                payload = bytes(view[off : off + plen])
                off += plen
                if etype == _EV_RECV:
                    receiver = self._listeners.get(a)
                    if receiver is not None:
                        receiver._enqueue(b, payload)
                elif etype == _EV_RECV_BATCH:
                    receiver = self._listeners.get(a)
                    if receiver is not None:
                        receiver._enqueue_frames(b, payload)
                elif etype == _EV_VOTE_BATCH:
                    receiver = self._listeners.get(a)
                    if receiver is not None:
                        receiver._enqueue_votes(b, payload)
                elif etype == _EV_ACKED:
                    fut = self._acks.pop(a, None)
                    if fut is not None and not fut.done():
                        fut.set_result(payload)
                elif etype == _EV_GONE and b == 0:
                    # conn_id 0 marks the LISTENER itself gone (an
                    # add-listener stranded by engine shutdown closed the
                    # fd loop-side): drop the phantom id so Python stops
                    # tracking a listener that can never emit again.
                    self._listeners.pop(a, None)
                # _EV_GONE with a real conn_id: inbound connection
                # closed — nothing to do; receivers are connectionless
                # from Python's view.


class _NativeFramedWriter:
    """Reply channel handed to ``MessageHandler.dispatch`` — writes ACKs
    back on the inbound connection (via the C++ loop)."""

    __slots__ = ("_transport", "_conn_id")

    def __init__(self, transport: NativeTransport, conn_id: int) -> None:
        self._transport = transport
        self._conn_id = conn_id

    async def send(self, payload: bytes) -> None:
        self._transport.reply(self._conn_id, payload)


class _AckedWriter:
    """Writer for auto-ack listeners: the transport already ACKed on
    frame arrival, so the handler's own ``writer.send(b"Ack")`` must
    become a no-op (a second ACK would mispair the sender's FIFO ACK
    accounting). Handlers only ever reply with the literal ACK frame."""

    __slots__ = ()

    async def send(self, payload: bytes) -> None:
        pass


class NativeReceiver:
    """Drop-in for ``network.Receiver``: one dispatch task drains the
    inbound frame queue sequentially (actor semantics preserved).

    With a vote pre-stage configured (``configure_vote_prestage``), the
    C++ loop delivers pre-validated votes as aggregated batches; the
    dispatch task hands each batch to ``handler.dispatch_votes`` (falling
    back to per-frame ``dispatch`` for handlers without one).

    General inbound frames arrive the same way (EV_RECV_BATCH: one
    aggregated event per poll cycle, conn ids preserved per record); a
    handler exposing ``dispatch_frames(pairs)`` receives the whole
    ``[(writer, frame), ...]`` list per wakeup, others degrade to
    per-frame ``dispatch``."""

    def __init__(
        self, address: tuple[str, int], handler, auto_ack: bool = False
    ) -> None:
        self.address = address
        self.handler = handler
        self.auto_ack = auto_ack
        self._transport: NativeTransport | None = None
        self._lid: int | None = None
        # ("frame", conn_id, frame) | ("votes", count, packed_frames)
        self._queue: asyncio.Queue[tuple[str, int, bytes]] = asyncio.Queue()
        self._task: asyncio.Task | None = None

    @classmethod
    async def spawn(
        cls, address: tuple[str, int], handler, auto_ack: bool = False
    ) -> "NativeReceiver":
        self = cls(address, handler, auto_ack)
        self._transport = NativeTransport.get()
        host, port = address
        self._lid = self._transport.listen(self, host, port, auto_ack)
        self._task = asyncio.create_task(self._dispatch_loop())
        log.debug(
            "native listener on %s:%d%s",
            host, port, " (auto-ack)" if auto_ack else "",
        )
        return self

    def _enqueue(self, conn_id: int, frame: bytes) -> None:
        self._queue.put_nowait(("frame", conn_id, frame))

    def _enqueue_votes(self, count: int, packed: bytes) -> None:
        self._queue.put_nowait(("votes", count, packed))

    def _enqueue_frames(self, count: int, packed: bytes) -> None:
        """One poll cycle's aggregated general-ingress frames
        (EV_RECV_BATCH): ``packed`` is ``count`` records of
        ``[u64 conn_id | u32 len | frame]``. One queue put per cycle."""
        self._queue.put_nowait(("frames", count, packed))

    def configure_vote_prestage(self, authors: list[bytes]) -> None:
        """Enable the C++ vote pre-stage with the committee's 32-byte
        public keys (seat table). Votes are then length-validated,
        seat-checked, round-gated and deduped on the loop thread and
        delivered as aggregated batches — a filter only; full Signature
        verification stays in the consensus core."""
        self._transport.set_vote_filter(self._lid, authors)

    def set_round(self, round_: int) -> None:
        """Advance the pre-stage's stale-round cutoff (call on round
        advance; monotonic)."""
        self._transport.set_round(self._lid, round_)

    async def _dispatch_loop(self) -> None:
        acked = _AckedWriter()
        undisclosed = 0  # dispatched frames not yet reported to the loop
        while True:
            if undisclosed and (
                undisclosed >= _CONSUMED_BATCH or self._queue.empty()
            ):
                self._transport.consumed(self._lid, undisclosed)
                undisclosed = 0
            kind, a, payload = await self._queue.get()
            if kind == "votes":
                frames = [
                    payload[i : i + VOTE_WIRE_LEN]
                    for i in range(0, len(payload), VOTE_WIRE_LEN)
                ]
                dispatch_votes = getattr(self.handler, "dispatch_votes", None)
                try:
                    if dispatch_votes is not None:
                        await dispatch_votes(frames)
                    else:
                        # Handler without a batch path: degrade to the
                        # per-frame contract (votes only arrive on
                        # auto-ack listeners, so the writer is a no-op).
                        for frame in frames:
                            await self.handler.dispatch(acked, frame)
                except Exception:
                    log.exception(
                        "vote batch handler error (native receiver %s)",
                        self.address,
                    )
                undisclosed += len(frames)
                continue
            if kind == "frames":
                # Aggregated general ingress: decode the cycle's records,
                # hand the handler the whole list per wakeup
                # (``dispatch_frames``; per-frame ``dispatch`` fallback).
                batch: list[tuple[int, bytes]] = []
                off = 0
                end = len(payload)
                while off + 12 <= end:
                    cid, flen = _BATCH_REC.unpack_from(payload, off)
                    off += 12
                    batch.append((cid, payload[off : off + flen]))
                    off += flen
                plane = _faultline.plane
                if plane is not None:
                    kept: list[tuple[int, bytes]] = []
                    for cid, frame in batch:
                        plan = plane.filter_recv(self.address)
                        if plan is not None:
                            f_action, f_delay = plan
                            if f_delay > 0:
                                await asyncio.sleep(f_delay)
                            if f_action == "drop":
                                continue
                        kept.append((cid, frame))
                    batch = kept
                if batch:
                    writers: dict[int, object] = {}
                    pairs = []
                    for cid, frame in batch:
                        if self.auto_ack:
                            writer = acked
                        else:
                            writer = writers.get(cid)
                            if writer is None:
                                writer = writers[cid] = _NativeFramedWriter(
                                    self._transport, cid
                                )
                        pairs.append((writer, frame))
                    dispatch_frames = getattr(
                        self.handler, "dispatch_frames", None
                    )
                    try:
                        if dispatch_frames is not None:
                            await dispatch_frames(pairs)
                        else:
                            for writer, frame in pairs:
                                await self.handler.dispatch(writer, frame)
                    except Exception:
                        log.exception(
                            "frame batch handler error (native receiver %s)",
                            self.address,
                        )
                # The C++ budget charged every frame, dropped or not.
                undisclosed += a
                continue
            conn_id = a
            # Faultline ingress filter (``side: "recv"`` rules). The C++
            # loop already ACKed auto-ack frames on arrival, so a drop
            # here models app-level ingress loss (frame read off the
            # wire, then eaten before dispatch).
            plane = _faultline.plane
            if plane is not None:
                plan = plane.filter_recv(self.address)
                if plan is not None:
                    f_action, f_delay = plan
                    if f_delay > 0:
                        await asyncio.sleep(f_delay)
                    if f_action == "drop":
                        undisclosed += 1
                        continue
            writer = (
                acked if self.auto_ack
                else _NativeFramedWriter(self._transport, conn_id)
            )
            try:
                await self.handler.dispatch(writer, payload)
            except Exception:
                log.exception("handler error (native receiver %s)", self.address)
            undisclosed += 1

    def abort(self) -> None:
        """Stop at once, as a process crash would: the dispatch task is
        cancelled and the listener closed before this returns, so no frame
        reaches the handler after it (``Consensus.crash``)."""
        if self._task is not None:
            self._task.cancel()
        if self._transport is not None and self._lid is not None:
            self._transport.close_listener(self._lid)
            self._lid = None

    async def shutdown(self) -> None:
        self.abort()


class NativeSimpleSender:
    """Drop-in for ``network.SimpleSender`` (best-effort, fire-and-forget)."""

    def __init__(self) -> None:
        self._rng = random.Random()

    def send(self, address: tuple[str, int], data: bytes) -> None:
        transport = NativeTransport.get()
        plane = _faultline.plane
        if plane is not None:
            plan = plane.filter_send(address, data)
            if plan is not None:
                action, delay, copies = plan
                if action == "drop":
                    return
                loop = asyncio.get_running_loop()
                for _ in range(copies):
                    loop.call_later(delay, transport.send, address, data)
                return
        transport.send(address, data, reliable=False)

    def broadcast(self, addresses: list[tuple[str, int]], data: bytes) -> None:
        # Coalesced: one command into the loop thread, one frame build.
        transport = NativeTransport.get()
        plane = _faultline.plane
        if plane is not None:
            # Per-link faults split the fan-out: untouched peers keep the
            # coalesced single-command path; dropped peers vanish; delayed
            # or duplicated peers are re-issued individually.
            clean: list[tuple[str, int]] = []
            loop = None
            for addr in addresses:
                plan = plane.filter_send(addr, data)
                if plan is None:
                    clean.append(addr)
                    continue
                action, delay, copies = plan
                if action == "drop":
                    continue
                if loop is None:
                    loop = asyncio.get_running_loop()
                for _ in range(copies):
                    loop.call_later(delay, transport.send, addr, data)
            if clean:
                transport.broadcast(clean, data)
            return
        transport.broadcast(addresses, data)

    def lucky_broadcast(
        self, addresses: list[tuple[str, int]], data: bytes, nodes: int
    ) -> None:
        picked = self._rng.sample(addresses, min(nodes, len(addresses)))
        self.broadcast(picked, data)

    def shutdown(self) -> None:
        pass  # connections are owned by the process-wide transport


class NativeReliableSender:
    """Drop-in for ``network.ReliableSender``: ``send`` returns a future
    resolved with the peer's ACK bytes; cancellation propagates to the
    C++ layer (skipped on replay, ACK discarded). Back-pressure matches
    the asyncio implementation: at PENDING_CAP live (un-ACKed,
    un-cancelled) messages for a peer, ``send`` awaits capacity."""

    def __init__(self) -> None:
        self._rng = random.Random()
        self._live: dict[tuple[str, int], int] = {}
        self._capacity: dict[tuple[str, int], asyncio.Event] = {}
        self._generation = -1  # transport loop generation of the counters

    def _cap_event(self, address: tuple[str, int]) -> asyncio.Event:
        ev = self._capacity.get(address)
        if ev is None:
            ev = asyncio.Event()
            ev.set()
            self._capacity[address] = ev
        return ev

    async def send(self, address: tuple[str, int], data: bytes):
        transport = NativeTransport.get()
        if self._generation != transport.generation:
            # The transport rebound to a new event loop and dropped our
            # in-flight futures (their done-callbacks can never run on
            # the dead loop): rebuild the back-pressure state so orphaned
            # messages don't consume PENDING_CAP capacity forever.
            self._generation = transport.generation
            self._live.clear()
            self._capacity.clear()
        ev = self._cap_event(address)
        while self._live.get(address, 0) >= PENDING_CAP:
            ev.clear()
            if self._live.get(address, 0) < PENDING_CAP:
                break
            await ev.wait()
        # Faultline link filter: drops leave the ACK future pending
        # forever (what a dead peer looks like — callers cancel after
        # their quorum); delays reschedule the engine handoff without
        # touching the caller. Duplicates are not applied to reliable
        # sends (FIFO ACK pairing would mispair).
        delay = 0.0
        plane = _faultline.plane
        if plane is not None:
            plan = plane.filter_send(address, data)
            if plan is not None:
                action, delay, _copies = plan
                if action == "drop":
                    return asyncio.get_running_loop().create_future()
        msg_id = transport.alloc_msg_id()
        handler: asyncio.Future = asyncio.get_running_loop().create_future()
        self._live[address] = self._live.get(address, 0) + 1

        def on_done(fut: asyncio.Future, *, _addr=address, _mid=msg_id) -> None:
            self._live[_addr] = max(0, self._live.get(_addr, 0) - 1)
            if self._live[_addr] < PENDING_CAP:
                self._cap_event(_addr).set()
            if fut.cancelled():
                transport.cancel(_mid)
                transport._acks.pop(_mid, None)

        handler.add_done_callback(on_done)
        transport._acks[msg_id] = handler
        if delay > 0:
            asyncio.get_running_loop().call_later(
                delay, transport.send, address, data, True, msg_id
            )
        else:
            transport.send(address, data, reliable=True, msg_id=msg_id)
        return handler

    async def broadcast(self, addresses: list[tuple[str, int]], data: bytes):
        return [await self.send(addr, data) for addr in addresses]

    async def lucky_broadcast(
        self, addresses: list[tuple[str, int]], data: bytes, nodes: int
    ):
        picked = self._rng.sample(addresses, min(nodes, len(addresses)))
        return [await self.send(addr, data) for addr in picked]

    def shutdown(self) -> None:
        pass  # connections are owned by the process-wide transport


def available() -> bool:
    """True when the native transport can be built/loaded on this host."""
    try:
        _load()
        return True
    except Exception:  # noqa: BLE001 — any toolchain failure means "no"
        return False
