"""Store layer: persistent KV with read-notification obligations.

Port copy of ``hotstuff_tpu/store/__init__.py`` (reference
``store/src/lib.rs:15-93``): a single-writer actor exposing
``write``/``read``/``notify_read``, where ``notify_read`` registers an
obligation fulfilled by a later ``write`` — the "wait until data arrives"
primitive every synchronizer builds on.

The on-disk format is the reference's, byte for byte: a directory one
package wrote opens in the other, compacted or not. A store with a path
opens the C++ engine (``store/native/``, ``NativeEngine``), as the
reference's does; ``LogEngine`` stays available through ``engine=``. One
departure: where the reference silently takes ``LogEngine`` when the
native engine cannot be built or opened, ``_default_engine`` here raises
(``KernelBuildError`` when g++ is missing or refuses the source).

Since the runtime is a single-threaded asyncio loop, actor serialization
is inherent — no queue hop is needed.
"""

from __future__ import annotations

import asyncio
import hashlib
import os
import struct

__all__ = ["LogEngine", "MemEngine", "MetaLog", "Store", "StoreError"]

_HDR = struct.Struct("<II")


class StoreError(Exception):
    pass


def _replay_records(path: str, into: dict) -> int:
    """Replay ``u32 klen, u32 vlen, key, value`` records from ``path`` into
    ``into`` (last record per key wins); a torn tail is truncated so later
    appends never land behind garbage. Returns the records read."""
    if not os.path.exists(path):
        return 0
    with open(path, "rb") as f:
        data = f.read()
    pos = records = 0
    while pos + _HDR.size <= len(data):
        klen, vlen = _HDR.unpack_from(data, pos)
        end = pos + _HDR.size + klen + vlen
        if end > len(data):
            break  # torn tail from a crash — drop it
        into[data[pos + _HDR.size : pos + _HDR.size + klen]] = data[
            pos + _HDR.size + klen : end
        ]
        records += 1
        pos = end
    if pos < len(data):
        os.truncate(path, pos)
    return records


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # platform without directory fds: best effort
    try:
        os.fsync(fd)
    except OSError:
        pass  # directory fsync unsupported (NFS/FUSE): best effort
    finally:
        os.close(fd)


class MetaLog:
    """Append-only log for small frequently-overwritten records (consensus
    voting state): ``u32 klen, u32 vlen, key, value`` records in
    ``meta.log``, the LAST record per key wins on replay. An update is two
    buffered writes (``sync=True`` also fsyncs); the file compacts in place
    (atomic replace) when superseded records dominate. Reads fall back to
    the legacy per-key ``meta_<hash>`` files."""

    COMPACT_MIN_RECORDS = 4096

    def __init__(self, dir_path: str) -> None:
        self._dir = dir_path
        self._path = os.path.join(dir_path, "meta.log")
        self._meta: dict[bytes, bytes] = {}
        # A crash between the compaction tmp write and its os.replace leaves
        # a stale ``meta.log.tmp`` beside the intact live log: discard it.
        try:
            os.unlink(self._path + ".tmp")
        except OSError:
            pass
        self._records = _replay_records(self._path, self._meta)
        existed = os.path.exists(self._path)
        self._f = open(self._path, "ab")
        if not existed:
            # A durable put into a file whose directory entry was never
            # fsynced can vanish on power failure: persist the creation.
            _fsync_dir(self._dir)

    def _legacy_path(self, key: bytes) -> str:
        return os.path.join(self._dir, "meta_" + hashlib.sha256(key).hexdigest()[:16])

    def put(self, key: bytes, value: bytes, sync: bool = False) -> None:
        # The map updates only after the write path completes: on OSError
        # callers never observe a value that may not survive restart.
        self._f.write(_HDR.pack(len(key), len(value)) + key + value)
        self._f.flush()
        if sync:
            os.fsync(self._f.fileno())
        self._meta[key] = value
        self._records += 1
        if self._records >= self.COMPACT_MIN_RECORDS and self._records >= 4 * len(self._meta):
            self._compact()

    def _compact(self) -> None:
        tmp = self._path + ".tmp"
        with open(tmp, "wb") as f:
            for k, v in self._meta.items():
                f.write(_HDR.pack(len(k), len(v)) + k + v)
            f.flush()
            os.fsync(f.fileno())
        self._f.close()
        os.replace(tmp, self._path)
        _fsync_dir(self._dir)  # persist the rename
        self._f = open(self._path, "ab")
        self._records = len(self._meta)

    def get(self, key: bytes) -> bytes | None:
        value = self._meta.get(key)
        if value is not None:
            return value
        try:  # pre-MetaLog layout: one atomic-replace file per key
            with open(self._legacy_path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def close(self) -> None:
        self._f.close()


class LogEngine:
    """Append-only log ``store.log`` + in-memory index, records
    ``u32 klen, u32 vlen, key, value`` (little-endian), flushed per write
    (no fsync, as the reference's RocksDB usage). Voting state goes through
    ``put_meta`` into the shared ``MetaLog``. The compactor truncates the
    log with the phased ``compact_*`` protocol below."""

    def __init__(self, path: str) -> None:
        self._index: dict[bytes, bytes] = {}
        self._path = path
        os.makedirs(path, exist_ok=True)
        self._log_path = os.path.join(path, "store.log")
        try:  # stale compaction temp from a crash inside the replace window
            os.unlink(self._log_path + ".tmp")
        except OSError:
            pass
        _replay_records(self._log_path, self._index)
        self._log = open(self._log_path, "ab")
        self._metalog = MetaLog(path)
        # Writes arriving while a compaction rewrite is in flight are
        # mirrored here and appended to the tmp file at commit, so the
        # atomic replace never discards records the index already holds.
        self._compacting = False
        self._delta: list[tuple[bytes, bytes]] = []

    def put_meta(self, key: bytes, value: bytes, sync: bool = False) -> None:
        self._metalog.put(key, value, sync=sync)

    def get_meta(self, key: bytes) -> bytes | None:
        return self._metalog.get(key)

    def put(self, key: bytes, value: bytes) -> None:
        self._log.write(_HDR.pack(len(key), len(value)) + key + value)
        self._log.flush()
        self._index[key] = value
        if self._compacting:
            self._delta.append((key, value))

    def get(self, key: bytes) -> bytes | None:
        return self._index.get(key)

    # -- phased compaction ---------------------------------------------------
    #
    # Rewrite ``store.log`` without the dropped keys (and without superseded
    # records) atomically: tmp + fsync + ``os.replace`` + directory fsync,
    # so a crash at any point leaves either the old or the new complete
    # log. ``begin`` snapshots the index on the loop and arms the write
    # mirror; ``write`` touches only its state object, so ``Store.compact``
    # runs it on an executor thread while the loop keeps appending;
    # ``commit`` appends the mirrored delta, swaps the files, and leaves an
    # open append handle on every path.

    class _CompactState:
        __slots__ = ("items", "drop", "tmp", "error")

        def __init__(self, items, drop, tmp):
            self.items = items
            self.drop = drop
            self.tmp = tmp
            self.error: OSError | None = None

    def compact_begin(self, drop_keys) -> "_CompactState | None":
        """Snapshot the retained records; ``None`` if a compaction is
        already in flight (the caller retries at the next trigger)."""
        if self._compacting:
            return None
        drop = set(drop_keys)
        items = [(k, v) for k, v in self._index.items() if k not in drop]
        self._compacting = True
        self._delta = []
        return self._CompactState(items, drop, self._log_path + ".tmp")

    def compact_write(self, state) -> bool:
        """Write the retained records to the tmp file (flush + fsync).
        Reads only ``state``: safe on an executor thread."""
        try:
            with open(state.tmp, "wb") as f:
                for k, v in state.items:
                    f.write(_HDR.pack(len(k), len(v)) + k + v)
                f.flush()
                os.fsync(f.fileno())
            return True
        except OSError as e:
            state.error = e
            return False

    def compact_abort(self, state) -> None:
        """Discard an in-flight compaction (write failure or shutdown): the
        live log was never touched."""
        self._compacting = False
        self._delta = []
        try:
            os.unlink(state.tmp)
        except OSError:
            pass

    def compact_commit(self, state) -> int:
        """Append the delta mirrored during the rewrite, swap the logs
        atomically, and drop the dead keys from the index. Returns the
        bytes reclaimed. On any failure the engine keeps an open append
        handle on whichever log survived."""
        before = self.size_bytes()
        replaced = False
        try:
            with open(state.tmp, "ab") as f:
                for k, v in self._delta:
                    if k not in state.drop:
                        f.write(_HDR.pack(len(k), len(v)) + k + v)
                f.flush()
                os.fsync(f.fileno())
            self._log.close()
            os.replace(state.tmp, self._log_path)
            replaced = True
            _fsync_dir(self._path)
        finally:
            self._compacting = False
            self._delta = []
            if not replaced:
                try:
                    os.unlink(state.tmp)
                except OSError:
                    pass
            if self._log.closed:
                # Whatever log is live: the new one after the replace, the
                # old (intact) one otherwise.
                self._log = open(self._log_path, "ab")
        for k in state.drop:
            self._index.pop(k, None)
        return max(0, before - self.size_bytes())

    def compact(self, drop_keys) -> int:
        """The phases in one synchronous call (tests, tools). Unknown keys
        are kept. Returns the bytes reclaimed (0 if a compaction was in
        flight or the rewrite failed; the old log stays live)."""
        state = self.compact_begin(drop_keys)
        if state is None:
            return 0
        if not self.compact_write(state):
            self.compact_abort(state)
            return 0
        return self.compact_commit(state)

    def size_bytes(self) -> int:
        try:
            return os.path.getsize(self._log_path)
        except OSError:
            return 0

    def close(self) -> None:
        self._log.close()
        self._metalog.close()


class MemEngine:
    """Volatile engine for tests and throwaway deployments."""

    def __init__(self) -> None:
        self._index: dict[bytes, bytes] = {}
        self._meta: dict[bytes, bytes] = {}

    def put(self, key: bytes, value: bytes) -> None:
        self._index[key] = value

    def get(self, key: bytes) -> bytes | None:
        return self._index.get(key)

    def put_meta(self, key: bytes, value: bytes, sync: bool = False) -> None:
        self._meta[key] = value

    def get_meta(self, key: bytes) -> bytes | None:
        return self._meta.get(key)

    def compact(self, drop_keys) -> int:
        freed = 0
        for k in drop_keys:
            v = self._index.pop(k, None)
            if v is not None:
                freed += len(k) + len(v) + _HDR.size
        return freed

    def close(self) -> None:
        pass


def _default_engine(path: str | None):
    if path is None:
        return MemEngine()
    from .native import NativeEngine

    return NativeEngine(path)


class Store:
    """Async KV handle (reference ``Store{new,read,write,notify_read}``,
    ``store/src/lib.rs:64-92``). Clonable by reference — share freely
    between actors on one loop."""

    def __init__(self, path: str | None = None, engine=None) -> None:
        self._engine = engine if engine is not None else _default_engine(path)
        self._obligations: dict[bytes, list[asyncio.Future]] = {}

    async def write(self, key: bytes, value: bytes) -> None:
        self._engine.put(key, value)
        waiters = self._obligations.pop(key, None)
        if waiters:
            for fut in waiters:
                if not fut.done():
                    fut.set_result(value)

    async def read(self, key: bytes) -> bytes | None:
        return self._engine.get(key)

    async def write_meta(self, key: bytes, value: bytes, sync: bool = False) -> None:
        """Small bounded record with overwrite semantics (no log growth);
        ``sync=True`` fsyncs for power-crash durability."""
        self._engine.put_meta(key, value, sync=sync)

    async def read_meta(self, key: bytes) -> bytes | None:
        return self._engine.get_meta(key)

    def compaction_offloaded(self) -> bool:
        """True when this store's engine runs the compaction rewrite off the
        event loop (the phased protocol): callers may then run ``compact``
        as a background task."""
        return hasattr(self._engine, "compact_begin")

    async def compact(self, drop_keys) -> int:
        """Drop ``drop_keys`` from the data log and reclaim their space (a
        no-op for engines without compaction). Returns the bytes reclaimed.

        A phased engine's bulk rewrite (the retained records and their
        fsyncs) runs on the default executor, so votes and timers keep
        running; only ``compact_begin`` and ``compact_commit`` run on the
        loop, and writes racing the rewrite are mirrored into it. Engines
        with only a synchronous ``compact`` (``MemEngine``) run inline."""
        engine = self._engine
        begin = getattr(engine, "compact_begin", None)
        if begin is None:
            engine_compact = getattr(engine, "compact", None)
            return 0 if engine_compact is None else engine_compact(drop_keys)
        state = begin(drop_keys)
        if state is None:
            return 0  # a compaction is already in flight
        fut = asyncio.get_running_loop().run_in_executor(None, engine.compact_write, state)
        try:
            ok = await asyncio.shield(fut)
        except asyncio.CancelledError:
            # The rewrite thread cannot be interrupted: let it finish, then
            # discard its output (the live log was never touched).
            fut.add_done_callback(lambda _f: engine.compact_abort(state))
            raise
        if not ok:
            engine.compact_abort(state)
            raise StoreError(f"compaction rewrite failed: {state.error}")
        return engine.compact_commit(state)

    async def notify_read(self, key: bytes) -> bytes:
        """Return the value for ``key``, waiting for a future ``write`` if it
        is not yet present (reference ``StoreCommand::NotifyRead``).
        Cancelling the awaiting task cleanly drops the obligation."""
        value = self._engine.get(key)
        if value is not None:
            return value
        fut: asyncio.Future[bytes] = asyncio.get_running_loop().create_future()
        self._obligations.setdefault(key, []).append(fut)
        try:
            return await fut
        finally:
            if fut.cancelled():
                waiters = self._obligations.get(key)
                if waiters and fut in waiters:
                    waiters.remove(fut)
                    if not waiters:
                        del self._obligations[key]

    def close(self) -> None:
        self._engine.close()
