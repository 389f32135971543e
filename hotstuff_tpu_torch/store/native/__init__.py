"""ctypes binding for the native C++ KV engine.

Port copy of ``hotstuff_tpu/store/native/__init__.py``. The engine's source
is the port's copy, ``store/native/engine.cpp``; it is built with g++ at
first use into ``hotstuff_tpu_torch/_build/native-<key>/``
(``utils/kernel_build.build_native``), where the reference builds beside its
source. A failed build raises ``KernelBuildError``: ``store._default_engine``
does not fall back to ``LogEngine`` as the reference's does.

Interchangeable on disk with the Python engine and with the reference's
engines: identical record format, including torn-tail crash replay. Meta
records go to the port's ``MetaLog`` append file (optional fsync), as the
reference's go to its own, so both engines are drop-in for consensus state
persistence.
"""

from __future__ import annotations

import ctypes
import os
import struct
from pathlib import Path

from hotstuff_tpu_torch.utils import kernel_build

_SRC = Path(__file__).resolve().parent / "engine.cpp"


def _ensure_built() -> str:
    return str(kernel_build.build_native(_SRC))


_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(_ensure_built())
        lib.hs_store_open.restype = ctypes.c_void_p
        lib.hs_store_open.argtypes = [ctypes.c_char_p]
        lib.hs_store_put.restype = ctypes.c_int
        lib.hs_store_put.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_uint32,
            ctypes.c_char_p,
            ctypes.c_uint32,
        ]
        lib.hs_store_get.restype = ctypes.c_int64
        lib.hs_store_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32]
        lib.hs_store_read.restype = ctypes.c_int
        lib.hs_store_read.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_uint32,
            ctypes.c_char_p,
            ctypes.c_uint32,
        ]
        lib.hs_store_size.restype = ctypes.c_uint64
        lib.hs_store_size.argtypes = [ctypes.c_void_p]
        lib.hs_store_compact.restype = ctypes.c_int64
        lib.hs_store_compact.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
        lib.hs_store_compact_begin.restype = ctypes.c_void_p
        lib.hs_store_compact_begin.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
        lib.hs_store_compact_write.restype = ctypes.c_int
        lib.hs_store_compact_write.argtypes = [ctypes.c_void_p]
        lib.hs_store_compact_abort.restype = None
        lib.hs_store_compact_abort.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.hs_store_compact_commit.restype = ctypes.c_int64
        lib.hs_store_compact_commit.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.hs_store_close.restype = None
        lib.hs_store_close.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


class NativeEngine:
    """Same interface as ``store.LogEngine``, backed by the C++ engine."""

    def __init__(self, path: str) -> None:
        lib = _load()
        os.makedirs(path, exist_ok=True)
        self._path = path
        self._handle = lib.hs_store_open(os.path.join(path, "store.log").encode())
        if not self._handle:
            raise OSError(f"failed to open native store at {path}")
        self._lib = lib
        self._metalog = None  # lazily opened MetaLog

    def put(self, key: bytes, value: bytes) -> None:
        rc = self._lib.hs_store_put(self._handle, key, len(key), value, len(value))
        if rc != 0:
            raise OSError("native store write failed")

    def get(self, key: bytes) -> bytes | None:
        n = self._lib.hs_store_get(self._handle, key, len(key))
        if n < 0:
            return None
        buf = ctypes.create_string_buffer(int(n))
        rc = self._lib.hs_store_read(self._handle, key, len(key), buf, int(n))
        if rc != 0:
            raise OSError("native store read failed")
        return buf.raw

    # -- phased compaction (see LogEngine for the contract) ---------------
    #
    # ``compact_begin`` (loop thread) deep-copies the retained records in
    # C and arms the put-delta mirror; ``compact_write`` touches only that
    # state, so Store.compact runs it on an executor thread (ctypes
    # releases the GIL for the call); ``compact_commit`` (loop thread)
    # appends the mirrored delta, swaps the files, and restores the
    # append handle.

    class _CompactState:
        __slots__ = ("ptr", "error")

        def __init__(self, ptr) -> None:
            self.ptr = ptr
            self.error = None

    def compact_begin(self, drop_keys) -> "_CompactState | None":
        blob = b"".join(struct.pack("<I", len(k)) + bytes(k) for k in drop_keys)
        ptr = self._lib.hs_store_compact_begin(self._handle, blob, len(blob))
        if not ptr:
            return None  # compaction already in flight (or malformed set)
        return self._CompactState(ptr)

    def compact_write(self, state) -> bool:
        ok = self._lib.hs_store_compact_write(state.ptr) == 0
        if not ok:
            state.error = "native tmp rewrite failed"
        return ok

    def compact_abort(self, state) -> None:
        self._lib.hs_store_compact_abort(self._handle, state.ptr)
        state.ptr = None

    def compact_commit(self, state) -> int:
        freed = self._lib.hs_store_compact_commit(self._handle, state.ptr)
        state.ptr = None  # commit consumed (and freed) the state either way
        if freed < 0:
            raise OSError("native store compaction failed")
        return int(freed)

    def compact(self, drop_keys) -> int:
        """Drop ``drop_keys`` from the log and reclaim their space (atomic
        rewrite, same crash discipline as ``LogEngine.compact``). Returns
        bytes reclaimed; 0 if a compaction was already in flight."""
        state = self.compact_begin(drop_keys)
        if state is None:
            return 0
        if not self.compact_write(state):
            self.compact_abort(state)
            raise OSError("native store compaction failed")
        return self.compact_commit(state)

    def size_bytes(self) -> int:
        try:
            return os.path.getsize(os.path.join(self._path, "store.log"))
        except OSError:
            return 0

    # Meta records: the same shared MetaLog append file as the Python
    # engine (with fallback reads of the legacy per-key replace files).
    @property
    def _meta_log(self):
        if self._metalog is None:
            from hotstuff_tpu_torch.store import MetaLog

            self._metalog = MetaLog(self._path)
        return self._metalog

    def put_meta(self, key: bytes, value: bytes, sync: bool = False) -> None:
        self._meta_log.put(key, value, sync=sync)

    def get_meta(self, key: bytes) -> bytes | None:
        return self._meta_log.get(key)

    def close(self) -> None:
        if self._handle:
            self._lib.hs_store_close(self._handle)
            self._handle = None
        if self._metalog is not None:
            self._metalog.close()
            self._metalog = None

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass
