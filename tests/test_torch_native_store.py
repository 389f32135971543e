"""The port's native C++ store engine, on the CPU.

Twins of ``tests/test_native_store.py`` (its 9 tests: interface parity
with ``LogEngine``, on-disk compatibility between the engines, torn-tail
replay, the ``Store`` actor on top of it, the default engine) and of the
two native-engine tests of ``tests/test_log_compaction.py``, on
``hotstuff_tpu_torch.store.native``. Then the records are held across the
packages (tolerance: the same bytes): a directory written by either
package's ``NativeEngine`` or ``LogEngine``, with a torn tail, opens in
each of the four with the same contents, and both native engines leave the
same ``store.log``. One departure is held: a store with a path whose native
build fails raises, where the reference takes ``LogEngine``.

Files only (``tmp_path``); no port is bound.
"""

import asyncio
import os
from pathlib import Path

import pytest

import hotstuff_tpu.store as j_store
import hotstuff_tpu.store.native as j_native
import hotstuff_tpu_torch.store as t_store
from hotstuff_tpu_torch.store import LogEngine, Store
from hotstuff_tpu_torch.store import native as t_native
from hotstuff_tpu_torch.store.native import NativeEngine
from hotstuff_tpu_torch.utils import kernel_build

from .common import async_test


def test_put_get_roundtrip(tmp_path):
    eng = NativeEngine(str(tmp_path / "db"))
    assert eng.get(b"missing") is None
    eng.put(b"k", b"v1")
    eng.put(b"k2", b"x" * 100_000)
    eng.put(b"k", b"v2")  # overwrite
    assert eng.get(b"k") == b"v2"
    assert eng.get(b"k2") == b"x" * 100_000
    eng.close()


def test_persistence_across_reopen(tmp_path):
    path = str(tmp_path / "db")
    eng = NativeEngine(path)
    eng.put(b"a", b"1")
    eng.put(b"b", bytes(range(256)))
    eng.close()
    eng2 = NativeEngine(path)
    assert eng2.get(b"a") == b"1"
    assert eng2.get(b"b") == bytes(range(256))
    eng2.close()


def test_cross_engine_disk_compat(tmp_path):
    """Python LogEngine and the C++ engine share the on-disk format."""
    path = str(tmp_path / "db")
    py = LogEngine(path)
    py.put(b"from-python", b"hello")
    py.close()
    nat = NativeEngine(path)
    assert nat.get(b"from-python") == b"hello"
    nat.put(b"from-native", b"world")
    nat.close()
    py2 = LogEngine(path)
    assert py2.get(b"from-native") == b"world"
    assert py2.get(b"from-python") == b"hello"
    py2.close()


def test_torn_tail_replay(tmp_path):
    path = str(tmp_path / "db")
    eng = NativeEngine(path)
    eng.put(b"good", b"value")
    eng.close()
    with open(os.path.join(path, "store.log"), "ab") as f:
        f.write(b"\x10\x00\x00\x00\x10\x00")  # half a header + garbage
    eng2 = NativeEngine(path)
    assert eng2.get(b"good") == b"value"
    eng2.close()


def test_torn_tail_double_restart(tmp_path):
    """Crash -> restart -> write -> restart keeps the post-crash write
    (replay truncates the torn tail before reopening for append)."""
    path = str(tmp_path / "db")
    eng = NativeEngine(path)
    eng.put(b"good", b"value")
    eng.close()
    with open(os.path.join(path, "store.log"), "ab") as f:
        f.write(b"\x10\x00\x00\x00\x10\x00")
    eng2 = NativeEngine(path)
    eng2.put(b"after-crash", b"kept")
    eng2.close()
    eng3 = NativeEngine(path)
    assert eng3.get(b"good") == b"value"
    assert eng3.get(b"after-crash") == b"kept"
    # No garbage keys: exactly the two real records survived.
    assert eng3._lib.hs_store_size(eng3._handle) == 2
    eng3.close()


def test_torn_tail_huge_length_header(tmp_path):
    """A torn header decoding to multi-GB lengths must be truncated, not
    attempted as an allocation (bad_alloc across the C ABI aborts)."""
    path = str(tmp_path / "db")
    eng = NativeEngine(path)
    eng.put(b"good", b"value")
    eng.close()
    with open(os.path.join(path, "store.log"), "ab") as f:
        f.write(b"\xff\xff\xff\xff\xff\xff\xff\xff tail")  # klen=vlen=4GiB-1
    eng2 = NativeEngine(path)
    assert eng2.get(b"good") == b"value"
    eng2.put(b"after", b"kept")
    eng2.close()
    eng3 = NativeEngine(path)
    assert eng3.get(b"after") == b"kept"
    assert eng3._lib.hs_store_size(eng3._handle) == 2
    eng3.close()


def test_meta_records(tmp_path):
    eng = NativeEngine(str(tmp_path / "db"))
    assert eng.get_meta(b"state") is None
    eng.put_meta(b"state", b"round=5", sync=True)
    eng.put_meta(b"state", b"round=6")
    assert eng.get_meta(b"state") == b"round=6"
    eng.close()


@async_test
async def test_store_actor_on_native_engine(tmp_path):
    store = Store(engine=NativeEngine(str(tmp_path / "db")))
    await store.write(b"k", b"v")
    assert await store.read(b"k") == b"v"
    waiter = asyncio.create_task(store.notify_read(b"pending"))
    await asyncio.sleep(0.01)
    await store.write(b"pending", b"arrived")
    assert await waiter == b"arrived"
    store.close()


def test_default_engine_prefers_native(tmp_path):
    """Store(path) picks the native engine when the toolchain exists."""
    store = Store(str(tmp_path / "db"))
    assert type(store._engine).__name__ == "NativeEngine"
    store.close()


# -- twins of tests/test_log_compaction.py's native-engine tests --------------


def _fill(engine, n=50, vlen=64):
    for i in range(n):
        engine.put(b"k%04d" % i, bytes([i % 256]) * vlen)


def test_native_engine_compact_parity(tmp_path):
    eng = NativeEngine(str(tmp_path))
    _fill(eng, n=30)
    before = eng.size_bytes()
    freed = eng.compact([b"k%04d" % i for i in range(20)])
    assert freed > 0 and eng.size_bytes() < before
    assert eng.get(b"k0000") is None and eng.get(b"k0025") is not None
    eng.close()
    # Compacted log replays identically in the PYTHON engine: the two
    # engines stay interchangeable on disk across a truncation.
    pyeng = LogEngine(str(tmp_path))
    assert pyeng.get(b"k0000") is None and pyeng.get(b"k0025") is not None
    pyeng.close()


def test_native_engine_phased_compaction_mirrors_puts(tmp_path):
    eng = NativeEngine(str(tmp_path))
    _fill(eng, n=20)
    drop = [b"k%04d" % i for i in range(10)]
    state = eng.compact_begin(drop)
    assert state is not None
    assert eng.compact_begin(drop) is None  # one compaction at a time
    eng.put(b"mid", b"written-during-rewrite")
    assert eng.compact_write(state)
    eng.put(b"late", b"written-after-rewrite-before-commit")
    assert eng.compact_commit(state) > 0
    eng.put(b"after", b"post-swap-append")  # handle restored by commit
    assert eng.get(b"mid") == b"written-during-rewrite"
    assert eng.get(b"k0003") is None and eng.get(b"k0015") is not None
    eng.close()
    # The mirrored records are IN the swapped file (replay via LogEngine:
    # same on-disk format, independent reader).
    pyeng = LogEngine(str(tmp_path))
    assert pyeng.get(b"mid") == b"written-during-rewrite"
    assert pyeng.get(b"late") == b"written-after-rewrite-before-commit"
    assert pyeng.get(b"after") == b"post-swap-append"
    assert pyeng.get(b"k0003") is None and pyeng.get(b"k0015") is not None
    pyeng.close()


# -- across the packages --------------------------------------------------------

ENGINES = {
    "port-native": NativeEngine,
    "port-log": LogEngine,
    "reference-native": j_native.NativeEngine,
    "reference-log": j_store.LogEngine,
}
RECORDS = [(b"k%03d" % i, bytes([i]) * (i * 37 % 300)) for i in range(40)]
TORN = b"\x10\x00\x00\x00\x10\x00"  # half a header


def _write(engine_cls, path: str) -> None:
    eng = engine_cls(path)
    for key, value in RECORDS:
        eng.put(key, value)
    eng.put(RECORDS[3][0], b"overwritten")
    eng.put_meta(b"state", b"round=9", sync=True)
    eng.close()
    with open(os.path.join(path, "store.log"), "ab") as f:
        f.write(TORN)


@pytest.mark.parametrize("writer", sorted(ENGINES))
@pytest.mark.parametrize("reader", sorted(ENGINES))
def test_a_directory_opens_in_every_engine_of_both_packages(tmp_path, writer, reader):
    path = str(tmp_path / "db")
    _write(ENGINES[writer], path)
    eng = ENGINES[reader](path)
    try:
        for i, (key, value) in enumerate(RECORDS):
            assert eng.get(key) == (b"overwritten" if i == 3 else value)
        assert eng.get_meta(b"state") == b"round=9"
        eng.put(b"after-the-torn-tail", b"kept")
    finally:
        eng.close()
    again = ENGINES[writer](path)
    try:
        assert again.get(b"after-the-torn-tail") == b"kept"
    finally:
        again.close()


def test_both_native_engines_write_the_same_log(tmp_path):
    logs = []
    for name, cls in (("port", NativeEngine), ("reference", j_native.NativeEngine)):
        path = str(tmp_path / name)
        eng = cls(path)
        for key, value in RECORDS:
            eng.put(key, value)
        eng.compact([key for key, _ in RECORDS[:10]])
        eng.put(b"after", b"compaction")
        eng.close()
        logs.append(Path(path, "store.log").read_bytes())
    assert logs[0] == logs[1]


def test_a_store_path_with_a_failing_native_build_raises(tmp_path, monkeypatch):
    """Departure: the reference's ``_default_engine`` takes ``LogEngine``
    on any exception; the port's raises the build's error."""
    monkeypatch.setattr(t_native, "_lib", None)
    monkeypatch.setattr(kernel_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(kernel_build, "native_path", lambda source, extra=(): tmp_path / "none.so")
    with pytest.raises(kernel_build.KernelBuildError):
        Store(str(tmp_path / "db"))
    assert type(t_store._default_engine(None)).__name__ == "MemEngine"

    def refused():
        raise OSError("g++ refused engine.cpp")

    monkeypatch.setattr(j_native, "_lib", None)
    monkeypatch.setattr(j_native, "_ensure_built", refused)
    fallback = j_store._default_engine(str(tmp_path / "ref"))
    assert isinstance(fallback, j_store.LogEngine)
    fallback.close()
