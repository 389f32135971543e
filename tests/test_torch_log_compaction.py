"""The port's log compaction (``hotstuff_tpu_torch.store``) against the
reference's: twins of the Python-engine tests of
``tests/test_log_compaction.py`` (the atomic ``store.log`` rewrite, the
phased protocol and its write mirror, stale compaction temps, MetaLog torn
tails and the legacy per-key fallback), and a directory compacted by one
package that reopens in the other with the same index and the same bytes.

The native engine's two tests wait for the port's native store.
"""

from __future__ import annotations

import asyncio
import os
import struct

import pytest

import hotstuff_tpu.store as j_store
from hotstuff_tpu_torch.consensus.statesync import SNAPSHOT_KEY
from hotstuff_tpu_torch.store import _HDR, LogEngine, MemEngine, MetaLog, Store

from .common import async_test


def _fill(engine, n=50, vlen=64):
    for i in range(n):
        engine.put(b"k%04d" % i, bytes([i % 256]) * vlen)


# -- LogEngine.compact -------------------------------------------------------


def test_log_compact_drops_keys_and_reclaims_bytes(tmp_path):
    eng = LogEngine(str(tmp_path))
    _fill(eng)
    before = eng.size_bytes()
    freed = eng.compact([b"k%04d" % i for i in range(40)])
    assert freed > 0 and eng.size_bytes() == before - freed
    assert eng.get(b"k0000") is None and eng.get(b"k0045") is not None
    eng.close()


def test_log_compact_squeezes_superseded_duplicates(tmp_path):
    eng = LogEngine(str(tmp_path))
    for _ in range(10):
        eng.put(b"hot", b"x" * 100)  # 10 versions on disk, 1 live
    freed = eng.compact([])  # nothing dropped: duplicates alone shrink it
    assert freed > 0
    assert eng.get(b"hot") == b"x" * 100
    eng.close()


def test_log_phased_compaction_mirrors_concurrent_puts(tmp_path):
    # Puts landing while the rewrite is in flight must be mirrored into the
    # tmp file at commit, or the atomic replace discards records the index
    # already holds.
    eng = LogEngine(str(tmp_path))
    _fill(eng, n=20)
    drop = [b"k%04d" % i for i in range(10)]
    state = eng.compact_begin(drop)
    assert state is not None
    assert eng.compact_begin(drop) is None  # one compaction at a time
    eng.put(b"mid", b"written-during-rewrite")
    assert eng.compact_write(state)
    eng.put(b"late", b"written-after-rewrite-before-commit")
    assert eng.compact_commit(state) > 0
    assert eng.get(b"mid") == b"written-during-rewrite"
    assert eng.get(b"late") == b"written-after-rewrite-before-commit"
    assert eng.get(b"k0003") is None and eng.get(b"k0015") is not None
    eng.close()
    # The mirrored records are IN the swapped file, not only the index.
    eng2 = LogEngine(str(tmp_path))
    assert eng2.get(b"mid") == b"written-during-rewrite"
    assert eng2.get(b"late") == b"written-after-rewrite-before-commit"
    assert eng2.get(b"k0003") is None and eng2.get(b"k0015") is not None
    eng2.close()


def test_log_compact_commit_failure_restores_append_handle(tmp_path, monkeypatch):
    # A failed atomic swap must leave the old log live and writable.
    eng = LogEngine(str(tmp_path))
    _fill(eng, n=10)
    state = eng.compact_begin([b"k0000"])
    assert eng.compact_write(state)
    monkeypatch.setattr(os, "replace", lambda src, dst: (_ for _ in ()).throw(OSError("no swap")))
    with pytest.raises(OSError):
        eng.compact_commit(state)
    monkeypatch.undo()
    eng.put(b"after-failure", b"v")
    assert eng.get(b"after-failure") == b"v"
    eng.close()
    eng2 = LogEngine(str(tmp_path))
    assert eng2.get(b"after-failure") == b"v"
    assert eng2.get(b"k0000") is not None  # old log survived whole
    eng2.close()


@async_test
async def test_store_compact_offloaded_with_concurrent_writes(tmp_path):
    # Store.compact runs the rewrite on the executor; a write racing it on
    # the loop must survive the swap.
    store = Store(engine=LogEngine(str(tmp_path)))
    for i in range(50):
        await store.write(b"k%04d" % i, bytes([i % 256]) * 64)
    assert store.compaction_offloaded()
    task = asyncio.create_task(store.compact([b"k%04d" % i for i in range(40)]))
    await asyncio.sleep(0)  # let the rewrite reach the executor
    await store.write(b"mid-compaction", b"v")
    assert await task > 0
    assert await store.read(b"mid-compaction") == b"v"
    assert await store.read(b"k0001") is None
    assert await store.read(b"k0045") is not None
    store.close()


def test_log_compact_survives_reopen(tmp_path):
    eng = LogEngine(str(tmp_path))
    _fill(eng, n=20)
    eng.compact([b"k%04d" % i for i in range(10)])
    eng.put(b"after", b"compaction")  # appends continue on the new log
    eng.close()
    eng2 = LogEngine(str(tmp_path))
    assert eng2.get(b"k0000") is None
    assert eng2.get(b"k0015") is not None
    assert eng2.get(b"after") == b"compaction"
    eng2.close()


def test_log_compact_unknown_keys_retained(tmp_path):
    eng = LogEngine(str(tmp_path))
    _fill(eng, n=5)
    eng.compact([b"not-present"])
    for i in range(5):
        assert eng.get(b"k%04d" % i) is not None
    eng.close()


def test_stale_compaction_tmp_discarded_on_open(tmp_path):
    eng = LogEngine(str(tmp_path))
    _fill(eng, n=5)
    eng.close()
    # A crash inside a compaction's write window leaves a partial tmp beside
    # the intact live log: it is discarded, never adopted.
    tmp = os.path.join(str(tmp_path), "store.log.tmp")
    with open(tmp, "wb") as f:
        f.write(b"half a compaction")
    eng2 = LogEngine(str(tmp_path))
    assert not os.path.exists(tmp)
    for i in range(5):
        assert eng2.get(b"k%04d" % i) is not None
    eng2.close()


def test_mem_engine_compact(tmp_path):
    eng = MemEngine()
    _fill(eng, n=10)
    assert eng.compact([b"k0000", b"missing"]) > 0
    assert eng.get(b"k0000") is None and eng.get(b"k0005") is not None


@async_test
async def test_store_compact_noop_without_engine_support():
    class Bare:
        def put(self, k, v): ...
        def get(self, k): return None
        def close(self): ...

    store = Store(engine=Bare())
    assert not store.compaction_offloaded()
    assert await store.compact([b"x"]) == 0


# -- MetaLog crash hardening -------------------------------------------------


def test_metalog_torn_tail_after_compaction_window(tmp_path):
    """A torn append after an in-place compaction truncates cleanly on
    replay: the compacted prefix survives, the torn record goes, and later
    appends parse."""
    ml = MetaLog(str(tmp_path))
    for i in range(8):
        ml.put(b"round", str(i).encode())
    ml.put(b"floor", b"42")
    ml._compact()  # in-place atomic replace: 2 live records remain
    ml.put(b"round", b"9")
    ml.close()
    path = os.path.join(str(tmp_path), "meta.log")
    with open(path, "ab") as f:  # crash mid-append
        f.write(_HDR.pack(5, 100) + b"tornk" + b"only-part")
    ml2 = MetaLog(str(tmp_path))
    assert ml2.get(b"round") == b"9"
    assert ml2.get(b"floor") == b"42"
    assert ml2.get(b"tornk") is None
    ml2.put(b"round", b"10")
    ml2.close()
    ml3 = MetaLog(str(tmp_path))
    assert ml3.get(b"round") == b"10"
    ml3.close()


def test_metalog_stale_compaction_tmp_discarded(tmp_path):
    ml = MetaLog(str(tmp_path))
    ml.put(b"k", b"live")
    ml.close()
    tmp = os.path.join(str(tmp_path), "meta.log.tmp")
    with open(tmp, "wb") as f:
        f.write(_HDR.pack(1, 1) + b"kX")  # plausible but stale generation
    ml2 = MetaLog(str(tmp_path))
    assert not os.path.exists(tmp)
    assert ml2.get(b"k") == b"live"
    ml2.close()


def test_metalog_legacy_fallback_reads_snapshot_record(tmp_path):
    """A snapshot record in the legacy per-key layout is read, and a new
    MetaLog put shadows it from then on."""
    legacy_value = b"snapshot-from-previous-layout"
    ml = MetaLog(str(tmp_path))
    legacy = ml._legacy_path(SNAPSHOT_KEY)
    ml.close()
    with open(legacy, "wb") as f:
        f.write(legacy_value)
    ml2 = MetaLog(str(tmp_path))
    assert ml2.get(SNAPSHOT_KEY) == legacy_value
    ml2.put(SNAPSHOT_KEY, b"new-layout-record")
    assert ml2.get(SNAPSHOT_KEY) == b"new-layout-record"
    ml2.close()
    ml3 = MetaLog(str(tmp_path))  # the shadow persists across reopen
    assert ml3.get(SNAPSHOT_KEY) == b"new-layout-record"
    ml3.close()


def test_metalog_torn_tail_with_legacy_fallback_present(tmp_path):
    """Torn-tail recovery does not fall back to a STALE legacy record for a
    key whose live record survived before the tear."""
    ml = MetaLog(str(tmp_path))
    legacy = ml._legacy_path(SNAPSHOT_KEY)
    ml.put(SNAPSHOT_KEY, b"current")
    ml.close()
    with open(legacy, "wb") as f:
        f.write(b"ancient")
    path = os.path.join(str(tmp_path), "meta.log")
    with open(path, "ab") as f:
        f.write(_HDR.pack(3, 50) + b"abc")  # torn: value bytes missing
    ml2 = MetaLog(str(tmp_path))
    assert ml2.get(SNAPSHOT_KEY) == b"current"
    ml2.close()


def test_metalog_torn_header_alone(tmp_path):
    ml = MetaLog(str(tmp_path))
    ml.put(b"a", b"1")
    ml.close()
    path = os.path.join(str(tmp_path), "meta.log")
    with open(path, "ab") as f:
        f.write(struct.pack("<I", 7))  # half a header
    ml2 = MetaLog(str(tmp_path))
    assert ml2.get(b"a") == b"1"
    assert os.path.getsize(path) == _HDR.size + 2  # tear truncated away
    ml2.close()


# -- across the packages -------------------------------------------------------

ENGINES = {"port": LogEngine, "reference": j_store.LogEngine}


@pytest.mark.parametrize("writer,reader", [("port", "reference"), ("reference", "port")])
def test_compacted_directory_reopens_in_the_other_package(tmp_path, writer, reader):
    """A directory that one package filled, overwrote, compacted (with a
    write mirrored during the rewrite) and appended to after the swap opens
    in the other with the same index; both packages' compactions of the
    same history leave the same bytes."""
    dirs = {}
    for name, engine in ENGINES.items():
        path = str(tmp_path / name)
        eng = engine(path)
        _fill(eng, n=30)
        eng.put(b"k0005", b"overwritten")
        eng.put_meta(SNAPSHOT_KEY, b"floor record", sync=True)
        state = eng.compact_begin([b"k%04d" % i for i in range(0, 30, 3)])
        eng.put(b"mid", b"written-during-rewrite")
        assert eng.compact_write(state)
        assert eng.compact_commit(state) > 0
        eng.put(b"after", b"post-swap-append")
        eng.close()
        dirs[name] = path
    for file in ("store.log", "meta.log"):
        with open(os.path.join(dirs["port"], file), "rb") as a, \
                open(os.path.join(dirs["reference"], file), "rb") as b:
            assert a.read() == b.read(), f"{file} differs between the packages"
    source = ENGINES[writer](dirs[writer])
    other = ENGINES[reader](dirs[writer])
    assert other._index == source._index
    assert len(other._index) == 30 - 10 + 2
    assert other.get(b"k0003") is None and other.get(b"k0005") == b"overwritten"
    assert other.get_meta(SNAPSHOT_KEY) == b"floor record"
    source.close()
    other.close()
