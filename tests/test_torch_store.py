"""The port's store against the JAX package's, on the CPU.

Twins of ``tests/test_store.py`` run on the port's ``Store`` and
``LogEngine``. Then the on-disk format is held across the two packages in
both directions: a directory one package's ``Store`` wrote opens in the
other with the same data and meta records, and the voting state one
package's ``Core`` persisted (round, ``last_voted_round``,
``last_committed_round``, ``high_qc``) is what the other's
``Core._restore_state`` reads. Tolerance: the same bytes.
"""

import asyncio
import os

import pytest

import hotstuff_tpu.consensus.core as j_core
import hotstuff_tpu.store as j_store
import hotstuff_tpu_torch.consensus.core as t_core
import hotstuff_tpu_torch.store as t_store
from hotstuff_tpu_torch.store import LogEngine, Store

from .common import async_test
from .test_torch_wire import PKGS, World

STORES = {"port": t_store, "reference": j_store}
CORES = {"port": t_core, "reference": j_core}


# -- twins of tests/test_store.py ---------------------------------------------


@async_test
async def test_create_store(tmp_path):
    Store(str(tmp_path / "db")).close()


@async_test
async def test_read_write_value(tmp_path):
    store = Store(str(tmp_path / "db"))
    await store.write(b"key", b"value")
    assert await store.read(b"key") == b"value"
    store.close()


@async_test
async def test_read_unknown_key():
    store = Store()
    assert await store.read(b"missing") is None


@async_test
async def test_notify_read_after_write():
    store = Store()
    await store.write(b"k", b"v")
    assert await store.notify_read(b"k") == b"v"


@async_test
async def test_notify_read_blocks_until_write():
    store = Store()
    waiter = asyncio.create_task(store.notify_read(b"pending"))
    await asyncio.sleep(0.02)
    assert not waiter.done()
    await store.write(b"pending", b"arrived")
    assert await waiter == b"arrived"


@async_test
async def test_notify_read_many_waiters():
    store = Store()
    waiters = [asyncio.create_task(store.notify_read(b"k")) for _ in range(5)]
    await asyncio.sleep(0)
    await store.write(b"k", b"v")
    assert await asyncio.gather(*waiters) == [b"v"] * 5


@async_test
async def test_notify_read_cancellation_drops_obligation():
    store = Store()
    waiter = asyncio.create_task(store.notify_read(b"k"))
    await asyncio.sleep(0)
    waiter.cancel()
    await asyncio.sleep(0)
    assert store._obligations == {}


@async_test
async def test_persistence_across_reopen(tmp_path):
    path = str(tmp_path / "db")
    store = Store(path)
    await store.write(b"a", b"1")
    await store.write(b"b", b"22")
    await store.write(b"a", b"333")  # overwrite keeps last value
    store.close()
    store2 = Store(path)
    assert await store2.read(b"a") == b"333"
    assert await store2.read(b"b") == b"22"
    store2.close()


def test_torn_tail_replay(tmp_path):
    path = str(tmp_path / "db")
    eng = LogEngine(path)
    eng.put(b"good", b"value")
    eng.close()
    # A crash mid-append: a garbage half-record at the tail.
    with open(os.path.join(path, "store.log"), "ab") as f:
        f.write(b"\x10\x00\x00\x00\x10")
    eng2 = LogEngine(path)
    assert eng2.get(b"good") == b"value"
    eng2.close()


def test_torn_tail_double_restart(tmp_path):
    """Crash -> restart -> write -> restart keeps the post-crash write:
    replay truncates the torn tail so new records never land behind garbage."""
    path = str(tmp_path / "db")
    eng = LogEngine(path)
    eng.put(b"good", b"value")
    eng.close()
    with open(os.path.join(path, "store.log"), "ab") as f:
        f.write(b"\x10\x00\x00\x00\x10")
    eng2 = LogEngine(path)
    eng2.put(b"after-crash", b"kept")
    eng2.close()
    eng3 = LogEngine(path)
    assert eng3.get(b"good") == b"value"
    assert eng3.get(b"after-crash") == b"kept"
    assert set(eng3._index) == {b"good", b"after-crash"}  # no garbage keys
    eng3.close()


def test_metalog_torn_tail_and_legacy_fallback(tmp_path):
    """The meta log truncates a torn tail like the data log, and a key
    with no meta.log record is read from its legacy per-key file."""
    import hashlib

    path = str(tmp_path / "db")
    eng = LogEngine(path)
    eng.put_meta(b"state", b"v1")
    eng.put_meta(b"state", b"v2", sync=True)
    eng.close()
    with open(os.path.join(path, "meta.log"), "ab") as f:
        f.write(b"\x05\x00\x00")
    with open(os.path.join(path, "meta_" + hashlib.sha256(b"old").hexdigest()[:16]), "wb") as f:
        f.write(b"legacy")
    eng2 = LogEngine(path)
    assert eng2.get_meta(b"state") == b"v2"
    assert eng2.get_meta(b"old") == b"legacy"
    assert eng2.get_meta(b"absent") is None
    eng2.close()


# -- the on-disk format across the two packages --------------------------------

RECORDS = [(b"a", b"1"), (b"b" * 40, bytes(range(256)) * 3), (b"a", b"333"), (b"", b"empty key")]
META = [(b"__consensus_state__", b"s1"), (b"x", b"y"), (b"__consensus_state__", b"s2")]


@pytest.mark.parametrize("writer,reader", [("reference", "port"), ("port", "reference")])
@async_test
async def test_a_store_directory_opens_in_the_other_package(tmp_path, writer, reader):
    path = str(tmp_path / "db")
    store = STORES[writer].Store(path)
    for k, v in RECORDS:
        await store.write(k, v)
    for k, v in META:
        await store.write_meta(k, v)
    store.close()
    other = STORES[reader].Store(path)
    for k, v in dict(RECORDS).items():
        assert await other.read(k) == v
    for k, v in dict(META).items():
        assert await other.read_meta(k) == v
    # The reader appends in the same format: the writer reads it back.
    await other.write(b"from-reader", b"ok")
    await other.write_meta(b"x", b"z")
    other.close()
    again = STORES[writer].Store(path)
    assert await again.read(b"from-reader") == b"ok"
    assert await again.read_meta(b"x") == b"z"
    again.close()


def test_log_files_are_byte_identical(tmp_path):
    """The same writes make the same ``store.log`` and ``meta.log`` bytes."""
    files = {}
    for name, pkg in STORES.items():
        eng = pkg.LogEngine(str(tmp_path / name))
        for k, v in RECORDS:
            eng.put(k, v)
        for k, v in META:
            eng.put_meta(k, v)
        eng.close()
        files[name] = [open(os.path.join(tmp_path, name, f), "rb").read()
                       for f in ("store.log", "meta.log")]
    assert files["port"] == files["reference"]


def _state_core(pkg_name: str, store, world: World, round_: int, last_voted: int,
                last_committed: int, qc_round: int):
    """A state-only Core (the reference tests' ``Core.__new__`` idiom) over
    ``store`` holding the given voting state and a high QC of ``world``."""
    core = CORES[pkg_name].Core.__new__(CORES[pkg_name].Core)
    core.store = store
    core.persist_sync = False
    core.round, core.last_voted_round, core.last_committed_round = round_, last_voted, last_committed
    core.high_qc = world.qc(qc_round, signers=[3, 0, 2]) if qc_round else world.pkg.messages.QC.genesis()
    return core


@pytest.mark.parametrize("qc_round", [0, 6])
@pytest.mark.parametrize("writer,reader", [("reference", "port"), ("port", "reference")])
@async_test
async def test_voting_state_carries_across(tmp_path, writer, reader, qc_round):
    """One package's Core persists its voting state on disk; the other's
    ``_restore_state`` reads the same round, last voted and committed
    rounds and high QC, and persists the same record bytes."""
    path = str(tmp_path / "db")
    worlds = {name: World(PKGS[name], n=4) for name in PKGS}
    store = STORES[writer].Store(path)
    await _state_core(writer, store, worlds[writer], 9, 8, 5, qc_round)._persist_state()
    record = await store.read_meta(b"__consensus_state__")
    store.close()

    store = STORES[reader].Store(path)
    restored = CORES[reader].Core.__new__(CORES[reader].Core)
    restored.store = store
    restored.round, restored.last_voted_round, restored.last_committed_round = 1, 0, 0
    restored.high_qc = PKGS[reader].messages.QC.genesis()
    await restored._restore_state()
    assert (restored.round, restored.last_voted_round, restored.last_committed_round) == (9, 8, 5)
    want = worlds[reader].qc(qc_round, signers=[3, 0, 2]) if qc_round else restored.high_qc
    assert restored.high_qc.round == qc_round and restored.high_qc.hash == want.hash
    assert [(pk.data, sig.data) for pk, sig in restored.high_qc.votes] == [
        (pk.data, sig.data) for pk, sig in want.votes
    ]
    # The reader persists the same record from the same state.
    restored.persist_sync = False
    await restored._persist_state()
    assert await store.read_meta(b"__consensus_state__") == record
    store.close()


@pytest.mark.parametrize("pkg_name", ["port", "reference"])
@async_test
async def test_corrupt_voting_state_halts_restore(pkg_name):
    store = STORES[pkg_name].Store()
    await store.write_meta(b"__consensus_state__", b"\x01\x02")
    core = CORES[pkg_name].Core.__new__(CORES[pkg_name].Core)
    core.store = store
    with pytest.raises(PKGS[pkg_name].errors.ConsensusError, match="corrupt persisted"):
        await core._restore_state()
