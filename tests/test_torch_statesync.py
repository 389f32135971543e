"""The port's state sync (``hotstuff_tpu_torch.consensus.statesync``)
against the reference's.

- Twins of the 17 tests of ``tests/test_statesync.py`` up to its faultline
  checker: the snapshot codec and the 2-chain proof's structural and
  cryptographic tamper rejection, the Compactor over a real store, the
  install adopting only certified state, the one-slot frontier pull and the
  per-origin rate limit on snapshot replies.
- Across the packages: the same chain's snapshot record is byte-identical,
  each package decodes the other's, the ``state_request`` /
  ``state_response`` frames are identical, and both Compactors write the
  same record over the same history.
- The card path's Python on the CPU: a snapshot verifies through
  ``BatchingBackend(CudaBackend(device="cpu"))`` in two inner calls (its two
  QCs are awaited one after the other), and a snapshot whose QCs meet
  ``BackendUnavailable`` is left unjudged and unadopted.

The seven faultline and watchtower tests of that file wait for those
planes in the port. Keys are ``tests/common.keys``; the committees'
addresses (22500-22599) are never bound.
"""

from __future__ import annotations

import random

import pytest

import hotstuff_tpu.consensus.messages as j_messages
import hotstuff_tpu.consensus.statesync as j_statesync
import hotstuff_tpu.crypto as j_crypto
import hotstuff_tpu.store as j_store
import hotstuff_tpu_torch.consensus.messages as t_messages
import hotstuff_tpu_torch.crypto as t_crypto
from hotstuff_tpu_torch.consensus import Authority, Committee, cert_arena
from hotstuff_tpu_torch.consensus.messages import QC, Block, CertificateCache, decode_message
from hotstuff_tpu_torch.consensus.statesync import (
    SNAPSHOT_KEY,
    Compactor,
    Snapshot,
    SnapshotError,
    StateSync,
    decode_snapshot,
    encode_snapshot,
    peek_frontier,
    verify_snapshot,
)
from hotstuff_tpu_torch.crypto import BackendUnavailable, Digest, Signature
from hotstuff_tpu_torch.crypto.batching import BatchingBackend
from hotstuff_tpu_torch.crypto.cuda_backend import CudaBackend
from hotstuff_tpu_torch.store import LogEngine, Store

from .common import async_test
from .common import chain as j_chain
from .common import keys as j_keys

BASE = 22500


@pytest.fixture(autouse=True)
def backends(monkeypatch):
    monkeypatch.setattr(t_crypto, "_BACKEND", None)
    monkeypatch.setattr(j_crypto, "_BACKEND", None)
    t_crypto.set_backend(t_crypto.CpuBackend())
    j_crypto.set_backend("cpu")
    cert_arena.reset()
    yield
    cert_arena.reset()


def keys(n: int = 4):
    """``tests/common.keys`` in the port's key types."""
    rng = random.Random(0)
    return [t_crypto.generate_keypair(seed=rng.randbytes(32))[:2] for _ in range(n)]


def consensus_committee(base_port: int, n: int = 4) -> Committee:
    return Committee({pk: Authority(1, ("127.0.0.1", base_port + i))
                      for i, (pk, _) in enumerate(keys(n))})


def chain(n_blocks: int) -> list[Block]:
    """``tests/common.chain`` built by the port: the same blocks, byte for
    byte."""
    key_list = keys()
    by_pk = dict(key_list)
    sorted_pks = sorted(by_pk)
    blocks, qc = [], QC.genesis()
    for r in range(1, n_blocks + 1):
        author = sorted_pks[r % len(sorted_pks)]
        blocks.append(Block.new_from_key(qc, None, author, r, [], by_pk[author]))
        qc = QC(hash=blocks[-1].digest(), round=r, votes=[])
        qc.votes = [(pk, Signature.new(qc.digest(), sk)) for pk, sk in key_list]
    return blocks


def _proof(n: int = 6, k: int = 2):
    """(blocks, frontier, child, cert): F = the block of round k + 1, c1 its
    consecutive child, cert the QC certifying c1 (carried by the block above
    c1)."""
    blocks = chain(n)
    return blocks, blocks[k], blocks[k + 1], blocks[k + 2].qc


# -- codec + structural proof checks ----------------------------------------


def test_snapshot_roundtrip_and_peek():
    _, frontier, child, cert = _proof()
    raw = encode_snapshot(frontier, child, cert)
    assert peek_frontier(raw) == (frontier.round, frontier.digest())
    snap = decode_snapshot(raw)
    assert snap.frontier.digest() == frontier.digest()
    assert snap.child.digest() == child.digest()
    assert snap.cert.hash == cert.hash and snap.cert.round == cert.round


def test_snapshot_rejects_unknown_version():
    _, frontier, child, cert = _proof()
    raw = encode_snapshot(frontier, child, cert)
    with pytest.raises(SnapshotError):
        decode_snapshot(b"\xff" + raw[1:])
    with pytest.raises(SnapshotError):
        peek_frontier(b"\xff" + raw[1:])


def test_snapshot_rejects_truncated_record():
    _, frontier, child, cert = _proof()
    raw = encode_snapshot(frontier, child, cert)
    with pytest.raises(SnapshotError):
        decode_snapshot(raw[: len(raw) // 2])
    with pytest.raises(SnapshotError):
        decode_snapshot(raw + b"\x00")  # trailing garbage must not parse


def test_snapshot_rejects_header_frontier_mismatch():
    blocks, frontier, child, cert = _proof()
    # The honest header (version, u64 round, 32 B digest) spliced onto a
    # body whose frontier block is another: the full decode must check that
    # the header matches the embedded block.
    honest = encode_snapshot(frontier, child, cert)
    forged = encode_snapshot(blocks[0], child, cert)
    with pytest.raises(SnapshotError):
        decode_snapshot(honest[:41] + forged[41:])


def test_snapshot_rejects_nonconsecutive_child():
    blocks = chain(6)
    # blocks[4].qc certifies blocks[3], not blocks[2].
    with pytest.raises(SnapshotError):
        decode_snapshot(encode_snapshot(blocks[2], blocks[4], blocks[5].qc))


def test_snapshot_rejects_cert_for_wrong_block():
    blocks = chain(6)
    # cert certifies blocks[4], not the child blocks[3].
    with pytest.raises(SnapshotError):
        decode_snapshot(encode_snapshot(blocks[2], blocks[3], blocks[5].qc))


def test_snapshot_rejects_genesis_frontier():
    blocks = chain(3)
    fake = Snapshot(blocks[0], blocks[1], blocks[2].qc)
    raw = encode_snapshot(fake.frontier, fake.child, fake.cert)
    # A round-1 frontier is the valid boundary (round 0 is the genesis
    # sentinel and cannot appear in a well-formed record).
    assert decode_snapshot(raw).frontier.round == 1


# -- cryptographic verification ---------------------------------------------


@async_test
async def test_verify_snapshot_accepts_honest_proof():
    _, frontier, child, cert = _proof()
    raw = encode_snapshot(frontier, child, cert)
    await verify_snapshot(decode_snapshot(raw), consensus_committee(BASE))


@async_test
async def test_verify_snapshot_rejects_forged_cert_votes():
    _, frontier, child, cert = _proof()
    # Topology valid, the cert re-signed with the wrong key: the structural
    # decode passes, the signature check must not.
    key_list = keys()
    wrong_sk = key_list[0][1]
    forged = QC(hash=cert.hash, round=cert.round,
                votes=[(pk, Signature.new(cert.digest(), wrong_sk)) for pk, _ in key_list])
    raw = encode_snapshot(frontier, child, forged)
    with pytest.raises(Exception):
        await verify_snapshot(decode_snapshot(raw), consensus_committee(BASE + 10))


# -- Compactor: snapshot + truncate over a real store -----------------------


class _CoreStub:
    def __init__(self, store, last_committed_round):
        self.store = store
        self.last_committed_round = last_committed_round
        self.synchronizer = self

    def note_floor(self, frontier):
        self.floor = frontier


@async_test
async def test_compactor_truncates_below_frontier(tmp_path):
    blocks = chain(20)
    store = Store(str(tmp_path / "db"))
    for b in blocks:
        await store.write(b.digest().data, b.serialize())
    comp = Compactor(store, retention_rounds=4)
    for b in blocks:
        comp.note_commit(b)
    core = _CoreStub(store, last_committed_round=18)
    await comp.maybe_compact(core)
    await comp.drain()  # the log rewrite runs as a background task
    raw = await store.read_meta(SNAPSHOT_KEY)
    assert raw is not None, "snapshot record must be written"
    snap = decode_snapshot(raw)
    assert snap.frontier.round <= 18 - 4
    assert core.floor.digest() == snap.frontier.digest()
    for b in blocks:
        data = await store.read(b.digest().data)
        if b.round < snap.frontier.round:
            assert data is None, f"round {b.round} should be truncated"
        else:
            assert data is not None, f"round {b.round} should survive"
    assert comp.compactions == 1 and comp.bytes_freed > 0
    assert comp.snapshot_round == snap.frontier.round
    assert comp.keys_dropped == snap.frontier.round - 1
    store.close()


@async_test
async def test_compactor_hysteresis_no_op_below_threshold(tmp_path):
    blocks = chain(10)
    store = Store(str(tmp_path / "db"))
    for b in blocks:
        await store.write(b.digest().data, b.serialize())
    comp = Compactor(store, retention_rounds=8)
    for b in blocks:
        comp.note_commit(b)
    # head - snapshot(0) = 10 < 2*8: must not snapshot yet.
    await comp.maybe_compact(_CoreStub(store, last_committed_round=10))
    await comp.drain()
    assert await store.read_meta(SNAPSHOT_KEY) is None
    assert comp.compactions == 0
    store.close()


@async_test
async def test_compactor_snapshot_survives_reopen(tmp_path):
    blocks = chain(20)
    path = str(tmp_path / "db")
    store = Store(path)
    for b in blocks:
        await store.write(b.digest().data, b.serialize())
    comp = Compactor(store, retention_rounds=4)
    for b in blocks:
        comp.note_commit(b)
    await comp.maybe_compact(_CoreStub(store, last_committed_round=18))
    await comp.drain()
    raw = await store.read_meta(SNAPSHOT_KEY)
    store.close()
    store2 = Store(path)
    assert await store2.read_meta(SNAPSHOT_KEY) == raw
    snap = decode_snapshot(raw)
    assert await store2.read(snap.frontier.digest().data) is not None
    for b in blocks:
        if b.round < snap.frontier.round:
            assert await store2.read(b.digest().data) is None
    store2.close()


# -- StateSync install: only certified state is adopted ----------------------


class _InstallCore:
    """The core surface ``StateSync._install`` touches, recording what the
    snapshot makes it adopt."""

    def __init__(self):
        self.store = Store()  # MemEngine
        self.synchronizer = self
        self.last_committed_round = 0
        self._last_committed_digest = None
        self.last_voted_round = 0
        self.qcs = []
        self.persists = 0
        self.cached = []

    def note_floor(self, frontier):
        self.floor = frontier

    def cache_block(self, block):
        self.cached.append(block)

    def increase_last_voted_round(self, target):
        self.last_voted_round = max(self.last_voted_round, target)

    async def process_qc(self, qc):
        self.qcs.append(qc)

    async def _persist_state(self):
        self.persists += 1


@async_test
async def test_install_adopts_only_certified_voting_floor():
    # The record carries no unauthenticated voting hint, and _install raises
    # the voting floor only to the round the certificates prove (c1's).
    _, frontier, child, cert = _proof()
    raw = encode_snapshot(frontier, child, cert)
    snap = decode_snapshot(raw)
    assert not hasattr(snap, "last_voted_round")

    ss = StateSync(keys()[0][0], consensus_committee(BASE + 20), 100)
    core = _InstallCore()
    ss._core = core
    await ss._install(snap, raw)

    assert core.last_voted_round == child.round
    assert core.floor.digest() == frontier.digest()
    assert core.last_committed_round == frontier.round
    assert [(q.hash, q.round) for q in core.qcs] == [(cert.hash, cert.round)]
    assert core.persists == 1
    assert ss.snapshots_installed == 1
    assert await core.store.read_meta(SNAPSHOT_KEY) == raw
    assert await core.store.read(frontier.digest().data) == frontier.serialize()
    assert await core.store.read(child.digest().data) == child.serialize()


# -- StateSync pull cap: forged frontier claims are O(1) ---------------------


class _PullSync:
    def __init__(self):
        self.requests = []
        self.cancelled = []
        self.outstanding = set()

    def request_block(self, digest, address):
        self.requests.append(digest)
        self.outstanding.add(digest)

    def requested(self, digest):
        return digest in self.outstanding

    def cancel_request(self, digest):
        self.cancelled.append(digest)
        self.outstanding.discard(digest)


class _PullCore:
    def __init__(self):
        self.synchronizer = _PullSync()
        self.last_committed_round = 0
        self.network = self
        self.scheduled = []
        self.sent = []

    def _call_later(self, delay, item):
        self.scheduled.append(item)

    def send(self, address, data):
        self.sent.append((address, data))


@async_test
async def test_forged_frontier_spray_bounded_to_one_pull():
    # A byzantine peer spraying distinct forged frontier digests must not
    # grow a request, a store obligation and a waiter per response.
    ss = StateSync(keys()[0][0], consensus_committee(BASE + 30), 100)
    core = _PullCore()
    ss._core = core
    for i in range(8):
        await ss.handle_state_response((50 + i, Digest(bytes([i]) * 32), None))
    assert len(core.synchronizer.requests) == 1
    assert ss.frontier_gap == 57


@async_test
async def test_pull_ttl_evicts_unservable_digest():
    ss = StateSync(keys()[0][0], consensus_committee(BASE + 40), 100)
    core = _PullCore()
    ss._core = core
    sync = core.synchronizer
    bogus = Digest(b"\x0b" * 32)
    await ss.handle_state_response((50, bogus, None))
    assert sync.requests == [bogus]
    # No peer ever serves it: after PULL_TTL_TICKS the slot is evicted
    # through cancel_request ...
    for _ in range(StateSync.PULL_TTL_TICKS):
        await ss.handle_tick()
    assert sync.cancelled == [bogus]
    assert ss._pull is None
    # ... and a later (honest) claim can use the slot again.
    honest = Digest(b"\xaa" * 32)
    await ss.handle_state_response((60, honest, None))
    assert sync.requests == [bogus, honest]
    # Commits never moved, so every tick after the first probed a peer.
    assert ss.probing == 1 and ss.probes_sent == StateSync.PULL_TTL_TICKS - 1
    assert len(core.sent) == ss.probes_sent


@async_test
async def test_pull_slot_frees_on_resolution_without_cancel():
    ss = StateSync(keys()[0][0], consensus_committee(BASE + 50), 100)
    core = _PullCore()
    ss._core = core
    sync = core.synchronizer
    first = Digest(b"\x01" * 32)
    await ss.handle_state_response((50, first, None))
    sync.outstanding.discard(first)  # the block arrived: request resolved
    await ss.handle_tick()
    assert ss._pull is None and sync.cancelled == []
    second = Digest(b"\x02" * 32)
    await ss.handle_state_response((60, second, None))
    assert sync.requests == [first, second]


# -- StateSync server: snapshot replies rate-limited per origin --------------


class _CountingStore:
    def __init__(self, snapshot):
        self._snapshot = snapshot
        self.meta_reads = 0

    async def read_meta(self, key):
        self.meta_reads += 1
        return self._snapshot


class _ServeCore:
    def __init__(self, store, frontier_digest):
        self.store = store
        self.last_committed_round = 30
        self._last_committed_digest = frontier_digest
        self.network = self
        self.sent = []

    def send(self, address, data):
        self.sent.append(data)


@async_test
async def test_state_request_snapshot_rate_limited_per_origin():
    # The origin field is unsigned and spoofable and the record heavy: at
    # most one attachment per origin per tick; frontier replies still flow.
    _, frontier, child, cert = _proof()
    raw = encode_snapshot(frontier, child, cert)
    ss = StateSync(keys()[0][0], consensus_committee(BASE + 60), 100)
    core = _ServeCore(_CountingStore(raw), frontier.digest())
    ss._core = core
    origin = keys()[1][0]
    for _ in range(3):
        await ss.handle_state_request((0, origin))
    assert core.store.meta_reads == 1  # snapshot attached once this tick
    assert len(core.sent) == 3  # every request still gets a frontier reply
    ss._tick_no += 1  # next probe window
    await ss.handle_state_request((0, origin))
    assert core.store.meta_reads == 2


# -- across the packages -------------------------------------------------------

CODEC = {"port": (encode_snapshot, decode_snapshot, peek_frontier),
         "reference": (j_statesync.encode_snapshot, j_statesync.decode_snapshot,
                       j_statesync.peek_frontier)}


def test_snapshot_record_is_byte_identical():
    t_blocks, j_blocks = chain(6), j_chain(6)
    assert [b.serialize() for b in t_blocks] == [b.serialize() for b in j_blocks]
    t_raw = encode_snapshot(t_blocks[2], t_blocks[3], t_blocks[4].qc)
    j_raw = j_statesync.encode_snapshot(j_blocks[2], j_blocks[3], j_blocks[4].qc)
    assert t_raw == j_raw


@pytest.mark.parametrize("writer,reader", [("port", "reference"), ("reference", "port")])
def test_snapshot_record_decodes_in_the_other_package(writer, reader):
    blocks = chain(6) if writer == "port" else j_chain(6)
    raw = CODEC[writer][0](blocks[2], blocks[3], blocks[4].qc)
    _, decode, peek = CODEC[reader]
    snap = decode(raw)
    assert snap.frontier.serialize() == blocks[2].serialize()
    assert snap.child.serialize() == blocks[3].serialize()
    assert (snap.cert.hash.data, snap.cert.round) == (blocks[4].qc.hash.data, blocks[4].qc.round)
    round_, digest = peek(raw)
    assert (round_, digest.data) == (3, blocks[2].digest().data)
    # A tampered record is refused alike: the cert of another block.
    bad = CODEC[writer][0](blocks[2], blocks[3], blocks[5].qc)
    with pytest.raises(Exception, match="cert does not certify child"):
        decode(bad)


@pytest.mark.parametrize("snapshot", [False, True])
def test_state_sync_frames_are_byte_identical(snapshot):
    blocks, j_blocks = chain(6), j_chain(6)
    raw = encode_snapshot(blocks[2], blocks[3], blocks[4].qc) if snapshot else None
    origin, j_origin = keys()[1][0], j_keys()[1][0]
    t_req = t_messages.encode_state_request(7, origin)
    assert t_req == j_messages.encode_state_request(7, j_origin)
    t_resp = t_messages.encode_state_response(9, blocks[5].digest(), raw)
    j_resp = j_messages.encode_state_response(9, j_blocks[5].digest(), raw)
    assert t_resp == j_resp
    kind, (since, who) = decode_message(j_messages.encode_state_request(7, j_origin))
    assert (kind, since, who) == ("state_request", 7, origin)
    kind, (round_, digest, snap) = decode_message(j_resp)
    assert (kind, round_, digest, snap) == ("state_response", 9, blocks[5].digest(), raw)
    kind, (round_, digest, snap) = j_messages.decode_message(t_resp)
    assert (kind, round_, digest.data, snap) == ("state_response", 9, blocks[5].digest().data, raw)


@async_test
async def test_both_compactors_write_the_same_record_and_log(tmp_path):
    """The same committed history through each package's Compactor and
    LogEngine store: the same snapshot record and the same compacted
    ``store.log``, byte for byte."""
    records, logs = {}, {}
    for name, blocks, store_cls, engine_cls, comp_cls in (
        ("port", chain(20), Store, LogEngine, Compactor),
        ("reference", j_chain(20), j_store.Store, j_store.LogEngine, j_statesync.Compactor),
    ):
        path = tmp_path / name
        store = store_cls(engine=engine_cls(str(path)))
        for b in blocks:
            await store.write(b.digest().data, b.serialize())
        comp = comp_cls(store, retention_rounds=4)
        for b in blocks:
            comp.note_commit(b)
        await comp.maybe_compact(_CoreStub(store, last_committed_round=18))
        await comp.drain()
        records[name] = await store.read_meta(SNAPSHOT_KEY)
        store.close()
        logs[name] = (path / "store.log").read_bytes()
    assert records["port"] is not None and records["port"] == records["reference"]
    assert logs["port"] == logs["reference"]


# -- the card path's Python, on the CPU ---------------------------------------


@async_test
async def test_snapshot_verifies_in_two_inner_calls_through_the_card_path():
    backend = BatchingBackend(CudaBackend(device="cpu"))
    t_crypto.set_backend(backend)
    _, frontier, child, cert = _proof()
    snap = decode_snapshot(encode_snapshot(frontier, child, cert))
    await verify_snapshot(snap, consensus_committee(BASE + 70))
    # The two QCs are awaited one after the other: they do not fuse.
    assert backend.inner_calls == 2 and backend.inner.dispatches == 2
    assert backend.inner.sigs == 2 * len(cert.votes)


class _FailingCore(_PullCore):
    def __init__(self):
        super().__init__()
        self._cert_cache = CertificateCache()
        self.store = Store()
        self.installs = 0


class _Unavailable:
    name = "cpu"

    def verify_batch(self, msgs, pubs, sigs):
        raise BackendUnavailable("card lost")

    def verify(self, msg, pub, sig):
        raise BackendUnavailable("card lost")


@async_test
async def test_snapshot_meeting_backend_unavailable_is_not_adopted():
    """A verification the backend cannot judge raises ``BackendUnavailable``
    out of the handler (the Core's ``_guarded`` counts it) and nothing of the
    record is adopted: no floor, no record, no pull."""
    t_crypto.set_backend(_Unavailable())
    _, frontier, child, cert = _proof()
    raw = encode_snapshot(frontier, child, cert)
    ss = StateSync(keys()[0][0], consensus_committee(BASE + 80), 100)
    core = _FailingCore()
    ss._core = core
    with pytest.raises(BackendUnavailable):
        await ss.handle_state_response((30, frontier.digest(), raw))
    assert ss.snapshots_installed == 0 and core.last_committed_round == 0
    assert await core.store.read_meta(SNAPSHOT_KEY) is None
    assert core.synchronizer.requests == []
