"""The port's data plane (``hotstuff_tpu_torch/mempool/dataplane``) and its
sharded client on the CPU.

- Twins of ``tests/test_dataplane.py``'s tests on the port's modules: the
  bundle and worker-batch wire formats, the availability-cert quorum logic
  in both wire formats, the watermark's hysteresis, shedding at the
  ingress edge, worker batching, certification and dedup against live
  ACKing peers, commit-path resolution and the data plane's depth
  bookkeeping. Left out: the faultline ``batch_withhold`` test (faultline
  is not ported).
- Bundle, worker-batch, ack, batch-request and v1/v2 cert frames are
  byte-identical across the packages for the same seeded inputs, and each
  package decodes the other's frames to the same values.
- A torsioned-R ack (valid under the cofactored equation, not under the
  strict single check) is refused by both packages' ``CertCollector`` and
  ``AvailabilityCert.verify``.
- Twins of the reference's two client-coalescing tests
  (``tests/test_ingress_batching.py``) on the port's ``run_sharded_client``.
  Their server double closes its side of the connection at EOF: the
  reference's does not, and Python 3.12's ``Server.wait_closed`` waits for
  every connection to close, so the reference's tests hang after the
  client has finished (ROADMAP §3).
- ``Worker.shutdown`` stops the worker's senders, unlike the reference's
  (ROADMAP §3 F3).

Tolerance: byte-exact frames, equal decoded values, equal verdicts.
Ports 22200-22321.
"""

import asyncio
import random
import struct

import pytest

import hotstuff_tpu.crypto as j_crypto
import hotstuff_tpu.mempool.config as j_config
import hotstuff_tpu.mempool.dataplane as j_dp
import hotstuff_tpu.mempool.dataplane.messages as j_dpm
import hotstuff_tpu_torch.crypto as t_crypto
import hotstuff_tpu_torch.mempool.config as t_config
import hotstuff_tpu_torch.mempool.dataplane as t_dp
import hotstuff_tpu_torch.mempool.dataplane.messages as dpm
from hotstuff_tpu_torch.crypto import (
    Signature,
    SignatureService,
    generate_keypair,
    sha512_digest,
)
from hotstuff_tpu_torch.crypto import ed25519_ref as ref
from hotstuff_tpu_torch.mempool import Parameters, Synchronize
from hotstuff_tpu_torch.mempool.dataplane import (
    AvailabilityCert,
    BoundedIngress,
    CertCollector,
    CertError,
    CommitResolver,
    DataPlane,
    IngressHandler,
    Watermark,
    Worker,
    WorkerSeatTable,
    ack_digest,
    cert_key,
)
from hotstuff_tpu_torch.network.receiver import read_frames
from hotstuff_tpu_torch.store import Store
from hotstuff_tpu_torch.utils.serde import SerdeError

from .common import async_test
from .test_torch_core import Env

BASE = 22200
PKG = {"port": (t_crypto, t_config, t_dp, dpm), "reference": (j_crypto, j_config, j_dp, j_dpm)}


def keys(package: str = "port", n: int = 4):
    """``tests/common.keys``' seeded keys, in ``package``'s types."""
    crypto = PKG[package][0]
    rng = random.Random(0)
    return [crypto.generate_keypair(seed=rng.randbytes(32))[:2] for _ in range(n)]


def worker_committee(base_port: int, package: str = "port", n: int = 4, workers: int = 1):
    """Transactions on base+i, mempool on base+4+i, worker w's ingress on
    base+8+8w+i and its peer port on base+12+8w+i."""
    config = PKG[package][1]
    return config.Committee(
        authorities={
            pk: config.Authority(
                stake=1,
                transactions_address=("127.0.0.1", base_port + i),
                mempool_address=("127.0.0.1", base_port + 4 + i),
                workers=[
                    config.WorkerEntry(
                        transactions_address=("127.0.0.1", base_port + 8 + 8 * w + i),
                        worker_address=("127.0.0.1", base_port + 12 + 8 * w + i),
                    )
                    for w in range(workers)
                ],
            )
            for i, (pk, _) in enumerate(keys(package, n))
        }
    )


def tx(sample_id: int | None = None, size: int = 100) -> bytes:
    if sample_id is not None:
        return b"\x00" + sample_id.to_bytes(8, "big") + b"\x01" * (size - 9)
    return b"\x01" * size


# -- wire formats ------------------------------------------------------------


def test_bundle_roundtrip_and_sample_scan():
    txs = [tx(sample_id=3), tx(), tx(sample_id=9, size=50)]
    frame = dpm.encode_bundle(txs)
    n, samples, blob = dpm.decode_bundle(frame)
    assert n == 3 and samples == [3, 9]
    assert dpm.split_blob(blob) == txs
    assert dpm.batch_tx_bytes(n, blob) == sum(len(t) for t in txs)


def test_bundle_rejects_malformed():
    with pytest.raises(SerdeError):
        dpm.decode_bundle(b"")
    with pytest.raises(SerdeError):
        dpm.decode_bundle(bytes([dpm.TAG_TX_BUNDLE]) + b"\x00")
    bad = dpm.encode_bundle([tx()], sample_ids=[1, 2])  # more samples than txs
    with pytest.raises(SerdeError):
        dpm.decode_bundle(bad)


def test_worker_batch_roundtrip():
    txs = [tx(sample_id=1), tx(size=33)]
    bundle_blob = dpm.decode_bundle(dpm.encode_bundle(txs))[2]
    frame = dpm.encode_worker_batch(2, 2, [1], bundle_blob)
    wid, n, samples, blob = dpm.decode_worker_batch(frame)
    assert (wid, n, samples) == (2, 2, [1])
    assert dpm.split_blob(blob) == txs


# -- the frames across the packages ------------------------------------------


def frames(package: str, seed: int) -> dict[str, bytes]:
    """Every data-plane frame, made by ``package`` from seeded inputs."""
    crypto, _, dp, m = PKG[package]
    rng = random.Random(seed)
    txs = [tx(sample_id=rng.getrandbits(40)), rng.randbytes(rng.randrange(9, 300)),
           tx(size=rng.randrange(9, 64)), tx(sample_id=rng.getrandbits(63), size=9)]
    blob = m.decode_bundle(m.encode_bundle(txs))[2]
    ks = keys(package)
    digest = crypto.sha512_digest(rng.randbytes(64))
    committee = worker_committee(BASE, package)
    pairs = [(pk, crypto.Signature.new(m.ack_digest(digest), sk)) for pk, sk in ks[1:]]
    cert = dp.AvailabilityCert(digest, pairs)
    return {
        "bundle": m.encode_bundle(txs),
        "bundle_explicit_samples": m.encode_bundle(txs[1:], sample_ids=[7, 8]),
        "worker_batch": m.encode_worker_batch(rng.randrange(4), len(txs), [1, 2], blob),
        "ack": m.encode_ack(digest, ks[2][0], pairs[1][1]),
        "batch_request": m.encode_batch_request(
            [crypto.sha512_digest(bytes([i])) for i in range(3)], ks[3][0]),
        "cert_v1": cert.encode(),
        "cert_v2": cert.encode(dp.WorkerSeatTable.for_committee(committee)),
    }


FRAMES = ["bundle", "bundle_explicit_samples", "worker_batch", "ack", "batch_request",
          "cert_v1", "cert_v2"]


def decoded(package: str, kind: str, frame: bytes):
    """``frame`` decoded by ``package``, as plain bytes and ints."""
    _, _, dp, m = PKG[package]
    if kind.startswith("bundle"):
        return m.decode_bundle(frame)
    if kind == "worker_batch":
        return m.decode_worker_batch(frame)
    if kind == "ack":
        return tuple(bytes(x) for x in m.decode_ack(frame))
    if kind == "batch_request":
        digests, requestor = m.decode_batch_request(frame)
        return [bytes(d) for d in digests], bytes(requestor)
    seats = dp.WorkerSeatTable.for_committee(worker_committee(BASE, package))
    cert = dp.AvailabilityCert.decode(frame, seats)
    return bytes(cert.digest), [(bytes(pk), bytes(sig)) for pk, sig in cert.pairs]


@pytest.mark.parametrize("kind", FRAMES)
@pytest.mark.parametrize("seed", [1, 2])
def test_frames_byte_identical_and_cross_decode(kind, seed):
    port, reference = frames("port", seed)[kind], frames("reference", seed)[kind]
    assert port == reference
    assert decoded("port", kind, reference) == decoded("reference", kind, port)
    assert dpm.peek_tag(port) == j_dpm.peek_tag(reference)


@pytest.mark.parametrize("package", ["port", "reference"])
def test_cert_key_and_ack_digest_match(package):
    crypto, _, _, m = PKG[package]
    d = crypto.sha512_digest(b"batch")
    assert bytes(m.ack_digest(d)) == bytes(dpm.ack_digest(t_crypto.sha512_digest(b"batch")))
    assert m.cert_key(d.data) == dpm.cert_key(d.data) == b"dpc:" + d.data


# -- availability certs ------------------------------------------------------


def _signed_ack(digest, pk, sk):
    return pk, Signature.new(ack_digest(digest), sk)


def test_cert_collector_quorum_crossing_exactly_once():
    committee = worker_committee(BASE)
    ks = keys()
    d = sha512_digest(b"batch")
    col = CertCollector(committee, d, own=_signed_ack(d, *ks[0]))
    assert not col.complete()
    assert col.add_ack(*_signed_ack(d, *ks[1])) is None
    cert = col.add_ack(*_signed_ack(d, *ks[2]))
    assert cert is not None and col.complete()
    # Post-quorum stragglers and retransmits never re-emit the cert.
    assert col.add_ack(*_signed_ack(d, *ks[3])) is None
    assert col.add_ack(*_signed_ack(d, *ks[1])) is None
    cert.verify(committee)


def test_cert_collector_rejects_bad_acks():
    committee = worker_committee(BASE)
    ks = keys()
    d = sha512_digest(b"batch")
    col = CertCollector(committee, d)
    stranger_pk, stranger_sk = generate_keypair()[:2]
    with pytest.raises(CertError):
        col.add_ack(*_signed_ack(d, stranger_pk, stranger_sk))
    wrong = Signature.new(ack_digest(sha512_digest(b"other")), ks[1][1])
    with pytest.raises(CertError):
        col.add_ack(ks[1][0], wrong)
    assert col.stake == 0


def test_cert_wire_v1_and_v2_roundtrip_and_verify():
    committee = worker_committee(BASE)
    ks = keys()
    d = sha512_digest(b"batch")
    pairs = [_signed_ack(d, pk, sk) for pk, sk in ks[:3]]
    cert = AvailabilityCert(d, pairs)
    cert.verify(committee)
    seats = WorkerSeatTable.for_committee(committee)

    v1 = cert.encode()
    v2 = cert.encode(seats)
    assert v1[0] == dpm.TAG_CERT and v2[0] == dpm.TAG_CERT_V2
    assert len(v2) < len(v1)  # the bitmap drops the repeated 32 B keys

    for got in (AvailabilityCert.decode(v1), AvailabilityCert.decode(v2, seats)):
        assert got.digest == d
        assert sorted(map(bytes, got.signers())) == sorted(bytes(pk) for pk, _ in pairs)
        got.verify(committee)

    with pytest.raises(SerdeError):  # v2 without a seat table
        AvailabilityCert.decode(v2)


def test_cert_verify_rejects_subquorum_and_forgery():
    committee = worker_committee(BASE)
    ks = keys()
    d = sha512_digest(b"batch")
    with pytest.raises(CertError):
        AvailabilityCert(d, [_signed_ack(d, *ks[0])]).verify(committee)
    pair = _signed_ack(d, *ks[0])
    with pytest.raises(CertError):  # duplicate signers cannot fake a quorum
        AvailabilityCert(d, [pair, pair, pair]).verify(committee)
    pairs = [_signed_ack(d, pk, sk) for pk, sk in ks[:3]]
    with pytest.raises(CertError):
        AvailabilityCert(d, pairs[:2] + [(ks[2][0], Signature(bytes(64)))]).verify(committee)


def torsioned_ack(seed: bytes, digest_data: bytes) -> bytes:
    """A signature by ``seed``'s key over ``ack_digest(digest)`` whose R
    carries a torsion component (``tests/test_torch_verify.py``'s
    ``torsioned_signature``, with a committee member's key)."""
    a, _ = ref.secret_expand(seed)
    pub = ref.point_compress(ref.point_mul(a, ref.G))
    msg = dpm.ack_digest(t_crypto.Digest(digest_data)).data
    r = random.Random(digest_data).getrandbits(250) % ref.L
    r_enc = ref.point_compress(ref.point_add(ref.point_mul(r, ref.G), ref.torsion_generator()))
    s = (r + ref.compute_challenge(r_enc, pub, msg) * a) % ref.L
    sig = r_enc + s.to_bytes(32, "little")
    assert ref.verify(pub, msg, sig, strict=False) and not ref.verify(pub, msg, sig, strict=True)
    return sig


@pytest.mark.parametrize("package", ["port", "reference"])
def test_torsioned_r_ack_rejected_like_the_reference(package):
    """The strict single check on acks and certificates refuses what the
    cofactored batch check of the certificate path would accept."""
    crypto, _, dp, m = PKG[package]
    committee = worker_committee(BASE, package)
    ks = keys(package)
    port_seed = keys("port")[2][1].seed
    d = crypto.sha512_digest(b"torsioned batch")
    bad = crypto.Signature(torsioned_ack(port_seed, d.data))
    col = dp.CertCollector(committee, d)
    with pytest.raises(dp.CertError):
        col.add_ack(ks[2][0], bad)
    assert col.stake == 0
    good = [(pk, crypto.Signature.new(m.ack_digest(d), sk)) for pk, sk in ks[:2]]
    with pytest.raises(dp.CertError):
        dp.AvailabilityCert(d, good + [(ks[2][0], bad)]).verify(committee)
    dp.AvailabilityCert(
        d, good + [(ks[2][0], crypto.Signature.new(m.ack_digest(d), ks[2][1]))]).verify(committee)


# -- back-pressure -----------------------------------------------------------


def test_watermark_hysteresis_transitions():
    async def main():
        wm = Watermark(high=4, low=2)
        assert not wm.gated
        wm.update(3)
        assert not wm.gated
        wm.update(4)
        assert wm.gated and wm.transitions == 1  # ok -> high at >= high
        wm.update(3)
        assert wm.gated  # hysteresis: above low stays gated
        wm.update(2)
        assert not wm.gated and wm.transitions == 2  # high -> ok at <= low
        wm.update(10)
        assert wm.gated and wm.transitions == 3
        with pytest.raises(ValueError):
            Watermark(high=1, low=2)

    asyncio.run(main())


def test_watermark_gates_and_releases_waiters():
    async def main():
        wm = Watermark(high=2, low=0)
        wm.update(2)
        waited = []

        async def waiter():
            await wm.wait_ok()
            waited.append(True)

        task = asyncio.create_task(waiter())
        await asyncio.sleep(0.02)
        assert not waited  # parked while gated
        wm.update(0)
        await asyncio.sleep(0.02)
        assert waited
        await task

    asyncio.run(main())


def test_bounded_ingress_sheds_when_full():
    async def main():
        ingress = BoundedIngress(2)
        assert ingress.offer(b"a") and ingress.offer(b"b")
        assert not ingress.offer(b"c")
        assert ingress.shed == 1
        assert await ingress.get() == b"a"
        assert ingress.offer(b"c")

    asyncio.run(main())


class _FakeWriter:
    def __init__(self):
        self.sent = []

    async def send(self, payload):
        self.sent.append(payload)


@async_test
async def test_ingress_handler_client_visible_shedding():
    ingress = BoundedIngress(1)
    handler = IngressHandler(ingress)
    writer = _FakeWriter()
    bundle = dpm.encode_bundle([tx(), tx()])
    await handler.dispatch(writer, bundle)
    assert writer.sent == []  # accepted silently
    await handler.dispatch(writer, bundle)
    assert writer.sent == [b"Shed"]  # the client SEES the refusal


@async_test
async def test_worker_dispatch_frames_offers_and_sheds():
    """Twin of ``tests/test_ingress_batching.py``'s: valid bundles land in
    the bounded queue, overflow sheds with a per-writer ``b"Shed"``,
    non-bundle frames are ignored (the port queues no arrival stamp)."""
    ingress = BoundedIngress(2)
    handler = IngressHandler(ingress)
    w_ok, w_shed, w_junk = _FakeWriter(), _FakeWriter(), _FakeWriter()
    await handler.dispatch_frames([
        (w_ok, dpm.encode_bundle([tx()] * 3)),
        (w_junk, b"\xff not a bundle"),
        (w_ok, dpm.encode_bundle([tx()] * 5)),
        (w_shed, dpm.encode_bundle([tx()] * 7)),
    ])
    assert ingress.qsize() == 2 and ingress.shed == 1
    assert w_shed.sent == [b"Shed"] and w_ok.sent == [] and w_junk.sent == []
    m1, m2 = ingress.get_nowait(), ingress.get_nowait()
    assert dpm.decode_bundle(m1)[0] == 3 and dpm.decode_bundle(m2)[0] == 5


# -- worker end to end against live ACKing peers ------------------------------


async def _acking_peer(port: int, secret, store: dict, *, sign: bool = True):
    """A one-connection peer worker double: stores batch frames and replies
    signed acks (or stays silent when ``sign`` is False)."""

    async def handle(reader, writer):
        try:
            while True:
                (n,) = struct.unpack(">I", await reader.readexactly(4))
                frame = await reader.readexactly(n)
                if frame[0] == dpm.TAG_BATCH:
                    digest = sha512_digest(frame)
                    store[digest.data] = frame
                    if sign:
                        sig = Signature.new(ack_digest(digest), secret)
                        ack = dpm.encode_ack(digest, secret.public_key(), sig)
                        writer.write(struct.pack(">I", len(ack)) + ack)
                        await writer.drain()
                elif frame[0] in (dpm.TAG_CERT, dpm.TAG_CERT_V2):
                    store.setdefault(b"certs", []).append(frame)
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        writer.close()

    return await asyncio.start_server(handle, "127.0.0.1", port)


async def _peers(committee, ks, stores, sign=lambda i: True):
    servers = []
    for i, ((pk, sk), store) in enumerate(zip(ks[1:], stores)):
        addr = committee.worker_address(pk, 0)
        servers.append(await _acking_peer(addr[1], sk, store, sign=sign(i)))
    await asyncio.sleep(0.05)
    return servers


async def _send(committee, name, bundles):
    _, writer = await asyncio.open_connection(
        "127.0.0.1", committee.workers_of(name)[0].transactions_address[1])
    for frame in bundles:
        writer.write(struct.pack(">I", len(frame)) + frame)
    await writer.drain()
    return writer


@async_test(timeout=30)
async def test_worker_seals_certifies_and_emits_digest():
    committee = worker_committee(BASE + 20)
    ks = keys()
    name = ks[0][0]
    peer_stores = [dict() for _ in range(3)]
    servers = await _peers(committee, ks, peer_stores)
    store = Store()
    tx_consensus = asyncio.Queue()
    params = Parameters(batch_size=150, max_batch_delay=5_000, workers=1)
    worker = Worker(name, 0, committee, params, store, SignatureService(ks[0][1]),
                    tx_consensus, Watermark(100, 50))
    await worker.spawn()
    # Two bundles crossing batch_size: an immediate seal and dissemination.
    writer = await _send(committee, name, [dpm.encode_bundle([tx(sample_id=s)]) for s in (1, 2)])

    digest = await asyncio.wait_for(tx_consensus.get(), 10)
    batch = await store.read(digest.data)
    wid, n_txs, samples, _ = dpm.decode_worker_batch(batch)
    assert (wid, n_txs, sorted(samples)) == (0, 2, [1, 2])
    cert = AvailabilityCert.decode(await store.read(cert_key(digest.data)),
                                   WorkerSeatTable.for_committee(committee))
    assert cert.digest == digest
    cert.verify(committee)
    await asyncio.sleep(0.2)
    for ps in peer_stores:  # every live peer holds the raw batch frame
        assert ps.get(digest.data) == batch
    assert (worker.batches_sealed, worker.certs_formed, worker.acks_invalid) == (1, 1, 0)

    writer.close()
    await worker.shutdown()
    for s in servers:
        s.close()


@async_test(timeout=30)
async def test_worker_certifies_despite_one_withholding_peer():
    """2f+1 = 3 of 4 with own stake: one peer that stores but never acks
    cannot block certification."""
    committee = worker_committee(BASE + 40)
    ks = keys()
    name = ks[0][0]
    servers = await _peers(committee, ks, [dict() for _ in range(3)], sign=lambda i: i != 0)
    store = Store()
    tx_consensus = asyncio.Queue()
    params = Parameters(batch_size=50, max_batch_delay=5_000, workers=1)
    worker = Worker(name, 0, committee, params, store, SignatureService(ks[0][1]),
                    tx_consensus, Watermark(100, 50))
    await worker.spawn()
    writer = await _send(committee, name, [dpm.encode_bundle([tx(sample_id=5)])])

    digest = await asyncio.wait_for(tx_consensus.get(), 10)
    cert = AvailabilityCert.decode(await store.read(cert_key(digest.data)),
                                   WorkerSeatTable.for_committee(committee))
    cert.verify(committee)
    assert bytes(ks[1][0]) not in {bytes(pk) for pk in cert.signers()}

    writer.close()
    await worker.shutdown()
    for s in servers:
        s.close()


@async_test(timeout=30)
async def test_worker_dedups_retransmitted_bundles():
    committee = worker_committee(BASE + 60)
    ks = keys()
    name = ks[0][0]
    servers = await _peers(committee, ks, [dict() for _ in range(3)])
    store = Store()
    tx_consensus = asyncio.Queue()
    params = Parameters(batch_size=1_000_000, max_batch_delay=100, workers=1)
    worker = Worker(name, 0, committee, params, store, SignatureService(ks[0][1]),
                    tx_consensus, Watermark(100, 50))
    await worker.spawn()
    bundle = dpm.encode_bundle([tx(sample_id=1), tx()])
    other = dpm.encode_bundle([tx(sample_id=2)])
    writer = await _send(committee, name, [bundle, bundle, other, bundle])  # retransmits

    digest = await asyncio.wait_for(tx_consensus.get(), 10)
    _, n_txs, samples, _ = dpm.decode_worker_batch(await store.read(digest.data))
    assert n_txs == 3 and sorted(samples) == [1, 2]

    writer.close()
    await worker.shutdown()
    for s in servers:
        s.close()


def sender_tasks() -> list[asyncio.Task]:
    return [t for t in asyncio.all_tasks()
            if t.get_coro().cr_code.co_filename.endswith(("reliable_sender.py", "simple_sender.py"))]


@async_test(timeout=30)
async def test_worker_shutdown_closes_its_senders():
    """A stopped worker's ReliableSender would go on retransmitting its
    batches to the peers' ports, and its SimpleSenders keep their
    connections; the reference's ``Worker.shutdown`` leaves both."""
    committee = worker_committee(BASE + 80)
    ks = keys()
    name = ks[0][0]
    servers = await _peers(committee, ks, [dict() for _ in range(3)])
    tx_consensus = asyncio.Queue()
    params = Parameters(batch_size=50, max_batch_delay=5_000, workers=1)
    worker = Worker(name, 0, committee, params, Store(), SignatureService(ks[0][1]),
                    tx_consensus, Watermark(100, 50))
    await worker.spawn()
    writer = await _send(committee, name, [dpm.encode_bundle([tx(sample_id=5)])])
    await asyncio.wait_for(tx_consensus.get(), 10)
    assert sender_tasks(), "no batch or certificate went out"
    writer.close()
    await worker.shutdown()
    await asyncio.sleep(0.1)
    assert sender_tasks() == []
    for s in servers:
        s.close()


def test_card_committee_binds_below_the_hosts_ephemeral_range():
    """The card test's committee (four nodes with two workers each, seven
    ports a node in ``benchmark/local.py``'s layout) binds below the H100
    host's ephemeral range (16000-65535), where an earlier engine's
    outgoing connection may hold a port, and clear of ``chip_smoke.py``'s
    phases (10000-10599) and the bench's range (10600-10699)."""
    from . import test_torch_dataplane_card as card

    ports = range(card.BASE, card.BASE + 7 * 4)
    assert min(ports) >= 10700 and max(ports) < 16000


# -- commit-path resolution --------------------------------------------------


@async_test
async def test_commit_resolver_passes_local_and_fetches_missing():
    store = Store()
    rx, out, to_mempool = asyncio.Queue(), asyncio.Queue(), asyncio.Queue()
    CommitResolver.spawn(store, rx, out, to_mempool)
    present = sha512_digest(b"present-batch")
    await store.write(present.data, b"present-batch")
    missing = sha512_digest(b"missing-batch")
    block = Env("port").chain(1)[0]
    block.payload = [present, missing]

    await rx.put(block)
    sync = await asyncio.wait_for(to_mempool.get(), 5)
    assert isinstance(sync, Synchronize) and sync.digests == [missing]
    await asyncio.sleep(0.05)
    assert out.empty()  # held until the batch materializes
    await store.write(missing.data, b"missing-batch")
    assert await asyncio.wait_for(out.get(), 5) is block


@async_test
async def test_commit_resolver_preserves_commit_order():
    store = Store()
    rx, out, to_mempool = asyncio.Queue(), asyncio.Queue(), asyncio.Queue()
    resolver = CommitResolver(store, rx, out, to_mempool)
    resolver.start()
    blocks = Env("port").chain(3)
    d = sha512_digest(b"late")
    blocks[0].payload = [d]  # the first block waits on a fetch
    for b in blocks:
        await rx.put(b)
    await asyncio.wait_for(to_mempool.get(), 5)
    await store.write(d.data, b"late")
    got = [await asyncio.wait_for(out.get(), 5) for _ in range(3)]
    assert got == blocks  # strictly in commit order
    assert (resolver.batches_fetched, resolver.batches_resolved, resolver.unresolved) == (1, 0, 0)


@async_test
async def test_dataplane_depth_rises_on_seal_and_falls_on_commit():
    committee = worker_committee(BASE + 100)
    ks = keys()
    params = Parameters(workers=1, store_high_watermark=4, store_low_watermark=2)
    dp = DataPlane(ks[0][0], committee, params, Store(), SignatureService(ks[0][1]),
                   asyncio.Queue())
    digests = [sha512_digest(f"b{i}".encode()) for i in range(5)]
    for d in digests[:4]:
        dp._note_sealed(d)
    assert dp.watermark.depth == 4 and dp.watermark.gated
    dp._note_sealed(digests[0])  # re-seal dedup: no double count
    assert dp.watermark.depth == 4
    dp.note_committed(digests[:3])
    assert dp.watermark.depth == 1 and not dp.watermark.gated
    dp.note_committed(digests[:3])  # idempotent
    assert dp.watermark.depth == 1
    dp.note_committed([digests[3], digests[4]])  # unknown digest: no-op
    assert dp.watermark.depth == 0


# -- the client's coalescing -------------------------------------------------


async def _frame_server(port: int, on_frames):
    async def on_conn(reader, writer):
        buf = bytearray()
        try:
            while True:
                got = await read_frames(reader, buf)
                if not got:
                    break
                on_frames(got)
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        writer.close()  # or Server.wait_closed waits for this connection

    return await asyncio.start_server(on_conn, "127.0.0.1", port)


@async_test(timeout=30)
async def test_client_coalescing_preserves_bundles_and_flushes_on_latency():
    """With the byte bound far above what a burst makes, only the latency
    bound can flush: bundles arrive promptly and parse at their original
    boundaries."""
    from hotstuff_tpu_torch.node.client import run_sharded_client

    got_frames = []

    server = await _frame_server(BASE + 120, got_frames.extend)
    await run_sharded_client([("127.0.0.1", BASE + 120)], size=32, rate=400, timeout_ms=0,
                             nodes=[], duration=1.2, coalesce_bytes=1 << 20, coalesce_ms=20.0)
    await asyncio.sleep(0.3)  # the server drains the tail
    server.close()
    await server.wait_closed()
    assert got_frames, "latency-bound flush never fired"
    for frame in got_frames:
        n_txs, samples, blob = dpm.decode_bundle(frame)  # boundaries intact
        assert len(dpm.split_blob(blob)) == n_txs and len(samples) <= 1


@async_test(timeout=30)
async def test_client_coalescing_packs_small_bundles():
    """A generous latency bound and a byte bound of several bundles:
    consecutive bursts coalesce, so some read holds 2+ whole bundles."""
    from hotstuff_tpu_torch.node.client import run_sharded_client

    total, multi = [0], [0]

    def on_frames(got):
        total[0] += len(got)
        multi[0] += len(got) > 1

    server = await _frame_server(BASE + 121, on_frames)
    await run_sharded_client([("127.0.0.1", BASE + 121)], size=32, rate=400, timeout_ms=0,
                             nodes=[], duration=1.5, coalesce_bytes=64 * 1024, coalesce_ms=500.0)
    await asyncio.sleep(0.3)
    server.close()
    await server.wait_closed()
    assert total[0] > 0 and multi[0] >= 1, "no packed write observed"


@async_test(timeout=30)
async def test_sharded_client_bundles_match_the_reference_layout():
    """The port's bundler writes what the reference's decodes, and a shard
    that refuses bundles is counted through the ``Shed`` replies."""
    from hotstuff_tpu.node.client import _make_bundler as j_bundler
    from hotstuff_tpu_torch.node.client import _make_bundler, _make_shed_counter

    for make in (_make_bundler, j_bundler):
        frame = make(64)(5, 42)
        for m in (dpm, j_dpm):
            n, samples, blob = m.decode_bundle(frame)
            txs = m.split_blob(blob)
            assert (n, samples, len(txs)) == (5, [42], 5) and all(len(t) == 64 for t in txs)
            assert txs[0][:9] == b"\x00" + (42).to_bytes(8, "big")
    shed = [0]
    reader = asyncio.StreamReader()
    for reply in (b"Shed", b"Ack", b"Shed"):
        reader.feed_data(len(reply).to_bytes(4, "big") + reply)
    reader.feed_eof()
    await _make_shed_counter(shed)(reader)
    assert shed == [2]
