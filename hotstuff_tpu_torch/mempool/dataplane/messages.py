"""Conveyor wire messages: the worker-sharded data plane's frame formats.

Port copy of ``hotstuff_tpu/mempool/dataplane/messages.py``, whole; the
frames are the reference's byte for byte.

Design rule: the node-side hot path never touches individual
transactions. Clients pre-frame their transactions into **bundles**
whose header carries the tx count and the benchmark sample ids, and
whose body is an opaque length-prefixed blob. A worker seals a batch by
CONCATENATING bundle blobs, so the tx bytes flow client → batch frame →
peer store as unparsed slices, and per-transaction Python cost stays on
the client.

Frames on the worker ports:

- ``TxBundle`` (client → worker ingress): header + opaque tx blob.
- ``WorkerBatch`` (worker → peer workers): a sealed batch; its DIGEST is
  SHA-512/32 of the entire serialized frame, so storing the raw frame
  under its digest needs no re-encode.
- ``BatchAck`` (peer worker → disseminating worker, as the framed reply
  on the batch connection): a SIGNATURE over the domain-separated ack
  digest, the unit availability certificates are made of.
- ``Cert`` (worker → peers, best-effort broadcast): 2f+1 acks bound to
  one digest. Two wire formats, mirroring consensus wire v2: v1 repeats
  ``(pk, sig)`` pairs; v2 names signers as a seat BITMAP over the
  mempool committee's sorted key order plus concatenated signatures.
- ``BatchRequest``: digest list + requestor, served from the store.

Certs are persisted under ``cert_key(digest)`` so the consensus
availability gate (``consensus/mempool_driver.py``) can vote on a block
whose batches it never received: ordering needs the proof of
availability, not the bytes.
"""

from __future__ import annotations

from hotstuff_tpu_torch.crypto import Digest, PublicKey, Signature, sha512_digest
from hotstuff_tpu_torch.utils.serde import Decoder, Encoder, SerdeError

# Tags start at 16: disjoint from the legacy mempool tags (0, 1) AND the
# consensus tags, so a data-plane frame routed through the legacy mempool
# port (the synchronizer's batch-fetch path serves stored frames raw) is
# recognizable from its first byte.
TAG_TX_BUNDLE = 16
TAG_BATCH = 17
TAG_ACK = 18
TAG_CERT = 19
TAG_CERT_V2 = 20
TAG_BATCH_REQUEST = 21

#: store-key prefix for availability certificates (batches live under
#: their bare 32-byte digest, exactly like the legacy mempool path).
CERT_KEY_PREFIX = b"dpc:"


def cert_key(digest_data: bytes) -> bytes:
    return CERT_KEY_PREFIX + digest_data


def ack_digest(digest: Digest) -> Digest:
    """What a batch ack signs: domain-separated from every consensus
    digest so an availability ack can never be replayed as a vote."""
    return sha512_digest(b"conveyor-ack-v1", digest.data)


# -- client bundles ----------------------------------------------------------


def encode_bundle(txs: list[bytes], sample_ids: list[int] | None = None) -> bytes:
    """Client-side bundle builder (the slow, per-tx path lives HERE, on
    the load generator). ``sample_ids`` defaults to scanning ``txs`` for
    the benchmark sample prefix."""
    if sample_ids is None:
        sample_ids = [
            int.from_bytes(tx[1:9], "big")
            for tx in txs
            if tx[:1] == b"\x00" and len(tx) > 8
        ]
    enc = Encoder().u8(TAG_TX_BUNDLE).u32(len(txs)).u32(len(sample_ids))
    for s in sample_ids:
        enc.u64(s)
    enc.bytes(b"".join(len(tx).to_bytes(4, "big") + tx for tx in txs))
    return enc.finish()


def decode_bundle(data: bytes) -> tuple[int, list[int], bytes]:
    """(n_txs, sample_ids, blob). Raises SerdeError on malformed input."""
    dec = Decoder(data)
    if dec.u8() != TAG_TX_BUNDLE:
        raise SerdeError("not a tx bundle")
    n_txs = dec.u32()
    n_samples = dec.u32()
    if n_samples > n_txs:
        raise SerdeError("bundle claims more samples than txs")
    samples = [dec.u64() for _ in range(n_samples)]
    blob = dec.bytes()
    dec.finish()
    return n_txs, samples, blob


def split_blob(blob: bytes) -> list[bytes]:
    """Materialize the individual transactions of a bundle/batch blob:
    the execution/commit-resolution path, never the ingest hot path."""
    txs = []
    pos = 0
    n = len(blob)
    while pos < n:
        if pos + 4 > n:
            raise SerdeError("truncated tx length prefix in blob")
        tx_len = int.from_bytes(blob[pos : pos + 4], "big")
        pos += 4
        if pos + tx_len > n:
            raise SerdeError("truncated tx in blob")
        txs.append(blob[pos : pos + tx_len])
        pos += tx_len
    return txs


# -- worker batches ----------------------------------------------------------


def encode_worker_batch(
    worker_id: int, n_txs: int, sample_ids: list[int], blob: bytes
) -> bytes:
    enc = Encoder().u8(TAG_BATCH).u32(worker_id).u32(n_txs).u32(len(sample_ids))
    for s in sample_ids:
        enc.u64(s)
    enc.bytes(blob)
    return enc.finish()


def decode_worker_batch(data: bytes) -> tuple[int, int, list[int], bytes]:
    """(worker_id, n_txs, sample_ids, blob)."""
    dec = Decoder(data)
    if dec.u8() != TAG_BATCH:
        raise SerdeError("not a worker batch")
    worker_id = dec.u32()
    n_txs = dec.u32()
    n_samples = dec.u32()
    if n_samples > n_txs:
        raise SerdeError("batch claims more samples than txs")
    samples = [dec.u64() for _ in range(n_samples)]
    blob = dec.bytes()
    dec.finish()
    return worker_id, n_txs, samples, blob


def batch_tx_bytes(n_txs: int, blob: bytes) -> int:
    """Transaction payload bytes of a batch blob (minus the per-tx length
    prefixes): the size the ``Batch d contains N B`` log line reports,
    matching the legacy BatchMaker's sum of tx lengths."""
    return len(blob) - 4 * n_txs


# -- acks --------------------------------------------------------------------


def encode_ack(digest: Digest, signer: PublicKey, signature: Signature) -> bytes:
    return (
        Encoder()
        .u8(TAG_ACK)
        .raw(digest.data)
        .raw(signer.data)
        .raw(signature.data)
        .finish()
    )


def decode_ack(data: bytes) -> tuple[Digest, PublicKey, Signature]:
    dec = Decoder(data)
    if dec.u8() != TAG_ACK:
        raise SerdeError("not a batch ack")
    digest = Digest(dec.raw(32))
    signer = PublicKey(dec.raw(32))
    signature = Signature(dec.raw(64))
    dec.finish()
    return digest, signer, signature


# -- batch requests ----------------------------------------------------------


def encode_batch_request(digests: list[Digest], requestor: PublicKey) -> bytes:
    return (
        Encoder()
        .u8(TAG_BATCH_REQUEST)
        .seq(digests, lambda e, d: e.raw(d.data))
        .raw(requestor.data)
        .finish()
    )


def decode_batch_request(data: bytes) -> tuple[list[Digest], PublicKey]:
    dec = Decoder(data)
    if dec.u8() != TAG_BATCH_REQUEST:
        raise SerdeError("not a batch request")
    digests = dec.seq(lambda d: Digest(d.raw(32)))
    requestor = PublicKey(dec.raw(32))
    dec.finish()
    return digests, requestor


def peek_tag(data: bytes) -> int:
    if not data:
        raise SerdeError("empty frame")
    return data[0]
