"""Mempool wire messages (reference ``mempool/src/mempool.rs:29-33``):
``Batch(Vec<Transaction>)`` and ``BatchRequest(Vec<Digest>, PublicKey)``.

Port copy of ``hotstuff_tpu/mempool/messages.py``, whole; the frames are
the reference's byte for byte.
"""

from __future__ import annotations

from hotstuff_tpu_torch.crypto import Digest, PublicKey
from hotstuff_tpu_torch.utils.serde import Decoder, Encoder, SerdeError

TAG_BATCH = 0
TAG_BATCH_REQUEST = 1


def encode_batch(transactions: list[bytes]) -> bytes:
    return (
        Encoder()
        .u8(TAG_BATCH)
        .seq(transactions, lambda e, tx: e.bytes(tx))
        .finish()
    )


def encode_batch_request(digests: list[Digest], requestor: PublicKey) -> bytes:
    return (
        Encoder()
        .u8(TAG_BATCH_REQUEST)
        .seq(digests, lambda e, d: e.raw(d.data))
        .raw(requestor.data)
        .finish()
    )


def decode(data: bytes):
    """Returns ("batch", [tx...]) or ("batch_request", ([digests], requestor)).

    Raises SerdeError on malformed input (byzantine peers)."""
    dec = Decoder(data)
    tag = dec.u8()
    if tag == TAG_BATCH:
        txs = dec.seq(lambda d: d.bytes())
        dec.finish()
        return ("batch", txs)
    if tag == TAG_BATCH_REQUEST:
        digests = dec.seq(lambda d: Digest(d.raw(32)))
        requestor = PublicKey(dec.raw(32))
        dec.finish()
        return ("batch_request", (digests, requestor))
    raise SerdeError(f"unknown mempool message tag {tag}")
