"""Data-plane frame tags and store keys.

Port copy of ``hotstuff_tpu/mempool/dataplane/messages.py``, trimmed to
``TAG_BATCH`` and ``cert_key``:

- a data-plane batch frame starts with ``TAG_BATCH`` (tags start at 16,
  disjoint from the legacy mempool tags), so the mempool's peer receiver
  can store such a frame when a peer serves it raw through the legacy
  sync path;
- availability certificates are persisted under ``cert_key(digest)`` so
  the consensus availability gate (``consensus/mempool_driver.py``) can
  vote on a block whose batches it never received.

The codec of the data plane's frames is not ported yet.
"""

from __future__ import annotations

TAG_BATCH = 17

#: store-key prefix for availability certificates (batches live under
#: their bare 32-byte digest).
CERT_KEY_PREFIX = b"dpc:"


def cert_key(digest_data: bytes) -> bytes:
    return CERT_KEY_PREFIX + digest_data
