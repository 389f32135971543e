"""Data-plane store keys.

Port copy of ``hotstuff_tpu/mempool/dataplane/messages.py``, trimmed to
``cert_key``: availability certificates are persisted under
``cert_key(digest)`` so the consensus availability gate
(``consensus/mempool_driver.py``) can vote on a block whose batches it
never received.
"""

from __future__ import annotations

#: store-key prefix for availability certificates (batches live under
#: their bare 32-byte digest).
CERT_KEY_PREFIX = b"dpc:"


def cert_key(digest_data: bytes) -> bytes:
    return CERT_KEY_PREFIX + digest_data
