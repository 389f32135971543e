"""Snapshot-record helpers of replica state sync.

Port copy of ``hotstuff_tpu/consensus/statesync.py``, trimmed to what the
helper's snapshot branch reads: ``SNAPSHOT_KEY``, ``SnapshotError`` and
``peek_frontier``. ``StateSync`` (anti-entropy catch-up) and ``Compactor``
(snapshot + truncate) stay in the reference until the state-sync slice;
without a compactor no snapshot record is ever written, so the helper
answers an unservable digest with nothing.
"""

from __future__ import annotations

from hotstuff_tpu_torch.crypto import Digest
from hotstuff_tpu_torch.utils.serde import Decoder

from .errors import ConsensusError

#: MetaLog key of the snapshot record (overwrite semantics, never in the
#: data log — so truncation can never drop its own floor record).
SNAPSHOT_KEY = b"__store_snapshot__"

# v2 dropped the trailing ``last_voted_round`` hint: it was certified by
# neither QC, so adopting it let a byzantine record mute an honest joiner.
_SNAPSHOT_VERSION = 2


class SnapshotError(ConsensusError):
    """Malformed or unproven snapshot record (byzantine or corrupt)."""


def peek_frontier(data: bytes) -> tuple[int, Digest]:
    """Frontier (round, digest) from a snapshot record's fixed header —
    the cheap read the Helper/probe-serving paths use."""
    dec = Decoder(data)
    if dec.u8() != _SNAPSHOT_VERSION:
        raise SnapshotError("unknown snapshot version")
    return dec.u64(), Digest(dec.raw(32))
