"""The consensus-to-mempool messages of the mempool synchronizer (reference
``mempool/src/synchronizer.rs``).

Port copy of ``hotstuff_tpu/mempool/synchronizer.py``, trimmed to
``Synchronize`` and ``Cleanup``; the synchronizer actor is the mempool
slice's.
"""

from __future__ import annotations

from dataclasses import dataclass

from hotstuff_tpu_torch.crypto import Digest, PublicKey


@dataclass
class Synchronize:
    digests: list[Digest]
    target: PublicKey


@dataclass
class Cleanup:
    round: int
