"""Mempool layer: batch dissemination ahead of consensus (reference
``mempool/src/mempool.rs``).

Port of ``hotstuff_tpu/mempool/__init__.py``: bulk transaction data travels
mempool-to-mempool as batches; consensus orders only their 32-byte
digests. The data plane (``mempool/dataplane/``) is not ported yet, apart
from its frame tag and store key.
"""

from .config import Authority, Committee, Parameters, WorkerEntry
from .mempool import Mempool
from .synchronizer import Cleanup, Synchronize

__all__ = [
    "Authority",
    "Committee",
    "Parameters",
    "WorkerEntry",
    "Mempool",
    "Synchronize",
    "Cleanup",
]
