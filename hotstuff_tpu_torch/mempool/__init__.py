"""Mempool layer: batch dissemination ahead of consensus (reference
``mempool/src/mempool.rs``).

Port of ``hotstuff_tpu/mempool/__init__.py``: bulk transaction data travels
mempool-to-mempool as batches; consensus orders only their 32-byte
digests. ``workers > 0`` adds the data plane (``mempool/dataplane/``):
worker shards whose batches reach consensus with availability
certificates.
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
