"""Mempool layer of the port: so far only the two messages the consensus
engine sends the mempool (``Synchronize``, ``Cleanup``).

Port copy of ``hotstuff_tpu/mempool/__init__.py``, trimmed to those names;
the mempool itself (batch maker, quorum waiter, processor, data plane) is
the next slice.
"""

from .synchronizer import Cleanup, Synchronize

__all__ = ["Synchronize", "Cleanup"]
