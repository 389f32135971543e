"""Parallel runtimes: the sharded verifier over a mesh of cards (``mesh``)
and the process-sharded committee engine groups (``engine_groups``).

Port of ``hotstuff_tpu/parallel/__init__.py``. The reference resolves its
mesh exports lazily to keep jax out of its engine-group worker processes;
the port imports no jax, so it imports them eagerly.
"""

from . import engine_groups
from .mesh import make_mesh, msm_sharded, verify_batch_device_sharded

__all__ = ["engine_groups", "make_mesh", "msm_sharded", "verify_batch_device_sharded"]
