"""Parallel runtimes: the sharded verifier over a mesh of cards (``mesh``).

Port of ``hotstuff_tpu/parallel/__init__.py``'s mesh exports. The
reference resolves them lazily to keep jax out of its engine-group worker
processes; the port imports no jax, so it imports them eagerly.
``engine_groups`` is not ported.
"""

from .mesh import make_mesh, msm_sharded, verify_batch_device_sharded

__all__ = ["make_mesh", "msm_sharded", "verify_batch_device_sharded"]
