"""CUDA batch-verification backend.

Port of ``hotstuff_tpu/crypto/tpu_backend.py``. Routes
``Signature.verify_batch`` to the random-linear-combination verifier of
``hotstuff_tpu_torch.ops.verify`` — the QC hot path (reference
``crypto/src/lib.rs:206-219``). Acceptance semantics are cofactored
(dalek ``verify_batch``).

With more than one visible card the backend shards the MSM lanes over a
mesh of them and combines the shards' results on its own card
(``parallel.mesh``), as the reference does over a ``jax.sharding.Mesh``.
Override with ``sharded=True/False`` or ``HOTSTUFF_TPU_SHARDED``
(``auto`` when unset; ``0``, ``false`` or ``no`` off; anything else on).
With one card there is no mesh, whatever the switch says.

The error contract is the reference's (``tpu_backend.py:64-106``):

- a length mismatch raises ``CryptoError``;
- a runtime or kernel failure raises ``BackendUnavailable`` — the batch
  was not judged;
- a rejected batch raises ``CryptoError``;
- on ``CacheFull`` the backend starts a fresh cache and verifies the
  batch through the uncached path.

Each non-empty batch counts into the telemetry counters
``crypto.dispatch.cuda`` and ``crypto.dispatch.cuda_sigs`` (the
reference's ``crypto.dispatch.tpu`` and ``tpu_sigs``, renamed as the
switches' values are), and into ``dispatches`` and ``sigs``. With the
stage spans armed (``telemetry/stages.py``) each such batch is one
``crypto.backend`` span.
"""

from __future__ import annotations

import os
import threading

from hotstuff_tpu_torch import telemetry
from hotstuff_tpu_torch.ops import verify as ops_verify
from hotstuff_tpu_torch.parallel import mesh as pmesh
from hotstuff_tpu_torch.telemetry import stages
from hotstuff_tpu_torch.utils.device import resolve

from . import BackendUnavailable, CryptoError


class CudaBackend:
    name = "cuda"

    def __init__(self, device="cuda", cache: bool | None = None,
                 sharded: bool | None = None) -> None:
        """``cache=False`` verifies every batch uncached: all keys
        decompress per batch (K1) and the MSM is unsigned (K4 + K3). Left
        unset, ``HOTSTUFF_TPU_CACHE`` decides as in the reference
        (``0``, ``false`` or ``no`` selects the uncached path). ``sharded``
        left unset, ``HOTSTUFF_TPU_SHARDED`` decides; a mesh is built over
        every visible card of ``device``'s type, ``device`` leading."""
        if cache is None:
            cache = os.environ.get("HOTSTUFF_TPU_CACHE", "1") not in ("0", "false", "no")
        if sharded is None:
            env = os.environ.get("HOTSTUFF_TPU_SHARDED", "auto")
            sharded = None if env == "auto" else env not in ("0", "false", "no")
        self.device = resolve(device)
        self._mesh = None
        if sharded is not False:
            devices = pmesh.visible_devices(self.device.type)
            if len(devices) > 1:
                # The lead holds the cache and runs the combine.
                lead = devices.index(self.device) if self.device in devices else 0
                self._mesh = pmesh.make_mesh(devices=devices[lead:] + devices[:lead])
                self.device = self._mesh.devices[0]
        # Committee point cache: validator keys decompress once and stay on
        # the card; per QC only R decompresses and the signed MSMs run.
        self._cache = ops_verify.DevicePointCache(device=self.device) if cache else None
        # Counted under a lock: the crypto bridge's workers may call
        # ``verify_batch`` from two threads at once.
        self._count_lock = threading.Lock()
        self.dispatches = 0
        self.sigs = 0

    def verify_batch(self, msgs, pubs, sigs) -> None:
        if not len(msgs) == len(pubs) == len(sigs):
            raise CryptoError("batch length mismatch")
        if not msgs:
            return
        # One span a dispatch: ``crypto.backend.calls`` moves with
        # ``crypto.dispatch.cuda``.
        t = stages.begin() if stages.ARMED else None
        with self._count_lock:
            self.dispatches += 1
            self.sigs += len(msgs)
        telemetry.counter("crypto.dispatch.cuda").inc()
        telemetry.counter("crypto.dispatch.cuda_sigs").inc(len(msgs))
        try:
            if self._mesh is not None and self._cache is not None:
                try:
                    ok = pmesh.verify_batch_device_cached_sharded(
                        self._mesh, msgs, pubs, sigs, self._cache)
                except ops_verify.CacheFull:
                    self._cache = ops_verify.DevicePointCache(device=self.device)
                    ok = pmesh.verify_batch_device_sharded(self._mesh, msgs, pubs, sigs)
            elif self._mesh is not None:
                ok = pmesh.verify_batch_device_sharded(self._mesh, msgs, pubs, sigs)
            elif self._cache is not None:
                try:
                    ok = ops_verify.verify_batch_device_cached(msgs, pubs, sigs, self._cache)
                except ops_verify.CacheFull:
                    # Keys accumulate across epochs with no eviction; only
                    # the current committee is live, so start a fresh cache
                    # rather than lose the cached path for good.
                    self._cache = ops_verify.DevicePointCache(device=self.device)
                    ok = ops_verify.verify_batch_device(msgs, pubs, sigs, device=self.device)
            else:
                ok = ops_verify.verify_batch_device(msgs, pubs, sigs, device=self.device)
        except Exception as e:
            # Device or runtime failure: the batch was NOT judged.
            raise BackendUnavailable(f"device verification failed: {e!r}") from e
        finally:
            if t is not None:
                stages.end("crypto.backend", t)
        if not ok:
            raise CryptoError("invalid signature in batch (device)")
