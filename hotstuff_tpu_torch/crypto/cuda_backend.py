"""CUDA batch-verification backend.

Port of ``hotstuff_tpu/crypto/tpu_backend.py`` for one card. Routes
``Signature.verify_batch`` to the random-linear-combination verifier of
``hotstuff_tpu_torch.ops.verify`` — the QC hot path (reference
``crypto/src/lib.rs:206-219``). Acceptance semantics are cofactored
(dalek ``verify_batch``).

The error contract is the reference's (``tpu_backend.py:64-106``):

- a length mismatch raises ``CryptoError``;
- a runtime or kernel failure raises ``BackendUnavailable`` — the batch
  was not judged;
- a rejected batch raises ``CryptoError``;
- on ``CacheFull`` the backend starts a fresh cache and verifies the
  batch through the uncached path.
"""

from __future__ import annotations

from hotstuff_tpu_torch.ops import verify as ops_verify
from hotstuff_tpu_torch.utils.device import resolve

from . import BackendUnavailable, CryptoError


class CudaBackend:
    name = "cuda"

    def __init__(self, device="cuda", cache: bool = True) -> None:
        """``cache=False`` verifies every batch uncached: all keys
        decompress per batch (K1) and the MSM is unsigned (K4 + K3)."""
        self.device = resolve(device)
        # Committee point cache: validator keys decompress once and stay on
        # the card; per QC only R decompresses and the signed MSMs run.
        self._cache = ops_verify.DevicePointCache(device=self.device) if cache else None
        self.dispatches = 0
        self.sigs = 0

    def verify_batch(self, msgs, pubs, sigs) -> None:
        if not len(msgs) == len(pubs) == len(sigs):
            raise CryptoError("batch length mismatch")
        if not msgs:
            return
        self.dispatches += 1
        self.sigs += len(msgs)
        try:
            if self._cache is None:
                ok = ops_verify.verify_batch_device(msgs, pubs, sigs, device=self.device)
            else:
                try:
                    ok = ops_verify.verify_batch_device_cached(msgs, pubs, sigs, self._cache)
                except ops_verify.CacheFull:
                    # Keys accumulate across epochs with no eviction; only
                    # the current committee is live, so start a fresh cache
                    # rather than lose the cached path for good.
                    self._cache = ops_verify.DevicePointCache(device=self.device)
                    ok = ops_verify.verify_batch_device(msgs, pubs, sigs, device=self.device)
        except Exception as e:
            # Device or runtime failure: the batch was NOT judged.
            raise BackendUnavailable(f"device verification failed: {e!r}") from e
        if not ok:
            raise CryptoError("invalid signature in batch (device)")
