"""Device arithmetic for the crypto hot path (port of ``hotstuff_tpu/ops``).

GF(2^255-19) in the reference's radix-2^13 x 20-limb int32 layout, Edwards25519
points in extended coordinates, batched decompression and the
random-linear-combination batch verification; the four MSM and root kernels
are hand-written CUDA (``msm_kernels.py`` wraps them). ``sha512.py`` is the
batched SHA-512 of the mempool's digests, its kernel ``csrc/sha512.cu``.
"""
