"""CPU batched Ed25519 verification: RLC + Pippenger multi-scalar mul.

Port of ``hotstuff_tpu/crypto/cpu_batch.py``, whole. dalek's
``verify_batch`` (reference ``crypto/src/lib.rs:206-219``) is not a serial
loop: it folds the whole batch into ONE multi-scalar multiplication

    8·[ (-sum z_i s_i mod L)·B + sum z_i·R_i + sum (z_i h_i mod L)·A_i ] == O

with random 128-bit z_i, evaluated by a Straus/Pippenger MSM. This module
implements the same equation with the same algorithm (bucketed Pippenger,
window size chosen by batch size) in pure Python over ``ed25519_ref``'s
extended coordinates, and the fused certificate check with deterministic
coefficients. ``best_verify_batch`` picks the native engine
(``native_ed25519``) when it builds; ``bench_torch.py`` reports the card
against it.
"""

from __future__ import annotations

import hashlib
import secrets

from .ed25519_ref import (
    G,
    IDENTITY,
    L,
    compute_challenge,
    is_identity,
    point_add,
    point_double,
    point_decompress,
    point_mul,
)


def best_verify_batch():
    """The fastest CPU batch-verify implementation available on this host:
    the native C++ engine when its shared library is built, else the
    pure-Python Pippenger below. Both take ``(msgs, pubs, sigs, rng=...)``."""
    try:
        from .native_ed25519 import native_available, verify_batch_native

        if native_available():
            return verify_batch_native
    except ImportError:
        pass
    return verify_batch_rlc_pippenger


# -- fused aggregate-certificate verification ------------------------------
#
# A wire-v2 certificate arrives as a seat bitmap plus one packed signature
# buffer; the fused path verifies the whole cert as ONE RLC equation over
# that buffer without materializing per-signature objects. The RLC
# coefficients are DERANDOMIZED Fiat–Shamir style: z_i is derived by
# hashing the full verify statement (domain tag, message(s), every public
# key, the raw signature buffer), so they are (a) reproducible — the same
# cert always folds with the same coefficients, which the process-wide
# cert-verdict arena and cross-backend equivalence tests rely on — and
# (b) sound — an adversary choosing signatures cannot choose them
# independently of the coefficients, exactly the argument that makes
# deterministic-challenge batch verification as strong as random z_i
# (each z_i is still a full 128-bit value with the top bit pinned, the
# same distribution dalek's verify_batch samples).

_CERT_RLC_DOMAIN = b"hs-agg-qc-v1"


def _cert_msg_at(msgs, i: int) -> bytes:
    """Message for seat ``i``: certs over one statement (QC) pass a single
    bytes object; per-seat statements (TC high-qc rounds) pass a list."""
    if isinstance(msgs, (bytes, bytearray, memoryview)):
        return bytes(msgs)
    return msgs[i]


def cert_rlc_coefficients(msgs, pubs, sig_buf, stride: int, n: int) -> list[int]:
    """Deterministic 128-bit RLC coefficients for a fused cert verify.

    seed = SHA-512(domain || len-prefixed message(s) || pubs || sig_buf);
    the coefficient stream is SHAKE-256(seed), 16 bytes per seat, top bit
    pinned so every z_i is exactly 128 bits (matching the sampled-z path).
    """
    h = hashlib.sha512()
    h.update(_CERT_RLC_DOMAIN)
    if isinstance(msgs, (bytes, bytearray, memoryview)):
        h.update(len(msgs).to_bytes(8, "little"))
        h.update(bytes(msgs))
    else:
        for m in msgs:
            h.update(len(m).to_bytes(8, "little"))
            h.update(bytes(m))
    for pub in pubs:
        h.update(bytes(pub))
    h.update(bytes(sig_buf))
    stream = hashlib.shake_256(h.digest()).digest(16 * n)
    return [
        int.from_bytes(stream[16 * i : 16 * i + 16], "little") | (1 << 127)
        for i in range(n)
    ]


def verify_cert_rlc(msgs, pubs, sig_buf, stride: int = 64, c: int = 8) -> bool:
    """Pure-Python fused cert verification (reference for the native path).

    ``pubs``: n public keys; ``sig_buf``: packed signatures at ``stride``
    bytes per record (signature in the first 64); ``msgs``: one shared
    bytes statement or a per-seat list. One RLC + Pippenger MSM over the
    whole cert with deterministic coefficients; same canonicality
    rejections as ``verify_batch_rlc_pippenger``.
    """
    n = len(pubs)
    if n == 0:
        return True
    if len(sig_buf) < stride * (n - 1) + 64:
        return False
    zs = cert_rlc_coefficients(msgs, pubs, sig_buf, stride, n)
    scalars: list[int] = []
    points: list = []
    b_coeff = 0
    for i in range(n):
        pub = bytes(pubs[i])
        r_enc = bytes(sig_buf[stride * i : stride * i + 32])
        s = int.from_bytes(sig_buf[stride * i + 32 : stride * i + 64], "little")
        if len(pub) != 32 or s >= L:
            return False
        a_pt = point_decompress(pub)
        r_pt = point_decompress(r_enc)
        if a_pt is None or r_pt is None:
            return False
        z = zs[i]
        h = compute_challenge(r_enc, pub, _cert_msg_at(msgs, i))
        b_coeff = (b_coeff + z * s) % L
        scalars.append(z)
        points.append(r_pt)
        scalars.append(z * h % L)
        points.append(a_pt)
    scalars.append((-b_coeff) % L)
    points.append(G)
    acc = _pippenger(scalars, points, c)
    return is_identity(point_mul(8, acc))


def _pippenger(scalars: list[int], points: list, c: int) -> tuple:
    """Bucketed MSM: sum scalars[i] * points[i], window width ``c`` bits."""
    n_windows = (max(s.bit_length() for s in scalars) + c - 1) // c if scalars else 1
    acc = IDENTITY
    for w in range(n_windows - 1, -1, -1):
        if acc is not IDENTITY:
            for _ in range(c):
                acc = point_double(acc)
        buckets: dict[int, tuple] = {}
        shift = w * c
        mask = (1 << c) - 1
        for s, pt in zip(scalars, points):
            d = (s >> shift) & mask
            if d == 0:
                continue
            cur = buckets.get(d)
            buckets[d] = pt if cur is None else point_add(cur, pt)
        if not buckets:
            continue
        # Bucket sweep: sum_d d * bucket[d] via running suffix sums.
        running = IDENTITY
        window_sum = IDENTITY
        for d in range(max(buckets), 0, -1):
            pt = buckets.get(d)
            if pt is not None:
                running = point_add(running, pt)
            window_sum = point_add(window_sum, running)
        acc = point_add(acc, window_sum)
    return acc


def verify_batch_rlc_pippenger(msgs, pubs, sigs, rng=None, c: int = 8) -> bool:
    """Batch verification, dalek ``verify_batch`` algorithm on CPU.

    msgs/pubs/sigs: equal-length lists of bytes. True iff the whole batch
    verifies under cofactored semantics. Rejects non-canonical encodings
    host-side exactly like the device pipeline (``ops.verify``).
    """
    if not len(msgs) == len(pubs) == len(sigs):
        raise ValueError("batch length mismatch")
    randbits = rng.getrandbits if rng is not None else secrets.randbits

    scalars: list[int] = []
    points: list = []
    b_coeff = 0
    for msg, pub, sig in zip(msgs, pubs, sigs):
        if len(sig) != 64 or len(pub) != 32:
            return False
        a_pt = point_decompress(pub)
        r_pt = point_decompress(sig[:32])
        if a_pt is None or r_pt is None:
            return False
        s = int.from_bytes(sig[32:], "little")
        if s >= L:
            return False
        z = randbits(128) | (1 << 127)
        h = compute_challenge(sig[:32], pub, msg)
        b_coeff = (b_coeff + z * s) % L
        scalars.append(z)
        points.append(r_pt)
        scalars.append(z * h % L)
        points.append(a_pt)
    scalars.append((-b_coeff) % L)
    points.append(G)

    acc = _pippenger(scalars, points, c)
    return is_identity(point_mul(8, acc))
