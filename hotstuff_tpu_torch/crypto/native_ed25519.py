"""ctypes binding for the native C++ Ed25519 batch-verification engine.

Port of ``hotstuff_tpu/crypto/native_ed25519.py``. The engine's source is the
port's copy, ``crypto/native/ed25519.cpp``; it is built with g++ at first use
into ``hotstuff_tpu_torch/_build/`` (``utils/kernel_build.build_native``,
keyed by a hash of the source and the flags), where the reference builds
beside its source. The C++ side evaluates the random-linear-combination
MSM; this module does the host prep byte for byte as the reference does:
strictness checks (canonical s < L, canonical y), SHA-512 challenges, and
the RLC scalar arithmetic mod L.

It is the CPU bar for the bench (dalek ``verify_batch`` semantics and
algorithm, reference ``crypto/src/lib.rs:206-219``, at native speed) and
the engine behind ``CpuBackend``'s RLC path. Once loaded, ``native_stats``
is the telemetry registry's ``crypto.native`` collector and the entry
points are registered with the sampling profiler, as in the reference.
"""

from __future__ import annotations

import ctypes
import hashlib
import secrets
from pathlib import Path

from hotstuff_tpu_torch import telemetry
from hotstuff_tpu_torch.telemetry import profiler as _pyprof
from hotstuff_tpu_torch.utils import kernel_build

from .ed25519_ref import G, L, P, point_compress

_SRC = Path(__file__).resolve().parent / "native" / "ed25519.cpp"

_B_ENC = point_compress(G)
_HALF_MASK = (1 << 255) - 1


def _is_built() -> bool:
    return kernel_build.native_path(_SRC).exists()


_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(kernel_build.build_native(_SRC)))
        lib.hs_ed25519_msm_is_identity.restype = ctypes.c_int
        lib.hs_ed25519_msm_is_identity.argtypes = [
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_uint64,
            ctypes.c_int,
        ]
        lib.hs_ed25519_decompress_check.restype = ctypes.c_int
        lib.hs_ed25519_decompress_check.argtypes = [
            ctypes.c_char_p,
            ctypes.c_char_p,
        ]
        lib.hs_ed25519_msm_signed.restype = ctypes.c_int
        lib.hs_ed25519_msm_signed.argtypes = [
            ctypes.c_char_p,  # encodings (m*32)
            ctypes.c_char_p,  # pre_xy (m*64), may be None
            ctypes.c_char_p,  # flags (m), may be None
            ctypes.c_char_p,  # scalars (m*32)
            ctypes.c_uint64,
            ctypes.c_int,  # window width
            ctypes.c_int,  # cofactored (0 = strict/cofactorless sum)
        ]
        lib.hs_ed25519_scalarmult_base.restype = ctypes.c_int
        lib.hs_ed25519_scalarmult_base.argtypes = [
            ctypes.c_char_p,
            ctypes.c_char_p,
        ]
        lib.hs_ed25519_cert_challenges.restype = ctypes.c_int
        lib.hs_ed25519_cert_challenges.argtypes = [
            ctypes.c_char_p,  # shared message
            ctypes.c_uint64,  # message length
            ctypes.c_char_p,  # pubs (n*32)
            ctypes.c_char_p,  # packed signature buffer (n*stride)
            ctypes.c_uint64,  # stride (>= 64)
            ctypes.c_uint64,  # n
            ctypes.c_char_p,  # out (n*64 digests)
        ]
        lib.hs_ed25519_stats.restype = ctypes.c_int
        lib.hs_ed25519_stats.argtypes = [
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_int,
        ]
        _lib = lib
        # The engine's counters surface through the registry's single
        # snapshot call once the library is live.
        telemetry.register_collector("crypto.native", native_stats)
        # Instrumentable ctypes boundary: an active profiler session
        # counts calls + wall ns per entry point (the per-call GIL
        # release/reacquire toll); zero cost otherwise.
        _pyprof.register_ctypes_lib(
            lib,
            "hs_ed25519",
            [
                "hs_ed25519_msm_is_identity", "hs_ed25519_msm_signed",
                "hs_ed25519_decompress_check", "hs_ed25519_scalarmult_base",
                "hs_ed25519_cert_challenges",
            ],
        )
    return _lib


# hs_ed25519_stats field order (new fields append; indices never move).
ED25519_STATS_FIELDS = (
    "msm_calls", "msm_points", "scalarmult_calls", "decompress_calls",
    "cert_challenge_calls", "cert_challenge_sigs",
)


def native_stats() -> dict[str, int]:
    """Engine counter snapshot: verify-side MSM evaluations/lanes plus
    sign/derive basepoint multiplications — one call exports them all."""
    out = (ctypes.c_uint64 * len(ED25519_STATS_FIELDS))()
    n = _load().hs_ed25519_stats(out, len(ED25519_STATS_FIELDS))
    return {name: out[i] for i, name in enumerate(ED25519_STATS_FIELDS[:n])}


def native_available(build: bool = True) -> bool:
    """True if the shared library is loadable on this host, building it
    first unless ``build=False``, which only probes for a library already
    built (``CpuBackend`` builds when it is constructed, never inside a
    verify)."""
    if not build and not _is_built():
        return False
    try:
        _load()
        return True
    except (OSError, kernel_build.KernelBuildError):
        return False


def decompress_check(encoding: bytes) -> bool:
    """Native single-point decompression probe (test hook)."""
    return _load().hs_ed25519_decompress_check(encoding, None) == 1


def scalarmult_base_native(scalar: int) -> bytes:
    """Compressed encoding of ``scalar * B`` (``scalar`` already reduced
    mod L). Powers signing/public-key derivation when the ``cryptography``
    package is unavailable. Variable-time in the scalar (comb indexing) —
    fine for this research testbed, noted here for production readers."""
    out = ctypes.create_string_buffer(32)
    rc = _load().hs_ed25519_scalarmult_base(
        scalar.to_bytes(32, "little"), out
    )
    if rc != 1:
        raise ValueError("native scalarmult rejected arguments")
    return bytes(out.raw)


# Decompressed-point cache: committee public keys recur in every QC this
# process ever verifies, and decompression (a field sqrt) is ~35% of a
# 67-signature batch on this box. A real validator decompresses each
# committee key once per epoch (the CPU analog of the device
# DevicePointCache), so sharing this across in-process testbed nodes
# models per-epoch amortization, not skipped per-round work. R points are
# per-signature nonces and never hit the cache.
_XY_CACHE_CAP = 4096
_xy_cache: dict[bytes, bytes] = {}


def _cached_xy(pub: bytes):
    """64-byte affine x|y for a compressed key, or None if invalid."""
    xy = _xy_cache.get(pub)
    if xy is not None:
        return xy
    out = ctypes.create_string_buffer(64)
    if _load().hs_ed25519_decompress_check(pub, out) != 1:
        return None
    if len(_xy_cache) >= _XY_CACHE_CAP:
        _xy_cache.clear()  # epoch-scale working sets never get here
    xy = bytes(out.raw)
    _xy_cache[pub] = xy
    return xy


def verify_batch_native(msgs, pubs, sigs, rng=None) -> bool:
    """Batch verification on the native engine.

    msgs/pubs/sigs: equal-length lists of bytes. True iff the whole batch
    is valid under cofactored semantics — the same host-side prep and
    rejection rules as the device pipeline (``ops.verify.prepare_batch``).
    Public-key and basepoint decompressions are cached; the MSM runs the
    signed-digit kernel (halved bucket sweep).
    """
    if not len(msgs) == len(pubs) == len(sigs):
        raise ValueError("batch length mismatch")
    if len(msgs) == 0:
        return True
    randbits = rng.getrandbits if rng is not None else secrets.randbits

    n = len(msgs)
    m = 2 * n + 1
    encodings = bytearray()
    pre_xy = bytearray()
    flags = bytearray()
    scalars = bytearray()
    zero64 = bytes(64)
    b_coeff = 0
    for msg, pub, sig in zip(msgs, pubs, sigs):
        if len(sig) != 64 or len(pub) != 32:
            return False
        r_enc, s_bytes = sig[:32], sig[32:]
        s = int.from_bytes(s_bytes, "little")
        if s >= L:  # non-canonical s: reject (RFC 8032 / dalek)
            return False
        if (int.from_bytes(pub, "little") & _HALF_MASK) >= P:
            return False
        if (int.from_bytes(r_enc, "little") & _HALF_MASK) >= P:
            return False
        z = randbits(128) | (1 << 127)
        h = int.from_bytes(hashlib.sha512(r_enc + pub + msg).digest(), "little") % L
        b_coeff = (b_coeff + z * s) % L
        encodings += r_enc
        pre_xy += zero64
        flags.append(0)
        scalars += z.to_bytes(32, "little")
        xy = _cached_xy(bytes(pub))
        if xy is None:
            return False  # invalid public key (same verdict as in-MSM)
        encodings += pub
        pre_xy += xy
        flags.append(1)
        scalars += (z * h % L).to_bytes(32, "little")
    encodings += _B_ENC
    pre_xy += _cached_xy(_B_ENC)
    flags.append(1)
    scalars += ((-b_coeff) % L).to_bytes(32, "little")

    rc = _load().hs_ed25519_msm_signed(
        bytes(encodings),
        bytes(pre_xy),
        bytes(flags),
        bytes(scalars),
        m,
        _signed_window(m),
        1,
    )
    if rc < 0:
        raise ValueError("native ed25519 engine rejected arguments")
    return rc == 1


def verify_cert_native(msgs, pubs, sig_buf, stride: int = 64) -> bool:
    """Fused aggregate-certificate verification on the native engine.

    ``pubs``: n public keys; ``sig_buf``: the cert's packed signature
    buffer at ``stride`` bytes per record (signature in the first 64);
    ``msgs``: one shared bytes statement (QC) or a per-seat list (TC).
    One RLC equation over the whole cert — the n challenge hashes run
    behind a single ctypes crossing when the message is shared, the RLC
    coefficients are the deterministic Fiat–Shamir stream from
    ``cpu_batch.cert_rlc_coefficients``, and the whole cert folds into
    one signed-digit MSM (m = 2n+1 lanes). Same canonicality rejections
    as ``verify_batch_native``.
    """
    n = len(pubs)
    if n == 0:
        return True
    sig_buf = bytes(sig_buf)
    if len(sig_buf) < stride * (n - 1) + 64:
        return False
    from .cpu_batch import cert_rlc_coefficients

    zs = cert_rlc_coefficients(msgs, pubs, sig_buf, stride, n)
    lib = _load()

    pubs_buf = b"".join(bytes(p) for p in pubs)
    if len(pubs_buf) != 32 * n:
        return False
    shared = isinstance(msgs, (bytes, bytearray, memoryview))
    if shared:
        msg = bytes(msgs)
        digests = ctypes.create_string_buffer(64 * n)
        rc = lib.hs_ed25519_cert_challenges(
            msg, len(msg), pubs_buf, sig_buf, stride, n, digests
        )
        if rc != 1:
            raise ValueError("native cert-challenge engine rejected arguments")
        digests = digests.raw
    else:
        digests = b"".join(
            hashlib.sha512(
                sig_buf[stride * i : stride * i + 32]
                + pubs_buf[32 * i : 32 * i + 32]
                + bytes(msgs[i])
            ).digest()
            for i in range(n)
        )

    m = 2 * n + 1
    encodings = bytearray()
    pre_xy = bytearray()
    flags = bytearray()
    scalars = bytearray()
    zero64 = bytes(64)
    b_coeff = 0
    for i in range(n):
        base = stride * i
        r_enc = sig_buf[base : base + 32]
        s = int.from_bytes(sig_buf[base + 32 : base + 64], "little")
        if s >= L:  # non-canonical s: reject (RFC 8032 / dalek)
            return False
        pub = pubs_buf[32 * i : 32 * i + 32]
        if (int.from_bytes(pub, "little") & _HALF_MASK) >= P:
            return False
        if (int.from_bytes(r_enc, "little") & _HALF_MASK) >= P:
            return False
        z = zs[i]
        h = int.from_bytes(digests[64 * i : 64 * i + 64], "little") % L
        b_coeff = (b_coeff + z * s) % L
        encodings += r_enc
        pre_xy += zero64
        flags.append(0)
        scalars += z.to_bytes(32, "little")
        xy = _cached_xy(pub)
        if xy is None:
            return False  # invalid public key (same verdict as in-MSM)
        encodings += pub
        pre_xy += xy
        flags.append(1)
        scalars += (z * h % L).to_bytes(32, "little")
    encodings += _B_ENC
    pre_xy += _cached_xy(_B_ENC)
    flags.append(1)
    scalars += ((-b_coeff) % L).to_bytes(32, "little")

    rc = lib.hs_ed25519_msm_signed(
        bytes(encodings),
        bytes(pre_xy),
        bytes(flags),
        bytes(scalars),
        m,
        _signed_window(m),
        1,
    )
    if rc < 0:
        raise ValueError("native ed25519 engine rejected arguments")
    return rc == 1


def verify_single_strict_native(msg: bytes, pub: bytes, sig: bytes) -> bool:
    """COFACTORLESS single verification: s B - R - h A == identity — the
    exact equation OpenSSL / dalek ``verify_strict`` check, evaluated as
    one 3-point MSM on the native engine. Used for ``Signature.verify``
    when the ``cryptography`` package is unavailable, so gated and
    non-gated processes share one strict acceptance set. The caller is
    responsible for the small-order/canonical-encoding rejections."""
    if len(sig) != 64 or len(pub) != 32:
        return False
    r_enc, s_bytes = sig[:32], sig[32:]
    s = int.from_bytes(s_bytes, "little")
    if s >= L:  # non-canonical s: reject (RFC 8032 / dalek / OpenSSL)
        return False
    if (int.from_bytes(pub, "little") & _HALF_MASK) >= P:
        return False
    if (int.from_bytes(r_enc, "little") & _HALF_MASK) >= P:
        return False
    xy = _cached_xy(bytes(pub))
    if xy is None:
        return False
    h = int.from_bytes(hashlib.sha512(r_enc + pub + msg).digest(), "little") % L
    encodings = r_enc + pub + _B_ENC
    pre_xy = bytes(64) + xy + _cached_xy(_B_ENC)
    flags = bytes([0, 1, 1])
    scalars = (
        (L - 1).to_bytes(32, "little")  # -1 * R
        + ((L - h) % L).to_bytes(32, "little")  # -h * A
        + s.to_bytes(32, "little")  # s * B
    )
    rc = _load().hs_ed25519_msm_signed(
        encodings, pre_xy, flags, scalars, 3, _signed_window(3), 0
    )
    if rc < 0:
        raise ValueError("native ed25519 engine rejected arguments")
    return rc == 1


def _pippenger_window(m: int) -> int:
    """Window width minimizing (253/c) * (m + 2^(c+1)) point additions."""
    return min(range(1, 13), key=lambda c: (253 / c) * (m + (1 << (c + 1))))


def _signed_window(m: int) -> int:
    """Window width for the signed-digit kernel: the sweep costs two adds
    per bucket and buckets number 2^(c-1)."""
    return min(range(1, 13), key=lambda c: (253 / c) * (m + (1 << c)))
