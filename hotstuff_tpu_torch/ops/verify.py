"""Device batch verification: the random-linear-combination equation.

Port of ``hotstuff_tpu/ops/verify.py``. Checks (dalek ``verify_batch``
semantics, reference ``crypto/src/lib.rs:206-219``)

    8 * [ (-sum z_i s_i mod L) * B + sum z_i * R_i + sum (z_i h_i mod L) * A_i ] == O

with fresh random 128-bit z_i. The host does byte parsing, strictness
checks (canonical s < L, canonical y), SHA-512 challenges and mod-L scalar
arithmetic, and packs one uint8 array per batch (one host-to-device copy).
The card does the curve math, each step one kernel: decompression (K1),
the MSMs (K2 + K3 on the cached path, K4 + K3 uncached) and the verdict
(all lanes decompressed and the cofactor-8 identity check).

The packed layouts and their host prep are byte-identical to the
reference's, so both verify the same batch from the same bytes.

With the stage spans armed (``telemetry/stages.py``) a batch records its
host prep as ``crypto.prep.ensure`` (the key cache), ``crypto.prep.scalars``
(the per-signature loop), ``crypto.prep.recode`` (signed digits) and
``crypto.prep.pack``, then ``crypto.launch`` (the copy to the card and the
kernels' enqueue) and ``crypto.wait`` (the host waiting for the verdict).
"""

from __future__ import annotations

import hashlib
import secrets
import threading

import numpy as np
import torch

from hotstuff_tpu_torch.crypto.ed25519_ref import G, L, P, point_compress
from hotstuff_tpu_torch.telemetry import stages
from hotstuff_tpu_torch.utils.device import resolve

from . import curve as cv
from . import field as fe
from . import msm_kernels as mk

_B_ENC = point_compress(G)
_IDENTITY_ENC = (1).to_bytes(32, "little")  # y=1, sign 0
_HALF_MASK = (1 << 255) - 1

# Limb k of y covers bits 13k .. 13k+12: a 3-byte read at byte 13k // 8,
# shifted by 13k % 8.
_LIMB_BYTE = np.array([fe.RADIX * k // 8 for k in range(fe.NLIMB)])
_LIMB_OFF = np.array([fe.RADIX * k % 8 for k in range(fe.NLIMB)], dtype=np.int32)


def _enc_to_y_limbs(enc: torch.Tensor) -> torch.Tensor:
    """int32[m, 32] little-endian encoding bytes (sign bit pre-cleared
    from byte 31) -> y limbs int32[m, 20], with bit 255 cleared from the
    top limb."""
    padded = torch.nn.functional.pad(enc, (0, 2))  # bytes 32, 33 read as 0
    idx = fe.const(_LIMB_BYTE, enc)
    window = padded[:, idx] + (padded[:, idx + 1] << 8) + (padded[:, idx + 2] << 16)
    limbs = (window >> fe.const(_LIMB_OFF, enc)) & fe.MASK
    limbs[:, fe.NLIMB - 1] &= 0xFF  # limbs is this function's own tensor
    return limbs


def _unpack_device(packed: torch.Tensor):
    """Device-side unpacking of the [m, 65] uint8 batch layout: bytes
    0..31 point encoding (LE), 32..63 RLC scalar (LE), 64 sign. Returns
    (y_limbs [m, 20], signs [m], digits [64, m] radix-16 MSB-first)."""
    b = packed.to(torch.int32)
    y_limbs = _enc_to_y_limbs(b[:, :32])
    signs = b[:, 64]
    sc = b[:, 32:64]
    nibbles = torch.stack([sc & 0xF, sc >> 4], dim=-1).reshape(b.shape[0], 64)  # LSB-first
    digits = nibbles.flip(-1).T.contiguous()
    return y_limbs, signs, digits


def uncached_inputs(packed: torch.Tensor):
    """Unpack and decompress (K1) a packed [m, 65] batch already on its
    device: (ok [m], points [m, 4, 20], digits [64, m]), the MSM's inputs."""
    y_limbs, signs, digits = _unpack_device(packed)
    ok, pts = mk.decompress(y_limbs, signs)
    return ok, pts, digits


def run_uncached(packed: torch.Tensor) -> torch.Tensor:
    """Decompress + MSM (K1, K4 + K3) + verdict of a packed [m, 65] batch
    already on its device; a 0-dim bool tensor."""
    ok, pts, digits = uncached_inputs(packed)
    return mk.verdict(ok, mk.msm(pts, digits))


def _pad_to_pow2(n: int, minimum: int = 4) -> int:
    m = minimum
    while m < n:
        m *= 2
    return m


def _uncached_lanes(msgs, pubs, sigs, randbits):
    """The per-signature work of ``prepare_batch``: strictness checks,
    challenges and RLC scalars. Returns the lanes' ``(encodings,
    scalars)``, the base point's last, or None if a check rejects."""
    encodings: list[bytes] = []
    scalars: list[int] = []
    b_coeff = 0
    for msg, pub, sig in zip(msgs, pubs, sigs):
        if len(sig) != 64 or len(pub) != 32:
            return None
        r_enc, s_bytes = sig[:32], sig[32:]
        s = int.from_bytes(s_bytes, "little")
        if s >= L:  # non-canonical s: reject (RFC 8032 / dalek)
            return None
        # Reject non-canonical y encodings host-side (y >= p).
        if (int.from_bytes(pub, "little") & _HALF_MASK) >= P:
            return None
        if (int.from_bytes(r_enc, "little") & _HALF_MASK) >= P:
            return None
        z = randbits(128) | (1 << 127)
        h = int.from_bytes(hashlib.sha512(r_enc + pub + msg).digest(), "little") % L
        b_coeff = (b_coeff + z * s) % L
        encodings.append(r_enc)
        scalars.append(z)
        encodings.append(pub)
        scalars.append(z * h % L)
    encodings.append(_B_ENC)
    scalars.append((-b_coeff) % L)
    return encodings, scalars


def prepare_batch(msgs, pubs, sigs, _rng=None):
    """Host-side prep: strictness checks, challenges, RLC scalars, and the
    packed uint8 batch array. Returns ``(packed, m_padded)`` where
    ``packed`` is uint8[m, 65] (see ``_unpack_device``), or None if the
    batch is rejected host-side."""
    randbits = _rng.getrandbits if _rng is not None else secrets.randbits

    t = stages.begin() if stages.ARMED else None
    lanes = _uncached_lanes(msgs, pubs, sigs, randbits)
    if t is not None:
        stages.end("crypto.prep.scalars", t)
    if lanes is None:
        return None
    encodings, scalars = lanes

    t = stages.begin() if stages.ARMED else None
    m = _pad_to_pow2(len(encodings))
    pad = m - len(encodings)
    encodings.extend([_IDENTITY_ENC] * pad)
    scalars.extend([0] * pad)

    data = np.frombuffer(b"".join(encodings), dtype=np.uint8).reshape(-1, 32)
    scalar_bytes = np.frombuffer(
        b"".join(s.to_bytes(32, "little") for s in scalars), dtype=np.uint8
    ).reshape(-1, 32)
    packed = np.empty((m, 65), dtype=np.uint8)
    packed[:, :32] = data
    packed[:, 31] &= 0x7F  # sign bit moved to its own byte
    packed[:, 32:64] = scalar_bytes
    packed[:, 64] = data[:, 31] >> 7
    if t is not None:
        stages.end("crypto.prep.pack", t)
    return packed, m


def pad_prepared(packed: np.ndarray, target: int):
    """Grow a prepared batch to ``target`` lanes with identity encodings
    (zero scalars)."""
    extra = target - packed.shape[0]
    pad = np.zeros((extra, 65), dtype=np.uint8)
    pad[:, :32] = np.frombuffer(_IDENTITY_ENC, dtype=np.uint8)
    return np.concatenate([packed, pad])


def _launch_and_wait(run, packed: torch.Tensor, device, *args) -> bool:
    """Copy a packed host batch to ``device`` and enqueue ``run`` on it
    (the ``crypto.launch`` span), then wait for its verdict
    (``crypto.wait``: the host waiting for the card)."""
    t = stages.begin() if stages.ARMED else None
    verdict = run(packed.to(device), *args)
    if t is not None:
        stages.end("crypto.launch", t)
        t = stages.begin()
    ok = bool(verdict)
    if t is not None:
        stages.end("crypto.wait", t)
    return ok


def verify_batch_device(msgs, pubs, sigs, _rng=None, device="cuda") -> bool:
    """msgs/pubs/sigs: equal-length lists of bytes. True iff the whole
    batch is valid under cofactored semantics (the uncached path)."""
    dev = resolve(device)
    if len(msgs) == 0:
        return True
    prepared = prepare_batch(msgs, pubs, sigs, _rng=_rng)
    if prepared is None:
        return False
    packed, _ = prepared
    return _launch_and_wait(run_uncached, torch.from_numpy(packed), dev)


# ---------------------------------------------------------------------------
# Committee point cache + signed digits + narrow R-lane windows.
#
# The committee is static per epoch, so the A_i points (validator keys)
# decompress once onto the card and stay resident; per batch only the R_i
# points pay the root chain. Scalars ship as host-recoded SIGNED radix-16
# digits; the R lanes' 128-bit RLC coefficients need 33 windows, the
# mod-L A/B-lane scalars 64.
# ---------------------------------------------------------------------------

N_WINDOWS_RLC = 33  # 128-bit z (top bit set) + signed-recode carry
N_WINDOWS_FULL = 64  # mod-L scalars

_ROW_WIDTH = 66  # 32 enc + 33 digits + 1 sign (fresh) / 64 digits + 2 row (cached)
MAX_ROWS = 65536  # row indices ship as 16 bits


def _decompress_packed(packed: torch.Tensor):
    """Decompress k packed encodings ([k, 33] uint8: 32 enc + sign)."""
    b = packed.to(torch.int32)
    return mk.decompress(_enc_to_y_limbs(b[:, :32]), b[:, 32])


class CacheFull(RuntimeError):
    """The device point cache hit its 16-bit row-index ceiling."""


def _identity_rows(n: int, device: torch.device) -> torch.Tensor:
    return fe.const(cv.IDENTITY, device).repeat(n, 1, 1)


class DevicePointCache:
    """Decompressed-point cache on the card, keyed by 32-byte encodings.

    Row 0 is always the Ed25519 base point; every other row starts as the
    identity, so a stray gather stays on the curve. Thread-safe; grows by
    doubling up to 65,536 rows, then raises ``CacheFull``. Rows are never
    reused. Invalid encodings are remembered host-side so batches naming
    them fail without a device call. Unlike the reference's immutable
    array, inserts write the rows of ``array`` in place.
    """

    def __init__(self, capacity: int = 4096, device="cuda") -> None:
        self.device = resolve(device)
        self.capacity = max(16, capacity)
        self._rows: dict[bytes, int] = {_B_ENC: 0}
        self._next_row = 1  # rows are never reused, even for failed inserts
        self._invalid: set[bytes] = set()
        self._lock = threading.Lock()
        self.array = _identity_rows(self.capacity, self.device)
        self.array[0] = torch.as_tensor(cv.BASE_POINT, device=self.device)

    def lookup(self, enc: bytes):
        return self._rows.get(enc)

    def ensure(self, encs) -> bool:
        """Decompress-and-insert any unknown encodings. Returns False if
        any encoding is known-invalid or fails decompression."""
        with self._lock:
            fresh = []
            for e in dict.fromkeys(encs):  # dedup, keep order
                if len(e) != 32 or e in self._invalid:
                    return False
                if e not in self._rows:
                    # host-side canonicality (y < p), mirroring prepare_batch
                    if (int.from_bytes(e, "little") & _HALF_MASK) >= P:
                        self._invalid.add(e)
                        return False
                    fresh.append(e)
            if not fresh:
                return True
            while self._next_row + len(fresh) > self.capacity:
                self._grow()
            k = _pad_to_pow2(len(fresh))
            packed = np.zeros((k, 33), dtype=np.uint8)
            for i, e in enumerate(fresh):
                row = np.frombuffer(e, dtype=np.uint8)
                packed[i, :32] = row
                packed[i, 31] &= 0x7F
                packed[i, 32] = row[31] >> 7
            ok, pts = _decompress_packed(torch.from_numpy(packed).to(self.device))
            ok = ok.cpu().numpy()
            # Only the decompressed points land in the array, each on a
            # never-used row: a failed insert can never alias or overwrite
            # a registered key's row.
            valid = [i for i in range(len(fresh)) if ok[i]]
            if valid:
                rows = list(range(self._next_row, self._next_row + len(valid)))
                self._next_row += len(valid)
                dst = torch.as_tensor(rows, device=self.device)
                src = torch.as_tensor(valid, device=self.device)
                self.array[dst] = pts[src]
                for r, i in zip(rows, valid):
                    self._rows[fresh[i]] = r
            all_ok = True
            for i, e in enumerate(fresh):
                if not ok[i]:
                    self._invalid.add(e)
                    all_ok = False
            return all_ok

    def _grow(self) -> None:
        new_cap = self.capacity * 2
        if new_cap > MAX_ROWS:
            raise CacheFull(f"point cache cannot exceed {MAX_ROWS} rows")
        arr = _identity_rows(new_cap, self.device)
        arr[: self.capacity] = self.array
        self.capacity = new_cap
        self.array = arr


def cache_from_numpy(array: np.ndarray, rows: dict, device="cuda") -> DevicePointCache:
    """A cache holding the state of a reference ``DevicePointCache``:
    ``array`` is ``np.asarray(cache.array)`` ([capacity, 4, 20] int32) and
    ``rows`` its ``_rows`` map (encoding -> row)."""
    array = np.asarray(array, dtype=np.int32)
    cache = DevicePointCache(capacity=array.shape[0], device=device)
    if cache.capacity != array.shape[0]:
        raise ValueError(f"capacity {array.shape[0]} is below the minimum of 16 rows")
    cache.array = torch.from_numpy(array.copy()).to(cache.device)
    cache._rows = dict(rows)
    cache._next_row = max(cache._rows.values()) + 1
    return cache


def cached_inputs(packed: torch.Tensor, cache_arr: torch.Tensor, mf: int):
    """Unpack a packed uint8[mf + mc, 66] split batch already on its device,
    decompress its fresh R rows (K1) and gather its cached rows:
    (ok_f [mf], pts_f [mf, 4, 20], digits_f [33, mf], pts_c [mc, 4, 20],
    digits_c [64, mc]), the two signed MSMs' inputs.

    Fresh rows: 32 enc bytes, 33 biased signed digits (d + 8), sign.
    Cached rows: 64 biased digits, row index (lo, hi).
    """
    b = packed.to(torch.int32)
    ok_f, pts_f, digits_f = fresh_inputs(b[:mf])
    rows, digits_c = cached_rows(b[mf:])
    pts_c = cache_arr.index_select(0, rows)  # [mc, 4, 20]
    return ok_f, pts_f, digits_f, pts_c, digits_c


def fresh_inputs(fresh: torch.Tensor):
    """The fresh rows of a split batch, int32 [mf, 66] on their device,
    decompressed (K1): (ok_f [mf], pts_f [mf, 4, 20], digits_f [33, mf])."""
    ok_f, pts_f = mk.decompress(_enc_to_y_limbs(fresh[:, :32]), fresh[:, 65])
    return ok_f, pts_f, fresh[:, 32:65].T - 8  # [33, mf] signed


def cached_rows(cached: torch.Tensor):
    """The cached rows of a split batch, int32 [mc, 66]: (cache row
    indices int64 [mc], digits_c [64, mc])."""
    rows = cached[:, 64] | (cached[:, 65] << 8)
    return rows.long(), cached[:, :64].T - 8  # [64, mc] signed


def run_cached(packed: torch.Tensor, cache_arr: torch.Tensor, mf: int) -> torch.Tensor:
    """Verify a packed uint8[mf + mc, 66] split batch already on its
    device against the cache rows; a 0-dim bool tensor."""
    ok_f, pts_f, digits_f, pts_c, digits_c = cached_inputs(packed, cache_arr, mf)
    return mk.verdict(ok_f, mk.msm_signed(pts_f, digits_f), mk.msm_signed(pts_c, digits_c))


def _cached_lanes(msgs, pubs, sigs, cache: DevicePointCache, randbits):
    """The per-signature work of ``prepare_batch_cached``: strictness
    checks, challenges and RLC scalars. Returns ``(r_encs, z_bytes, rows,
    full_scalars)``, the base point's row and scalar last, or None if a
    check rejects."""
    n = len(msgs)
    r_encs: list[bytes] = []
    z_bytes = np.zeros((n, 32), dtype=np.uint8)
    rows: list[int] = []
    full_scalars: list[int] = []
    b_coeff = 0
    for i, (msg, pub, sig) in enumerate(zip(msgs, pubs, sigs)):
        r_enc, s_bytes = sig[:32], sig[32:]  # lengths validated by the caller
        s = int.from_bytes(s_bytes, "little")
        if s >= L:
            return None
        if (int.from_bytes(r_enc, "little") & _HALF_MASK) >= P:
            return None
        z = randbits(128) | (1 << 127)
        h = int.from_bytes(hashlib.sha512(r_enc + pub + msg).digest(), "little") % L
        b_coeff = (b_coeff + z * s) % L
        r_encs.append(r_enc)
        z_bytes[i, :16] = np.frombuffer(z.to_bytes(16, "little"), dtype=np.uint8)
        rows.append(cache.lookup(pub))
        full_scalars.append(z * h % L)
    rows.append(0)  # base point row
    full_scalars.append((-b_coeff) % L)
    return r_encs, z_bytes, rows, full_scalars


def prepare_batch_cached(msgs, pubs, sigs, cache: DevicePointCache, _rng=None):
    """Host prep for the cached path. Returns ``(packed, mf, mc)`` or None
    if the batch is rejected host-side (non-canonical encodings, invalid
    cached keys)."""
    randbits = _rng.getrandbits if _rng is not None else secrets.randbits

    # Length checks BEFORE cache.ensure: a wrong-length pub is a rejection,
    # not a shape error.
    for pub, sig in zip(pubs, sigs):
        if len(sig) != 64 or len(pub) != 32:
            return None

    t = stages.begin() if stages.ARMED else None
    known = cache.ensure(pubs)
    if t is not None:
        stages.end("crypto.prep.ensure", t)
    if not known:
        return None

    t = stages.begin() if stages.ARMED else None
    lanes = _cached_lanes(msgs, pubs, sigs, cache, randbits)
    if t is not None:
        stages.end("crypto.prep.scalars", t)
    if lanes is None:
        return None
    r_encs, z_bytes, rows, full_scalars = lanes

    n = len(msgs)
    mf = _pad_to_pow2(n)
    mc = _pad_to_pow2(n + 1)

    t = stages.begin() if stages.ARMED else None
    digits_f = cv.signed_digits_from_bytes(z_bytes, N_WINDOWS_RLC)  # [33, n]
    sc_bytes = np.frombuffer(
        b"".join(s.to_bytes(32, "little") for s in full_scalars), dtype=np.uint8
    ).reshape(-1, 32)
    digits_c = cv.signed_digits_from_bytes(sc_bytes, N_WINDOWS_FULL)  # [64, n+1]
    if t is not None:
        stages.end("crypto.prep.recode", t)

    t = stages.begin() if stages.ARMED else None
    packed = np.zeros((mf + mc, _ROW_WIDTH), dtype=np.uint8)
    enc_arr = np.frombuffer(b"".join(r_encs), dtype=np.uint8).reshape(n, 32)
    packed[:n, :32] = enc_arr
    packed[:n, 31] &= 0x7F
    packed[:n, 32:65] = (digits_f.T + 8).astype(np.uint8)
    packed[:n, 65] = enc_arr[:, 31] >> 7
    packed[n:mf, 0] = 1  # identity encoding (y=1, sign 0), zero digits
    packed[n:mf, 32:65] = 8  # biased zero digits

    c = packed[mf:]
    c[: n + 1, :64] = (digits_c.T + 8).astype(np.uint8)
    row_arr = np.asarray(rows, dtype=np.uint32)
    c[: n + 1, 64] = (row_arr & 0xFF).astype(np.uint8)
    c[: n + 1, 65] = (row_arr >> 8).astype(np.uint8)
    c[n + 1 :, :64] = 8  # biased zero digits, row 0 (B * 0 = identity)
    if t is not None:
        stages.end("crypto.prep.pack", t)
    return packed, mf, mc


def pad_prepared_cached(packed, mf: int, mc: int, mf2: int, mc2: int):
    """Grow a ``prepare_batch_cached`` layout to (mf2, mc2) lanes with
    neutral rows (identity encodings / zero digits on row 0), preserving
    the verdict."""
    out = np.zeros((mf2 + mc2, _ROW_WIDTH), dtype=np.uint8)
    out[:mf] = packed[:mf]
    out[mf:mf2, 0] = 1  # identity encoding (y=1, sign 0)
    out[mf:mf2, 32:65] = 8  # biased zero digits
    out[mf2 : mf2 + mc] = packed[mf:]
    out[mf2 + mc :, :64] = 8  # biased zero digits, row 0 (B * 0 = identity)
    return out


def verify_batch_device_cached(msgs, pubs, sigs, cache: DevicePointCache, _rng=None) -> bool:
    """Cached-committee variant of ``verify_batch_device`` — the steady-
    state QC path (same cofactored acceptance set), on the cache's device."""
    if len(msgs) == 0:
        return True
    prepared = prepare_batch_cached(msgs, pubs, sigs, cache, _rng=_rng)
    if prepared is None:
        return False
    packed, mf, _ = prepared
    return _launch_and_wait(run_cached, torch.from_numpy(packed), cache.device, cache.array, mf)
