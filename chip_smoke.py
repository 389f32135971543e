#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``hotstuff_tpu_torch``) on one card.

    python3 chip_smoke.py [--seed 0]

Needs one NVIDIA Hopper card (sm_90a), ``nvcc`` and the repository beside
this file; it exits non-zero without them and prints no result. Phases, each
unguarded (any failure ends the run with a non-zero exit):

1. toolchain: the card's name and power limit, CUDA, nvcc, capability;
2. build: every ``hotstuff_tpu_torch/csrc/*.cu`` with nvcc (timed);
3. the main path: a committee of N = 1000 keys from ``--seed``; in each
   of 3 rounds, 2f+1 signed votes go through ``Aggregator.add_vote`` to a QC
   and ``QC.verify`` runs under ``set_backend(CudaBackend())``. A QC with
   one flipped signature byte must raise ``InvalidSignature``, one QC goes
   through the uncached path. The kernels' launch counts are zeroed just
   before and read just after; each kernel of the path (decompression,
   K2, K3, K4, verdict) must have launched;
4. small-input check: both MSMs against the pure-Python RFC 8032 oracle;
5. kernels against their plain PyTorch versions on the card, on the inputs
   the main path gives them (one QC's batch), limb for limb; the
   decompression with invalid rows (a non-square, x = 0 with sign 1)
   written over padding lanes, the verdict also on a rejected point and on
   an ``ok`` with one False; the root alone (``sqrt_pow``, off the path);
   the full MSMs against the plain ``curve.msm_signed``/``curve.msm`` by
   canonical affine encoding (their additions run in another order). Each
   kernel is timed at
   each of its main-path shapes by CUDA events and by the profiler's device
   time (``utils/kernel_times.kernel_ms``: the profiler's figure is taken
   where the two differ by more than 10%), beside its grid, threads per
   CTA, and ptxas' registers and stack bytes;
6. warm per-QC time, split into host prep and the stream span of the copy
   and ``run_cached`` (CUDA events; it includes the gaps where the card
   waits for the host to issue the next op, so it is not device time); a
   warm QC must launch decompression once, K2 and K3 twice, the verdict
   once, and nothing else;
7. a ``torch.profiler`` trace of warm ``QC.verify`` calls: device time
   (the busy time the profiler saw), its share of the wall time, and
   device time and launches by kernel name. A warm QC must stay within
   400 aten ops and 60 device ops (the glue the kernels replaced was
   about 10,700 and 4,150).

The last two lines are a JSON object per kernel (``{"kernels": [...]}``)
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from hotstuff_tpu_torch import crypto  # noqa: E402
from hotstuff_tpu_torch.consensus import errors  # noqa: E402
from hotstuff_tpu_torch.consensus.aggregator import Aggregator  # noqa: E402
from hotstuff_tpu_torch.consensus.config import Authority, Committee  # noqa: E402
from hotstuff_tpu_torch.consensus.messages import QC, Vote  # noqa: E402
from hotstuff_tpu_torch.crypto import ed25519_ref as ref  # noqa: E402
from hotstuff_tpu_torch.crypto.cuda_backend import CudaBackend  # noqa: E402
from hotstuff_tpu_torch.ops import curve as cv  # noqa: E402
from hotstuff_tpu_torch.ops import field as fe  # noqa: E402
from hotstuff_tpu_torch.ops import msm_kernels as mk  # noqa: E402
from hotstuff_tpu_torch.ops import verify as ov  # noqa: E402
from hotstuff_tpu_torch.utils import kernel_build  # noqa: E402
from hotstuff_tpu_torch.utils.kernel_times import PROFILER_NAMES, kernel_ms  # noqa: E402

# Where each kernel's TPU counterpart is built (hotstuff_tpu/ops/pallas_msm.py);
# the verdict has none (jnp code in the reference's verify graphs).
SOURCES = {
    "decompress": ("hotstuff_tpu_torch/csrc/decompress.cu", "hotstuff_tpu/ops/pallas_msm.py:248"),
    "sqrt_pow": ("hotstuff_tpu_torch/csrc/sqrt_pow.cu", "hotstuff_tpu/ops/pallas_msm.py:248"),
    "msm_partials_signed": (
        "hotstuff_tpu_torch/csrc/msm_partials.cu",
        "hotstuff_tpu/ops/pallas_msm.py:552",
    ),
    "msm_combine": ("hotstuff_tpu_torch/csrc/msm_combine.cu", "hotstuff_tpu/ops/pallas_msm.py:562"),
    "msm_partials": ("hotstuff_tpu_torch/csrc/msm_partials.cu", "hotstuff_tpu/ops/pallas_msm.py:483"),
    "verdict": ("hotstuff_tpu_torch/csrc/verdict.cu", None),
}
# The main path's kernels (phase 3), and a warm cached QC's launches (phase 6).
PATH_KERNELS = ("decompress", "msm_partials_signed", "msm_combine", "msm_partials", "verdict")
WARM_QC_LAUNCHES = {"decompress": 1, "sqrt_pow": 0, "msm_partials_signed": 2, "msm_partials": 0,
                    "msm_combine": 2, "verdict": 1}
# Phase 7's ceiling per warm QC: aten ops the profiler sees, and device ops.
MAX_ATEN_OPS, MAX_DEVICE_OPS = 400, 60

# The bound. These kernels are bound by int32 multiply-adds (IMAD): a field
# mul is a 20 x 20 limb schoolbook, 400 IMADs. A Hopper SM issues 64 int32
# lanes per clock (NVIDIA's Hopper white paper), so the card's IMAD peak is
# SMs x 64 x its maximum SM clock. Bytes: each input read once, each output
# written once, over 3.35 TB/s (H100 SXM data sheet).
IMAD_PER_MUL = 400
INT32_LANES_PER_SM = 64
HBM_BYTES_PER_S = 3.35e12
MULS_PADD, MULS_PDOUBLE, MULS_SQRT_POW = 9, 8, 269
# A decompressed lane: y^2 and d y^2, the root, r^2 v, x y. A lane whose
# root is fixed by sqrt(-1) takes one more, left out: the bound is at most
# 1/275 low, which does not flatter the kernel.
MULS_DECOMPRESS = 2 + MULS_SQRT_POW + 2 + 1
# K3's serial chain, in field muls that each wait for the one before: a
# point add's muls run in 3 dependent stages ({a, b, T 2d, 2Z Z'}, then
# (T 2d) T', then the four products), a doubling's in 2.
STAGES_PADD, STAGES_PDOUBLE = 3, 2

# The smoke configuration: BASELINE.json config 4, a 1000-validator
# committee (stake 1 each, quorum 667), at its full width.
VALIDATORS = 1000
ROUNDS = 3


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_usage() -> dict[str, tuple[int, int, int]]:
    """(registers, stack bytes, spill store bytes) of each kernel, by its
    ``PROFILER_NAMES`` key, from ptxas' report in the build log."""
    mangled = {"decompress": "decompress_kernel",
               "sqrt_pow": "sqrt_pow_kernel", "msm_partials_signed": "msm_partials_kernelILb1",
               "msm_partials": "msm_partials_kernelILb0", "msm_combine": "msm_combine_kernel",
               "verdict": "verdict_kernel"}
    usage, current = {}, None
    for _, log in kernel_build.build_log.values():
        for line in log.splitlines():
            if "Compiling entry function" in line:
                current = next((k for k, m in mangled.items() if m in line), None)
            elif current and "bytes stack frame" in line:
                words = line.split()
                stack, spill = int(words[0]), int(words[4])
            elif current and "Used" in line and "registers" in line:
                regs = int(line.split("Used")[1].split()[0])
                usage[current] = (regs, stack, spill)
                current = None
    return usage


def bound_ms(muls: int, nbytes: int, imad_per_s: float) -> tuple[float, str]:
    t_ops = muls * IMAD_PER_MUL / imad_per_s
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.long() - b.long()).abs().max())


# -- phase 3: the main path ----------------------------------------------------


def make_committee(n: int, seed: int):
    rng = random.Random(seed)
    keys = [crypto.generate_keypair(seed=rng.randbytes(32)) for _ in range(n)]
    committee = Committee({pk: Authority(1, ("127.0.0.1", 9000 + i)) for i, (pk, _) in enumerate(keys)})
    return keys, committee


def make_qc(keys, committee, round_: int, seed: int) -> QC:
    """Signed votes of a shuffled committee into the aggregator until the
    QC forms (at 2f+1 by stake)."""
    rng = random.Random(seed * 1000 + round_)
    block = crypto.sha512_digest(b"block", seed.to_bytes(8, "little"), round_.to_bytes(8, "little"))
    agg = Aggregator(committee)
    order = list(keys)
    rng.shuffle(order)
    for pk, sk in order:
        qc = agg.add_vote(Vote.new_from_key(block, round_, pk, sk))
        if qc is not None:
            return qc
    raise SmokeFailure("no QC formed")


def tampered(qc: QC) -> QC:
    votes = list(qc.votes)
    pk, sig = votes[len(votes) // 2]
    data = bytearray(sig.data)
    data[5] ^= 0x01  # inside R: host checks pass, the device equation fails
    votes[len(votes) // 2] = (pk, crypto.Signature(bytes(data)))
    return QC(hash=qc.hash, round=qc.round, votes=votes)


def main_path(keys, committee, qcs):
    """Drive the port's entry points; returns (launch counts, timings)."""
    mk.reset_launches()
    t0 = time.perf_counter()
    backend = CudaBackend()
    crypto.set_backend(backend)
    first_ms = []
    for qc in qcs:
        t = time.perf_counter()
        qc.verify(committee)  # raises on rejection
        first_ms.append((time.perf_counter() - t) * 1e3)
    try:
        tampered(qcs[0]).verify(committee)
        raise SmokeFailure("tampered QC accepted")
    except errors.InvalidSignature:
        pass
    try:
        QC(qcs[0].hash, qcs[0].round, qcs[0].votes[: len(qcs[0].votes) - 1]).verify(committee)
        raise SmokeFailure("QC below quorum accepted")
    except errors.QCRequiresQuorum:
        pass
    crypto.set_backend(CudaBackend(cache=False))
    t = time.perf_counter()
    qcs[-1].verify(committee)
    uncached_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(mk.LAUNCHES)
    crypto.set_backend(backend)
    check(backend.dispatches == len(qcs) + 1, f"backend dispatches {backend.dispatches}")
    return launches, backend, {"first_ms": first_ms, "uncached_ms": uncached_ms, "wall_s": wall}


# -- phase 4: small input against the oracle ----------------------------------


def oracle_check(device) -> None:
    rng = random.Random(7)
    points, scalars = [], []
    for _ in range(4):
        k = rng.randrange(1, ref.L)
        points.append(ref.point_mul(k, ref.G))
        scalars.append(rng.randrange(0, ref.L))
    expected = ref.IDENTITY
    for pt, s in zip(points, scalars):
        expected = ref.point_add(expected, ref.point_mul(s, pt))
    arr = np.stack(
        [np.stack([fe._int_to_limbs(c % fe.P) for c in pt]) for pt in points]
    ).astype(np.int32)
    pts = torch.from_numpy(arr).to(device)
    signed = torch.from_numpy(cv.scalars_to_signed_digits(scalars, 64).copy()).to(device)
    unsigned = torch.from_numpy(cv.scalars_to_digits(scalars)).to(device)
    want = ref.point_compress(expected)
    check(cv.to_affine_bytes(mk.msm_signed(pts, signed)) == want, "signed MSM != oracle")
    check(cv.to_affine_bytes(mk.msm(pts, unsigned)) == want, "unsigned MSM != oracle")


# -- phase 5: kernels against plain versions ----------------------------------


def usage_note(name: str) -> str:
    regs, stack, spill = ptxas_usage()[name]
    return f"{regs} registers, {stack} B stack, {spill} B spill stores"


def with_invalid_rows(y: torch.Tensor, sign: torch.Tensor):
    """Copies of a batch's y limbs and signs with its last three lanes (the
    padding of a QC's batch) made invalid: a non-square y = 2, y = 1 (x = 0)
    with sign 1, and y = p - 1 (x = 0, top limb full) with sign 1."""
    y, sign = y.clone(), sign.clone()
    for i, (val, s) in enumerate([(2, 0), (1, 1), (fe.P - 1, 1)]):
        y[-1 - i] = torch.from_numpy(fe._int_to_limbs(val)).to(y.device)
        sign[-1 - i] = s
    return y, sign


def kernel_checks(qc: QC, backend, device, imad_per_s: float):
    digest = qc.digest().data
    msgs = [digest] * len(qc.votes)
    pubs = [pk.data for pk, _ in qc.votes]
    sigs = [sig.data for _, sig in qc.votes]
    packed, mf, mc = ov.prepare_batch_cached(msgs, pubs, sigs, backend._cache)
    packed_d = torch.from_numpy(packed).to(device)
    ok_f, pts_f, digits_f, pts_c, digits_c = ov.cached_inputs(packed_d, backend._cache.array, mf)
    fresh = packed_d[:mf].to(torch.int32)
    y_f, sign_f = ov._enc_to_y_limbs(fresh[:, :32]), fresh[:, 65]
    packed_u, m_u = ov.prepare_batch(msgs, pubs, sigs)
    packed_ud = torch.from_numpy(packed_u).to(device)
    ok_u, pts_u, digits_u = ov.uncached_inputs(packed_ud)
    y_u, sign_u = ov._unpack_device(packed_ud)[:2]
    digits_f, digits_c = digits_f.contiguous(), digits_c.contiguous()
    torch.cuda.synchronize()

    rows, notes = {}, []

    def timed_plain(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    # K1, the decompression: at the fresh R lanes of the cached QC and at
    # every lane of the uncached batch, each with invalid rows.
    for y, sign in ((y_f, sign_f), (y_u, sign_u)):
        y, sign = with_invalid_rows(y, sign)
        m = y.shape[0]
        ok_k, pts_k = mk.decompress(y, sign)
        (ok_p, pts_p), plain = timed_plain(lambda: mk.decompress_plain(y, sign))
        err = max_abs_err(pts_k, pts_p)
        check(err == 0, f"decompress [{m}] points differ from the plain version by {err}")
        check(torch.equal(ok_k, ok_p), f"decompress [{m}] ok differs from the plain version")
        check(not ok_k[-3:].any() and bool(ok_k[:-3].all()),
              f"decompress [{m}]: the invalid rows passed or a valid one failed")
        b, by = bound_ms(MULS_DECOMPRESS * m, m * (80 + 4 + 1 + 320), imad_per_s)
        ms, ev, pr = kernel_ms(lambda: mk.decompress(y, sign), 20, PROFILER_NAMES["decompress"])
        grid, threads = mk.decompress_geometry(m)
        notes.append(f"decompress y [{m}, 20]: grid {grid} x {threads} threads, "
                     f"{usage_note('decompress')}; {ms:.4f} ms (events {ev:.4f}, profiler {pr:.4f}; "
                     f"plain {plain:.1f} ms, bound {b:.4f} ms)")
        if m == mf:  # the JSON row: the cached QC's shape, one launch a QC
            rows["decompress"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                                      bound_by=by, shape=f"y [{m}, 20]")

    # The root alone, off the path since the decompression took it in.
    u, v = cv.decompress_ratio(y_f)
    m = u.shape[0]
    r_k = mk.sqrt_pow(u, v)
    r_p, plain = timed_plain(lambda: mk.sqrt_pow_plain(u, v))
    err = max_abs_err(r_k, r_p)
    check(err == 0, f"sqrt_pow differs from its plain version by {err}")
    check(bool((fe.canonical(r_k) == fe.canonical(r_p)).all()), "sqrt_pow canonical mismatch")
    b, by = bound_ms(MULS_SQRT_POW * m, 3 * m * 80, imad_per_s)
    ms, ev, pr = kernel_ms(lambda: mk.sqrt_pow(u, v), 20, PROFILER_NAMES["sqrt_pow"])
    rows["sqrt_pow"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                            shape=f"u, v [{m}, 20]")
    blocks = -(-m // mk.SQRT_POW_BLOCK)
    notes.append(f"sqrt_pow u, v [{m}, 20]: grid ({blocks}, 1) x {min(mk.SQRT_POW_BLOCK, m)} "
                 f"threads, {usage_note('sqrt_pow')}; {ms:.4f} ms (events {ev:.4f}, profiler "
                 f"{pr:.4f}; plain {plain:.1f} ms, bound {b:.4f} ms)")

    # K2 + K3 (signed) at both window counts; K4 + K3 (unsigned).
    cases = [
        ("signed", pts_f, digits_f, True),
        ("signed", pts_c, digits_c, True),
        ("unsigned", pts_u, digits_u, False),
    ]
    for kind, pts, digits, signed in cases:
        m, w = pts.shape[0], digits.shape[0]
        block = min(mk.PARTIALS_BLOCK, m)
        nb = m // block
        part_k = mk.msm_partials(pts, digits, signed=signed)
        part_p, part_plain = timed_plain(lambda: mk.msm_partials_plain(pts, digits, block, signed))
        err_p = max_abs_err(part_k, part_p)
        check(err_p == 0, f"{kind} partials ({w} windows) differ from plain by {err_p}")
        out_k = mk.msm_combine(part_k)
        out_p, comb_plain = timed_plain(lambda: mk.msm_combine_plain(part_k))
        err_c = max_abs_err(out_k, out_p)
        check(err_c == 0, f"combine ({w} windows) differs from plain by {err_c}")
        whole = cv.msm_signed if signed else cv.msm
        ref_pt = whole(pts, digits)
        check(cv.to_affine_bytes(out_k) == cv.to_affine_bytes(ref_pt),
              f"{kind} MSM ({w} windows, m={m}) != plain curve MSM")
        table = 9 if signed else 16
        pname = "msm_partials_signed" if signed else "msm_partials"
        p_ms, p_ev, p_pr = kernel_ms(lambda: mk.msm_partials(pts, digits, signed=signed), 10,
                                     PROFILER_NAMES[pname])
        c_ms, c_ev, c_pr = kernel_ms(lambda: mk.msm_combine(part_k), 10,
                                     PROFILER_NAMES["msm_combine"])
        pb, pby = bound_ms(
            MULS_PADD * (m * (table - 2) + nb * w * (block - 1)),
            m * 320 + w * m * 4 + nb * w * 320, imad_per_s,
        )
        cb, cby = bound_ms(
            MULS_PADD * w * (nb - 1) + (w - 1) * (4 * MULS_PDOUBLE + MULS_PADD),
            nb * w * 320 + 320, imad_per_s,
        )
        p_grid, p_threads = mk.partials_geometry(m, w, block)
        c_grid, c_threads = mk.combine_geometry(w)
        notes.append(
            f"{pname} points [{m}, 4, 20], digits [{w}, {m}]: grid {p_grid} x {p_threads} "
            f"threads, {usage_note(pname)}; {p_ms:.4f} ms (events {p_ev:.4f}, profiler "
            f"{p_pr:.4f}; plain {part_plain:.1f} ms, bound {pb:.4f} ms)"
        )
        chain = (nb - 1) * STAGES_PADD + (w - 1) * (4 * STAGES_PDOUBLE + STAGES_PADD)
        notes.append(
            f"msm_combine partials [{nb}, {w}, 4, 20]: grid {c_grid} x {c_threads} threads, "
            f"{usage_note('msm_combine')}; {c_ms:.4f} ms (events {c_ev:.4f}, profiler "
            f"{c_pr:.4f}; plain {comb_plain:.1f} ms, bound {cb:.4f} ms; serial chain {chain} "
            f"dependent mul stages, {c_ms * 1e6 / chain:.0f} ns each)"
        )
        # The JSON row of each kernel is taken at its widest main-path shape:
        # K2 and K3 at the cached lanes' 64 windows, K4 at the uncached batch.
        if w == 64 and (pname not in rows):
            rows[pname] = dict(max_abs_err=err_p, ms=p_ms, plain_ms=part_plain, bound_ms=pb,
                               bound_by=pby, shape=f"points [{m}, 4, 20], digits [{w}, {m}]")
        if signed and w == 64:
            rows["msm_combine"] = dict(max_abs_err=err_c, ms=c_ms, plain_ms=comb_plain,
                                       bound_ms=cb, bound_by=cby,
                                       shape=f"partials [{nb}, {w}, 4, 20]")
    # The verdict: the cached QC's two MSM results and the uncached one's,
    # then rejections (one point alone, an ok with one False in its last
    # lane), each against the plain version.
    acc_f, acc_c = mk.msm_signed(pts_f, digits_f), mk.msm_signed(pts_c, digits_c)
    acc_u = mk.msm(pts_u, digits_u)
    ok_last_false = ok_f.clone()
    ok_last_false[-1] = False
    cases = [
        ("cached", ok_f, (acc_f, acc_c), True),
        ("uncached", ok_u, (acc_u,), True),
        ("one MSM of two", ok_f, (acc_f,), False),
        ("ok with one False", ok_last_false, (acc_f, acc_c), False),
    ]
    for name, ok, pts, want in cases:
        got = mk.verdict(ok, *pts)
        plain_v, plain = timed_plain(lambda: mk.verdict_plain(ok, *pts))
        err = abs(int(got) - int(plain_v))
        check(err == 0 and bool(got) == want,
              f"verdict ({name}): kernel {bool(got)}, plain {bool(plain_v)}, expected {want}")
        if name not in ("cached", "uncached"):
            continue
        m = ok.shape[0]
        muls = (MULS_PADD if len(pts) == 2 else 0) + 3 * MULS_PDOUBLE
        b, by = bound_ms(muls, m + 320 * len(pts) + 1, imad_per_s)
        ms, ev, pr = kernel_ms(lambda: mk.verdict(ok, *pts), 20, PROFILER_NAMES["verdict"])
        chain = (STAGES_PADD if len(pts) == 2 else 0) + 3 * STAGES_PDOUBLE
        notes.append(f"verdict ok [{m}], {len(pts)} point(s): grid (1, 1) x 128 threads, "
                     f"{usage_note('verdict')}; {ms:.4f} ms (events {ev:.4f}, profiler {pr:.4f}; "
                     f"plain {plain:.1f} ms, bound {b:.6f} ms; serial chain {chain} dependent "
                     f"mul stages)")
        if name == "cached":
            rows["verdict"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                                   shape=f"ok [{m}], a, b [4, 20]")
    return rows, notes, (mf, mc, m_u)


# -- phase 6: warm QC timing ---------------------------------------------------


def qc_timing(qcs, committee, backend, device, reps: int):
    wall, host, span = [], [], []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(reps):
        for qc in qcs:
            torch.cuda.synchronize()
            t = time.perf_counter()
            qc.verify(committee)
            wall.append((time.perf_counter() - t) * 1e3)
            digest = qc.digest().data
            msgs = [digest] * len(qc.votes)
            pubs = [pk.data for pk, _ in qc.votes]
            sigs = [sig.data for _, sig in qc.votes]
            t = time.perf_counter()
            packed, mf, _ = ov.prepare_batch_cached(msgs, pubs, sigs, backend._cache)
            host.append((time.perf_counter() - t) * 1e3)
            start.record()
            ok = ov.run_cached(torch.from_numpy(packed).to(device), backend._cache.array, mf)
            end.record()
            check(bool(ok), "warm QC rejected")
            span.append(start.elapsed_time(end))
    return float(np.median(wall)), float(np.median(host)), float(np.median(span))


# -- phase 7: where the time goes ----------------------------------------------


def profile_qc(qc: QC, committee, reps: int) -> tuple[list[str], float, float]:
    """Trace ``reps`` warm verifies of one QC; per QC: wall (profiler on),
    device busy time, and device time and count by kernel name. Also
    returns the aten ops and the device ops per QC."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            qc.verify(committee)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / reps
    by_name: dict[str, list[float]] = {}
    host_ops = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            dur = (e.time_range.end - e.time_range.start) / 1e3
            by_name.setdefault(e.name, []).append(dur)
        elif e.name.startswith("aten::"):
            host_ops += 1
    h2d = sum(len(d) for name, d in by_name.items() if "HtoD" in name) / reps
    busy = sum(sum(d) for d in by_name.values()) / reps
    launches = sum(len(d) for d in by_name.values()) / reps
    check(busy > 0, "the profiler saw no device time")
    lines = [f"profile ({reps} warm QC.verify, profiler on): wall {wall_ms:.2f} ms per QC, device "
             f"time (profiler busy) {busy:.2f} ms ({100 * busy / wall_ms:.1f}% of wall, idle "
             f"{100 * (1 - busy / wall_ms):.1f}%), {launches:.0f} device ops and "
             f"{host_ops / reps:.0f} aten ops per QC, {h2d:.0f} host-to-device copies per QC"]
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:8]
    for name, durs in top:
        lines.append(f"  {sum(durs) / reps:8.3f} ms  x{len(durs) / reps:6.0f}  {name[:90]}")
    return lines, host_ops / reps, launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card", file=sys.stderr)
        return 1
    device = torch.device("cuda")

    # 1. toolchain
    card = nvidia_smi("name,power.limit")
    print(card)
    kind = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    imad_per_s = sms * INT32_LANES_PER_SM * max_clock_mhz * 1e6
    print(f"torch {torch.__version__} cuda {torch.version.cuda} nvcc {shutil.which('nvcc')} "
          f"capability {cap} SMs {sms} max SM clock {max_clock_mhz:.0f} MHz "
          f"(int32 IMAD peak {imad_per_s / 1e12:.2f} T/s)")

    # 2. build
    t = time.perf_counter()
    kernel_build.load_all()
    print(f"kernel build {time.perf_counter() - t:.1f} s: " + ", ".join(
        f"{name} {secs:.1f} s" for name, (secs, _) in sorted(kernel_build.build_log.items())))
    for name, (regs, stack, spill) in sorted(ptxas_usage().items()):
        print(f"  ptxas {name}: {regs} registers, {stack} B stack, {spill} B spill stores")

    # 3. the main path
    t = time.perf_counter()
    keys, committee = make_committee(VALIDATORS, args.seed)
    keygen_s = time.perf_counter() - t
    t = time.perf_counter()
    qcs = [make_qc(keys, committee, r + 1, args.seed) for r in range(ROUNDS)]
    sign_s = time.perf_counter() - t
    n_sigs = len(qcs[0].votes)
    print(f"committee N={VALIDATORS} quorum {committee.quorum_threshold()}: keygen "
          f"{keygen_s:.2f} s, {ROUNDS} QCs of {n_sigs} votes signed in {sign_s:.2f} s "
          f"(signer: {'cryptography' if crypto._HAVE_PYCA else 'pure-Python RFC 8032'})")
    launches, backend, mp = main_path(keys, committee, qcs)
    print(f"main path: {len(qcs)} QCs accepted, tampered QC rejected, QC below quorum "
          f"rejected, uncached QC accepted in {mp['wall_s']:.2f} s; first verifies "
          + ", ".join(f"{x:.1f}" for x in mp["first_ms"])
          + f" ms, uncached {mp['uncached_ms']:.1f} ms; launches {launches}")
    for name in PATH_KERNELS:
        check(launches[name] > 0, f"kernel {name} never launched on the main path")

    # 4. small input against the oracle
    oracle_check(device)
    print("oracle: signed and unsigned MSM at m=4 equal the RFC 8032 oracle")

    # 5. kernels against plain versions
    rows, notes, shapes = kernel_checks(qcs[0], backend, device, imad_per_s)
    print(f"kernels vs plain on the card (limb-exact; MSMs also affine-equal to the plain curve "
          f"MSM), mf={shapes[0]} mc={shapes[1]} uncached m={shapes[2]}:")
    for line in notes:
        print("  " + line)

    # 6. warm QC timing
    wall, host, span = qc_timing(qcs, committee, backend, device, reps=3)
    print(f"warm QC.verify (N={VALIDATORS}, {n_sigs} sigs, cached path) on {card}: "
          f"{wall:.2f} ms per QC, {wall * 1e3 / n_sigs:.1f} us/sig; host prep {host:.2f} ms, "
          f"stream span (events; includes host-issue gaps) {span:.2f} ms")
    mk.reset_launches()
    qcs[0].verify(committee)
    warm = dict(mk.LAUNCHES)
    check(warm == WARM_QC_LAUNCHES, f"a warm QC launched {warm}, expected {WARM_QC_LAUNCHES}")
    print(f"warm QC launches: {warm}")

    # 7. where the time goes
    lines, aten_ops, device_ops = profile_qc(qcs[0], committee, reps=3)
    for line in lines:
        print(line)
    check(aten_ops <= MAX_ATEN_OPS and device_ops <= MAX_DEVICE_OPS,
          f"a warm QC ran {aten_ops:.0f} aten ops and {device_ops:.0f} device ops "
          f"(at most {MAX_ATEN_OPS} and {MAX_DEVICE_OPS})")

    kernels = []
    for name in ("decompress", "sqrt_pow", "msm_partials_signed", "msm_combine", "msm_partials",
                 "verdict"):
        source, replaces = SOURCES[name]
        row = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None, "shape": row["shape"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
