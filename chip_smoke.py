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
   about 10,700 and 4,150);
8. the node's certificate path under ``set_backend("cuda-batched")``, with
   the process-wide cert arena on (phases 3 to 7 turn it off, so that a
   repeated verify pays what it is counted and timed for). The counts are
   zeroed before and read after; the path's kernels must have launched:
   a. a leader's round-4 ``Block`` carrying the last QC goes out as a v2
      frame (``encode_propose``), is decoded once (``decode_shared``),
      re-encodes byte for byte and verifies with a ``CertificateCache``
      (decompression 1, K2 2, K3 2, verdict 1); an arena hit launches
      nothing;
   b. a view change: 2f+1 ``Timeout``s off the wire, each carrying a v2
      high QC of round 1, 2 or 3, go through ``Aggregator.add_timeout`` to
      a TC; the TC goes out v2 (``encode_tc``) and verifies on the card;
      one flipped signature byte raises ``InvalidSignature``, one vote
      below quorum ``TCRequiresQuorum``; a timeout whose high QC is in the
      node's cache launches nothing;
   c. fusion, made deterministic by a gated ``CudaBackend`` whose first
      call waits until the rest have pooled: the TC, then four
      materialized QCs of pipelined rounds (a leader's own aggregates, or
      v1 frames), must make 2 inner calls, the second of 4 x 2f+1
      signatures; the same four QCs as v2 copies off the wire are cert
      jobs and must make 5 calls of 2f+1 (one per distinct certificate:
      they pool but do not fuse); with one QC tampered, only its waiter
      gets ``InvalidSignature``; eight copies of one QC make one call of
      2f+1 signatures, the rest deduped;
   d. the cached path's kernels against their plain versions at the fused
      flush's width (mf = mc = 4096) and at the widest flush that
      ``max_sigs`` lets through (8192 signatures: mf = 8192, mc = 16384),
      timed as in phase 5; the widest batch must verify;
   e. numbers: a lone QC through ``cuda-batched`` against the direct
      ``CudaBackend``, the fused flush (ms, µs/sig) against its four QCs
      one by one and against the inner calls of the four pooled v2 QCs,
      the widest flush, the TC verify, the v2 decode of the proposal, and
      the serial ``CpuBackend`` on one QC on the card's host.

The last two lines are a JSON object per kernel (``{"kernels": [...]}``;
``launches`` from phase 3, ``launches_node_path`` from phase 8, the
``fused_*`` and ``widest_*`` keys from 8d) and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from hotstuff_tpu_torch import crypto  # noqa: E402
from hotstuff_tpu_torch.consensus import cert_arena, errors  # noqa: E402
from hotstuff_tpu_torch.consensus.aggregator import Aggregator  # noqa: E402
from hotstuff_tpu_torch.consensus.config import Authority, Committee  # noqa: E402
from hotstuff_tpu_torch.consensus.decode_arena import decode_shared  # noqa: E402
from hotstuff_tpu_torch.consensus.messages import (  # noqa: E402
    QC,
    TC,
    Block,
    CertificateCache,
    SeatTable,
    Timeout,
    Vote,
    decode_message,
    encode_propose,
    encode_tc,
    encode_timeout,
)
from hotstuff_tpu_torch.crypto import ed25519_ref as ref  # noqa: E402
from hotstuff_tpu_torch.crypto.batching import BatchingBackend  # noqa: E402
from hotstuff_tpu_torch.crypto.cuda_backend import CudaBackend  # noqa: E402
from hotstuff_tpu_torch.ops import curve as cv  # noqa: E402
from hotstuff_tpu_torch.ops import field as fe  # noqa: E402
from hotstuff_tpu_torch.ops import msm_kernels as mk  # noqa: E402
from hotstuff_tpu_torch.ops import verify as ov  # noqa: E402
from hotstuff_tpu_torch.utils import kernel_build  # noqa: E402
from hotstuff_tpu_torch.utils.serde import Decoder, Encoder  # noqa: E402
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
# The node path's kernels (phase 8): the cached path's.
PHASE8_KERNELS = ("decompress", "msm_partials_signed", "msm_combine", "verdict")
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
# Phase 8's view change: the round its timeouts and TC are for.
TC_ROUND = ROUNDS + 2


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


def qc_batch(qc: QC):
    """A QC's (msgs, pubs, sigs), as ``QC.verify`` hands them to the backend."""
    digest = qc.digest().data
    return [digest] * len(qc.votes), [pk.data for pk, _ in qc.votes], [sig.data for _, sig in qc.votes]


def kernel_checks(batch, backend, device, imad_per_s: float, uncached: bool = True):
    """Each kernel against its plain version on the inputs that verifying
    ``batch`` (msgs, pubs, sigs) gives it, timed, with its bound. The
    cached path's kernels always; with ``uncached``, also the uncached
    path's (K1 over every lane, K4 + K3, its verdict) and the root alone."""
    msgs, pubs, sigs = batch
    packed, mf, mc = ov.prepare_batch_cached(msgs, pubs, sigs, backend._cache)
    packed_d = torch.from_numpy(packed).to(device)
    ok_f, pts_f, digits_f, pts_c, digits_c = ov.cached_inputs(packed_d, backend._cache.array, mf)
    fresh = packed_d[:mf].to(torch.int32)
    y_f, sign_f = ov._enc_to_y_limbs(fresh[:, :32]), fresh[:, 65]
    digits_f, digits_c = digits_f.contiguous(), digits_c.contiguous()
    decompress_cases, msm_cases = [(y_f, sign_f)], [("signed", pts_f, digits_f, True),
                                                    ("signed", pts_c, digits_c, True)]
    m_u = None
    if uncached:
        packed_u, m_u = ov.prepare_batch(msgs, pubs, sigs)
        packed_ud = torch.from_numpy(packed_u).to(device)
        ok_u, pts_u, digits_u = ov.uncached_inputs(packed_ud)
        y_u, sign_u = ov._unpack_device(packed_ud)[:2]
        decompress_cases.append((y_u, sign_u))
        msm_cases.append(("unsigned", pts_u, digits_u, False))
    torch.cuda.synchronize()

    rows, notes = {}, []

    def timed_plain(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    # K1, the decompression: at the fresh R lanes of the cached batch and at
    # every lane of the uncached batch, each with invalid rows.
    for y, sign in decompress_cases:
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
    if uncached:
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
    for kind, pts, digits, signed in msm_cases:
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
    ok_last_false = ok_f.clone()
    ok_last_false[-1] = False
    cases = [
        ("cached", ok_f, (acc_f, acc_c), True),
        ("one MSM of two", ok_f, (acc_f,), False),
        ("ok with one False", ok_last_false, (acc_f, acc_c), False),
    ]
    if uncached:
        cases.insert(1, ("uncached", ok_u, (mk.msm(pts_u, digits_u),), True))
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
            msgs, pubs, sigs = qc_batch(qc)
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


# -- phase 8: the node's certificate path --------------------------------------


def expect_launches(before: dict, verifies: int, what: str) -> None:
    """The kernels launched since ``before`` are those of ``verifies``
    cached-path verifies on warm keys, and nothing else."""
    got = {name: mk.LAUNCHES[name] - before[name] for name in mk.LAUNCHES}
    want = {name: n * verifies for name, n in WARM_QC_LAUNCHES.items()}
    check(got == want, f"{what} launched {got}, expected {want}")


class GatedCuda:
    """A ``CudaBackend`` whose first call waits until ``release`` is set: an
    in-flight device call that later requests pool behind, so a fused
    flush is deterministic. Records each call's size and milliseconds (the
    first call's without its wait)."""

    name = "cuda"

    def __init__(self, inner: CudaBackend) -> None:
        self.inner = inner
        self.calls: list[tuple[int, float]] = []
        self.entered, self.release = threading.Event(), threading.Event()

    def verify_batch(self, msgs, pubs, sigs) -> None:
        if not self.calls:
            self.entered.set()
            if not self.release.wait(300):
                raise SmokeFailure("the gate was never released")
        t = time.perf_counter()
        try:
            self.inner.verify_batch(msgs, pubs, sigs)
        finally:
            self.calls.append((len(msgs), (time.perf_counter() - t) * 1e3))


def pooled(cuda: CudaBackend, opener, calls) -> tuple[list, GatedCuda, BatchingBackend]:
    """Install a fresh ``BatchingBackend(GatedCuda(cuda))``, run ``opener``
    into it, then ``calls`` in threads once its inner call is in flight, and
    open the gate when all of them have pooled. Returns (the exception or
    None of the opener and of each call, the gated backend, the wrapper)."""
    gated = GatedCuda(cuda)
    fusing = BatchingBackend(gated)
    crypto.set_backend(fusing)
    errors = [None] * (len(calls) + 1)

    def run(i, fn):
        try:
            fn()
        except Exception as e:  # the verdict is the exception, read below
            errors[i] = e

    first = threading.Thread(target=run, args=(0, opener))
    first.start()
    check(gated.entered.wait(300), "the opener never reached the device")
    threads = [threading.Thread(target=run, args=(i + 1, fn)) for i, fn in enumerate(calls)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 300
    while time.monotonic() < deadline:
        with fusing._lock:
            if len(fusing._pending) == len(calls):
                break
        time.sleep(0.001)
    gated.release.set()
    for t in (first, *threads):
        t.join(600)
        check(not t.is_alive(), "a pooled request never returned")
    return errors, gated, fusing


def median_ms(fn, reps: int, before=None) -> float:
    out = []
    for _ in range(reps):
        if before is not None:
            before()
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return float(np.median(out))


def expect(fn, error: type, what: str) -> None:
    try:
        fn()
    except error:
        return
    raise SmokeFailure(f"{what} was not rejected with {error.__name__}")


def v2_copy(qc: QC, seats: SeatTable) -> QC:
    """A QC as a v2 decode gives it: seats and a packed signature buffer."""
    enc = Encoder()
    qc.encode(enc, seats)
    dec = Decoder(enc.finish())
    out = QC.decode(dec, seats)
    dec.finish()
    return out


def flipped(frame: bytes, pos: int) -> bytes:
    data = bytearray(frame)
    data[pos] ^= 0x01
    return bytes(data)


def node_path(keys, committee, qcs, seed: int):
    """Phase 8: the certificate path as a node runs it, under
    ``set_backend("cuda-batched")``. Returns (launches of the whole phase,
    its numbers, the four-QC fused batch for 8d, the ``BatchingBackend``
    around the ``CudaBackend``)."""
    seats = SeatTable.for_committee(committee)
    secret = dict(keys)
    quorum = committee.quorum_threshold()
    crypto.set_backend("cuda-batched")
    batched = crypto.get_backend()
    check(isinstance(batched, BatchingBackend) and isinstance(batched.inner, CudaBackend),
          f"cuda-batched installed {batched!r}")
    cuda = batched.inner
    numbers = {}
    mk.reset_launches()

    # Committee keys at first sight: one decompression onto the card.
    check(cuda._cache.ensure([pk.data for pk in committee.sorted_keys()]),
          "a committee key failed to decompress")

    # a. A proposal off the wire: a v2 frame, decoded once per process.
    leader = committee.sorted_keys()[4 % len(keys)]
    payload = [crypto.sha512_digest(b"payload", seed.to_bytes(8, "little"), bytes([i]))
               for i in range(4)]
    block = Block.new_from_key(qcs[-1], None, leader, 4, payload, secret[leader])
    frame = encode_propose(block, seats)
    kind, proposal = decode_shared(frame, seats)
    check(kind == "propose" and "_raw_votes" in proposal.qc.__dict__,
          "the proposal's QC is not lazy v2")
    check(encode_propose(proposal, seats) == frame, "re-encoding the proposal changed its bytes")
    check(decode_shared(frame, seats)[1] is proposal, "a second decode_shared decoded again")
    cert_arena.reset()
    before = dict(mk.LAUNCHES)
    proposal.verify(committee, CertificateCache())
    expect_launches(before, 1, "the proposal's verify")
    before = dict(mk.LAUNCHES)
    decode_message(frame, seats)[1].verify(committee, CertificateCache())  # an arena hit
    expect_launches(before, 0, "a proposal whose QC is in the arena")
    numbers["decode_ms"] = median_ms(lambda: decode_message(frame, seats), 20)

    # b. A view change: timeouts carrying v2 high QCs of rounds 1..3 go
    # through the aggregator to a TC, verified off the wire.
    v2_qcs = [v2_copy(q, seats) for q in qcs]
    by_seat = sorted(keys, key=lambda kp: kp[0])
    voters = by_seat[:quorum]
    agg, cache = Aggregator(committee), CertificateCache()
    cert_arena.reset()
    before = dict(mk.LAUNCHES)
    tcs = []
    for i, (pk, sk) in enumerate(voters):
        timeout = Timeout.new_from_key(v2_qcs[i % len(v2_qcs)], TC_ROUND, pk, sk)
        _, arrived = decode_shared(encode_timeout(timeout, seats), seats)
        check("_raw_votes" in arrived.high_qc.__dict__, "a timeout's high QC is not lazy v2")
        arrived.verify(committee, cache)
        tcs.append(agg.add_timeout(arrived))
    check([tc is not None for tc in tcs] == [False] * (quorum - 1) + [True],
          "the TC did not form at the quorum")
    expect_launches(before, len(v2_qcs),
                    f"{len(voters)} timeouts with {len(v2_qcs)} distinct high QCs")
    tc = tcs[-1]
    check(sorted(set(tc.high_qc_rounds())) == [q.round for q in qcs], "the TC's high QC rounds")
    cert_arena.reset()
    late = Timeout.new_from_key(v2_qcs[0], TC_ROUND, *by_seat[quorum])
    before = dict(mk.LAUNCHES)
    late.verify(committee, cache)
    expect_launches(before, 0, "a timeout whose high QC is in the node's cache")
    tc_frame = encode_tc(tc, seats)
    _, tc_v2 = decode_message(tc_frame, seats)
    check("_raw_votes" in tc_v2.__dict__, "the TC is not lazy v2")
    cert_arena.reset()
    before = dict(mk.LAUNCHES)
    tc_v2.verify(committee)
    expect_launches(before, 1, "the TC's verify")
    numbers["tc_ms"] = median_ms(lambda: tc_v2.verify(committee), 5, before=cert_arena.reset)
    records = 1 + 8 + 4 + seats.nbytes  # tag, round, count, bitmap
    bad_tc = decode_message(flipped(tc_frame, records + 72 * (quorum // 2) + 5), seats)[1]
    expect(lambda: bad_tc.verify(committee), errors.InvalidSignature,
           "a TC with a flipped signature byte")
    short = decode_message(encode_tc(TC(tc.round, tc.votes[:-1]), seats), seats)[1]
    expect(lambda: short.verify(committee), errors.TCRequiresQuorum, "a TC one vote below quorum")

    # c. Fusion: the TC opens a flush; four QCs of pipelined rounds pool
    # behind it and fuse into one call.
    four = [*qcs, make_qc(keys, committee, len(qcs) + 1, seed)]
    fused_batch = tuple(sum(parts, []) for parts in zip(*(qc_batch(q) for q in four)))
    fresh_tc = lambda: decode_message(tc_frame, seats)[1].verify(committee)  # noqa: E731
    cert_arena.reset()
    before = dict(mk.LAUNCHES)
    errs, gated, fusing = pooled(cuda, fresh_tc, [lambda q=q: q.verify(committee) for q in four])
    check(errs == [None] * 5, f"fused requests failed: {errs}")
    sizes = [n for n, _ in gated.calls]
    check(sizes == [quorum, 4 * quorum] and fusing.inner_calls == 2, f"fusion made calls {sizes}")
    expect_launches(before, 2, "the TC and the fused flush")
    numbers["fused_first_ms"] = gated.calls[1][1]

    # The same four QCs as a node receives them, off the v2 wire: each is a
    # cert job (``BatchingBackend.verify_cert``) and ``_flush_certs`` makes
    # one inner call per distinct certificate, so they pool but do not fuse.
    four_v2 = [v2_copy(q, seats) for q in four]
    v2_ms = []
    for _ in range(3):
        cert_arena.reset()
        before = dict(mk.LAUNCHES)
        errs, gated, fusing = pooled(cuda, fresh_tc,
                                     [lambda q=q: q.verify(committee) for q in four_v2])
        sizes = [n for n, _ in gated.calls]
        check(errs == [None] * 5 and sizes == [quorum] * 5 and fusing.inner_calls == 5
              and fusing.cert_requests == 5,
              f"four pooled v2 QCs gave calls {sizes}, errors {errs}")
        expect_launches(before, 5, "the TC and four pooled v2 QCs")
        v2_ms.append(sum(ms for _, ms in gated.calls[1:]))
    numbers["v2_pooled_ms"] = float(np.median(v2_ms))

    cert_arena.reset()
    bad = 1  # the tampered one of the four
    mixed = four[:bad] + [tampered(four[bad])] + four[bad + 1:]
    errs, gated, _ = pooled(cuda, fresh_tc, [lambda q=q: q.verify(committee) for q in mixed])
    check(all(e is None for i, e in enumerate(errs) if i != 1 + bad)
          and isinstance(errs[1 + bad], errors.InvalidSignature), f"isolation gave {errs}")
    sizes = [n for n, _ in gated.calls]
    check(sizes == [quorum, 4 * quorum] + [quorum] * 4, f"isolation made calls {sizes}")

    cert_arena.reset()
    copies = [QC(qcs[0].hash, qcs[0].round, list(qcs[0].votes)) for _ in range(8)]
    errs, gated, fusing = pooled(cuda, fresh_tc, [lambda q=q: q.verify(committee) for q in copies])
    sizes = [n for n, _ in gated.calls]
    check(errs == [None] * 9 and sizes == [quorum, quorum] and fusing.deduped_sigs == 7 * quorum,
          f"eight copies gave calls {sizes}, {fusing.deduped_sigs} deduped, errors {errs}")
    phase_launches = dict(mk.LAUNCHES)

    # e. Numbers. A lone QC through the wrapper against the direct backend
    # (the flusher's handoff), in turns; the fused flush against its four
    # QCs one by one; the serial CPU backend on the same QC.
    lone = {"batched": [], "direct": []}
    for _ in range(5):
        for name, backend in (("direct", cuda), ("batched", batched)):
            crypto.set_backend(backend)
            lone[name].append(median_ms(lambda: qcs[0].verify(committee), 1, before=cert_arena.reset))
    numbers["lone_batched_ms"] = float(np.median(lone["batched"]))
    numbers["lone_direct_ms"] = float(np.median(lone["direct"]))
    numbers["fused_ms"] = median_ms(lambda: cuda.verify_batch(*fused_batch), 5)
    crypto.set_backend(cuda)
    numbers["four_alone_ms"] = median_ms(lambda: [q.verify(committee) for q in four], 3,
                                         before=cert_arena.reset)
    crypto.set_backend(crypto.CpuBackend())
    numbers["cpu_qc_ms"] = median_ms(lambda: qcs[0].verify(committee), 3,
                                     before=cert_arena.reset)
    crypto.set_backend(batched)
    numbers["fused_sigs"] = len(fused_batch[0])
    return phase_launches, numbers, fused_batch, batched


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

    # 3. the main path. Phases 3 to 7 run with the process-wide cert arena
    # off, so that a repeated verify of one QC pays the verify it is
    # counted and timed for; phase 8 runs with it on, as a node does.
    os.environ["HOTSTUFF_CERT_ARENA"] = "0"
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
    rows, notes, shapes = kernel_checks(qc_batch(qcs[0]), backend, device, imad_per_s)
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

    # 8. the node's certificate path
    os.environ["HOTSTUFF_CERT_ARENA"] = "1"
    cert_arena.reset()
    t = time.perf_counter()
    node_launches, nb, fused_batch, batched = node_path(keys, committee, qcs, args.seed)
    cuda = batched.inner
    print(f"node path (cuda-batched, cert arena on) in {time.perf_counter() - t:.2f} s: v2 proposal "
          f"decoded once and re-encoded byte for byte, accepted (decompress 1, K2 2, K3 2, verdict "
          f"1), an arena hit launched nothing; {committee.quorum_threshold()} v2 timeouts of high "
          f"QC rounds 1-3 to a TC, accepted on the card, a flipped TC byte and a TC below quorum "
          f"rejected, a cached high QC launched nothing; the TC and four QCs fused into 2 inner "
          f"calls ({nb['fused_sigs']} signatures in the second), the same four QCs off the v2 wire "
          f"made one call each, a tampered QC among them failed alone, eight copies of a QC "
          f"deduped to one call; launches {node_launches}")
    for name in PHASE8_KERNELS:
        check(node_launches[name] > 0, f"kernel {name} never launched on the node path")
    n_sigs = committee.quorum_threshold()
    print(f"node path numbers on {card}: lone QC through cuda-batched {nb['lone_batched_ms']:.2f} ms, "
          f"direct CudaBackend {nb['lone_direct_ms']:.2f} ms (median of 5 each, in turns)")
    print(f"node path numbers on {card}: four-QC fused flush ({nb['fused_sigs']} signatures) "
          f"{nb['fused_ms']:.2f} ms, {nb['fused_ms'] * 1e3 / nb['fused_sigs']:.2f} us/sig (median "
          f"of 5; its first run in the pooled flush {nb['fused_first_ms']:.2f} ms); the same four "
          f"QCs one by one {nb['four_alone_ms']:.2f} ms (median of 3); the same four QCs as v2 "
          f"copies pooled behind the TC, their 4 inner calls of {n_sigs} {nb['v2_pooled_ms']:.2f} "
          f"ms in all (median of 3)")
    print(f"node path numbers on {card}: TC verify (N={VALIDATORS}, {n_sigs} per-voter digests) "
          f"{nb['tc_ms']:.2f} ms (median of 5); v2 decode of the proposal frame "
          f"{nb['decode_ms']:.3f} ms (median of 20)")
    print(f"node path numbers on {card}: CpuBackend (serial, signer: "
          f"{'OpenSSL' if crypto._HAVE_PYCA else 'pure-Python RFC 8032'}) on one QC of {n_sigs} "
          f"signatures on the card's host {nb['cpu_qc_ms']:.2f} ms, "
          f"{nb['cpu_qc_ms'] * 1e3 / n_sigs:.1f} us/sig (median of 3)")

    # 8d. the kernels at the fused flush's width
    fused_rows, fused_notes, fused_shapes = kernel_checks(fused_batch, cuda, device, imad_per_s,
                                                          uncached=False)
    print(f"kernels vs plain on the card at the fused flush's width (limb-exact), mf={fused_shapes[0]} "
          f"mc={fused_shapes[1]}:")
    for line in fused_notes:
        print("  " + line)

    # 8d, at the widest flush that ``max_sigs`` lets through: twelve QCs and
    # part of a thirteenth (rounds 1 to 13; a QC signs the same votes each
    # time it is made from the seed), mf = pow2(n), mc = pow2(n + 1).
    more = [make_qc(keys, committee, r, args.seed) for r in range(ROUNDS + 1, ROUNDS + 11)]
    wide_batch = tuple(sum(parts, [])[:batched.max_sigs]
                       for parts in zip(*(qc_batch(q) for q in qcs + more)))
    check(len(wide_batch[0]) == batched.max_sigs, "the widest batch is short")
    wide_rows, wide_notes, wide_shapes = kernel_checks(wide_batch, cuda, device, imad_per_s,
                                                       uncached=False)
    check(wide_shapes[:2] == (batched.max_sigs, 2 * batched.max_sigs),
          f"the widest flush ran at mf, mc = {wide_shapes[:2]}")
    wide_ms = median_ms(lambda: cuda.verify_batch(*wide_batch), 3)  # raises on rejection
    print(f"kernels vs plain on the card at the widest flush (limb-exact), {batched.max_sigs} "
          f"signatures, mf={wide_shapes[0]} mc={wide_shapes[1]}; the batch verifies in "
          f"{wide_ms:.2f} ms, {wide_ms * 1e3 / batched.max_sigs:.2f} us/sig (median of 3) on {card}:")
    for line in wide_notes:
        print("  " + line)

    kernels = []
    for name in ("decompress", "sqrt_pow", "msm_partials_signed", "msm_combine", "msm_partials",
                 "verdict"):
        source, replaces = SOURCES[name]
        row = rows[name]
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None, "shape": row["shape"],
            "launches_node_path": node_launches[name],
        }
        for prefix, extra in (("fused", fused_rows), ("widest", wide_rows)):
            row_x = extra.get(name)
            if row_x is not None:
                entry["shape"] += f"; {prefix} flush {row_x['shape']}"
                entry.update({f"{prefix}_{key}": row_x[key]
                              for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")})
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
