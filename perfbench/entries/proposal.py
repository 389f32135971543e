"""The ``proposal`` entry: a validator receiving proposals, the entry of
``n1008-viewchange`` and of every cell whose traffic names no entry. With
``drive.py`` (the closed loop) and ``inputs.py`` (the plan), the one module
of this entry that imports the program.

The entry is a validator receiving a proposal: ``decode_message`` on the
frame, then ``Block.verify`` through the crypto bridge's worker pool
(``verify_off_loop``), exactly as the consensus core runs it. Caches that
could serve a repeated certificate stay off: the process-wide certificate
arena (``HOTSTUFF_CERT_ARENA=0``), the opt-in verdict memo (never turned
on), and no ``CertificateCache`` is passed.

``correct``: the plain reference (``reference/``) judges every distinct
frame handed off in the window from the frame alone; four exact numbers,
limit 0: ``verdicts_wrong``, ``decodes_wrong``, ``unjudged`` and
``sigs_gap`` (|the change of ``crypto.dispatch.cuda_sigs`` - the
signatures the window's proposals sent to a batch check|).
"""

from __future__ import annotations

import os
import time

from perfbench import drive, faults, inputs, trace


def configure_environment(traffic: dict, chips: int) -> None:
    """Switches the program reads at first use; set before it is imported."""
    os.environ["HOTSTUFF_CRYPTO_BACKEND"] = traffic["backend"]
    os.environ["HOTSTUFF_CRYPTO_WORKERS"] = str(int(traffic["workers"]))
    os.environ["HOTSTUFF_CERT_ARENA"] = "0"
    if chips == 1:
        os.environ["HOTSTUFF_TPU_SHARDED"] = "0"


class Program:
    """The program's objects for one run: committee, seat table, backend."""

    def __init__(self, plan, traffic: dict, device: str) -> None:
        from hotstuff_tpu_torch import telemetry
        from hotstuff_tpu_torch.consensus import crypto_bridge, errors
        from hotstuff_tpu_torch.consensus.config import Authority, Committee
        from hotstuff_tpu_torch.consensus.messages import SeatTable, decode_message
        from hotstuff_tpu_torch.crypto import (
            BackendUnavailable,
            PublicKey,
            get_backend,
            set_backend,
        )
        from hotstuff_tpu_torch.ops import msm_kernels

        # Counters are live only with telemetry on; the backends take
        # theirs when they are built.
        telemetry.enable()
        self.telemetry = telemetry
        self.msm_kernels = msm_kernels
        self.errors = errors
        self.BackendUnavailable = BackendUnavailable
        self.decode_message = decode_message
        self.verify_off_loop = crypto_bridge.verify_off_loop
        self.committee = Committee(authorities={
            PublicKey(pk): Authority(stake=plan.stake, address=("127.0.0.1", 0)) for pk in plan.keys
        })
        self.seats = SeatTable.for_committee(self.committee)
        if [pk.data for pk in self.seats.keys] != plan.keys:
            raise RuntimeError("the program's seat order differs from the plan's")
        if device == "cuda":
            set_backend(traffic["backend"])
        else:
            # Test runs on the host: the same backend over the kernels'
            # plain versions.
            from hotstuff_tpu_torch.crypto.cuda_backend import CudaBackend

            set_backend(CudaBackend(device=device))
        self.backend = get_backend()

    def frames(self, plan, proposals) -> list[bytes]:
        """Each proposal as a frame from the program's encoder, with the
        certificates in the seat-bitmap format (v2) that nodes send."""
        from hotstuff_tpu_torch.consensus.messages import QC, TC, Block, encode_propose
        from hotstuff_tpu_torch.crypto import Digest, PublicKey, Signature
        from hotstuff_tpu_torch.utils.serde import Decoder, Encoder

        keys = self.seats.keys
        lazy = {}

        def cert(i):
            # Encoded once, then decoded into the program's lazy form, which
            # re-encodes from its packed buffer.
            if i not in lazy:
                c = plan.certs[i]
                enc = Encoder()
                if c.kind == "qc":
                    votes = [(keys[s], Signature(r)) for s, r in zip(c.seats, c.records)]
                    QC(Digest(c.hash), c.round, votes).encode(enc, self.seats)
                    lazy[i] = QC.decode(Decoder(enc.finish()), self.seats)
                else:
                    votes = [(keys[s], Signature(r[:64]), int.from_bytes(r[64:], "little"))
                             for s, r in zip(c.seats, c.records)]
                    TC(c.round, votes).encode(enc, self.seats)
                    lazy[i] = TC.decode(Decoder(enc.finish()), self.seats)
            return lazy[i]

        out = []
        for p in proposals:
            block = Block(
                qc=cert(p.qc),
                tc=cert(p.tc) if p.tc is not None else None,
                author=PublicKey(plan.keys[p.author]),
                round=p.round,
                payload=[Digest(d) for d in p.payload],
                signature=Signature(p.signature),
            )
            out.append(encode_propose(block, self.seats))
        return out

    def counters(self) -> dict[str, int]:
        reg = self.telemetry.get_registry()
        names = ("crypto.dispatch.cuda", "crypto.dispatch.cuda_sigs")
        return {n: reg.counter(n).value() for n in names}

    def launches(self) -> dict[str, int]:
        return dict(self.msm_kernels.LAUNCHES)

    def verdict_of(self, exc: BaseException | None) -> str:
        """The verdict class of what ``Block.verify`` raised."""
        if exc is None:
            return "accept"
        if isinstance(exc, self.errors.ConsensusError):
            return type(exc).__name__
        if isinstance(exc, self.BackendUnavailable):
            return "unjudged"
        return f"error:{type(exc).__name__}"

    def decode(self, frame: bytes):
        """The block of a frame, or None when the program refuses it."""
        from hotstuff_tpu_torch.utils.serde import SerdeError

        try:
            kind, block = self.decode_message(frame, self.seats)
        except (SerdeError, ValueError, self.errors.ConsensusError):
            return None
        return block if kind == "propose" else None

    @staticmethod
    def fields(block) -> tuple[bytes, tuple]:
        """The decoded block's digest and certificate fields, read after
        the window, in the reference's layout."""
        tc = block.tc
        return block.digest().data, (
            block.qc.round, block.qc.n_votes(),
            tc.round if tc is not None else None,
            tc.n_votes() if tc is not None else 0,
        )


class Entry:
    """Proposals from the seeded plan, driven in a closed loop of
    ``in_flight`` clients (``drive.py``)."""

    def __init__(self, config: dict, traffic: dict, seed: int, seconds: float, device: str,
                 log) -> None:
        self.config, self.traffic, self.seed = config, traffic, seed
        self.seconds, self.device, self.log = seconds, device, log
        self.in_flight = int(traffic["in_flight"])

    def setup(self) -> None:
        log = self.log
        t = time.perf_counter()
        plan = self.plan = inputs.make_plan(self.seed, self.config, self.traffic, self.seconds)
        log(f"set-up: plan of {len(plan.keys)} validators, {len(plan.certs)} certificates, "
            f"{len(plan.warmup)} warm-up and {len(plan.window)} window proposals "
            f"{time.perf_counter() - t:.2f} s")
        t = time.perf_counter()
        program = self.program = Program(plan, self.traffic, self.device)
        warm = program.frames(plan, plan.warmup)
        self.frames = program.frames(plan, plan.window)
        log(f"set-up: the program's objects and frames {time.perf_counter() - t:.2f} s")
        warm_ids = [(p.qc, p.tc) for p in plan.warmup]
        self.ids = [(p.qc, p.tc) for p in plan.window]
        out = drive.run(program, warm, warm_ids, self.in_flight, None)
        wrong = sum(r.verdict != p.intended
                    for r, p in zip(sorted(out.records, key=lambda r: r.j), plan.warmup))
        log(f"set-up: warm-up of {len(out.records)} proposals, {wrong} verdicts unlike the plan, "
            f"{(out.t_drained - out.t_start) / 1e9:.2f} s")

    @property
    def backend(self):
        return self.program.backend

    def install(self, control: str | None, fault: str | None) -> None:
        from hotstuff_tpu_torch.crypto import BackendUnavailable, CryptoError, set_backend

        if control:
            set_backend({"quorum-only": faults.QuorumOnly}[control]())
        if fault == "altered-decode":
            faults.altered_decode(self.program)
        elif fault:
            faults.break_backend(fault, self.program.backend, CryptoError, BackendUnavailable)

    def counters(self) -> dict[str, int]:
        return self.program.counters()

    def launches(self) -> dict[str, int]:
        return self.program.launches()

    def window(self, seconds: float, spans) -> drive.Outcome:
        return drive.run(self.program, self.frames, self.ids, self.in_flight, seconds, spans)

    def host_spans(self, run) -> dict:
        spans = run.spans
        return {
            "backend call": trace.merge((a, b) for a, b, _, _ in spans.backend),
            "verify outside the backend": trace.merge(spans.verify),
            "decode": trace.merge(spans.decode),
            "bridge hand-off": trace.merge((r.t0, r.t1) for r in run.records),
        }

    def check(self, run):
        """The reference judges every distinct frame handed off in the
        window."""
        from perfbench.reference import judge as ref

        t_ref = time.perf_counter()
        plan, frames = self.plan, self.frames
        committee = ref.Committee(plan.keys, {k: plan.stake for k in plan.keys})
        idx = sorted({r.j % len(frames) for r in run.records})
        verdicts = dict(zip(idx, ref.Judge(committee, self.seed).judge([frames[i] for i in idx])))
        checks, failed = _compare(run, verdicts, self.program, len(frames))
        self.log(f"reference: {len(idx)} frames judged in {time.perf_counter() - t_ref:.2f} s")
        unlike = sum(verdicts[i].verdict != plan.window[i].intended for i in idx)
        if unlike:
            # The yardstick's own inputs: the traffic is not what the plan made.
            self.log(f"the reference's verdicts of {unlike} frames are not the plan's: no result")
            return None
        return checks, failed


def _compare(run, verdicts: dict, program, n_frames: int):
    wrong = decodes = unjudged = 0
    expected_sigs = 0
    failed = 0
    for r in run.records:
        ref = verdicts[r.j % n_frames]
        expected_sigs += ref.sigs_sent
        bad = False
        if r.verdict == "unjudged" or r.verdict.startswith("error:"):
            unjudged += 1
            bad = True
        elif r.verdict != ref.verdict:
            wrong += 1
            bad = True
        if r.block is not None:
            if program.fields(r.block) != (ref.digest, ref.fields):
                decodes += 1
                bad = True
        failed += bad
    sigs = run.counters.get("crypto.dispatch.cuda_sigs", 0)
    checks = {
        "verdicts_wrong": {"value": wrong, "limit": 0},
        "decodes_wrong": {"value": decodes, "limit": 0},
        "unjudged": {"value": unjudged, "limit": 0},
        "sigs_gap": {"value": abs(sigs - expected_sigs), "limit": 0},
    }
    return checks, failed
