"""Everything the benchmark takes from the program, in one place: the
entry it drives, the encoder that makes the frames nodes send, the backend
selection, and the counters it reads. Nothing else under ``perfbench/``
imports the program.

The entry is a validator receiving a proposal: ``decode_message`` on the
frame, then ``Block.verify`` through the crypto bridge's worker pool
(``verify_off_loop``), exactly as the consensus core runs it. Caches that
could serve a repeated certificate stay off: the process-wide certificate
arena (``HOTSTUFF_CERT_ARENA=0``), the opt-in verdict memo (never turned
on), and no ``CertificateCache`` is passed.
"""

from __future__ import annotations

import os


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
