"""The control and the planted faults that the benchmark's comparison has to
catch. The benchmark's own runs use none of them; ``tests/`` runs each and
sees ``correct`` come out false. Nothing here imports the program: the entry
(``entries/<name>.py``) hands over the objects and the exception classes.

- control ``quorum-only``: the reference's acceptance rules put in the
  program's place with one guarantee broken: a certificate whose signers
  reach the quorum is accepted without its signatures being judged (the
  step a later change could take to save the batch check). It breaks the
  configuration's "no forged certificate is accepted".
- fault ``half-batch``: the backend judges the first half of each batch
  and leaves out the rest.
- fault ``altered-verdict``: every eighth verdict the backend produces is
  turned over where it is produced.
- fault ``unchanged``: the backend call returns at once and leaves its
  state as it was: nothing is judged.
- fault ``altered-decode``: every eighth decoded block comes out of the
  decoder with its round one higher.
- fault ``unavailable``: every eighth backend call fails as a device
  failure would, so its proposal gets no verdict.
"""

from __future__ import annotations

CONTROLS = ("quorum-only",)
FAULTS = ("half-batch", "altered-verdict", "unchanged", "altered-decode", "unavailable")


class QuorumOnly:
    """A batch backend that judges no signature."""

    name = "cuda-control-quorum-only"

    def verify_batch(self, msgs, pubs, sigs) -> None:
        return None


def altered_decode(program) -> None:
    """Every eighth block ``program.decode`` returns has its round one higher."""
    decode = program.decode
    decoded = [0]

    def altered(frame):
        block = decode(frame)
        decoded[0] += 1
        if block is not None and decoded[0] % 8 == 1:
            block.round += 1
        return block

    program.decode = altered


def break_backend(name: str, inst, crypto_error, unavailable_error) -> None:
    """Plant fault ``name`` under ``inst.verify_batch`` (the card backend
    instance), with the program's verdict and device-failure exceptions."""
    inner = inst.verify_batch
    calls = [0]

    if name == "half-batch":
        def verify_batch(msgs, pubs, sigs):
            h = max(1, len(msgs) // 2)
            return inner(msgs[:h], pubs[:h], sigs[:h])
    elif name == "altered-verdict":
        def verify_batch(msgs, pubs, sigs):
            calls[0] += 1
            try:
                inner(msgs, pubs, sigs)
            except crypto_error:
                if calls[0] % 8 == 1:
                    return None
                raise
            if calls[0] % 8 == 1:
                raise crypto_error("verdict turned over")
    elif name == "unchanged":
        def verify_batch(msgs, pubs, sigs):
            return None
    elif name == "unavailable":
        def verify_batch(msgs, pubs, sigs):
            calls[0] += 1
            if calls[0] % 8 == 1:
                raise unavailable_error("device verification failed")
            return inner(msgs, pubs, sigs)
    else:
        raise ValueError(f"unknown fault {name!r}")
    inst.verify_batch = verify_batch
