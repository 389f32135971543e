"""The port's batched SHA-512 (``hotstuff_tpu_torch/ops/sha512.py``) against
the JAX package's ``sha512_batch`` and ``hashlib``.

On the CPU the wrapper runs the kernel's plain version, which pads each
lane itself and walks the same rounds on int64 tensors. It is held, byte
for byte, against:

- the JAX ``sha512_batch`` (interpreted on the CPU, as
  ``tests/test_sha512_device.py`` runs it, at that file's lengths; the
  reference takes messages of one length only, so each length is its own
  call there) and ``hashlib``;
- ``hashlib`` on drains of mixed lengths in one call, at every padding
  boundary (111/112 bytes: the length field spills into a second block;
  0: the empty lane still makes one block);
- the 32-byte truncation and the 96-byte challenge input ``R || A || M``.

The kernel itself is held against the plain version and ``hashlib`` on
the card by ``tests/test_torch_kernels.py`` (which imports no JAX) and
``chip_smoke.py`` phase 10. Tolerance: byte-exact.
"""

import hashlib
import random

import pytest
import torch

from hotstuff_tpu.ops import sha512 as j_sha512
from hotstuff_tpu_torch.ops import sha512 as t_sha512

LENGTHS = [0, 1, 32, 96, 111, 112, 127, 128, 300]
BOUNDARIES = [0, 1, 7, 8, 9, 111, 112, 113, 127, 128, 129, 239, 240, 255, 256, 300]


def messages(lengths, seed, copies=4):
    rng = random.Random(seed)
    return [rng.randbytes(n) for n in lengths for _ in range(copies)]


@pytest.mark.parametrize("length", LENGTHS)
def test_plain_matches_the_jax_sha512_and_hashlib(length):
    msgs = messages([length], seed=length)
    port = t_sha512.sha512_batch(msgs, device="cpu")
    assert port == j_sha512.sha512_batch(msgs)
    assert port == [hashlib.sha512(m).digest() for m in msgs]


@pytest.mark.parametrize("seed", [0, 1])
def test_mixed_lengths_in_one_call(seed):
    rng = random.Random(seed)
    msgs = messages(BOUNDARIES, seed, copies=1) + [rng.randbytes(rng.randrange(0, 700))
                                                   for _ in range(24)]
    rng.shuffle(msgs)
    assert t_sha512.sha512_batch(msgs, device="cpu") == [hashlib.sha512(m).digest() for m in msgs]


def test_protocol_digest_truncation():
    msgs = [b"batch-bytes" * 10] * 3 + [b"", b"x" * 200]
    got = t_sha512.sha512_32_batch(msgs, device="cpu")
    assert got == [hashlib.sha512(m).digest()[:32] for m in msgs]
    assert got[:3] == j_sha512.sha512_32_batch(msgs[:3])


def test_challenge_hash_shape():
    """The verifier's h = SHA512(R || A || M) input is 96 bytes: one block."""
    msgs = messages([96], seed=99, copies=8)
    assert t_sha512.blocks_of(96) == 1
    assert t_sha512.sha512_batch(msgs, device="cpu") == [hashlib.sha512(m).digest() for m in msgs]


@pytest.mark.parametrize("length, blocks", [(0, 1), (110, 1), (111, 1), (112, 2), (239, 2),
                                            (240, 3), (15000, 118)])
def test_block_count(length, blocks):
    assert t_sha512.blocks_of(length) == blocks
    assert int(t_sha512.blocks_of(torch.tensor([length]))[0]) == blocks


def test_pack_aligns_every_lane_and_counts_no_launch():
    msgs = [b"a" * 3, b"", b"b" * 9, b"c" * 16]
    buf = t_sha512.pack(msgs)
    data, offsets, lengths = t_sha512.unpack(buf, len(msgs))
    assert offsets.tolist() == [0, 8, 8, 24] and lengths.tolist() == [3, 0, 9, 16]
    for off, m in zip(offsets.tolist(), msgs):
        assert bytes(data[off : off + len(m)].numpy()) == m
    before = t_sha512.LAUNCHES["sha512"]
    t_sha512.sha512(data, offsets, lengths)  # CPU tensors: the plain version
    assert t_sha512.LAUNCHES["sha512"] == before


def test_the_card_is_the_default_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_sha512.sha512_batch([b"m"])

