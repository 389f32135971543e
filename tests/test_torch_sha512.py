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

The plain version is split as the kernel is: ``schedule_plain`` (the
producer warps' ``K[t] + W[t]``) is held against a FIPS 180-4 schedule in
Python ints, and ``rounds_plain`` over it against ``hashlib`` and the JAX
``sha512_batch``; a window of the schedule is the slice of the whole, and
the state carried window to window gives ``hashlib``'s digests. The packed layout (16-byte lanes, zero padding, a zero
tail) and the reused staging buffers of ``sha512_batch`` (two drains in a
row, two threads at once; ``device="cpu"`` takes the same pack path) are
checked here too.

The kernel itself is held against the plain version and ``hashlib`` on
the card by ``tests/test_torch_kernels.py`` (which imports no JAX) and
``chip_smoke.py`` phase 10. Tolerance: byte-exact.
"""

import hashlib
import random
import sys
import threading

import numpy as np
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
    assert offsets.tolist() == [0, 16, 16, 32] and lengths.tolist() == [3, 0, 9, 16]
    for off, m in zip(offsets.tolist(), msgs):
        assert bytes(data[off : off + len(m)].numpy()) == m
    before = t_sha512.LAUNCHES["sha512"]
    t_sha512.sha512(data, offsets, lengths)  # CPU tensors: the plain version
    assert t_sha512.LAUNCHES["sha512"] == before


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("big", [False, True])
def test_pack_pads_with_zeros_and_ends_in_the_tail(seed, big):
    """Lanes on 16-byte boundaries, zeros between them, then the zero
    tail; the layout's total is the buffer's size. A small drain goes
    through the join, a big one is copied lane by lane: the same layout."""
    rng = random.Random(seed)
    msgs = [rng.randbytes(rng.randrange(0, 70)) for _ in range(rng.randrange(1, 12))]
    if big:
        msgs.insert(rng.randrange(len(msgs)), rng.randbytes(t_sha512.JOIN_BELOW + 3))
    offsets, lengths, total = t_sha512.layout(msgs)
    buf = t_sha512.pack(msgs).numpy()
    assert buf.shape == (total,)
    head = 16 * len(msgs)
    spans = [(len(m) + 15) // 16 * 16 for m in msgs]
    assert total == head + sum(spans) + t_sha512.TAIL_BYTES
    assert all(off % 16 == 0 for off in offsets.tolist())
    expect = b"".join(m + bytes(span - len(m)) for m, span in zip(msgs, spans))
    assert bytes(buf[head:]) == expect + bytes(t_sha512.TAIL_BYTES)


@pytest.mark.parametrize("msgs", [[b"x" * 5, b"y" * 40],
                                  [b"x" * 5000, b"", b"y" * (t_sha512.JOIN_BELOW + 1)]])
def test_pack_into_writes_nothing_past_the_drain(msgs):
    """Over a dirty buffer (a reused staging buffer): the pack writes
    every byte up to the layout's total, padding included, and nothing
    past it."""
    offsets, lengths, total = t_sha512.layout(msgs)
    view = np.full(total + 32, 0xEE, dtype=np.uint8)
    t_sha512.pack_into(view, msgs, offsets, lengths)
    assert bytes(view[:total]) == bytes(t_sha512.pack(msgs).numpy())
    assert (view[:total] != 0xEE).sum() == (view[:total] != 0xEE).size - sum(
        m.count(0xEE) for m in msgs)
    assert (view[total:] == 0xEE).all()


# -- the plain version, split as the kernel is ---------------------------------

M64 = (1 << 64) - 1


def fips_kw(msg: bytes) -> list[list[int]]:
    """FIPS 180-4 5.1.2 padding and 6.4.2 step 1 in Python ints: K[t] + W[t]
    of every block."""
    def rotr(x, n):
        return ((x >> n) | (x << (64 - n))) & M64

    bits = len(msg) * 8
    padded = msg + b"\x80" + bytes((111 - len(msg)) % 128) + bits.to_bytes(16, "big")
    assert len(padded) % 128 == 0
    out = []
    for i in range(0, len(padded), 128):
        w = [int.from_bytes(padded[i + 8 * j : i + 8 * j + 8], "big") for j in range(16)]
        for t in range(16, 80):
            s0 = rotr(w[t - 15], 1) ^ rotr(w[t - 15], 8) ^ (w[t - 15] >> 7)
            s1 = rotr(w[t - 2], 19) ^ rotr(w[t - 2], 61) ^ (w[t - 2] >> 6)
            w.append((w[t - 16] + s0 + w[t - 7] + s1) & M64)
        out.append([(k + wt) & M64 for k, wt in zip(t_sha512._K64, w)])
    return out


@pytest.mark.parametrize("length", BOUNDARIES + [15000])
def test_schedule_plain_matches_fips(length):
    """Every lane of a drain, its own blocks, against the Python-int
    schedule; the drain's other lanes are longer, so blocks past a lane's
    end exist and are left alone."""
    rng = random.Random(length)
    msgs = [rng.randbytes(length), rng.randbytes(length + 300), b""]
    buf = t_sha512.pack(msgs)
    kw = t_sha512.schedule_plain(*t_sha512.unpack(buf, len(msgs)))
    assert kw.dtype == torch.int64 and kw.shape == (3, t_sha512.blocks_of(length + 300), 80)
    for lane, m in enumerate(msgs):
        want = fips_kw(m)
        got = (kw[lane, : len(want)].numpy().astype(np.uint64)).tolist()
        assert got == want


@pytest.mark.parametrize("length", LENGTHS)
def test_rounds_over_the_schedule_match_hashlib_and_the_jax_sha512(length):
    msgs = messages([length], seed=1000 + length)
    data, offsets, lengths = t_sha512.unpack(t_sha512.pack(msgs), len(msgs))
    kw = t_sha512.schedule_plain(data, offsets, lengths)
    got = t_sha512.digest_bytes(t_sha512.rounds_plain(kw, t_sha512.blocks_of(lengths)))
    digests = [bytes(row) for row in got.numpy()]
    assert digests == [hashlib.sha512(m).digest() for m in msgs]
    assert digests == j_sha512.sha512_batch(msgs)


@pytest.mark.parametrize("first,count", [(0, 1), (0, 3), (1, 3), (2, 5), (6, 3), (8, 1)])
def test_schedule_window_is_a_slice_of_the_whole(first, count):
    """A window of blocks, as ``sha512_plain`` asks for it, is the same
    slice of the whole drain's schedule: a lane's last block (its length
    words) lands in the window that holds it, and only there."""
    rng = random.Random(first * 10 + count)
    msgs = [rng.randbytes(n) for n in (0, 111, 112, 300, 1000, 1135)]
    views = t_sha512.unpack(t_sha512.pack(msgs), len(msgs))
    whole = t_sha512.schedule_plain(*views)
    assert whole.shape[1] == 9
    assert torch.equal(t_sha512.schedule_plain(*views, first, count), whole[:, first : first + count])


@pytest.mark.parametrize("window", [1, 2, 3, 7])
def test_rounds_carried_across_windows_match_hashlib(monkeypatch, window):
    """The plain version's state carried from window to window, at window
    widths that do and do not divide the lanes' blocks."""
    monkeypatch.setattr(t_sha512, "PLAIN_WINDOW", window)
    rng = random.Random(window)
    msgs = [rng.randbytes(n) for n in (0, 17, 239, 240, 900, 2049)]
    got = t_sha512.sha512_plain(*t_sha512.unpack(t_sha512.pack(msgs), len(msgs)))
    assert [bytes(row) for row in got.numpy()] == [hashlib.sha512(m).digest() for m in msgs]


# -- the staging buffers of ``sha512_batch`` -----------------------------------


def test_staging_is_reused_across_drains():
    """Two calls in a row, a wide drain then a narrow one, each give
    hashlib's digests; the second packs into the first one's buffer,
    whose stale bytes past the drain do not leak in."""
    rng = random.Random(7)
    wide = [rng.randbytes(rng.randrange(0, 3000)) for _ in range(20)]
    narrow = [rng.randbytes(n) for n in (0, 111, 112)]
    assert t_sha512.sha512_batch(wide, device="cpu") == [hashlib.sha512(m).digest() for m in wide]
    stage = t_sha512.staging(torch.device("cpu"))
    first = stage.pack(wide).data_ptr()
    assert t_sha512.sha512_32_batch(narrow, device="cpu") == [
        hashlib.sha512(m).digest()[:32] for m in narrow]
    assert stage.pack(narrow).data_ptr() == first


def test_digests_marks_every_step_in_order():
    """The steps of one call, as ``chip_smoke.py`` times them, each named
    once and in order, and the call's result unchanged."""
    msgs = [b"abc", b"", bytes(200)]
    seen = []
    got = t_sha512.digests(msgs, device="cpu", size=32, mark=seen.append)
    assert seen == list(t_sha512.STEPS)
    assert got == [hashlib.sha512(m).digest()[:32] for m in msgs]
    assert got == t_sha512.sha512_32_batch(msgs, device="cpu")


def test_staging_serves_threads_at_once():
    """Eight threads share the one staging buffer of the device, with the
    interpreter switching threads as often as it can: every drain still
    gets hashlib's digests (a buffer rewritten under another call would
    not)."""
    rng = random.Random(8)
    drains = [[rng.randbytes(rng.randrange(0, 600)) for _ in range(rng.randrange(2, 9))]
              for _ in range(24)]
    results = [None] * len(drains)
    workers = 8
    barrier = threading.Barrier(workers)

    def worker(first):
        barrier.wait()
        for i in range(first, len(drains), workers):
            results[i] = t_sha512.sha512_32_batch(drains[i], device="cpu")

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(workers)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert results == [[hashlib.sha512(m).digest()[:32] for m in d] for d in drains]


def test_the_card_is_the_default_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_sha512.sha512_batch([b"m"])

