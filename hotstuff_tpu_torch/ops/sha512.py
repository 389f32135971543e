"""Batched SHA-512 on the card, 32 messages a CTA.

Port of ``hotstuff_tpu/ops/sha512.py``. The reference is jnp under
``jax.jit`` (``_compiled``, ``_compress``), no Pallas kernel: 64-bit words
as (hi, lo) uint32 pairs, the schedule (``extend``) and the rounds
(``round_step``) as ``lax.scan``s, and messages of one length only
(``_pad_messages`` asserts it, so the mempool processor's drains of batches
of mixed lengths go to ``hashlib``). The port's kernel, ``csrc/sha512.cu``,
works on native uint64 and takes a length a lane: it pads each lane itself,
so a drain of mixed lengths hashes in one launch, with the same digests.
Its producer warps compute the schedule, ``KW[t] = K[t] + W[t]``, into a
ring in shared memory, and one warp runs the 80-round chain of 32 messages
over it.

The layout of a call: the drain packed into one byte buffer, led by an
int64 offset and an int64 length a lane, each message starting on a
16-byte boundary (the kernel's vector loads), zeros between, and a tail of
``TAIL_BYTES`` zeros. ``sha512_batch`` packs into a grow-only staging
buffer of the device (pinned for a card), which goes over in one copy; one
launch; n x 64 bytes come back into a second pinned buffer. A lock of the
device's ``Staging`` is held from the pack to the read-back, so a buffer
is never rewritten while a copy from or into it runs (the mempool's two
processors hash from worker threads).

The plain version is split the way the kernel is: ``schedule_plain`` gives
the padded blocks' ``KW`` (the producers' work), ``rounds_plain`` the 80
rounds and the feed-forward over it (the chain's, with ``h + KW[t]`` and
``d + h + KW[t]`` formed a round ahead), and ``sha512_plain`` is their
composition over a window of blocks at a time (the ring's stage), on
int64 tensors (right shifts masked, since ``>>`` on int64
carries the sign; additions wrap). The wrapper ``sha512`` takes it only
for a tensor on the CPU. ``LAUNCHES["sha512"]`` counts the kernel's
launches; only the wrapper adds to it, where it launches.

Protocol fit (reference ``crypto/src/lib.rs``, ``mempool/src/processor.rs``):
protocol digests are SHA-512 truncated to 32 bytes (``sha512_32_batch``).
"""

from __future__ import annotations

import itertools
import threading

import numpy as np
import torch

from hotstuff_tpu_torch.utils.device import resolve

LAUNCHES = {"sha512": 0}

BLOCK_BYTES = 128
ROUNDS = 80
# Each lane starts on this boundary; the buffer ends with this many zeros,
# so it is never empty.
ALIGN = 16
TAIL_BYTES = 16
_PADS = tuple(bytes(i) for i in range(ALIGN))
# ``pack_into`` joins the messages of a drain of fewer bytes, and copies
# them one by one from there on: a join costs a second copy of the bytes,
# a copy a message two slice assignments. ``utils/kernel_times.py`` times
# the pack by each route at phase 10b's drains (its ``pack by join`` and
# ``pack by copy`` rows), the readings this threshold is chosen from.
JOIN_BELOW = 2 << 20
# Blocks of ``KW`` the plain version holds at once, as the kernel's stage.
PLAIN_WINDOW = 3

_K64 = [
    0x428A2F98D728AE22, 0x7137449123EF65CD, 0xB5C0FBCFEC4D3B2F, 0xE9B5DBA58189DBBC,
    0x3956C25BF348B538, 0x59F111F1B605D019, 0x923F82A4AF194F9B, 0xAB1C5ED5DA6D8118,
    0xD807AA98A3030242, 0x12835B0145706FBE, 0x243185BE4EE4B28C, 0x550C7DC3D5FFB4E2,
    0x72BE5D74F27B896F, 0x80DEB1FE3B1696B1, 0x9BDC06A725C71235, 0xC19BF174CF692694,
    0xE49B69C19EF14AD2, 0xEFBE4786384F25E3, 0x0FC19DC68B8CD5B5, 0x240CA1CC77AC9C65,
    0x2DE92C6F592B0275, 0x4A7484AA6EA6E483, 0x5CB0A9DCBD41FBD4, 0x76F988DA831153B5,
    0x983E5152EE66DFAB, 0xA831C66D2DB43210, 0xB00327C898FB213F, 0xBF597FC7BEEF0EE4,
    0xC6E00BF33DA88FC2, 0xD5A79147930AA725, 0x06CA6351E003826F, 0x142929670A0E6E70,
    0x27B70A8546D22FFC, 0x2E1B21385C26C926, 0x4D2C6DFC5AC42AED, 0x53380D139D95B3DF,
    0x650A73548BAF63DE, 0x766A0ABB3C77B2A8, 0x81C2C92E47EDAEE6, 0x92722C851482353B,
    0xA2BFE8A14CF10364, 0xA81A664BBC423001, 0xC24B8B70D0F89791, 0xC76C51A30654BE30,
    0xD192E819D6EF5218, 0xD69906245565A910, 0xF40E35855771202A, 0x106AA07032BBD1B8,
    0x19A4C116B8D2D0C8, 0x1E376C085141AB53, 0x2748774CDF8EEB99, 0x34B0BCB5E19B48A8,
    0x391C0CB3C5C95A63, 0x4ED8AA4AE3418ACB, 0x5B9CCA4F7763E373, 0x682E6FF3D6B2B8A3,
    0x748F82EE5DEFB2FC, 0x78A5636F43172F60, 0x84C87814A1F0AB72, 0x8CC702081A6439EC,
    0x90BEFFFA23631E28, 0xA4506CEBDE82BDE9, 0xBEF9A3F7B2C67915, 0xC67178F2E372532B,
    0xCA273ECEEA26619C, 0xD186B8C721C0C207, 0xEADA7DD6CDE0EB1E, 0xF57D4F7FEE6ED178,
    0x06F067AA72176FBA, 0x0A637DC5A2C898A6, 0x113F9804BEF90DAE, 0x1B710B35131C471B,
    0x28DB77F523047D84, 0x32CAAB7B40C72493, 0x3C9EBE0A15C9BEBC, 0x431D67C49C100D4C,
    0x4CC5D4BECB3E42B6, 0x597F299CFC657E2A, 0x5FCB6FAB3AD6FAEC, 0x6C44198C4A475817,
]
_H0 = [
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B, 0xA54FF53A5F1D36F1,
    0x510E527FADE682D1, 0x9B05688C2B3E6C1F, 0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
]


def _signed(x: int) -> int:
    """A 64-bit word as the int64 with the same bits."""
    return x - (1 << 64) if x >= 1 << 63 else x


_K = [_signed(k) for k in _K64]
_H = [_signed(h) for h in _H0]


def blocks_of(length):
    """128-byte blocks of a padded message of ``length`` bytes (one for
    the empty message; an extra one when ``length % 128 >= 112``), for an
    int or an int64 tensor of lengths."""
    return (length + 17 + BLOCK_BYTES - 1) // BLOCK_BYTES


def layout(msgs) -> tuple[np.ndarray, np.ndarray, int]:
    """(offsets, lengths, total bytes) of the packed drain: each message on
    an ``ALIGN``-byte boundary, offsets counted from the first message
    byte, after a head of 16 bytes a lane."""
    n = len(msgs)
    lengths = np.fromiter((len(m) for m in msgs), dtype=np.int64, count=n)
    spans = (lengths + ALIGN - 1) & -ALIGN
    offsets = np.zeros(n, dtype=np.int64)
    np.cumsum(spans[:-1], out=offsets[1:])
    return offsets, lengths, 16 * n + int(spans.sum()) + TAIL_BYTES


def pack_into(view: np.ndarray, msgs, offsets: np.ndarray, lengths: np.ndarray) -> None:
    """Write the packed drain into the uint8 array ``view`` (at least
    ``layout``'s total): the head, the messages with their zero padding,
    and the zero tail. Nothing else of ``view`` is written. A small drain
    goes in one join and one copy; from ``JOIN_BELOW`` bytes on, each
    message is copied straight into ``view``, since a join would copy the
    bytes twice."""
    n = len(msgs)
    head = 16 * n
    view[:head] = np.concatenate([offsets, lengths]).view(np.uint8)
    spans = (lengths + ALIGN - 1) & -ALIGN
    end = head + int(offsets[-1] + spans[-1]) if n else head
    if int(lengths.sum()) >= JOIN_BELOW:
        for off, m, span in zip((head + offsets).tolist(), msgs, spans.tolist()):
            view[off : off + len(m)] = np.frombuffer(m, dtype=np.uint8)
            view[off + len(m) : off + span] = 0
    else:
        pads = map(_PADS.__getitem__, ((-lengths) & (ALIGN - 1)).tolist())
        view[head:end] = np.frombuffer(b"".join(itertools.chain.from_iterable(zip(msgs, pads))),
                                       dtype=np.uint8)
    view[end : end + TAIL_BYTES] = 0


def pack(msgs: list[bytes], pin: bool = False) -> torch.Tensor:
    """The drain as a fresh uint8 buffer (see ``layout``)."""
    offsets, lengths, total = layout(msgs)
    buf = torch.empty(total, dtype=torch.uint8, pin_memory=pin)
    pack_into(buf.numpy(), msgs, offsets, lengths)
    return buf


def unpack(buf: torch.Tensor, n: int):
    """(data, offsets, lengths) views of a packed buffer, on its device."""
    head = buf[: 16 * n].view(torch.int64)
    return buf[16 * n :], head[:n], head[n:]


class Staging:
    """Grow-only host buffers of one device for ``sha512_batch``: the packed
    drain and the digests read back, pinned for a card. A call holds
    ``lock`` from its pack to its read-back."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.lock = threading.Lock()
        self._packed: torch.Tensor | None = None
        self._digests: torch.Tensor | None = None

    def _grown(self, buf: torch.Tensor | None, nbytes: int) -> torch.Tensor:
        if buf is not None and buf.numel() >= nbytes:
            return buf
        size = 1 << (nbytes - 1).bit_length()
        return torch.empty(size, dtype=torch.uint8, pin_memory=self.dev.type == "cuda")

    def pack(self, msgs) -> torch.Tensor:
        """The drain packed into the staging buffer (a view of it)."""
        offsets, lengths, total = layout(msgs)
        self._packed = self._grown(self._packed, total)
        pack_into(self._packed.numpy(), msgs, offsets, lengths)
        return self._packed[:total]

    def read_back(self, out: torch.Tensor) -> torch.Tensor:
        """The digests ``out`` [n, 64] on the host, flat: from a card
        through the pinned buffer, after the stream has finished."""
        if out.device.type == "cpu":
            return out.reshape(-1)
        self._digests = self._grown(self._digests, out.numel())
        host = self._digests[: out.numel()]
        host.copy_(out.reshape(-1), non_blocking=True)
        torch.cuda.current_stream(out.device).synchronize()
        return host


_STAGING: dict[torch.device, Staging] = {}
_STAGING_LOCK = threading.Lock()


def staging(dev: torch.device) -> Staging:
    """The device's ``Staging``, made at first use."""
    with _STAGING_LOCK:
        if dev not in _STAGING:
            _STAGING[dev] = Staging(dev)
        return _STAGING[dev]


def split(digests: torch.Tensor, n: int, size: int = 64) -> list[bytes]:
    """The first ``size`` bytes of each of the n digests in a flat host
    buffer, as ``bytes``."""
    raw = digests[: 64 * n].numpy().tobytes()
    return [raw[i : i + size] for i in range(0, 64 * n, 64)]


# -- the plain version ---------------------------------------------------------


def _shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int64 words (``>>`` carries the sign)."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return _shr(x, n) | (x << (64 - n))


def schedule_plain(data: torch.Tensor, offsets: torch.Tensor, lengths: torch.Tensor,
                   first: int = 0, count: int | None = None) -> torch.Tensor:
    """The producers' work: ``KW[t] = K[t] + W[t]`` of the padded blocks
    ``first`` to ``first + count - 1`` of every lane, int64 [n, count, 80];
    by default every block up to the most of any lane (a lane's blocks past
    its own end hold the schedule of zero words). The padding as the
    kernel's ``load_block``: 0x80 after the message, zeros, the 128-bit
    bit length in words 14 and 15 of the lane's last block."""
    n, dev = lengths.shape[0], data.device
    nb = blocks_of(lengths)
    if count is None:
        count = (int(nb.max()) if n else 0) - first
    q = torch.arange(first * BLOCK_BYTES, (first + count) * BLOCK_BYTES, device=dev)
    q = q[None, :].expand(n, -1)
    src = data if data.numel() else torch.zeros(1, dtype=torch.uint8, device=dev)
    index = (offsets[:, None] + q).clamp(0, src.numel() - 1)
    byte = torch.where(q < lengths[:, None], src[index].long(), torch.zeros_like(q))
    byte = torch.where(q == lengths[:, None], torch.full_like(q, 0x80), byte)
    byte = byte.view(n, count, 16, 8)
    words = torch.zeros((n, count, 16), dtype=torch.int64, device=dev)
    for i in range(8):
        words = (words << 8) | byte[..., i]
    last = nb - 1 - first
    mine = (last >= 0) & (last < count)
    rows, last = torch.arange(n, device=dev)[mine], last[mine]
    words[rows, last, 14] = _shr(lengths[mine], 61)
    words[rows, last, 15] = lengths[mine] << 3
    w = list(words.unbind(2))
    for t in range(16, ROUNDS):
        s0 = _rotr(w[t - 15], 1) ^ _rotr(w[t - 15], 8) ^ _shr(w[t - 15], 7)
        s1 = _rotr(w[t - 2], 19) ^ _rotr(w[t - 2], 61) ^ _shr(w[t - 2], 6)
        w.append(w[t - 16] + s0 + w[t - 7] + s1)
    return torch.stack([wt + k for wt, k in zip(w, _K)], dim=2)


def _compress(s: list[torch.Tensor], kw: list[torch.Tensor]) -> list[torch.Tensor]:
    """One block's rounds as the kernel's ``compress``: ``hk = h + KW[t]``
    and ``dhk = d + hk`` formed a round ahead, then the feed-forward."""
    a, b, c, d, e, f, g, h = s
    hk = h + kw[0]
    dhk = d + hk
    for t in range(ROUNDS):
        s1 = _rotr(e, 14) ^ _rotr(e, 18) ^ _rotr(e, 41)
        ch = g ^ (e & (f ^ g))
        t1 = hk + s1 + ch
        new_e = dhk + s1 + ch
        new_a = t1 + (_rotr(a, 28) ^ _rotr(a, 34) ^ _rotr(a, 39)) + ((a & b) | (c & (a | b)))
        if t + 1 < ROUNDS:
            hk = g + kw[t + 1]
            dhk = c + hk
        h, g, f, e, d, c, b, a = g, f, e, new_e, c, b, a, new_a
    return [x + y for x, y in zip(s, (a, b, c, d, e, f, g, h))]


def rounds_plain(kw: torch.Tensor, blocks: torch.Tensor, state: torch.Tensor | None = None,
                 first: int = 0) -> torch.Tensor:
    """The chain's work: the state, int64 [n, 8], after the rounds over
    ``kw`` [n, B, 80] (as ``schedule_plain`` gives it) of blocks ``first``
    to ``first + B - 1``, from ``state`` (by default the initial hash
    value); a lane stops at its own ``blocks``."""
    n, dev = kw.shape[0], kw.device
    if state is None:
        state = torch.tensor(_H, dtype=torch.int64, device=dev).repeat(n, 1)
    s = list(state.unbind(1))
    for j in range(kw.shape[1]):
        new = _compress(s, list(kw[:, j].unbind(1)))
        live = blocks > first + j
        s = [torch.where(live, x, y) for x, y in zip(new, s)]
    return torch.stack(s, dim=1)


def digest_bytes(state: torch.Tensor) -> torch.Tensor:
    """uint8 [n, 64]: the state's eight words big-endian."""
    shifts = torch.arange(56, -8, -8, device=state.device)
    return ((state[:, :, None] >> shifts) & 0xFF).to(torch.uint8).reshape(-1, 64)


def sha512_plain(data: torch.Tensor, offsets: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """The kernel's function on tensors of any device: uint8 [n, 64]
    digests of the lanes (``data`` uint8, ``offsets``/``lengths`` int64
    [n]), the rounds over the schedule, ``PLAIN_WINDOW`` blocks at a time,
    so its memory does not grow with the longest lane."""
    n = lengths.shape[0]
    blocks = blocks_of(lengths)
    most = int(blocks.max()) if n else 0
    state = torch.tensor(_H, dtype=torch.int64, device=data.device).repeat(n, 1)
    for first in range(0, most, PLAIN_WINDOW):
        kw = schedule_plain(data, offsets, lengths, first, min(PLAIN_WINDOW, most - first))
        state = rounds_plain(kw, blocks, state, first)
    return digest_bytes(state)


# -- the kernel ----------------------------------------------------------------


def sha512(data: torch.Tensor, offsets: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """uint8 [n, 64] digests of a packed drain (see ``unpack``): the
    kernel for CUDA tensors, ``sha512_plain`` for CPU ones."""
    if data.device.type == "cpu":
        return sha512_plain(data, offsets, lengths)
    n = lengths.shape[0]
    if n < 1:
        raise ValueError("sha512: an empty drain")
    for t, dtype, what in ((data, torch.uint8, "data"), (offsets, torch.int64, "offsets"),
                           (lengths, torch.int64, "lengths")):
        if t.device != data.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"sha512 {what}: expected a contiguous {dtype} tensor on {data.device}")
    if offsets.shape != (n,):
        raise ValueError(f"sha512: {tuple(offsets.shape)} offsets for {n} lengths")
    out = torch.empty((n, 64), dtype=torch.uint8, device=data.device)
    from hotstuff_tpu_torch.utils.kernel_build import kernel

    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        rc = kernel("sha512", "sha512_launch")(
            data.data_ptr(), data.numel(), offsets.data_ptr(), lengths.data_ptr(), n,
            out.data_ptr(), stream
        )
    if rc != 0:
        raise RuntimeError(f"sha512_launch failed: cudaError {rc}")
    LAUNCHES["sha512"] += 1
    return out


# The steps of one ``digests`` call, in order.
STEPS = ("pack", "h2d", "kernel", "d2h", "bytes")


def digests(msgs: list[bytes], device="cuda", size: int = 64, mark=None) -> list[bytes]:
    """The first ``size`` bytes of each message's SHA-512, in one launch:
    the drain packed into the device's staging buffer, copied over, hashed,
    read back and split. ``mark``, where given, is called with each of
    ``STEPS`` as it ends, under the staging lock (``chip_smoke.py`` times
    the steps there)."""
    dev = resolve(device)
    n = len(msgs)
    if n == 0:
        return []
    mark = mark or (lambda step: None)
    stage = staging(dev)
    with stage.lock:
        host = stage.pack(msgs)
        mark("pack")
        buf = host.to(dev, non_blocking=True) if dev.type == "cuda" else host
        mark("h2d")
        out = sha512(*unpack(buf, n))
        mark("kernel")
        back = stage.read_back(out)
        mark("d2h")
        got = split(back, n, size)
        mark("bytes")
        return got


def sha512_batch(msgs: list[bytes], device="cuda") -> list[bytes]:
    """SHA-512 of every message, of any lengths, in one launch."""
    return digests(msgs, device, 64)


def sha512_32_batch(msgs: list[bytes], device="cuda") -> list[bytes]:
    """Protocol digests: SHA-512 truncated to 32 bytes."""
    return digests(msgs, device, 32)
