"""Batched SHA-512 on the card, one message a lane.

Port of ``hotstuff_tpu/ops/sha512.py``. The reference is jnp under
``jax.jit`` (``_compiled``, ``_compress``), no Pallas kernel: 64-bit words
as (hi, lo) uint32 pairs, the blocks and rounds as ``lax.scan``s, and
messages of one length only (``_pad_messages`` asserts it, so the mempool
processor's drains of batches of mixed lengths go to ``hashlib``). The
port's kernel, ``csrc/sha512.cu``, works on native uint64 and takes a
length a lane: it pads each lane itself, so a drain of mixed lengths
hashes in one launch, with the same digests.

The layout of a call: the drain packed into one byte buffer, led by an
int64 offset and an int64 length a lane, each message starting on an
8-byte boundary (the kernel's aligned loads). For the card the buffer is
pinned and goes over in one copy; one launch; n x 64 bytes come back.

``sha512_plain`` follows the kernel step by step on int64 tensors (the
same padding, schedule and rounds; right shifts masked, since ``>>`` on
int64 carries the sign; additions wrap). The wrapper ``sha512`` takes it
only for a tensor on the CPU. ``LAUNCHES["sha512"]`` counts the kernel's
launches; only the wrapper adds to it, where it launches.

Protocol fit (reference ``crypto/src/lib.rs``, ``mempool/src/processor.rs``):
protocol digests are SHA-512 truncated to 32 bytes (``sha512_32_batch``).
"""

from __future__ import annotations

import numpy as np
import torch

from hotstuff_tpu_torch.utils.device import resolve

LAUNCHES = {"sha512": 0}

BLOCK_BYTES = 128

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


def pack(msgs: list[bytes], pin: bool = False) -> torch.Tensor:
    """The drain as one uint8 buffer: int64 offsets [n], int64 lengths
    [n], then the messages, each starting on an 8-byte boundary (offsets
    count from the first message byte)."""
    n = len(msgs)
    lengths = np.fromiter((len(m) for m in msgs), dtype=np.int64, count=n)
    spans = (lengths + 7) & ~7
    offsets = np.zeros(n, dtype=np.int64)
    np.cumsum(spans[:-1], out=offsets[1:])
    head = 16 * n
    total = head + int(spans.sum()) + 8  # never empty, whatever the lengths
    buf = torch.empty(total, dtype=torch.uint8, pin_memory=pin)
    view = buf.numpy()
    view[:head] = np.concatenate([offsets, lengths]).view(np.uint8)
    view[head:] = 0
    for off, m in zip(offsets.tolist(), msgs):
        view[head + off : head + off + len(m)] = np.frombuffer(m, dtype=np.uint8)
    return buf


def unpack(buf: torch.Tensor, n: int):
    """(data, offsets, lengths) views of a packed buffer, on its device."""
    head = buf[: 16 * n].view(torch.int64)
    return buf[16 * n :], head[:n], head[n:]


# -- the plain version ---------------------------------------------------------


def _shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int64 words (``>>`` carries the sign)."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return _shr(x, n) | (x << (64 - n))


def _padded_words(data, offsets, lengths, blk: int) -> list[torch.Tensor]:
    """The 16 words of block ``blk`` of every lane's padded message, as
    ``padded_word`` and the length field of the kernel make them."""
    pos = blk * BLOCK_BYTES + torch.arange(BLOCK_BYTES, device=data.device)
    q = pos[None, :].expand(lengths.shape[0], -1)
    inside = q < lengths[:, None]
    index = (offsets[:, None] + q).clamp(max=max(data.shape[0] - 1, 0))
    byte = torch.where(inside, data[index].long(), torch.zeros_like(q))
    byte = torch.where(q == lengths[:, None], torch.full_like(q, 0x80), byte)
    byte = byte.view(-1, 16, 8)
    words = torch.zeros(byte.shape[:2], dtype=torch.int64, device=data.device)
    for i in range(8):
        words = (words << 8) | byte[:, :, i]
    w = list(words.unbind(1))
    last = blocks_of(lengths) - 1 == blk
    w[14] = torch.where(last, _shr(lengths, 61), w[14])
    w[15] = torch.where(last, lengths << 3, w[15])
    return w


def _compress(s: list[torch.Tensor], w: list[torch.Tensor]) -> list[torch.Tensor]:
    a, b, c, d, e, f, g, h = s
    w = list(w)
    for t in range(80):
        if t < 16:
            wt = w[t]
        else:
            w15, w2 = w[(t - 15) & 15], w[(t - 2) & 15]
            s0 = _rotr(w15, 1) ^ _rotr(w15, 8) ^ _shr(w15, 7)
            s1 = _rotr(w2, 19) ^ _rotr(w2, 61) ^ _shr(w2, 6)
            wt = w[t & 15] + s0 + w[(t - 7) & 15] + s1
            w[t & 15] = wt
        big_s1 = _rotr(e, 14) ^ _rotr(e, 18) ^ _rotr(e, 41)
        ch = (e & f) ^ (~e & g)
        t1 = h + big_s1 + ch + _K[t] + wt
        big_s0 = _rotr(a, 28) ^ _rotr(a, 34) ^ _rotr(a, 39)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e, d, c, b, a = g, f, e, d + t1, c, b, a, t1 + big_s0 + maj
    return [x + y for x, y in zip(s, (a, b, c, d, e, f, g, h))]


def sha512_plain(data: torch.Tensor, offsets: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """The kernel's function on tensors of any device: uint8 [n, 64]
    digests of the lanes (``data`` uint8, ``offsets``/``lengths`` int64
    [n]). A lane stops at its own last block, as the kernel's loop does."""
    n = lengths.shape[0]
    s = [torch.full((n,), h, dtype=torch.int64, device=data.device) for h in _H]
    nb = blocks_of(lengths)
    for blk in range(int(nb.max()) if n else 0):
        new = _compress(s, _padded_words(data, offsets, lengths, blk))
        live = nb > blk
        s = [torch.where(live, x, y) for x, y in zip(new, s)]
    words = torch.stack(s, dim=1)  # [n, 8]
    shifts = torch.arange(56, -8, -8, device=data.device)
    return ((words[:, :, None] >> shifts) & 0xFF).to(torch.uint8).reshape(n, 64)


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
        if t.device.type != "cuda" or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"sha512 {what}: expected a contiguous CUDA {dtype} tensor")
    if offsets.shape != (n,):
        raise ValueError(f"sha512: {tuple(offsets.shape)} offsets for {n} lengths")
    out = torch.empty((n, 64), dtype=torch.uint8, device=data.device)
    from hotstuff_tpu_torch.utils.kernel_build import kernel

    stream = torch.cuda.current_stream(data.device).cuda_stream
    rc = kernel("sha512", "sha512_launch")(
        data.data_ptr(), offsets.data_ptr(), lengths.data_ptr(), n, out.data_ptr(), stream
    )
    if rc != 0:
        raise RuntimeError(f"sha512_launch failed: cudaError {rc}")
    LAUNCHES["sha512"] += 1
    return out


def sha512_batch(msgs: list[bytes], device="cuda") -> list[bytes]:
    """SHA-512 of every message, of any lengths, in one launch."""
    dev = resolve(device)
    n = len(msgs)
    if n == 0:
        return []
    buf = pack(msgs, pin=dev.type == "cuda")
    if dev.type == "cuda":
        buf = buf.to(dev, non_blocking=True)
    out = sha512(*unpack(buf, n))
    # ``.cpu()`` waits for the stream the copy and the kernel ran on.
    return [bytes(row) for row in out.cpu().numpy()]


def sha512_32_batch(msgs: list[bytes], device="cuda") -> list[bytes]:
    """Protocol digests: SHA-512 truncated to 32 bytes."""
    return [d[:32] for d in sha512_batch(msgs, device)]
