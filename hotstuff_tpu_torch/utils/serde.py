"""Deterministic binary wire codec.

Port copy of ``hotstuff_tpu/utils/serde.py``, byte for byte the same
format, so a frame that one package encodes decodes in the other:

- integers: fixed-width little-endian (``u8``/``u32``/``u64``)
- byte strings: ``u32`` length prefix + raw bytes
- sequences: ``u32`` count prefix + elements
- enums: ``u8`` tag + variant payload
- options: ``u8`` 0/1 + payload

Encodings are canonical (one byte string per value): signatures cover
SHA-512 digests of serialized content, and the certificate caches key on
the encoding.
"""

from __future__ import annotations

import struct


class SerdeError(Exception):
    """Raised on malformed input from the wire."""


_U8 = struct.Struct("<B")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")

# Upper bound on any length prefix we will allocate for; guards against
# memory exhaustion from malformed or byzantine frames.
MAX_LEN = 64 * 1024 * 1024


class Encoder:
    __slots__ = ("_parts",)

    def __init__(self) -> None:
        self._parts: list[bytes] = []

    def u8(self, v: int) -> "Encoder":
        self._parts.append(_U8.pack(v))
        return self

    def u32(self, v: int) -> "Encoder":
        self._parts.append(_U32.pack(v))
        return self

    def u64(self, v: int) -> "Encoder":
        self._parts.append(_U64.pack(v))
        return self

    def raw(self, b: bytes) -> "Encoder":
        """Fixed-size field: no length prefix (e.g. 32-byte digests)."""
        self._parts.append(b)
        return self

    def bytes(self, b: bytes) -> "Encoder":
        self._parts.append(_U32.pack(len(b)))
        self._parts.append(b)
        return self

    def seq(self, items, write_item) -> "Encoder":
        self._parts.append(_U32.pack(len(items)))
        for it in items:
            write_item(self, it)
        return self

    def option(self, value, write_value) -> "Encoder":
        if value is None:
            self._parts.append(b"\x00")
        else:
            self._parts.append(b"\x01")
            write_value(self, value)
        return self

    def finish(self) -> bytes:
        return b"".join(self._parts)


class Decoder:
    __slots__ = ("_buf", "_pos")

    def __init__(self, buf: bytes) -> None:
        self._buf = buf
        self._pos = 0

    def _take(self, n: int) -> bytes:
        if n < 0 or self._pos + n > len(self._buf):
            raise SerdeError(f"short read: need {n} bytes at offset {self._pos}")
        out = self._buf[self._pos : self._pos + n]
        self._pos += n
        return out

    def u8(self) -> int:
        return _U8.unpack(self._take(1))[0]

    def u32(self) -> int:
        return _U32.unpack(self._take(4))[0]

    def u64(self) -> int:
        return _U64.unpack(self._take(8))[0]

    def raw(self, n: int) -> bytes:
        return self._take(n)

    def bytes(self) -> bytes:
        n = self.u32()
        if n > MAX_LEN:
            raise SerdeError(f"length prefix {n} exceeds MAX_LEN")
        return self._take(n)

    def seq(self, read_item) -> list:
        n = self.u32()
        if n > MAX_LEN:
            raise SerdeError(f"sequence count {n} exceeds MAX_LEN")
        return [read_item(self) for _ in range(n)]

    def option(self, read_value):
        tag = self.u8()
        if tag == 0:
            return None
        if tag == 1:
            return read_value(self)
        raise SerdeError(f"bad option tag {tag}")

    def finish(self) -> None:
        """Assert the whole buffer was consumed (canonical encodings only)."""
        if self._pos != len(self._buf):
            raise SerdeError(f"trailing garbage: {len(self._buf) - self._pos} bytes unread")
