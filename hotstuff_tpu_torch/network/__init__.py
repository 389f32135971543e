"""Network layer: framed TCP actors.

Port copy of ``hotstuff_tpu/network/__init__.py``, with the same frames and
ACK behaviour as the reference network crate (``network/src/lib.rs:11-13``):

- ``Receiver`` + ``MessageHandler``: accept loop, one runner per connection,
  4-byte big-endian length-delimited frames, handler may write replies/ACKs
  on the same socket (reference ``network/src/receiver.rs:20-88``).
- ``SimpleSender``: best-effort, one connection task per peer, no retry
  (reference ``network/src/simple_sender.rs:22-143``).
- ``ReliableSender``: at-least-once with per-message ``CancelHandler``
  resolved by the peer's ACK; exponential-backoff reconnect with replay of
  un-ACKed messages (reference ``network/src/reliable_sender.rs:140-247``).

``HOTSTUFF_NET=native``, read at import, swaps all three for the C++ epoll
transport (``network/native/``): same APIs, same wire behaviour. One
departure: where the reference logs a warning and keeps asyncio when the
library cannot be built or loaded, the port raises (``KernelBuildError``
when g++ is missing or refuses the source), so the switch never falls
back silently.
"""

import os as _os

from .receiver import FramedWriter, MessageHandler, Receiver, read_frame, write_frame
from .reliable_sender import CancelHandler, ReliableSender
from .simple_sender import SimpleSender

if _os.environ.get("HOTSTUFF_NET", "").lower() == "native":
    from . import native as _native

    _native._load()
    Receiver = _native.NativeReceiver  # type: ignore[misc]
    SimpleSender = _native.NativeSimpleSender  # type: ignore[misc]
    ReliableSender = _native.NativeReliableSender  # type: ignore[misc]

__all__ = [
    "MessageHandler",
    "Receiver",
    "FramedWriter",
    "SimpleSender",
    "ReliableSender",
    "CancelHandler",
    "read_frame",
    "write_frame",
]
