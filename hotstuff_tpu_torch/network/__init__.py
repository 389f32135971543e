"""Network layer: framed TCP actors.

Port copy of ``hotstuff_tpu/network/__init__.py``: the asyncio transport
only (the reference's ``HOTSTUFF_NET=native`` C++ engine stays there), with
the same frames and ACK behaviour as the reference network crate
(``network/src/lib.rs:11-13``):

- ``Receiver`` + ``MessageHandler``: accept loop, one runner per connection,
  4-byte big-endian length-delimited frames, handler may write replies/ACKs
  on the same socket (reference ``network/src/receiver.rs:20-88``).
- ``SimpleSender``: best-effort, one connection task per peer, no retry
  (reference ``network/src/simple_sender.rs:22-143``).
- ``ReliableSender``: at-least-once with per-message ``CancelHandler``
  resolved by the peer's ACK; exponential-backoff reconnect with replay of
  un-ACKed messages (reference ``network/src/reliable_sender.rs:140-247``).
"""

from .receiver import FramedWriter, MessageHandler, Receiver, read_frame, write_frame
from .reliable_sender import CancelHandler, ReliableSender
from .simple_sender import SimpleSender

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
