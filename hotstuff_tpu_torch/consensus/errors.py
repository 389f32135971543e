"""Consensus error types (reference ``consensus/src/error.rs:25-65``).

Port copy of ``hotstuff_tpu/consensus/errors.py``."""

from __future__ import annotations


class ConsensusError(Exception):
    pass


class WrongLeader(ConsensusError):
    pass


class UnknownAuthority(ConsensusError):
    pass


class AuthorityReuse(ConsensusError):
    pass


class QCRequiresQuorum(ConsensusError):
    pass


class TCRequiresQuorum(ConsensusError):
    pass


class InvalidSignature(ConsensusError):
    pass


class MalformedMessage(ConsensusError):
    pass
