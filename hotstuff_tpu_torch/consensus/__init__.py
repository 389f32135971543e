"""Consensus layer of the port: the 2-chain HotStuff engine of
``hotstuff_tpu/consensus`` (core, proposer, synchronizer, helper, leader
election, the crypto bridge and the ``Consensus`` root), its committee and
messages with their wire codec, aggregation, the certificate caches, the
shared decode arena, and state sync with log compaction."""

from .aggregator import Aggregator, QCMaker, TCMaker
from .config import Authority, Committee, Parameters
from .consensus import Consensus
from .messages import QC, TC, Block, CertificateCache, SeatTable, Timeout, Vote

__all__ = [
    "Aggregator",
    "Authority",
    "Block",
    "CertificateCache",
    "Committee",
    "Consensus",
    "Parameters",
    "QC",
    "QCMaker",
    "SeatTable",
    "TC",
    "TCMaker",
    "Timeout",
    "Vote",
]
