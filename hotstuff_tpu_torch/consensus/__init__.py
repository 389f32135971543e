"""Consensus layer of the port: the certificate path of ``hotstuff_tpu/consensus``
(committee, messages and their wire codec, aggregation, the certificate
caches and the shared decode arena)."""

from .aggregator import Aggregator, QCMaker, TCMaker
from .config import Authority, Committee
from .messages import QC, TC, Block, CertificateCache, SeatTable, Timeout, Vote

__all__ = [
    "Aggregator",
    "Authority",
    "Block",
    "CertificateCache",
    "Committee",
    "QC",
    "QCMaker",
    "SeatTable",
    "TC",
    "TCMaker",
    "Timeout",
    "Vote",
]
