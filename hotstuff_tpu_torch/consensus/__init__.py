"""Consensus layer of the port: the vote/QC slice of ``hotstuff_tpu/consensus``."""

from .aggregator import Aggregator, QCMaker
from .config import Authority, Committee
from .messages import QC, Vote

__all__ = ["Aggregator", "Authority", "Committee", "QC", "QCMaker", "Vote"]
