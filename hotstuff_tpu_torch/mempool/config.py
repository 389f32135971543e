"""Mempool configuration (reference ``mempool/src/config.rs``).

Port copy of ``hotstuff_tpu/mempool/config.py``, whole. The mempool keeps
its own committee type with its own address space, two addresses per node:
``transactions_address`` for clients and ``mempool_address`` for peer
mempools (reference ``mempool/src/config.rs:50-64``), plus the data
plane's worker entries (``WorkerEntry``: a client ingress and a peer port
per shard) and their lookups (``workers_of``, ``worker_peers``,
``worker_address``).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

from hotstuff_tpu_torch.crypto import PublicKey

log = logging.getLogger("mempool")

Stake = int


@dataclass
class Parameters:
    """Defaults match the reference (``mempool/src/config.rs:24-34``)."""

    gc_depth: int = 50  # rounds
    sync_retry_delay: int = 5_000  # ms
    sync_retry_nodes: int = 3  # number of nodes
    batch_size: int = 500_000  # bytes
    max_batch_delay: int = 100  # ms
    # -- the data plane (mempool/dataplane/) ---------------------------------
    # Worker shards per node: 0 disables the data plane (the legacy
    # BatchMaker path always runs); >0 spawns min(workers,
    # committee-declared worker entries) shards, each with its own
    # client-ingress port, peer port, bounded ingress queue and
    # availability-cert pipeline.
    workers: int = 0
    # Per-worker ingress bound, in client BUNDLES. Arrivals beyond it are
    # shed with a client-visible b"Shed" reply.
    worker_ingress_capacity: int = 512
    # Store-depth watermarks, in sealed-but-uncommitted batches per node:
    # sealing gates at >= high and resumes at <= low (hysteresis).
    store_high_watermark: int = 256
    store_low_watermark: int = 128
    # Hash the batches a processor finds pending together in one call of
    # the SHA-512 kernel (``ops/sha512.py``) instead of one ``hashlib``
    # call each: the BASELINE config-3 regime. Off by default: a lone
    # batch is latency-bound and host hashing wins.
    device_batch_digests: bool = False

    def log(self) -> None:
        # These log entries are picked up by the benchmark log parser
        # (reference ``mempool/src/config.rs:37-44``).
        log.info("Garbage collection depth set to %d rounds", self.gc_depth)
        log.info("Sync retry delay set to %d ms", self.sync_retry_delay)
        log.info("Sync retry nodes set to %d nodes", self.sync_retry_nodes)
        log.info("Batch size set to %d B", self.batch_size)
        log.info("Max batch delay set to %d ms", self.max_batch_delay)


@dataclass
class WorkerEntry:
    """One worker shard's address pair: ``transactions_address`` faces
    clients, ``worker_address`` faces peer workers (batch dissemination,
    acks, certs, batch requests)."""

    transactions_address: tuple[str, int]
    worker_address: tuple[str, int]


@dataclass
class Authority:
    stake: Stake
    transactions_address: tuple[str, int]
    mempool_address: tuple[str, int]
    # Data-plane worker shards (empty: the legacy single-lane mempool).
    # Worker ``w`` of every node disseminates to worker ``w`` of every
    # peer, so entries pair up positionally across the committee.
    workers: list[WorkerEntry] = field(default_factory=list)


@dataclass
class Committee:
    authorities: dict[PublicKey, Authority]
    epoch: int = 1

    def size(self) -> int:
        return len(self.authorities)

    def stake(self, name: PublicKey) -> Stake:
        a = self.authorities.get(name)
        return a.stake if a else 0

    def total_stake(self) -> Stake:
        return sum(a.stake for a in self.authorities.values())

    def quorum_threshold(self) -> Stake:
        # 2f+1 out of N=3f+1 by stake (reference ``mempool/src/config.rs:90-95``).
        return 2 * self.total_stake() // 3 + 1

    def transactions_address(self, name: PublicKey) -> tuple[str, int] | None:
        a = self.authorities.get(name)
        return a.transactions_address if a else None

    def mempool_address(self, name: PublicKey) -> tuple[str, int] | None:
        a = self.authorities.get(name)
        return a.mempool_address if a else None

    def broadcast_addresses(self, name: PublicKey) -> list[tuple[PublicKey, tuple[str, int]]]:
        """(name, mempool_address) of every node except ``name``."""
        return [
            (pk, a.mempool_address)
            for pk, a in self.authorities.items()
            if pk != name
        ]

    def workers_of(self, name: PublicKey) -> list[WorkerEntry]:
        a = self.authorities.get(name)
        return a.workers if a else []

    def worker_peers(
        self, name: PublicKey, worker_id: int
    ) -> list[tuple[PublicKey, tuple[str, int]]]:
        """(peer, worker_address) of every OTHER node's worker shard
        ``worker_id``: the dissemination fan-out of our shard
        ``worker_id``. Peers without that shard are skipped."""
        return [
            (pk, a.workers[worker_id].worker_address)
            for pk, a in self.authorities.items()
            if pk != name and worker_id < len(a.workers)
        ]

    def worker_address(
        self, name: PublicKey, worker_id: int
    ) -> tuple[str, int] | None:
        a = self.authorities.get(name)
        if a is None or worker_id >= len(a.workers):
            return None
        return a.workers[worker_id].worker_address
