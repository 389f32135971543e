"""Conveyor: a Narwhal-style worker-sharded data plane.

Port of ``hotstuff_tpu/mempool/dataplane/``, with the reference's export
list. Per-node worker shards batch client transactions independently,
disseminate batches to peer workers, collect 2f+1 signed availability
acks into a **batch availability certificate**, and hand only certified
digests to the primary. Consensus orders digests it can prove the
committee already holds; the commit path resolves digests back to
batches from the local worker store.
"""

from .backpressure import BoundedIngress, Watermark
from .certificate import (
    AvailabilityCert,
    CertCollector,
    CertError,
    WorkerSeatTable,
)
from .dataplane import CommitResolver, DataPlane
from .messages import ack_digest, cert_key
from .worker import IngressHandler, PeerWorkerHandler, Worker

__all__ = [
    "AvailabilityCert",
    "BoundedIngress",
    "CertCollector",
    "CertError",
    "CommitResolver",
    "DataPlane",
    "IngressHandler",
    "PeerWorkerHandler",
    "Watermark",
    "Worker",
    "WorkerSeatTable",
    "ack_digest",
    "cert_key",
]
