"""Node-level config files (reference ``node/src/config.rs``).

Port copy of ``hotstuff_tpu/node/config.py``, whole: ``Secret``,
``Committee``, ``Parameters`` and ``ConfigError``. The JSON schemas are the
reference's byte for byte (reference ``benchmark/benchmark/config.py:33-53``),
so a file written by either package reads in the other:

- committee: ``{"consensus": {"authorities": {name: {name, stake, address}},
  "epoch"}, "mempool": {"authorities": {name: {name, stake,
  transactions_address, mempool_address}}, "epoch"}}`` with ``ip:port``
  strings (and the data plane's optional ``workers`` entries);
- parameters: ``{"consensus": {...}, "mempool": {...}}``;
- secret: ``{"name": <b64 pk>, "secret": <b64 seed>}``.
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass

from hotstuff_tpu_torch.consensus import Authority as ConsensusAuthority
from hotstuff_tpu_torch.consensus import Committee as ConsensusCommittee
from hotstuff_tpu_torch.consensus import Parameters as ConsensusParameters
from hotstuff_tpu_torch.crypto import PublicKey, SecretKey, generate_keypair
from hotstuff_tpu_torch.mempool import Authority as MempoolAuthority
from hotstuff_tpu_torch.mempool import Committee as MempoolCommittee
from hotstuff_tpu_torch.mempool import Parameters as MempoolParameters
from hotstuff_tpu_torch.mempool import WorkerEntry


class ConfigError(Exception):
    pass


def _parse_addr(s: str) -> tuple[str, int]:
    host, _, port = s.rpartition(":")
    return (host, int(port))


def _fmt_addr(a: tuple[str, int]) -> str:
    return f"{a[0]}:{a[1]}"


@dataclass
class Secret:
    name: PublicKey
    secret: SecretKey

    @classmethod
    def new(cls) -> "Secret":
        pk, sk = generate_keypair()
        return cls(pk, sk)

    @classmethod
    def default(cls) -> "Secret":
        """Fixed-seed key for tests (reference ``config.rs:73-79``)."""
        rng = random.Random(0)
        pk, sk = generate_keypair(seed=rng.randbytes(32))
        return cls(pk, sk)

    @classmethod
    def read(cls, path: str) -> "Secret":
        try:
            with open(path) as f:
                data = json.load(f)
            return cls(
                PublicKey.decode_base64(data["name"]),
                SecretKey.decode_base64(data["secret"]),
            )
        except (OSError, KeyError, ValueError) as e:
            raise ConfigError(f"failed to read config file '{path}': {e}") from e

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(
                {"name": self.name.encode_base64(), "secret": self.secret.encode_base64()},
                f,
                indent=4,
                sort_keys=True,
            )
            f.write("\n")


@dataclass
class Committee:
    consensus: ConsensusCommittee
    mempool: MempoolCommittee

    @classmethod
    def read(cls, path: str) -> "Committee":
        try:
            with open(path) as f:
                data = json.load(f)
            consensus = ConsensusCommittee(
                authorities={
                    PublicKey.decode_base64(a["name"]): ConsensusAuthority(
                        stake=int(a["stake"]), address=_parse_addr(a["address"])
                    )
                    for a in data["consensus"]["authorities"].values()
                },
                epoch=int(data["consensus"].get("epoch", 1)),
            )
            mempool = MempoolCommittee(
                authorities={
                    PublicKey.decode_base64(a["name"]): MempoolAuthority(
                        stake=int(a["stake"]),
                        transactions_address=_parse_addr(a["transactions_address"]),
                        mempool_address=_parse_addr(a["mempool_address"]),
                        # Conveyor worker shards: optional, so committee
                        # files from the reference harness parse unchanged.
                        workers=[
                            WorkerEntry(
                                transactions_address=_parse_addr(
                                    w["transactions_address"]
                                ),
                                worker_address=_parse_addr(w["worker_address"]),
                            )
                            for w in a.get("workers", [])
                        ],
                    )
                    for a in data["mempool"]["authorities"].values()
                },
                epoch=int(data["mempool"].get("epoch", 1)),
            )
            return cls(consensus, mempool)
        except (OSError, KeyError, ValueError) as e:
            raise ConfigError(f"failed to read config file '{path}': {e}") from e

    def write(self, path: str) -> None:
        data = {
            "consensus": {
                "authorities": {
                    pk.encode_base64(): {
                        "name": pk.encode_base64(),
                        "stake": a.stake,
                        "address": _fmt_addr(a.address),
                    }
                    for pk, a in self.consensus.authorities.items()
                },
                "epoch": self.consensus.epoch,
            },
            "mempool": {
                "authorities": {
                    pk.encode_base64(): {
                        "name": pk.encode_base64(),
                        "stake": a.stake,
                        "transactions_address": _fmt_addr(a.transactions_address),
                        "mempool_address": _fmt_addr(a.mempool_address),
                        # Emitted only when shards exist: files stay
                        # byte-compatible with the reference harness
                        # whenever the data plane is off.
                        **(
                            {
                                "workers": [
                                    {
                                        "transactions_address": _fmt_addr(
                                            w.transactions_address
                                        ),
                                        "worker_address": _fmt_addr(
                                            w.worker_address
                                        ),
                                    }
                                    for w in a.workers
                                ]
                            }
                            if a.workers
                            else {}
                        ),
                    }
                    for pk, a in self.mempool.authorities.items()
                },
                "epoch": self.mempool.epoch,
            },
        }
        with open(path, "w") as f:
            json.dump(data, f, indent=4, sort_keys=True)
            f.write("\n")


@dataclass
class Parameters:
    consensus: ConsensusParameters
    mempool: MempoolParameters

    @classmethod
    def default(cls) -> "Parameters":
        return cls(ConsensusParameters(), MempoolParameters())

    @classmethod
    def read(cls, path: str) -> "Parameters":
        try:
            with open(path) as f:
                data = json.load(f)
            c, m = data.get("consensus", {}), data.get("mempool", {})
            return cls(
                ConsensusParameters(
                    timeout_delay=int(c.get("timeout_delay", 5_000)),
                    sync_retry_delay=int(c.get("sync_retry_delay", 10_000)),
                    persist_sync=bool(c.get("persist_sync", False)),
                    batch_vote_verification=bool(
                        c.get("batch_vote_verification", False)
                    ),
                    leader_elector=str(
                        c.get("leader_elector", "round-robin")
                    ),
                    # Emit-side wire negotiation: decode always accepts
                    # both formats, so this is safe to flip per epoch.
                    wire_v2=bool(c.get("wire_v2", True)),
                    retention_rounds=int(c.get("retention_rounds", 0)),
                ),
                MempoolParameters(
                    gc_depth=int(m.get("gc_depth", 50)),
                    sync_retry_delay=int(m.get("sync_retry_delay", 5_000)),
                    sync_retry_nodes=int(m.get("sync_retry_nodes", 3)),
                    batch_size=int(m.get("batch_size", 500_000)),
                    max_batch_delay=int(m.get("max_batch_delay", 100)),
                    device_batch_digests=bool(m.get("device_batch_digests", False)),
                    workers=int(m.get("workers", 0)),
                    worker_ingress_capacity=int(
                        m.get("worker_ingress_capacity", 512)
                    ),
                    store_high_watermark=int(
                        m.get("store_high_watermark", 256)
                    ),
                    store_low_watermark=int(m.get("store_low_watermark", 128)),
                ),
            )
        except (OSError, ValueError) as e:
            raise ConfigError(f"failed to read config file '{path}': {e}") from e

    def write(self, path: str) -> None:
        data = {
            "consensus": {
                "timeout_delay": self.consensus.timeout_delay,
                "sync_retry_delay": self.consensus.sync_retry_delay,
                "persist_sync": self.consensus.persist_sync,
                "batch_vote_verification": (
                    self.consensus.batch_vote_verification
                ),
                "leader_elector": self.consensus.leader_elector,
                "wire_v2": self.consensus.wire_v2,
                "retention_rounds": self.consensus.retention_rounds,
            },
            "mempool": {
                "gc_depth": self.mempool.gc_depth,
                "sync_retry_delay": self.mempool.sync_retry_delay,
                "sync_retry_nodes": self.mempool.sync_retry_nodes,
                "batch_size": self.mempool.batch_size,
                "max_batch_delay": self.mempool.max_batch_delay,
                "device_batch_digests": self.mempool.device_batch_digests,
                "workers": self.mempool.workers,
                "worker_ingress_capacity": self.mempool.worker_ingress_capacity,
                "store_high_watermark": self.mempool.store_high_watermark,
                "store_low_watermark": self.mempool.store_low_watermark,
            },
        }
        with open(path, "w") as f:
            json.dump(data, f, indent=4, sort_keys=True)
            f.write("\n")
