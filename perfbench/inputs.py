"""The traffic generator: one general generator that turns a configuration
file and a traffic file into a seeded plan of proposals.

Everything is drawn from ``--seed``: the validators' keys, a pool of
distinct signed certificates, and the proposals. Signing is spread over
worker processes (``signer``). Every seed gives the same mix: each block
of 64 proposals holds ``forged_per_64`` proposals with one certificate
vote altered and ``short_per_64`` with a QC one vote short of quorum, at
positions the seed shuffles.

Certificates come from a pool (``pool`` clean sets, ``forged_pool`` altered
copies per certificate kind, ``short_pool`` short QCs) that the proposals
cycle through, since signing a certificate for every proposal would take
minutes. Every proposal is its own block: its own round, payload and
author signature. The window's proposals carry ``plan_sigs_per_s`` times
its seconds in certificate signatures, a rate set a quarter above the one
the program sustains; a faster program cycles them, and every cycle pays
in full. The plan holds plain data only; ``entries/proposal.py`` encodes it
into frames with the program's encoder.
"""

from __future__ import annotations

import math
import os
import random
from dataclasses import dataclass

from perfbench import signer, spec
from perfbench.reference import ed25519
from perfbench.reference.judge import ACCEPT, block_digest, qc_digest, tc_vote_digest


@dataclass
class Cert:
    kind: str  # "qc" or "tc"
    round: int
    hash: bytes | None  # QC: the certified block
    seats: list[int]  # ascending
    records: list[bytes]  # 64 B signature (+ u64 high-QC round for a TC)


@dataclass
class Proposal:
    round: int
    author: int  # seat
    payload: list[bytes]
    qc: int  # cert id
    tc: int | None
    intended: str  # the verdict the plan means it to get
    signature: bytes = b""


@dataclass
class Plan:
    keys: list[bytes]  # seats: public keys in byte order
    stake: int
    certs: list[Cert]
    warmup: list[Proposal]
    window: list[Proposal]


def _alter(rec: bytes, rng: random.Random) -> bytes:
    """``rec`` with one byte of R or S changed, both kept canonical
    (R's y below p, s below L), so a verifier computes the whole batch."""
    while True:
        b = bytearray(rec)
        pos = rng.randrange(31) + (32 if rng.random() < 0.5 else 0)
        b[pos] ^= rng.randrange(1, 256)
        y = int.from_bytes(b[:32], "little") & ((1 << 255) - 1)
        s = int.from_bytes(b[32:64], "little")
        if y < ed25519.P and s < ed25519.L:
            return bytes(b)


def make_plan(seed: int, config: dict, traffic: dict, seconds: float) -> Plan:
    rng = random.Random(f"perfbench-traffic:{seed}")
    n = int(config["validators"])
    stake = int(config["stake"])
    quorum = 2 * n * stake // 3 + 1
    q = -(-quorum // stake)  # votes that reach the quorum
    kinds = list(traffic["certificates"])
    n_pool = int(traffic["pool"])
    n_forged = int(traffic["forged_pool"])
    n_short = int(traffic["short_pool"])
    n_window = max(1, math.ceil(seconds * float(traffic["plan_sigs_per_s"]) / (q * len(kinds))))
    workers = max(1, min(8, os.cpu_count() or 1))

    secret = sorted((ed25519.expand(rng.randbytes(32)) for _ in range(n)), key=lambda e: e[2])
    keys = [e[2] for e in secret]  # seat order
    perm = list(range(n))
    rng.shuffle(perm)

    def signers(offset: int) -> list[int]:
        return sorted(perm[(offset + j) % n] for j in range(q))

    certs: list[Cert] = []
    tasks: list[tuple] = []  # (cert, vote, seat, message)
    sets = []  # per clean set: {kind: cert id}
    high_qc = {}  # TC cert id -> each vote's high-QC round
    for s in range(n_pool):
        ids = {"qc": len(certs)}
        qround = 1000 + 4 * s
        h = rng.randbytes(32)
        certs.append(Cert("qc", qround, h, signers(s * q), [b""] * q))
        msg = qc_digest(h, qround)
        tasks += [(certs[-1], j, seat, msg) for j, seat in enumerate(certs[-1].seats)]
        if "tc" in kinds:
            tround = qround + 2
            ids["tc"] = len(certs)
            certs.append(Cert("tc", tround, None, signers(s * q + n // 2), [b""] * q))
            hqc = high_qc[ids["tc"]] = [tround - 1 - rng.randrange(3) for _ in range(q)]
            tasks += [(certs[-1], j, seat, tc_vote_digest(tround, r))
                      for j, (seat, r) in enumerate(zip(certs[-1].seats, hqc))]
        sets.append(ids)
    # Altered and short copies of clean certificates, filled once signed.
    derived = []  # (cert id, base id, vote, alter?)
    forged = {k: [] for k in kinds}
    for k in kinds:
        for f in range(n_forged):
            base = sets[f % n_pool][k]
            forged[k].append(len(certs))
            derived.append((len(certs), base, rng.randrange(q), True))
            certs.append(Cert(k, certs[base].round, certs[base].hash, list(certs[base].seats), []))
    shorts = []
    for f in range(n_short):
        base = sets[f % n_pool]["qc"]
        v = rng.randrange(q)
        shorts.append(len(certs))
        derived.append((len(certs), base, v, False))
        seats = certs[base].seats
        certs.append(Cert("qc", certs[base].round, certs[base].hash, seats[:v] + seats[v + 1:], []))

    # The mix: in every block of 64, the same counts at shuffled places.
    n_f, n_s = int(traffic["forged_per_64"]), int(traffic["short_per_64"])
    counters = {"set": 0, "short": 0, **{f"forged_{k}": 0 for k in kinds}}

    def schedule(count: int) -> list[str]:
        out = []
        while len(out) < count:
            block = [f"forged_{kinds[i % len(kinds)]}" for i in range(n_f)]
            block += ["short"] * n_s
            block += ["clean"] * (64 - len(block))
            rng.shuffle(block)
            out += block
        return out[:count]

    d = int(config["payload_digests"])

    def proposal(rnd: int, what: str) -> Proposal:
        ids = dict(sets[counters["set"] % n_pool])
        counters["set"] += 1
        intended = ACCEPT
        if what == "short":
            ids["qc"] = shorts[counters["short"] % n_short]
            counters["short"] += 1
            intended = "QCRequiresQuorum"
        elif what != "clean":
            k = what[len("forged_"):]
            ids[k] = forged[k][counters[what] % n_forged]
            counters[what] += 1
            intended = "InvalidSignature"
        payload = [rng.randbytes(32) for _ in range(d)]
        return Proposal(rnd, rnd % n, payload, ids["qc"], ids.get("tc"), intended)

    # Warm-up: every pool certificate once, at the window's concurrency.
    warm_kinds = ["clean"] * n_pool + [f"forged_{k}" for k in kinds for _ in range(n_forged)]
    warm_kinds += ["short"] * n_short
    warm_kinds += ["clean"] * max(0, 4 * int(traffic["in_flight"]) - len(warm_kinds))
    warmup = [proposal(100 + i, w) for i, w in enumerate(warm_kinds)]
    window = [proposal(100_000 + i, w) for i, w in enumerate(schedule(n_window))]

    props = warmup + window
    items = [(secret[seat][0], secret[seat][1], keys[seat], msg) for _, _, seat, msg in tasks]
    for p in props:
        author = keys[p.author]
        msg = block_digest(author, p.round, p.payload, certs[p.qc].hash)
        items.append((secret[p.author][0], secret[p.author][1], author, msg))
    sigs = signer.sign_all(items, workers, spec.ROOT)
    for (cert, j, _, _), sig in zip(tasks, sigs):
        cert.records[j] = sig
    for p, sig in zip(props, sigs[len(tasks):]):
        p.signature = sig
    for i, hqc in high_qc.items():
        certs[i].records = [r + x.to_bytes(8, "little") for r, x in zip(certs[i].records, hqc)]
    for i, base, v, alter in derived:
        recs = list(certs[base].records)
        if alter:
            recs[v] = _alter(recs[v][:64], rng) + recs[v][64:]
        else:
            del recs[v]
        certs[i].records = recs
    return Plan(keys, stake, certs, warmup, window)
