"""Lifeline: per-batch data-plane lifecycle tracing (``hotstuff-dtrace-v1``).

The round-trace plane (:mod:`.trace`) stops at the consensus boundary: a
committed block's propose→vote→QC→commit path is fully attributed while
everything the Conveyor data plane does before ordering — bundle
ingress, sealing, dissemination, 2f+1 ack fan-in, cert→proposer queue
wait — and after it (commit-path resolution) was a black box of
aggregate counters. This module is the missing axis: one bounded ring of
``(seq, node, batch, stage, t_mono[, detail])`` events keyed by the
BATCH DIGEST instead of the round number, recorded at each lifecycle
stage and drained by the same :class:`~.emitter.TelemetryEmitter` into
``hotstuff-dtrace-v1`` JSON lines interleaved with the snapshots.
``benchmark/dtrace_assemble.py`` merges both stream kinds across nodes
into one causal timeline per committed batch.

The lifecycle stages, in causal order (see ``docs/telemetry.md``):

- ``ingress``   — earliest client bundle contributing to the batch
                  arrived at the worker (recorded at seal time with the
                  arrival timestamp, so the hot ingress path pays zero)
- ``seal``      — the batcher sealed the batch (detail:
                  ``w<id>|<txs>tx|<bytes>B[|s<id>,...]`` — worker shard,
                  size, and leading sample ids for the client-log join)
- ``disseminate`` — dissemination frames handed to the ReliableSender
- ``ack``       — one peer's signed availability ack verified (detail:
                  the signer label)
- ``cert``      — 2f+1 stake reached, the AvailabilityCert exists
- ``enqueue``   — the certified digest entered a proposer queue (own
                  certifier, or a peer cert received on the wire — v1
                  and v2 cert frames both land here)
- ``proposed``  — a leader drained the digest into a block (detail:
                  ``r<round>`` — THE join point onto the round trace)
- ``committed`` — a node 2-chain-committed a block carrying the digest
                  (detail: ``r<round>``)
- ``resolved``  — the commit-path resolver materialized the batch bytes

Batches are labeled by their **interned digest label** — the same
``base64[:16]`` rendering as ``repr(Digest)``, which is what the round
trace's ``propose_send`` detail and the benchmark log lines already
print — through a small bounded cache so the hot path stays "one dict
hit + one ring append". Everything is gated on ``telemetry.enabled()``;
the disabled cost is one boolean check.

Port copy of ``hotstuff_tpu/telemetry/dtrace.py``, unchanged.
"""

from __future__ import annotations

import base64
import os
import threading
from collections import OrderedDict

from .trace import TraceBuffer

DTRACE_SCHEMA = "hotstuff-dtrace-v1"

#: the lifecycle stages a batch may leave behind, in causal order.
STAGES = (
    "ingress", "seal", "disseminate", "ack", "cert", "enqueue",
    "proposed", "committed", "resolved",
)

#: bounded digest→label intern cache (a soak seals far more batches than
#: fit here; eviction only costs a re-encode, never correctness).
_INTERN_CAP = 8192
_intern_lock = threading.Lock()
_interned: OrderedDict[bytes, str] = OrderedDict()


def intern_label(data: bytes) -> str:
    """The batch's stream label: ``base64[:16]`` of the digest bytes —
    identical to ``repr(Digest)`` so dtrace events, round-trace details,
    and the benchmark log lines all name a batch the same way."""
    with _intern_lock:
        label = _interned.get(data)
        if label is None:
            label = base64.standard_b64encode(data).decode()[:16]
            if len(_interned) >= _INTERN_CAP:
                _interned.popitem(last=False)
            _interned[data] = label
    return label


def build_dtrace_record(
    buffer: TraceBuffer, events: list[tuple], node: str = ""
) -> dict:
    """One ``hotstuff-dtrace-v1`` stream line carrying ``events``."""
    return {
        "schema": DTRACE_SCHEMA,
        "node": node,
        "pid": os.getpid(),
        "anchor": buffer.anchor(),
        "evicted": buffer.evicted,
        "events": [list(e) for e in events],
    }


def validate_dtrace_record(obj) -> list[str]:
    """Schema check mirroring ``validate_trace_record``; returns
    problems. The one structural difference from the round trace: slot 2
    is the batch's interned digest LABEL (a string), not a round int."""
    problems: list[str] = []
    if not isinstance(obj, dict):
        return [f"dtrace record is {type(obj).__name__}, not an object"]
    if obj.get("schema") != DTRACE_SCHEMA:
        problems.append(
            f"schema is {obj.get('schema')!r}, want {DTRACE_SCHEMA!r}"
        )
    anchor = obj.get("anchor")
    if not isinstance(anchor, dict) or not all(
        isinstance(anchor.get(k), (int, float)) for k in ("mono", "wall")
    ):
        problems.append("anchor missing mono/wall")
    events = obj.get("events")
    if not isinstance(events, list):
        problems.append("events missing or not a list")
        return problems
    for i, ev in enumerate(events):
        if (
            not isinstance(ev, (list, tuple))
            or len(ev) not in (5, 6)
            or not isinstance(ev[0], int)
            or not isinstance(ev[1], str)
            or not isinstance(ev[2], str)
            or not isinstance(ev[3], str)
            or not isinstance(ev[4], (int, float))
            or (len(ev) == 6 and not isinstance(ev[5], str))
        ):
            problems.append(f"event {i} malformed: {ev!r}")
            break
    return problems


def reset_for_tests() -> None:
    with _intern_lock:
        _interned.clear()
