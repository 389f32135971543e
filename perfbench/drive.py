"""The closed loop that drives the entry: ``in_flight`` clients on one
asyncio loop, each handing the next frame to the validator's entry and
waiting for its verdict before taking another.

A proposal's time runs from its hand-off (before the decode) to the moment
its client resumes with the verdict. A client takes the next frame whose
certificates are not already in flight, so no two concurrent requests
carry the same certificate and nothing can be shared between them. With
``spans`` the loop also records, from the benchmark's side, each decode,
each ``Block.verify`` on its worker thread and, through a wrapper the
harness installs on the backend instance, each backend call.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field


@dataclass
class Record:
    j: int  # index into the run's frames
    t0: int  # hand-off, ns
    t1: int  # verdict, ns
    verdict: str
    block: object  # the program's decoded block, or None


@dataclass
class Spans:
    decode: list = field(default_factory=list)  # (start, end) ns
    verify: list = field(default_factory=list)  # (start, end) ns, worker side
    backend: list = field(default_factory=list)  # (start, end, sigs, msgs) ns


@dataclass
class Outcome:
    records: list
    t_start: int
    t_end: int
    t_drained: int


class _Feeder:
    """Hands out frame indices in order, skipping for now any frame that
    shares a certificate with one in flight."""

    def __init__(self, cert_ids: list[tuple], limit: int | None) -> None:
        self.cert_ids = cert_ids
        self.limit = limit
        self.next = 0
        self.waiting: list[int] = []
        self.in_flight: dict = {}

    def take(self) -> int | None:
        for pos, j in enumerate(self.waiting):
            if self._free(j):
                del self.waiting[pos]
                return self._hold(j)
        while self.limit is None or self.next < self.limit:
            j = self.next
            self.next += 1
            if self._free(j):
                return self._hold(j)
            self.waiting.append(j)
        return None

    def done(self, j: int) -> None:
        for c in self._ids(j):
            self.in_flight[c] -= 1

    def _ids(self, j: int):
        return [c for c in self.cert_ids[j % len(self.cert_ids)] if c is not None]

    def _free(self, j: int) -> bool:
        return all(not self.in_flight.get(c) for c in self._ids(j))

    def _hold(self, j: int) -> int:
        for c in self._ids(j):
            self.in_flight[c] = self.in_flight.get(c, 0) + 1
        return j


def run(program, frames: list[bytes], cert_ids: list[tuple], in_flight: int,
        seconds: float | None, spans: Spans | None = None) -> Outcome:
    """Drive ``frames`` (cycled when the window outlasts them) for
    ``seconds``, or each frame once when ``seconds`` is None."""
    return asyncio.run(_run(program, frames, cert_ids, in_flight, seconds, spans))


async def _run(program, frames, cert_ids, in_flight, seconds, spans):
    decode = program.decode
    verify_off_loop = program.verify_off_loop
    verdict_of = program.verdict_of
    committee = program.committee
    feeder = _Feeder(cert_ids, len(frames) if seconds is None else None)
    records: list[Record] = []
    perf = time.perf_counter_ns
    n = len(frames)
    t_start = perf()
    t_end = t_start + int(seconds * 1e9) if seconds is not None else None

    async def client():
        while True:
            t0 = perf()
            if t_end is not None and t0 >= t_end:
                return
            j = feeder.take()
            if j is None:
                if not feeder.waiting:
                    return
                await asyncio.sleep(0)
                continue
            block = decode(frames[j % n])
            if spans is not None:
                spans.decode.append((t0, perf()))
            exc = None
            if block is None:
                verdict = "malformed"
            else:
                fn = block.verify if spans is None else _traced(block.verify, spans)
                try:
                    await verify_off_loop(fn, committee)
                except Exception as e:  # the verdict is the exception's class
                    exc = e
                verdict = verdict_of(exc)
            records.append(Record(j, t0, perf(), verdict, block))
            feeder.done(j)

    await asyncio.gather(*(client() for _ in range(in_flight)))
    return Outcome(records, t_start, t_end if t_end is not None else perf(), perf())


def _traced(verify, spans: Spans):
    def run(committee):
        a = time.perf_counter_ns()
        try:
            return verify(committee)
        finally:
            spans.verify.append((a, time.perf_counter_ns()))

    return run


def wrap_backend(instance, spans: Spans):
    """Time each ``verify_batch`` of the backend instance; returns the
    function that removes the wrapper."""
    inner = instance.verify_batch
    perf = time.perf_counter_ns

    def verify_batch(msgs, pubs, sigs):
        a = perf()
        try:
            return inner(msgs, pubs, sigs)
        finally:
            spans.backend.append((a, perf(), len(msgs), msgs))

    instance.verify_batch = verify_batch
    return lambda: instance.__dict__.pop("verify_batch", None)
