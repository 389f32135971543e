"""The certificate path's stage spans (``hotstuff_tpu_torch/telemetry/
stages.py``), on the CPU through ``CudaBackend(device="cpu")`` (the
kernels' plain versions), on the cached and the uncached path.

A proposal at N = 4 (a v2 QC of 3 signatures) is decoded and judged by
``Block.verify`` through the crypto bridge, as a validator judges one:

- unarmed, no site reads a clock or touches a counter: the stage
  functions are replaced by ones that raise, and the registry and the
  ring stay as they were;
- armed, each stage of the path counts exactly one call, a rejected QC
  closes its spans too, the host-prep, launch and wait spans nest inside
  the backend call, which nests inside the certificate's, all on one
  worker thread, and each stage's ``.ns`` is the sum of its intervals;
- the bridge counts one queue and one resume span for each call that
  goes to its worker pool, and none for a call it runs inline;
- a ring of tiny capacity counts what it evicts.
"""

from __future__ import annotations

import asyncio

import pytest

from hotstuff_tpu_torch import crypto, telemetry
from hotstuff_tpu_torch.consensus import cert_arena, crypto_bridge, errors
from hotstuff_tpu_torch.consensus.config import Authority, Committee
from hotstuff_tpu_torch.consensus.messages import (
    QC,
    Block,
    SeatTable,
    decode_message,
    encode_propose,
)
from hotstuff_tpu_torch.crypto.batching import BatchingBackend
from hotstuff_tpu_torch.crypto.cuda_backend import CudaBackend
from hotstuff_tpu_torch.telemetry import stages
from hotstuff_tpu_torch.telemetry.trace import TraceBuffer

PATHS = ["cached", "uncached"]
PREP = {
    "cached": ("crypto.prep.ensure", "crypto.prep.scalars", "crypto.prep.recode", "crypto.prep.pack"),
    "uncached": ("crypto.prep.scalars", "crypto.prep.pack"),
}
# One QC, one author signature, one trip through the bridge.
ONCE = ("consensus.decode", "crypto.bridge.queue", "crypto.bridge.resume", "crypto.cert",
        "crypto.single", "crypto.backend", "crypto.launch", "crypto.wait")


@pytest.fixture(autouse=True)
def isolate(monkeypatch):
    """No certificate arena, a fresh registry, ring and switch, and the
    process backend restored around every test."""
    monkeypatch.setenv("HOTSTUFF_CERT_ARENA", "0")
    monkeypatch.setattr(crypto, "_BACKEND", None)
    cert_arena.reset()
    telemetry.reset_for_tests()
    telemetry.enable()
    yield
    telemetry.reset_for_tests()
    cert_arena.reset()


class World:
    """N = 4 validators of stake 1 (quorum 3) and their seat table."""

    def __init__(self) -> None:
        self.keys = [crypto.generate_keypair(seed=bytes([i + 1]) * 32) for i in range(4)]
        self.committee = Committee(authorities={
            pk: Authority(stake=1, address=("127.0.0.1", 0)) for pk, _ in self.keys})
        self.seats = SeatTable.for_committee(self.committee)

    def frame(self, tampered: bool = False) -> bytes:
        """A proposal whose QC carries 3 votes, in the v2 wire format;
        ``tampered`` flips a bit inside the second vote's R."""
        qc = QC(hash=crypto.sha512_digest(b"block", (3).to_bytes(8, "little")), round=3, votes=[])
        qc.votes = [(pk, crypto.Signature.new(qc.digest(), sk)) for pk, sk in self.keys[:3]]
        pk, sk = self.keys[1]
        block = Block.new_from_key(qc, None, pk, 4, [crypto.sha512_digest(b"p0")], sk)
        data = bytearray(encode_propose(block, self.seats))
        if tampered:
            data[1 + 32 + 8 + 4 + self.seats.nbytes + 64 + 5] ^= 0x10
        return bytes(data)

    def judge(self, data: bytes) -> str:
        """Decode a frame and verify its block through the crypto bridge;
        the verdict's class name, or ``accepted``."""
        kind, block = decode_message(data, self.seats)
        assert kind == "propose" and "_raw_votes" in block.qc.__dict__

        async def run():
            await crypto_bridge.verify_off_loop(block.verify, self.committee)

        try:
            asyncio.run(run())
        except errors.ConsensusError as e:
            return type(e).__name__
        return "accepted"


def use_backend(path: str, batched: bool = False) -> CudaBackend:
    backend = CudaBackend(device="cpu", cache=path == "cached", sharded=False)
    crypto.set_backend(BatchingBackend(backend) if batched else backend)
    return backend


def stage_counters() -> dict[str, int]:
    """The registry's counters of the stage spans."""
    counters = telemetry.get_registry().snapshot()["counters"]
    return {k: v for k, v in counters.items() if k.rsplit(".", 1)[0] in stages.NESTING}


def calls() -> dict[str, int]:
    return {k[:-len(".calls")]: v for k, v in stage_counters().items() if k.endswith(".calls")}


def single_waits() -> int:
    """Flusher waits of one strict single verify: without the OpenSSL
    binding it goes through the native engine's fuser."""
    return 0 if crypto._HAVE_PYCA or not crypto.native_ed25519.native_available() else 1


def _raise(*args, **kwargs):
    raise AssertionError("an unarmed site called into the stages")


@pytest.mark.parametrize("path", PATHS)
def test_unarmed_sites_read_the_switch_and_nothing_else(path, monkeypatch):
    world = World()
    backend = use_backend(path)
    frame = world.frame()
    for name in ("begin", "end", "interval", "_counters"):
        monkeypatch.setattr(stages, name, _raise)
    assert world.judge(frame) == "accepted"
    assert backend.dispatches == 1
    assert stage_counters() == {}
    assert stages.intervals() == [] and stages.ring().evicted == 0
    counters = telemetry.get_registry().snapshot()["counters"]
    assert {k for k in counters if k.startswith("crypto.")} == {
        "crypto.dispatch.cuda", "crypto.dispatch.cuda_sigs"}


@pytest.mark.parametrize("batched", [False, True], ids=["plain", "batched"])
@pytest.mark.parametrize("path", PATHS)
def test_armed_path_counts_each_stage_once_for_one_qc(path, batched):
    world = World()
    backend = use_backend(path, batched)
    frame = world.frame()
    stages.arm()
    assert world.judge(frame) == "accepted"
    stages.disarm()
    want = dict.fromkeys(ONCE + PREP[path], 1)
    waits = single_waits() + batched
    if waits:
        want["crypto.batch.wait"] = waits
    assert calls() == want
    assert (backend.dispatches, backend.sigs) == (1, 3)
    assert len(stages.intervals()) == sum(want.values())
    # Disarmed again: a second proposal adds nothing.
    before = stage_counters()
    assert world.judge(frame) == "accepted"
    assert stage_counters() == before


@pytest.mark.parametrize("path", PATHS)
def test_rejected_qc_closes_its_spans(path):
    world = World()
    use_backend(path)
    frame = world.frame(tampered=True)
    stages.arm()
    assert world.judge(frame) == "InvalidSignature"
    got = calls()
    assert all(got.get(name) == 1 for name in ONCE + PREP[path]), got


@pytest.mark.parametrize("path", PATHS)
def test_spans_nest_inside_the_backend_and_the_certificate_on_one_thread(path):
    world = World()
    use_backend(path)
    frame = world.frame()
    stages.arm()
    assert world.judge(frame) == "accepted"
    spans = {name: (thread, a, b) for name, thread, a, b in stages.intervals()}
    cert, backend = spans["crypto.cert"], spans["crypto.backend"]
    inner = PREP[path] + ("crypto.launch", "crypto.wait")
    assert {spans[n][0] for n in inner + ("crypto.backend", "crypto.cert")} == {cert[0]}
    assert cert[1] <= backend[1] <= backend[2] <= cert[2]
    for n in inner:
        assert backend[1] <= spans[n][1] <= spans[n][2] <= backend[2], n
    # In the order the host runs them, one after another.
    order = sorted(inner, key=lambda n: spans[n][1])
    assert order == list(inner)
    assert all(spans[a][2] <= spans[b][1] for a, b in zip(order, order[1:]))
    # The worker took the job after it was queued, and the awaiting task
    # resumed after the worker returned.
    queue, resume = spans["crypto.bridge.queue"], spans["crypto.bridge.resume"]
    assert queue[2] <= cert[1] and cert[2] <= resume[1]
    assert spans["consensus.decode"][2] <= queue[1]


@pytest.mark.parametrize("path", PATHS)
def test_each_stage_counts_the_wall_time_of_its_intervals(path):
    world = World()
    use_backend(path)
    frames = [world.frame(), world.frame(tampered=True)]
    stages.arm()
    for data in frames:
        world.judge(data)
    counters = stage_counters()
    assert set(counters) == {f"{name}.{field}" for name in calls() for field in ("ns", "calls")}
    assert set(calls()) >= set(ONCE + PREP[path])
    spans = stages.intervals()
    for name, n in calls().items():
        mine = [b - a for got, _, a, b in spans if got == name]
        assert len(mine) == n and min(mine) >= 0, name
        assert counters[f"{name}.ns"] == sum(mine), name


def test_bridge_counts_each_hop_to_the_pool():
    use_backend("cached")

    def ok(x):
        return x + 1

    def bad(x):
        raise ValueError(x)

    async def run():
        assert [await crypto_bridge.verify_off_loop(ok, i) for i in range(3)] == [1, 2, 3]
        with pytest.raises(ValueError):
            await crypto_bridge.verify_off_loop(bad, 7)

    stages.arm()
    asyncio.run(run())
    got = calls()
    assert got == {"crypto.bridge.queue": 4, "crypto.bridge.resume": 4}
    # A backend that does not block runs small verifications inline: no hop.
    crypto.set_backend(crypto.CpuBackend())

    async def inline():
        assert await crypto_bridge.verify_off_loop(ok, 1) == 2

    asyncio.run(inline())
    assert calls() == got


def test_tiny_ring_counts_its_evictions(monkeypatch):
    monkeypatch.setattr(stages, "_RING", TraceBuffer(4))
    stages.arm()
    for _ in range(6):
        stages.end("crypto.launch", stages.begin())
    assert stages.ring().evicted == 2
    assert len(stages.intervals()) == 4
    assert calls() == {"crypto.launch": 6}
    assert all(name == "crypto.launch" and a <= b for name, _, a, b in stages.intervals())
