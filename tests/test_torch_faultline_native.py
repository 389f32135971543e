"""The port's native engine's fault table and faultline on the native
plane, on the CPU.

Twins of ``tests/test_faultline_native.py`` (its 6 tests, same inputs and
assertions) on ``hotstuff_tpu_torch``: ``hs_net_faults`` drops, delays and
splits a broadcast per peer, and replays its drop pattern from a seed; a
crash, partition and lossy-link scenario on four port engines whose
consensus receivers and vote broadcasts are the C++ engine's is safe and
recovers, its trace the compiled schedule's; a seeded scenario with the
command ring exercised replays byte-identically. The native classes are
selected by monkeypatching the module names, as the reference's tests do.
Then a mixed committee, two reference engines and two port engines, all
on their package's native transport, commits the same digests (tolerance:
the same digests, round by round). The crypto backend is each package's
CPU backend.

The library builds with g++ into ``hotstuff_tpu_torch/_build/``; a build
failure fails these tests. Ports 24000-24099.
"""

import asyncio
import random
import time

import pytest

import hotstuff_tpu.consensus as j_consensus
import hotstuff_tpu.consensus.consensus as j_consensus_mod
import hotstuff_tpu.consensus.core as j_core_mod
import hotstuff_tpu.crypto as j_crypto
import hotstuff_tpu.store as j_store
import hotstuff_tpu_torch.consensus as t_consensus
import hotstuff_tpu_torch.consensus.consensus as t_consensus_mod
import hotstuff_tpu_torch.consensus.core as t_core_mod
import hotstuff_tpu_torch.crypto as t_crypto
import hotstuff_tpu_torch.store as t_store
from hotstuff_tpu.network import native as j_native
from hotstuff_tpu_torch.consensus import cert_arena
from hotstuff_tpu_torch.network import native as hsnative

from .common import async_test

BASE_PORT = 24000


@pytest.fixture(autouse=True)
def backends(monkeypatch):
    monkeypatch.delenv("HOTSTUFF_WIRE_V2", raising=False)
    monkeypatch.setattr(t_crypto, "_BACKEND", None)
    monkeypatch.setattr(j_crypto, "_BACKEND", None)
    t_crypto.set_backend(t_crypto.CpuBackend())
    j_crypto.set_backend("cpu")
    cert_arena.reset()
    yield
    cert_arena.reset()


class _CollectHandler:
    def __init__(self):
        self.received = []

    async def dispatch(self, writer, message: bytes) -> None:
        self.received.append((time.monotonic(), message))


async def _clear_faults(transport) -> None:
    transport.set_faults({})
    await asyncio.sleep(0.05)


@async_test
async def test_native_fault_drop_eats_best_effort_frames():
    port = BASE_PORT
    handler = _CollectHandler()
    receiver = await hsnative.NativeReceiver.spawn(
        ("127.0.0.1", port), handler, auto_ack=True
    )
    transport = hsnative.NativeTransport.get()
    before = transport.stats()
    try:
        transport.set_faults(
            {("127.0.0.1", port): (1_000_000, 0)}, seed=42
        )  # drop everything
        sender = hsnative.NativeSimpleSender()
        for i in range(20):
            sender.send(("127.0.0.1", port), b"doomed-%d" % i)
        await asyncio.sleep(0.3)
        assert handler.received == []
        stats = transport.stats()
        assert stats["faults_dropped"] - before.get("faults_dropped", 0) == 20

        await _clear_faults(transport)
        sender.send(("127.0.0.1", port), b"alive")
        deadline = time.monotonic() + 5
        while not handler.received and time.monotonic() < deadline:
            await asyncio.sleep(0.02)
        assert [m for _, m in handler.received] == [b"alive"]
    finally:
        await _clear_faults(transport)
        await receiver.shutdown()


@async_test
async def test_native_fault_delay_holds_frames():
    port = BASE_PORT + 1
    handler = _CollectHandler()
    receiver = await hsnative.NativeReceiver.spawn(
        ("127.0.0.1", port), handler, auto_ack=True
    )
    transport = hsnative.NativeTransport.get()
    before = transport.stats()
    try:
        transport.set_faults({("127.0.0.1", port): (0, 200)})  # 200 ms hold
        sender = hsnative.NativeSimpleSender()
        t0 = time.monotonic()
        sender.send(("127.0.0.1", port), b"later")
        deadline = time.monotonic() + 5
        while not handler.received and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
        assert handler.received, "delayed frame never arrived"
        arrival, payload = handler.received[0]
        assert payload == b"later"
        assert arrival - t0 >= 0.15  # held by the engine, not dropped
        stats = transport.stats()
        assert stats["faults_delayed"] - before.get("faults_delayed", 0) == 1
    finally:
        await _clear_faults(transport)
        await receiver.shutdown()


@async_test
async def test_native_fault_broadcast_split_per_peer():
    """A broadcast with one faulted peer: the clean peer receives, the
    dropped peer does not — the engine applies rules per peer inside the
    coalesced broadcast command."""
    p1, p2 = BASE_PORT + 2, BASE_PORT + 3
    h1, h2 = _CollectHandler(), _CollectHandler()
    r1 = await hsnative.NativeReceiver.spawn(("127.0.0.1", p1), h1, auto_ack=True)
    r2 = await hsnative.NativeReceiver.spawn(("127.0.0.1", p2), h2, auto_ack=True)
    transport = hsnative.NativeTransport.get()
    try:
        transport.set_faults({("127.0.0.1", p2): (1_000_000, 0)})
        # Bypass the Python-side fault plane deliberately: this exercises
        # the ENGINE's table on the coalesced broadcast path.
        transport.broadcast(
            [("127.0.0.1", p1), ("127.0.0.1", p2)], b"fanout"
        )
        deadline = time.monotonic() + 5
        while not h1.received and time.monotonic() < deadline:
            await asyncio.sleep(0.02)
        assert [m for _, m in h1.received] == [b"fanout"]
        await asyncio.sleep(0.2)
        assert h2.received == []
    finally:
        await _clear_faults(transport)
        await r1.shutdown()
        await r2.shutdown()


def test_chaos_crash_partition_lossy_links_on_native_plane(monkeypatch):
    """Acceptance: the full chaos stack — supervised crash/restart, a
    partition with healing, and a delay+duplicate+reorder link rule —
    over the NATIVE transport plane (consensus receivers and vote
    broadcasts on the C++ engine). Safety and post-heal liveness must
    hold exactly as on the asyncio plane, and the compiled fault
    schedule must replay byte-identically."""
    import hotstuff_tpu_torch.consensus.consensus as consensus_mod
    import hotstuff_tpu_torch.consensus.core as core_mod

    from hotstuff_tpu_torch.faultline import Scenario, run_scenario

    monkeypatch.setattr(consensus_mod, "Receiver", hsnative.NativeReceiver)
    monkeypatch.setattr(core_mod, "SimpleSender", hsnative.NativeSimpleSender)

    scenario = Scenario(
        name="native-smoke", seed=20260805, duration_s=6.0,
        events=[
            {"kind": "crash", "node": 2, "at": 0.5},
            {"kind": "restart", "node": 2, "at": 2.0},
            {"kind": "partition", "at": 3.0, "until": 4.5},
            {"kind": "link", "src": 0, "dst": "*", "at": 1.0, "until": 5.0,
             "drop": 0.05, "delay_ms": [1, 10], "duplicate": 0.1,
             "reorder": 0.1},
        ],
    )

    async def run():
        return await run_scenario(
            scenario, 4, base_port=BASE_PORT + 40, timeout_delay=500,
            recovery_timeout_s=60.0,
        )

    result = asyncio.run(asyncio.wait_for(run(), timeout=150))
    verdict = result["verdict"]
    assert verdict["safety"]["ok"], verdict["safety"]
    assert verdict["liveness"]["recovered"], verdict["liveness"]
    counts = verdict["injections"]["counts"]
    assert counts["events_applied"] == 6  # 4 injects + partition/link heals
    assert counts["send_drops"] > 0
    assert counts["delays"] + counts["duplicates"] + counts["reorders"] > 0
    assert result["trace"] == scenario.compile(
        [f"n{i:03d}" for i in range(4)]
    ).trace()


@async_test
async def test_native_fault_drop_pattern_replays_with_seed():
    """Same seed + same frame sequence => identical engine drop pattern
    (the per-peer xorshift streams are seed-derived)."""
    port = BASE_PORT + 4

    async def spawn_with_retry(handler):
        # The port must stay FIXED across patterns (it keys the engine's
        # per-peer RNG stream), and the previous listener's close is a
        # command serviced asynchronously on the loop thread — retry the
        # bind until it lands.
        deadline = time.monotonic() + 5
        while True:
            try:
                return await hsnative.NativeReceiver.spawn(
                    ("127.0.0.1", port), handler, auto_ack=True
                )
            except OSError:
                if time.monotonic() > deadline:
                    raise
                await asyncio.sleep(0.05)

    async def pattern(seed: int) -> list[bytes]:
        handler = _CollectHandler()
        receiver = await spawn_with_retry(handler)
        transport = hsnative.NativeTransport.get()
        try:
            transport.set_faults({("127.0.0.1", port): (500_000, 0)}, seed=seed)
            sender = hsnative.NativeSimpleSender()
            for i in range(60):
                sender.send(("127.0.0.1", port), b"m%03d" % i)
                await asyncio.sleep(0.002)  # keep the wire ordered
            await asyncio.sleep(0.4)
            return [m for _, m in handler.received]
        finally:
            await _clear_faults(transport)
            await receiver.shutdown()

    first = await pattern(99)
    second = await pattern(99)
    other = await pattern(100)
    assert first == second
    assert 0 < len(first) < 60  # p=0.5 drops some, passes some
    assert other != first  # different stream (overwhelmingly likely)


def test_chaos_replay_on_native_plane_with_command_ring(monkeypatch):
    """Satellite guard for the command ring: a seeded chaos scenario over
    the NATIVE plane — with the batched hs_net_cmds_flush path active and
    demonstrably exercised — must produce a byte-identical compiled fault
    schedule across two runs (the ``Schedule.trace()`` replay contract)
    and a clean safety/liveness verdict both times. Catches ring-flush
    reordering bugs: a flush that reordered SET_ROUND/CONSUMED/SEND
    records would stall the vote pre-stage or strand back-pressure and
    surface here as a liveness failure."""
    import hotstuff_tpu_torch.consensus.consensus as consensus_mod
    import hotstuff_tpu_torch.consensus.core as core_mod

    from hotstuff_tpu_torch.faultline import Scenario, run_scenario

    monkeypatch.setattr(consensus_mod, "Receiver", hsnative.NativeReceiver)
    monkeypatch.setattr(core_mod, "SimpleSender", hsnative.NativeSimpleSender)

    scenario = Scenario(
        name="ring-replay", seed=8020, duration_s=5.0,
        events=[
            {"kind": "crash", "node": 1, "at": 0.5},
            {"kind": "restart", "node": 1, "at": 2.0},
            {"kind": "link", "src": 2, "dst": "*", "at": 1.0, "until": 4.0,
             "drop": 0.05, "delay_ms": [1, 5]},
        ],
    )

    transport = hsnative.NativeTransport.get_if_live()
    traces, verdicts = [], []
    for i in range(2):
        flushes_before = transport.ring_flushes if transport else 0

        async def run(base=BASE_PORT + 80 + 8 * i):
            return await run_scenario(
                scenario, 4, base_port=base, timeout_delay=500,
                recovery_timeout_s=60.0,
            )

        result = asyncio.run(asyncio.wait_for(run(), timeout=120))
        traces.append(result["trace"])
        verdicts.append(result["verdict"])
        transport = hsnative.NativeTransport.get_if_live()
        assert transport is not None and transport._ring_enabled
        assert transport.ring_flushes > flushes_before, (
            "chaos run did not exercise the command ring"
        )

    assert traces[0] == traces[1], "replay trace diverged for equal seeds"
    for verdict in verdicts:
        assert verdict["safety"]["ok"], verdict["safety"]
        assert verdict["liveness"]["recovered"], verdict["liveness"]


PKG = {
    "port": (t_consensus, t_crypto, t_store),
    "reference": (j_consensus, j_crypto, j_store),
}


def test_mixed_committee_on_both_native_transports_commits_the_same_digests(monkeypatch):
    monkeypatch.setattr(t_consensus_mod, "Receiver", hsnative.NativeReceiver)
    monkeypatch.setattr(t_core_mod, "SimpleSender", hsnative.NativeSimpleSender)
    monkeypatch.setattr(j_consensus_mod, "Receiver", j_native.NativeReceiver)
    monkeypatch.setattr(j_core_mod, "SimpleSender", j_native.NativeSimpleSender)
    rng = random.Random(0)
    seeds = [rng.randbytes(32) for _ in range(4)]
    base = BASE_PORT + 96

    async def run():
        engines, commits, sinks = [], [], []
        for i, name in enumerate(["reference", "port", "reference", "port"]):
            consensus, crypto, store = PKG[name]
            pairs = [crypto.generate_keypair(seed=s)[:2] for s in seeds]
            committee = consensus.Committee({
                p: consensus.Authority(1, ("127.0.0.1", base + j))
                for j, (p, _) in enumerate(pairs)})
            pk, sk = pairs[i]
            rx_mempool, tx_mempool, tx_commit = asyncio.Queue(), asyncio.Queue(), asyncio.Queue()

            async def drain(q=tx_mempool):
                while True:
                    await q.get()

            sinks.append(asyncio.create_task(drain()))
            engines.append(await consensus.Consensus.spawn(
                pk, committee,
                consensus.Parameters(timeout_delay=2_000, batch_vote_verification=True),
                crypto.SignatureService(sk), store.Store(), rx_mempool, tx_mempool, tx_commit))
            commits.append(tx_commit)
        rounds = []
        try:
            for _ in range(4):
                got = await asyncio.wait_for(asyncio.gather(*[q.get() for q in commits]), 60)
                rounds.append([(b.round, b.digest().data) for b in got])
        finally:
            for e in engines:
                await e.shutdown()
            for s in sinks:
                s.cancel()
        return rounds, engines

    rounds, engines = asyncio.run(asyncio.wait_for(run(), timeout=100))
    for i, got in enumerate(rounds):
        assert len(set(got)) == 1, f"engines committed different blocks at commit {i}: {got}"
    assert rounds[0][0][0] == 1
    assert all(type(e.receivers[0]).__name__ == "NativeReceiver" for e in engines)
    assert all(e.core.timeouts_fired == 0 for e in engines[1::2])
