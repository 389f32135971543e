"""The port's consensus engine parts, on the CPU: twins of
``tests/test_timer.py``, ``tests/test_sync_retry.py``,
``tests/test_consensus_helper.py`` and the unit tests of
``tests/test_leader_reputation.py``, run on ``hotstuff_tpu_torch``, plus
the two packages' leader electors held to the same leaders on the same
committed chain, and the helper's reply frames held byte for byte.

Ports 21800-21899, below the ephemeral range (no reference test binds them).
"""

import asyncio
import time

import pytest

import hotstuff_tpu.consensus.leader as j_leader
from hotstuff_tpu_torch.consensus import synchronizer as sync_mod
from hotstuff_tpu_torch.consensus.helper import Helper
from hotstuff_tpu_torch.consensus.leader import (
    ReputationLeaderElector,
    RRLeaderElector,
    make_elector,
)
from hotstuff_tpu_torch.consensus.messages import decode_message
from hotstuff_tpu_torch.consensus.synchronizer import Synchronizer
from hotstuff_tpu_torch.consensus.timer import Timer
from hotstuff_tpu_torch.store import Store

from .common import async_test, listener
from .test_torch_core import Env

BASE = 21800


def consensus_committee(base_port: int, n: int = 4):
    """The port's 4-node localhost committee of ``tests/common.keys``."""
    env = Env("port")
    from hotstuff_tpu_torch.consensus import Authority, Committee

    return Committee({pk: Authority(1, ("127.0.0.1", base_port + i)) for i, (pk, _) in enumerate(env.keys)})


def keys(n: int = 4):
    return Env("port").keys[:n]


def chain(n: int):
    return Env("port").chain(n)


# -- twins of tests/test_timer.py ----------------------------------------------


@async_test
async def test_timer_fires_after_duration():
    t = Timer(50)
    start = time.monotonic()
    await t.wait()
    assert time.monotonic() - start >= 0.045


@async_test
async def test_reset_postpones_firing():
    t = Timer(80)
    start = time.monotonic()
    task = asyncio.create_task(t.wait())
    await asyncio.sleep(0.05)
    t.reset()  # pushes deadline to start+0.05+0.08
    await task
    assert time.monotonic() - start >= 0.12


# -- twins of tests/test_sync_retry.py -----------------------------------------


def _bare(retry_delay_s: float) -> Synchronizer:
    """State-only instance (no tasks) for unit-testing the retry policy."""
    s = Synchronizer.__new__(Synchronizer)
    s.sync_retry_delay = retry_delay_s
    s._requests = {}
    s._last_sent = {}
    return s


def test_expired_frontiers_rearm_instead_of_rebroadcasting_every_tick():
    s = _bare(2.0)
    s._requests["d1"] = 0.0
    s._last_sent["d1"] = 0.0
    assert s._expired_frontiers(1.0) == []  # not expired yet
    assert s._expired_frontiers(2.5) == ["d1"]  # expired: retry once
    # The retry re-armed the request: the next ticks inside the delay
    # window do NOT re-broadcast (the old behavior re-sent every tick).
    assert s._expired_frontiers(3.0) == []
    assert s._expired_frontiers(4.0) == []
    assert s._expired_frontiers(5.0) == ["d1"]  # a full delay later


def test_expired_frontiers_newest_first_capped():
    s = _bare(1.0)
    for i in range(6):
        s._requests[f"d{i}"] = float(i)  # d5 newest
        s._last_sent[f"d{i}"] = float(i)
    got = s._expired_frontiers(10.0)
    assert got == ["d5", "d4", "d3"]  # frontier cap, newest first
    # Only the retried three re-armed; the rest stay expired.
    assert s._expired_frontiers(10.0) == ["d2", "d1", "d0"]


@async_test(timeout=30)
async def test_idle_loop_never_touches_the_network():
    committee = consensus_committee(BASE)

    name = committee.sorted_keys()[0]
    s = Synchronizer(name, committee, Store(), asyncio.Queue(), 5_000)
    sent = []
    s.network = type(
        "Rec", (), {
            "send": lambda self, a, d: sent.append(("send", a)),
            "broadcast": lambda self, addrs, d: sent.append(("bcast", tuple(addrs))),
        },
    )()
    old = sync_mod.TIMER_ACCURACY
    sync_mod.TIMER_ACCURACY = 0.02
    try:
        await asyncio.sleep(0.15)  # several idle ticks
        assert sent == []
        # Register a request with an expired last-send: exactly one
        # retry broadcast per retry window.
        blocks = chain(3)
        s._requests[blocks[1].parent()] = 0.0
        s._last_sent[blocks[1].parent()] = -10.0
        await asyncio.sleep(0.15)
        bcasts = [e for e in sent if e[0] == "bcast"]
        assert len(bcasts) == 1, sent  # re-armed, not per-tick
    finally:
        sync_mod.TIMER_ACCURACY = old
        s.shutdown()


@async_test(timeout=30)
async def test_cancel_request_releases_waiter_and_store_obligation():
    # Regression: direct pulls (state-sync frontier requests) are driven
    # by unauthenticated peer claims, so the caller must be able to
    # withdraw one that will never resolve — without leaking the retry
    # entries, the waiter task, or the store's notify_read obligation.
    committee = consensus_committee(BASE + 8)
    store = Store()
    s = Synchronizer(
        committee.sorted_keys()[0], committee, store, asyncio.Queue(), 5_000
    )
    s.network = type(
        "Rec", (), {"send": lambda self, a, d: None,
                    "broadcast": lambda self, addrs, d: None},
    )()
    try:
        bogus = chain(1)[0].digest()
        s.request_block(bogus, None)
        assert s.requested(bogus)
        await asyncio.sleep(0)  # waiter reaches notify_read
        assert store._obligations
        s.cancel_request(bogus)
        await asyncio.sleep(0)  # cancellation unwinds the waiter
        assert not s.requested(bogus)
        assert not s._direct and not s._last_sent
        assert not store._obligations
        # The slot is genuinely free: the same digest can be re-requested.
        s.request_block(bogus, None)
        assert s.requested(bogus)
        # Fulfilment self-cleans the same entries without a cancel.
        await store.write(bogus.data, b"block-bytes")
        await asyncio.sleep(0)
        assert not s.requested(bogus) and not s._direct
    finally:
        s.shutdown()


@async_test(timeout=30)
async def test_suspend_timestamps_come_from_injected_clock():
    committee = consensus_committee(BASE + 5)
    blocks = chain(3)
    fake_now = [1234.5]
    s = Synchronizer(
        committee.sorted_keys()[0], committee, Store(), asyncio.Queue(),
        5_000, clock=lambda: fake_now[0],
    )
    sent = []
    s.network = type(
        "Rec", (), {
            "send": lambda self, a, d: sent.append(a),
            "broadcast": lambda self, addrs, d: None,
        },
    )()
    try:
        s._suspend(blocks[2])
        parent = blocks[2].parent()
        assert s._requests[parent] == 1234.5
        assert s._last_sent[parent] == 1234.5
        assert s.requested(parent)
        assert len(sent) == 1  # the initial targeted request
        # Re-suspending the same block is a no-op (no duplicate request).
        s._suspend(blocks[2])
        assert len(sent) == 1
    finally:
        s.shutdown()


@async_test(timeout=30)
async def test_suspend_on_an_own_block_asks_a_voter_of_its_parent():
    """A replica whose store was lost meets a block it authored itself
    (before the loss, or proposed since on a QC it holds without the
    block): the request for the parent goes to a peer that voted for the
    parent, not to its own empty store."""
    committee = consensus_committee(BASE + 9)
    blocks = chain(3)
    own = blocks[2]
    s = Synchronizer(own.author, committee, Store(), asyncio.Queue(), 5_000)
    sent = []
    s.network = type(
        "Rec", (), {
            "send": lambda self, a, d: sent.append(a),
            "broadcast": lambda self, addrs, d: None,
        },
    )()
    try:
        s._suspend(own)
        voters = {committee.address(pk) for pk, _ in own.qc.votes if pk != own.author}
        assert len(sent) == 1 and sent[0] in voters, (sent, voters)
        assert sent[0] != committee.address(own.author)
        # Another's block still asks its author, as the reference does.
        s._suspend(blocks[1])
        assert sent[1] == committee.address(blocks[1].author)
    finally:
        s.shutdown()


# -- twins of tests/test_consensus_helper.py ----------------------------------


@async_test
async def test_helper_serves_stored_block():
    committee = consensus_committee(BASE + 20)
    store = Store()
    block = chain(1)[0]
    await store.write(block.digest().data, block.serialize())

    rx: asyncio.Queue = asyncio.Queue()
    Helper.spawn(committee, store, rx)

    requestor = keys()[1][0]
    task = asyncio.create_task(listener(committee.address(requestor)[1]))
    await asyncio.sleep(0.05)
    await rx.put((block.digest(), requestor))
    frame = await asyncio.wait_for(task, 5)
    kind, replied = decode_message(frame)
    assert kind == "propose"
    assert replied.digest() == block.digest()


@async_test
async def test_helper_survives_corrupt_stored_block():
    """A corrupt stored block must not kill the helper task: later requests
    for healthy blocks are still served."""
    committee = consensus_committee(BASE + 30)
    store = Store()
    block = chain(1)[0]
    await store.write(block.digest().data, block.serialize())
    from hotstuff_tpu_torch.crypto import sha512_digest

    corrupt = sha512_digest(b"corrupt")
    await store.write(corrupt.data, b"\xff garbage not a block")

    rx: asyncio.Queue = asyncio.Queue()
    helper_task = Helper.spawn(committee, store, rx)
    requestor = keys()[1][0]
    await rx.put((corrupt, requestor))  # deserialization fails
    await asyncio.sleep(0.1)
    assert not helper_task.done(), "helper died on a corrupt stored block"

    task = asyncio.create_task(listener(committee.address(requestor)[1]))
    await asyncio.sleep(0.05)
    await rx.put((block.digest(), requestor))
    frame = await asyncio.wait_for(task, 5)
    kind, replied = decode_message(frame)
    assert kind == "propose" and replied.digest() == block.digest()


@async_test
async def test_helper_ignores_unknown_digest_and_stranger():
    from hotstuff_tpu_torch.crypto import generate_keypair, sha512_digest

    committee = consensus_committee(BASE + 40)
    store = Store()
    rx: asyncio.Queue = asyncio.Queue()
    Helper.spawn(committee, store, rx)
    stranger, _ = generate_keypair(seed=b"\x55" * 32)
    await rx.put((sha512_digest(b"unknown"), stranger))  # unknown requestor
    await rx.put((sha512_digest(b"unknown"), keys()[1][0]))  # unknown block
    await asyncio.sleep(0.2)  # nothing to assert beyond "no crash/no send"


@async_test
async def test_helper_rate_limits_snapshot_replies_per_origin():
    """Regression: the request's origin field is unsigned and spoofable,
    and a snapshot reply is heavy (two blocks + a 2f+1-signature QC) —
    spraying unknown digests with a victim's origin must not have the
    helper amplify traffic at the victim. At most one snapshot reply per
    origin per half retry window, checked BEFORE the meta read."""
    # The record is written in the reference's format (the port has no
    # compactor to write one); the port's helper peeks its frontier.
    from hotstuff_tpu.consensus.statesync import encode_snapshot
    from hotstuff_tpu_torch.consensus.statesync import SNAPSHOT_KEY

    committee = consensus_committee(BASE + 50)
    j_blocks = Env("reference").chain(4)
    snapshot = encode_snapshot(j_blocks[1], j_blocks[2], j_blocks[3].qc)

    class _CountingStore(Store):
        def __init__(self):
            super().__init__()
            self.meta_reads = 0

        async def read_meta(self, key):
            self.meta_reads += 1
            return await super().read_meta(key)

    store = _CountingStore()
    await store.write_meta(SNAPSHOT_KEY, snapshot)
    rx: asyncio.Queue = asyncio.Queue()
    # sync_retry_delay=10s -> 5s window: the burst below fits inside it.
    Helper.spawn(committee, store, rx, sync_retry_delay=10_000)
    from hotstuff_tpu_torch.crypto import sha512_digest

    victim = keys()[1][0]
    for i in range(5):
        await rx.put((sha512_digest(b"unknown%d" % i), victim))
    await asyncio.sleep(0.2)
    assert store.meta_reads == 1  # one snapshot reply, 4 requests shed
    # A different origin is NOT throttled by the victim's bucket.
    other = keys()[2][0]
    await rx.put((sha512_digest(b"unknown-other"), other))
    await asyncio.sleep(0.1)
    assert store.meta_reads == 2


# -- twins of tests/test_leader_reputation.py's unit tests ----------------------


def test_make_elector_kinds():
    committee = consensus_committee(BASE)
    assert isinstance(make_elector(committee, "round-robin"), RRLeaderElector)
    assert isinstance(make_elector(committee, "rr"), RRLeaderElector)
    assert isinstance(
        make_elector(committee, "reputation"), ReputationLeaderElector
    )
    try:
        make_elector(committee, "bogus")
        raise AssertionError("unknown elector kind accepted")
    except ValueError:
        pass


def test_empty_window_falls_back_to_round_robin():
    committee = consensus_committee(BASE)
    rep = ReputationLeaderElector(committee)
    rr = RRLeaderElector(committee)
    for r in range(10):
        assert rep.get_leader(r) == rr.get_leader(r)


def test_deterministic_across_instances():
    """Two nodes feeding identical committed blocks elect identical
    leaders for every round — the agreement requirement."""
    committee = consensus_committee(BASE)
    blocks = chain(3)
    a = ReputationLeaderElector(committee)
    b = ReputationLeaderElector(committee)
    for blk in blocks:
        a.update(blk)
        b.update(blk)
    for r in range(4, 40):
        assert a.get_leader(r) == b.get_leader(r)


def test_nonparticipant_is_not_elected():
    """A validator absent from the committed window (crashed: no blocks
    authored, no QC votes) must never be chosen once the window has
    data — round-robin would keep burning a timeout on it every N
    rounds."""
    committee = consensus_committee(BASE)
    all_keys = [pk for pk, _ in keys(4)]
    rep = ReputationLeaderElector(committee)
    blocks = chain(3)  # authored/signed by a quorum subset
    participants = set()
    for blk in blocks:
        rep.update(blk)
        participants.add(blk.author)
        participants.update(pk for pk, _ in blk.qc.votes)
    absent = [pk for pk in all_keys if pk not in participants]
    # chain(3) uses 3-of-4 quorums; with a fixed vote set one validator
    # can be absent. Skip silently if the fixture happened to use all 4.
    # Elections below blocks[-1].round + LAG still use the boot fallback
    # (round-lagged anchoring), so assert from there on.
    start = blocks[-1].round + ReputationLeaderElector.LAG
    for r in range(start, start + 200):
        leader = rep.get_leader(r)
        assert leader in participants
        assert leader not in absent


def test_recent_author_excluded():
    committee = consensus_committee(BASE)
    rep = ReputationLeaderElector(committee, exclude=1)
    blocks = chain(2)
    for blk in blocks:
        rep.update(blk)
    last_author = blocks[-1].author
    start = blocks[-1].round + ReputationLeaderElector.LAG
    for r in range(start, start + 100):
        assert rep.get_leader(r) != last_author


# -- the two packages' electors and helpers on the same inputs -----------------


@pytest.mark.parametrize("kind", ["round-robin", "reputation"])
def test_electors_agree_across_packages(kind):
    """The same committed chain (and TC-entered rounds) fed to both
    packages' electors gives the same leader for every round."""
    envs = {name: Env(name) for name in ("port", "reference")}
    make = {"port": make_elector, "reference": j_leader.make_elector}
    electors = {name: make[name](env.committee, kind) for name, env in envs.items()}
    chains = {name: env.chain(12) for name, env in envs.items()}
    leaders = {name: [] for name in envs}
    for i in range(12):
        for name, el in electors.items():
            el.update(chains[name][i])
            if i % 5 == 4:
                el.note_round_entry(i + 3, via_tc=True)
            leaders[name].append([envs[name].index(el.get_leader(r)) for r in range(1, 40)])
    assert leaders["port"] == leaders["reference"]


@async_test
async def test_helper_replies_byte_identical_to_the_reference():
    """Both packages' helpers answer the same sync request (a block with
    two stored ancestors) with the same frames, newest first."""
    import hotstuff_tpu.consensus.helper as j_helper
    import hotstuff_tpu.store as j_store

    got = {}
    for name, helper_cls, store_cls, port in (
        ("port", Helper, Store, BASE + 60),
        ("reference", j_helper.Helper, j_store.Store, BASE + 70),
    ):
        env = Env(name)
        committee = env.pkg.config.Committee(
            {pk: env.pkg.config.Authority(1, ("127.0.0.1", port + i)) for i, (pk, _) in enumerate(env.keys)}
        )
        store = store_cls()
        blocks = env.chain(3)
        for b in blocks:
            await store.write(b.digest().data, b.serialize())
        frames = []
        done = asyncio.Event()

        async def handle(reader, writer):
            from hotstuff_tpu_torch.network.receiver import read_frames

            buf = bytearray()
            while len(frames) < 3:
                frames.extend(await read_frames(reader, buf))
            done.set()
            writer.close()

        server = await asyncio.start_server(handle, "127.0.0.1", port + 1)
        rx: asyncio.Queue = asyncio.Queue()
        task = helper_cls.spawn(committee, store, rx)
        await rx.put((blocks[2].digest(), env.keys[1][0]))
        await asyncio.wait_for(done.wait(), 10)
        task.cancel()
        server.close()
        got[name] = frames
    assert got["port"] == got["reference"]
    kinds = [decode_message(f)[0] for f in got["port"]]
    assert kinds == ["propose"] * 3
    assert [decode_message(f)[1].round for f in got["port"]] == [3, 2, 1]
