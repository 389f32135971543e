"""The port's consensus core against the JAX package's, on the CPU.

Three groups.

1. Parity. Twins of ``tests/test_consensus_core.py`` and
   ``tests/test_batch_vote_verification.py``: the same scenario drives the
   port's ``Core`` and the reference's through the ``network=`` and
   ``timer=`` seams (an outbox that records each frame, a timer that
   expires only when a test injects ``("timer", round)``), with the same
   keys and messages built in each package. Ed25519 signing is
   deterministic, so everything each core emits must be byte-identical:
   the frames it sends and broadcasts, its synchronizer's sync requests,
   what it hands its proposer and mempool, the blocks it commits and the
   voting state it persists. The reference tests' own expectations are
   checked on top.
2. The crypto bridge's gate: card backends (``cuda``, ``cuda+superbatch``)
   always leave the event loop; the ``cpu`` backend runs small
   verifications inline. ``CudaBackend``'s counters under two concurrent
   verifications.
3. A device failure on the certificate path: what each core does when
   ``BatchingBackend``'s inner backend raises ``BackendUnavailable``.
"""

import asyncio
import threading

import pytest

import hotstuff_tpu.consensus.core as j_core
import hotstuff_tpu.consensus.crypto_bridge as j_bridge
import hotstuff_tpu.consensus.leader as j_leader
import hotstuff_tpu.consensus.mempool_driver as j_driver
import hotstuff_tpu.consensus.proposer as j_proposer
import hotstuff_tpu.consensus.synchronizer as j_sync
import hotstuff_tpu.store as j_store
import hotstuff_tpu_torch.consensus.core as t_core
import hotstuff_tpu_torch.consensus.crypto_bridge as t_bridge
import hotstuff_tpu_torch.consensus.leader as t_leader
import hotstuff_tpu_torch.consensus.mempool_driver as t_driver
import hotstuff_tpu_torch.consensus.proposer as t_proposer
import hotstuff_tpu_torch.consensus.synchronizer as t_sync
import hotstuff_tpu_torch.store as t_store
from hotstuff_tpu_torch.crypto.cuda_backend import CudaBackend

from .common import async_test
from .test_torch_wire import PKGS

for _name, _mods in (
    ("port", dict(core=t_core, bridge=t_bridge, leader=t_leader, driver=t_driver,
                  proposer=t_proposer, sync=t_sync, store=t_store)),
    ("reference", dict(core=j_core, bridge=j_bridge, leader=j_leader, driver=j_driver,
                       proposer=j_proposer, sync=j_sync, store=j_store)),
):
    for _k, _v in _mods.items():
        setattr(PKGS[_name], _k, _v)

N = 4
BASE = 21200  # addresses only: the seams keep every frame off the sockets


@pytest.fixture(autouse=True)
def isolate(monkeypatch):
    """Each package's serial CPU backend and fresh arenas around every test
    (a QC verified by an earlier test would otherwise be an arena hit)."""
    monkeypatch.delenv("HOTSTUFF_AGG_QC", raising=False)
    monkeypatch.delenv("HOTSTUFF_CERT_ARENA", raising=False)
    for pkg in PKGS.values():
        monkeypatch.setattr(pkg.crypto, "_BACKEND", None)
        pkg.cert_arena.reset()
    PKGS["port"].crypto.set_backend(PKGS["port"].crypto.CpuBackend())
    PKGS["reference"].crypto.set_backend("cpu")
    yield
    for pkg in PKGS.values():
        pkg.cert_arena.reset()


# -- the harness ---------------------------------------------------------------


class Outbox:
    """The network seam: records each frame with its destination ports."""

    def __init__(self):
        self.frames = []

    def send(self, address, data):
        self.frames.append(("send", address[1], bytes(data)))

    def broadcast(self, addresses, data):
        self.frames.append(("broadcast", tuple(a[1] for a in addresses), bytes(data)))

    def shutdown(self):
        pass


class StillTimer:
    """The timer seam: never expires by itself (tests inject expiries)."""

    def __init__(self):
        self.resets = 0

    def reset(self):
        self.resets += 1

    async def wait(self):
        await asyncio.get_running_loop().create_future()


class Env:
    """One committee of ``N`` seeded keys in one package, with makers of its
    messages (the keys of ``tests/common.keys``)."""

    def __init__(self, name: str):
        import random

        self.name = name
        self.pkg = pkg = PKGS[name]
        rng = random.Random(0)
        self.keys = [pkg.crypto.generate_keypair(seed=rng.randbytes(32))[:2] for _ in range(N)]
        self.committee = pkg.config.Committee(
            {pk: pkg.config.Authority(1, ("127.0.0.1", BASE + i)) for i, (pk, _) in enumerate(self.keys)}
        )
        self.seats = pkg.messages.SeatTable.for_committee(self.committee)
        self.sorted = self.committee.sorted_keys()
        self.secret = dict(self.keys)

    def leader(self, round_: int):
        return self.sorted[round_ % N]

    def index(self, pk) -> int:
        return [k for k, _ in self.keys].index(pk)

    def qc_over(self, block, signers=(0, 1, 2)):
        m = self.pkg.messages
        qc = m.QC(hash=block.digest(), round=block.round, votes=[])
        qc.votes = [(self.keys[i][0], self.pkg.crypto.Signature.new(qc.digest(), self.keys[i][1]))
                    for i in signers]
        return qc

    def block(self, round_: int, qc, payload=(), tc=None):
        author = self.leader(round_)
        digests = [self.pkg.crypto.sha512_digest(p) for p in payload]
        return self.pkg.messages.Block.new_from_key(qc, tc, author, round_, digests, self.secret[author])

    def chain(self, n: int):
        """Blocks 1..n from genesis, each by its round's leader, each QC
        signed by keys 0, 1, 2 (``tests/common.chain``'s shape)."""
        blocks, qc = [], self.pkg.messages.QC.genesis()
        for r in range(1, n + 1):
            blocks.append(self.block(r, qc))
            qc = self.qc_over(blocks[-1])
        return blocks

    def vote(self, block, signer: int):
        pk, sk = self.keys[signer]
        return self.pkg.messages.Vote.new_from_key(block.digest(), block.round, pk, sk)

    def timeout(self, round_: int, signer: int, high_qc=None):
        pk, sk = self.keys[signer]
        high_qc = self.pkg.messages.QC.genesis() if high_qc is None else high_qc
        return self.pkg.messages.Timeout.new_from_key(high_qc, round_, pk, sk)

    def wire(self, kind: str, obj, v2: bool = False):
        """``obj`` as it arrives off the wire: encoded (v2 with ``v2``) and
        decoded by this package."""
        m = self.pkg.messages
        seats = self.seats if v2 else None
        enc = {"propose": m.encode_propose, "timeout": m.encode_timeout, "tc": m.encode_tc}[kind]
        got_kind, got = m.decode_message(enc(obj, seats), self.seats)
        assert got_kind == kind
        return got


class Node:
    """A Core of ``env`` at key ``idx`` behind the seams, running on a
    queue the test feeds; its synchronizer's sender is an outbox too."""

    def __init__(self, env: Env, idx: int, store=None, **core_kwargs):
        pkg = env.pkg
        self.env = env
        self.pk, sk = env.keys[idx]
        self.store = store if store is not None else pkg.store.Store()
        self.rx, self.proposer, self.commit, self.mempool = (asyncio.Queue() for _ in range(4))
        self.out, self.timer = Outbox(), StillTimer()
        self.sync = pkg.sync.Synchronizer(self.pk, env.committee, self.store, self.rx, 10_000)
        self.sync.network = Outbox()
        driver = pkg.driver.MempoolDriver(self.store, self.mempool, self.rx)
        self.core = pkg.core.Core(
            self.pk, env.committee, pkg.crypto.SignatureService(sk), self.store,
            pkg.leader.RRLeaderElector(env.committee), driver, self.sync, 10_000,
            self.rx, self.rx, self.proposer, self.commit,
            network=self.out, timer=self.timer, **core_kwargs,
        )
        self.task = asyncio.create_task(self.core.run())

    async def put(self, kind: str, payload) -> None:
        await self.rx.put((kind, payload))
        await self.settle()

    async def settle(self) -> None:
        """Let the core drain its queue (every verification is inline)."""
        for _ in range(400):
            await asyncio.sleep(0)
            if self.rx.empty():
                break
        for _ in range(20):
            await asyncio.sleep(0)

    def stop(self) -> None:
        self.task.cancel()
        self.sync.shutdown()

    async def snapshot(self) -> dict:
        """Everything the core emitted so far, package-free."""
        pkg = self.env.pkg

        def qc_bytes(qc):
            enc = pkg.serde.Encoder()
            qc.encode(enc)
            return enc.finish()

        proposer = []
        while not self.proposer.empty():
            msg = self.proposer.get_nowait()
            if isinstance(msg, pkg.proposer.Make):
                tc = None
                if msg.tc is not None:
                    enc = pkg.serde.Encoder()
                    msg.tc.encode(enc)
                    tc = enc.finish()
                proposer.append(("make", msg.round, qc_bytes(msg.qc), tc))
            else:
                proposer.append(("cleanup", sorted(d.data for d in msg.digests)))
        mempool = []
        while not self.mempool.empty():
            msg = self.mempool.get_nowait()
            mempool.append((type(msg).__name__, getattr(msg, "round", None),
                            [d.data for d in getattr(msg, "digests", [])]))
        commits = []
        while not self.commit.empty():
            commits.append(self.commit.get_nowait().digest().data)
        core = self.core
        return {
            "frames": list(self.out.frames),
            "sync_frames": list(self.sync.network.frames),
            "proposer": proposer,
            "mempool": mempool,
            "commits": commits,
            "state": await self.store.read_meta(b"__consensus_state__"),
            "round": core.round,
            "last_voted_round": core.last_voted_round,
            "last_committed_round": core.last_committed_round,
            "high_qc": (core.high_qc.round, core.high_qc.hash.data),
            "timer_resets": self.timer.resets,
        }


async def both(scenario) -> dict:
    """Run ``scenario(env)`` on each package; its snapshots must agree.
    Returns the port's."""
    out = {}
    for name in ("reference", "port"):
        out[name] = await scenario(Env(name))
    assert out["port"] == out["reference"]
    return out["port"]


def frames_of(snap, kind: str):
    """The decoded frames of ``kind`` the core sent (decoded by the port)."""
    m = PKGS["port"].messages
    got = []
    for how, ports, data in snap["frames"]:
        k, obj = m.decode_message(data, Env("port").seats)
        if k == kind:
            got.append((how, ports, obj))
    return got


def not_leading(env: Env, *rounds) -> int:
    lead = {env.index(env.leader(r)) for r in rounds}
    return next(i for i in range(N) if i not in lead)


# -- 1. parity: twins of tests/test_consensus_core.py --------------------------


@async_test
async def test_proposal_sends_vote_to_next_leader():
    async def scenario(env):
        node = Node(env, not_leading(env, 1, 2))
        await node.put("propose", env.chain(1)[0])
        node.stop()
        return await node.snapshot()

    snap = await both(scenario)
    env = Env("port")
    (how, port, vote), = frames_of(snap, "vote")
    assert how == "send" and port == env.committee.address(env.leader(2))[1]
    assert vote.hash == env.chain(1)[0].digest() and vote.round == 1
    vote.verify(env.committee)
    assert snap["last_voted_round"] == 1 and snap["state"] is not None


@async_test
async def test_quorum_of_votes_triggers_proposal():
    async def scenario(env):
        block = env.chain(1)[0]
        node = Node(env, env.index(env.leader(2)))
        for i in range(3):
            await node.put("vote", env.vote(block, i))
        node.stop()
        return await node.snapshot()

    snap = await both(scenario)
    makes = [p for p in snap["proposer"] if p[0] == "make"]
    assert [p[1] for p in makes] == [2] and snap["round"] == 2


@async_test
async def test_chain_commits_first_block():
    async def scenario(env):
        node = Node(env, 0)
        for b in env.chain(3):
            await node.put("propose", b)
        node.stop()
        return await node.snapshot()

    snap = await both(scenario)
    env = Env("port")
    assert snap["commits"] == [env.chain(1)[0].digest().data]
    # A vote to the next leader is a frame, unless node 0 leads next.
    sent = [r for r in (1, 2, 3) if env.leader(r + 1) != env.keys[0][0]]
    assert [v.round for _, _, v in frames_of(snap, "vote")] == sent
    assert ("Cleanup", 1, []) in snap["mempool"]


@async_test
async def test_local_timeout_broadcasts_timeout_message():
    async def scenario(env):
        node = Node(env, 0, wire_seats=env.seats)
        await node.put("timer", 1)
        node.stop()
        return await node.snapshot()

    snap = await both(scenario)
    (how, ports, timeout), = frames_of(snap, "timeout")
    env = Env("port")
    assert how == "broadcast" and len(ports) == N - 1
    assert timeout.round == 1 and timeout.author == env.keys[0][0]
    timeout.verify(env.committee)
    assert snap["last_voted_round"] == 1


@async_test
async def test_voting_state_survives_restart():
    """After voting in round 1 and restarting on the same store, the node
    refuses to vote for a conflicting round-1 block."""

    async def scenario(env):
        store = env.pkg.store.Store()
        me = not_leading(env, 1, 2)
        node = Node(env, me, store=store)
        await node.put("propose", env.chain(1)[0])
        node.stop()
        first = await node.snapshot()
        again = Node(env, me, store=store)
        await again.settle()
        conflicting = env.block(1, env.pkg.messages.QC.genesis(), payload=[b"other"])
        await again.put("propose", conflicting)
        again.stop()
        return {"first": first, "again": await again.snapshot()}

    snap = await both(scenario)
    assert len(frames_of(snap["first"], "vote")) == 1
    assert frames_of(snap["again"], "vote") == []
    assert snap["again"]["last_voted_round"] == 1


@async_test
async def test_sync_request_on_missing_parent():
    async def scenario(env):
        blocks = env.chain(3)
        node = Node(env, 0)
        await node.put("propose", blocks[2])
        requests = list(node.sync.network.frames)
        for b in blocks[:2]:
            await node.store.write(b.digest().data, b.serialize())
        await node.settle()
        node.stop()
        return {"requests": requests, **await node.snapshot()}

    # Node 0 authored blocks[2] itself. The packages part on where the
    # request goes: the reference asks the block's author, here itself, and
    # the port asks a peer that signed the block's QC (ROADMAP §3 F4).
    # Everything else is the same.
    snaps = {name: await scenario(Env(name)) for name in ("reference", "port")}
    sent = {name: snap.pop("requests") for name, snap in snaps.items()}
    assert snaps["reference"].pop("sync_frames") == sent["reference"]
    assert snaps["port"].pop("sync_frames") == sent["port"]
    assert snaps["port"] == snaps["reference"]
    env = Env("port")
    blocks = env.chain(3)
    assert blocks[2].author == env.keys[0][0]
    (ref_how, ref_port, ref_data), = sent["reference"]
    (how, port, data), = sent["port"]
    assert ref_how == how == "send" and ref_data == data
    assert ref_port == env.committee.address(blocks[2].author)[1]
    voters = {env.committee.address(pk)[1] for pk, _ in blocks[2].qc.votes if pk != env.keys[0][0]}
    assert port in voters
    kind, (digest, origin) = PKGS["port"].messages.decode_message(data)
    assert kind == "sync_request" and digest == blocks[1].digest() and origin == env.keys[0][0]
    assert snaps["port"]["commits"] == [blocks[0].digest().data]


@async_test
async def test_stale_timer_event_does_not_suppress_vote():
    async def scenario(env):
        blocks = env.chain(3)
        node = Node(env, 0)
        await node.put("propose", blocks[0])
        await node.put("propose", blocks[1])  # round 2 via qc1
        await node.put("timer", 1)  # stale: fired in round 1
        await node.put("propose", blocks[2])
        node.stop()
        return await node.snapshot()

    snap = await both(scenario)
    env = Env("port")
    sent = [r for r in (1, 2, 3) if env.leader(r + 1) != env.keys[0][0]]
    assert [v.round for _, _, v in frames_of(snap, "vote")] == sent
    assert frames_of(snap, "timeout") == [] and snap["last_voted_round"] == 3


@async_test
async def test_commit_walk_never_recommits_across_round_gaps():
    async def scenario(env):
        node = Node(env, 0)
        await node.settle()
        genesis = env.pkg.messages.QC.genesis()
        b1 = env.block(1, genesis)
        b2 = env.block(2, env.qc_over(b1))
        b4 = env.block(4, env.qc_over(b2))
        b5 = env.block(5, env.qc_over(b4))
        for b in (b1, b2, b4):
            await node.core.store_block(b)
        await node.core.commit(b2)
        await node.core.commit(b5)
        node.stop()
        snap = await node.snapshot()
        snap["rounds"] = [b1, b2, b4, b5]
        snap["rounds"] = [b.round for b in snap["rounds"] if b.digest().data in snap["commits"]]
        return snap

    snap = await both(scenario)
    assert snap["rounds"] == [1, 2, 4, 5] and len(snap["commits"]) == 4


@async_test
async def test_timeouts_make_a_tc_and_amplify_v2():
    """View change, v2 wire: 2f+1 timeouts at round 1 form a TC, which is
    broadcast and, at the round-2 leader, proposed on; then f+1 timeouts
    for round 4 make the node amplify its own round-4 timeout."""

    async def scenario(env):
        node = Node(env, env.index(env.leader(2)), wire_seats=env.seats)
        others = [i for i in range(N) if env.keys[i][0] != node.pk]
        for i in others:
            await node.put("timeout", env.wire("timeout", env.timeout(1, i), v2=True))
        for i in others[:2]:
            await node.put("timeout", env.wire("timeout", env.timeout(4, i), v2=True))
        node.stop()
        return await node.snapshot()

    snap = await both(scenario)
    # The amplified timeout is the third at round 4: a second TC forms.
    tcs = frames_of(snap, "tc")
    assert [(how, tc.round, tc.n_votes()) for how, _, tc in tcs] == [("broadcast", 1, 3), ("broadcast", 4, 3)]
    assert [t.round for _, _, t in frames_of(snap, "timeout")] == [4]
    assert snap["last_voted_round"] == 4 and snap["round"] == 5
    assert [p[1] for p in snap["proposer"] if p[0] == "make" and p[3] is not None] == [2]


@async_test
async def test_v2_proposals_commit_and_tc_extends():
    """Proposals off the v2 wire (a lazy QC in each) commit, and a block
    that extends a TC gets the vote that safety rule 2 allows."""

    async def scenario(env):
        node = Node(env, 0, wire_seats=env.seats)
        blocks = env.chain(2)
        for b in blocks:
            await node.put("propose", env.wire("propose", b, v2=True))
        tc_votes = []
        for i in range(3):
            t = env.timeout(2, i, high_qc=env.qc_over(blocks[0]))
            tc_votes.append((t.author, t.signature, t.high_qc.round))
        tc = env.pkg.messages.TC(round=2, votes=tc_votes)
        b3 = env.block(3, env.qc_over(blocks[0]), tc=tc)
        await node.put("propose", env.wire("propose", b3, v2=True))
        node.stop()
        return await node.snapshot()

    snap = await both(scenario)
    env = Env("port")
    sent = [r for r in (1, 2, 3) if env.leader(r + 1) != env.keys[0][0]]
    assert [v.round for _, _, v in frames_of(snap, "vote")] == sent
    assert snap["last_voted_round"] == 3


# -- 1. parity: twins of tests/test_batch_vote_verification.py -----------------


async def _make_after(node, round_: int) -> bool:
    for _ in range(3):
        await node.settle()
    return any(isinstance(m, node.env.pkg.proposer.Make) and m.round == round_
               for m in list(node.proposer._queue))


@async_test
async def test_batched_votes_make_verified_qc():
    async def scenario(env):
        block = env.chain(1)[0]
        node = Node(env, env.index(env.leader(2)), batch_vote_verification=True)
        for i in range(3):
            await node.put("vote", env.vote(block, i))
        assert await _make_after(node, 2)
        node.stop()
        return await node.snapshot()

    await both(scenario)


@pytest.mark.parametrize("bogus_digest", [False, True])
@async_test
async def test_spoofed_vote_cannot_displace_honest_vote(bogus_digest):
    """A garbage signature under an honest author's key arrives first (for
    the real block, or for a fabricated digest): the genuine vote is still
    verified individually, re-seated, and the QC forms."""

    async def scenario(env):
        m = env.pkg.messages
        block = env.chain(1)[0]
        node = Node(env, env.index(env.leader(2)), batch_vote_verification=True)
        target = env.pkg.crypto.sha512_digest(b"bogus") if bogus_digest else block.digest()
        spoof = m.Vote(target, 1, env.keys[0][0], env.pkg.crypto.Signature(b"\x09" * 64))
        await node.put("vote", spoof)
        order = [1, 2, 0] if bogus_digest else [0, 1, 2]
        for i in order:
            await node.put("vote", env.vote(block, i))
        assert await _make_after(node, 2)
        node.stop()
        return await node.snapshot()

    await both(scenario)


@async_test
async def test_future_round_votes_bounded():
    async def scenario(env):
        block = env.chain(1)[0]
        node = Node(env, 0, batch_vote_verification=True)
        pk, sk = env.keys[1]
        await node.put("vote", env.pkg.messages.Vote.new_from_key(block.digest(), 10_000_000, pk, sk))
        assert 10_000_000 not in node.core.aggregator.votes_aggregators
        node.stop()
        return await node.snapshot()

    await both(scenario)


@async_test
async def test_byzantine_vote_ejected_and_quorum_recovers():
    async def scenario(env):
        m = env.pkg.messages
        block = env.chain(1)[0]
        node = Node(env, env.index(env.leader(2)), batch_vote_verification=True)
        bad = m.Vote(block.digest(), 1, env.keys[2][0], env.pkg.crypto.Signature(b"\x07" * 64))
        for v in (env.vote(block, 0), env.vote(block, 1), bad):
            await node.put("vote", v)
        assert not await _make_after(node, 2)
        assert node.core._bad_sigs[1]
        await node.put("vote", env.vote(block, 3))
        assert await _make_after(node, 2)
        node.stop()
        return await node.snapshot()

    await both(scenario)


@async_test(timeout=30)
async def test_backend_outage_does_not_blacklist_honest_votes():
    """A transient backend failure while the assembled QC verifies leaves
    the votes unjudged; the QC is retried and forms once the backend is
    back."""

    async def scenario(env):
        crypto = env.pkg.crypto
        real = crypto.get_backend()

        class Outage:
            name = "outage"
            fail = True

            def verify_batch(self, msgs, pubs, sigs):
                if Outage.fail:
                    raise crypto.BackendUnavailable("tunnel died")
                real.verify_batch(msgs, pubs, sigs)

        crypto.set_backend(Outage())
        block = env.chain(1)[0]
        node = Node(env, env.index(env.leader(2)), batch_vote_verification=True)
        for i in range(3):
            await node.put("vote", env.vote(block, i))
        assert not await _make_after(node, 2) and not node.task.done()
        assert not node.core._bad_sigs.get(1)
        Outage.fail = False
        await asyncio.sleep(0.4)  # the first retry fires after 0.25 s
        assert await _make_after(node, 2)
        node.stop()
        crypto.set_backend(real)
        return await node.snapshot()

    await both(scenario)


def _aggregator_env(pkg_name: str, stakes=(1, 1, 1, 1)):
    pkg = PKGS[pkg_name]
    env = Env(pkg_name)
    committee = pkg.config.Committee(
        {pk: pkg.config.Authority(s, ("127.0.0.1", BASE + i))
         for i, ((pk, _), s) in enumerate(zip(env.keys, stakes))}
    )
    return env, pkg, committee, pkg.aggregator.Aggregator(committee)


@pytest.mark.parametrize("pkg_name", ["port", "reference"])
def test_rebuild_emits_qc_when_good_votes_meet_quorum(pkg_name):
    """Unequal stakes (1, 1, 3): ejecting a vote that was not load-bearing
    leaves a quorum, and the rebuild emits the QC."""
    env, pkg, committee, agg = _aggregator_env(pkg_name, stakes=(1, 1, 3))
    committee.authorities = dict(list(committee.authorities.items())[:3])
    agg = pkg.aggregator.Aggregator(committee)
    block = env.chain(1)[0]
    bad_b = pkg.messages.Vote(block.digest(), 1, env.keys[1][0], pkg.crypto.Signature(b"\x03" * 64))
    assert agg.add_vote(bad_b) is None
    assert agg.add_vote(env.vote(block, 0)) is None
    qc = agg.add_vote(env.vote(block, 2))
    assert qc is not None
    bad = [(pk, sig) for pk, sig in qc.votes if pk == env.keys[1][0]]
    rebuilt, ejected = agg.eject_votes(qc.round, qc.digest(), bad, qc.hash)
    assert ejected == {env.keys[1][0]} and rebuilt is not None
    rebuilt.verify(committee)


@pytest.mark.parametrize("pkg_name", ["port", "reference"])
def test_eject_votes_keeps_replaced_genuine_signature(pkg_name):
    env, pkg, committee, agg = _aggregator_env(pkg_name)
    committee.authorities = dict(list(committee.authorities.items())[:3])
    agg = pkg.aggregator.Aggregator(committee)
    block = env.chain(1)[0]
    spoofed = pkg.messages.Vote(block.digest(), 1, env.keys[1][0], pkg.crypto.Signature(b"\x07" * 64))
    assert agg.add_vote(spoofed) is None
    assert agg.add_vote(env.vote(block, 0)) is None
    stale_qc = agg.add_vote(env.vote(block, 2))
    assert stale_qc is not None
    agg.replace_vote(env.vote(block, 1))
    bad = [(pk, sig) for pk, sig in stale_qc.votes if pk == env.keys[1][0]]
    fixed, ejected = agg.eject_votes(stale_qc.round, stale_qc.digest(), bad, stale_qc.hash)
    assert ejected == set() and fixed is not None
    fixed.verify(committee)


@pytest.mark.parametrize("pkg_name", ["port", "reference"])
def test_aggregator_one_bucket_per_author(pkg_name):
    env, pkg, committee, agg = _aggregator_env(pkg_name)
    pk = env.keys[0][0]
    sha = pkg.crypto.sha512_digest
    agg.add_vote(pkg.messages.Vote(sha(b"digest0"), 3, pk, pkg.crypto.Signature(b"\x01" * 64)))
    for i in range(1, 10):
        with pytest.raises(pkg.errors.AuthorityReuse):
            agg.add_vote(pkg.messages.Vote(sha(b"digest%d" % i), 3, pk, pkg.crypto.Signature(b"\x01" * 64)))
    assert len(agg.votes_aggregators[3]) == 1
    block = env.chain(1)[0]
    qc = None
    for hpk, hsk in env.keys[1:4]:
        qc = agg.add_vote(pkg.messages.Vote.new_from_key(block.digest(), 3, hpk, hsk))
    assert qc is not None and qc.hash == block.digest()


@pytest.mark.parametrize("pkg_name", ["port", "reference"])
def test_reseat_vote_moves_author_across_buckets(pkg_name):
    env, pkg, committee, agg = _aggregator_env(pkg_name)
    block = env.chain(1)[0]
    bogus = pkg.messages.Vote(pkg.crypto.sha512_digest(b"bogus"), 1, env.keys[0][0],
                              pkg.crypto.Signature(b"\x02" * 64))
    agg.add_vote(bogus)
    for i in (1, 2):
        assert agg.add_vote(env.vote(block, i)) is None
    qc = agg.reseat_vote(env.vote(block, 0))
    assert qc is not None and qc.hash == block.digest()
    qc.verify(committee)
    assert bogus.digest() not in agg.votes_aggregators[1]


# -- 2. the crypto bridge's gate ------------------------------------------------


class _Named:
    def __init__(self, name):
        self.name = name

    def verify_batch(self, msgs, pubs, sigs):
        pass


@pytest.mark.parametrize("backend", ["cpu", "cuda", "cuda+superbatch"])
@async_test
async def test_verify_off_loop_gates_inline_on_backend_and_batch_size(backend):
    """Card backends always leave the event loop, whatever the batch size;
    the CPU backend runs small verifications inline and large ones in the
    pool (the reference looks for "tpu" in the name, the port for "cuda")."""
    PKGS["port"].crypto.set_backend(_Named(backend))
    loop_thread = threading.get_ident()
    seen = {}

    def probe():
        seen["thread"] = threading.get_ident()
        return 42

    assert await t_bridge.verify_off_loop(probe) == 42
    assert (seen["thread"] == loop_thread) == (backend == "cpu")
    assert await t_bridge.verify_off_loop(probe, n_sigs=t_bridge.INLINE_SIG_LIMIT) == 42
    assert seen["thread"] != loop_thread


@async_test
async def test_reference_gate_for_comparison():
    """The reference's gate on its own names: ``cpu`` inline below the
    limit, and a ``cuda`` name judged non-blocking (why the port differs)."""
    loop_thread = threading.get_ident()
    seen = {}

    def probe():
        seen["thread"] = threading.get_ident()

    for name, inline in (("cpu", True), ("cuda", True), ("tpu", False)):
        PKGS["reference"].crypto.set_backend(_Named(name))
        await j_bridge.verify_off_loop(probe)
        assert (seen["thread"] == loop_thread) == inline, name


def test_cuda_backend_counts_two_concurrent_verifications():
    """The bridge's two workers may call ``CudaBackend.verify_batch`` at
    once (under plain ``cuda``): both batches verify and both are counted."""
    env = Env("port")
    backend = CudaBackend(device="cpu")
    blocks = env.chain(2)
    qcs = [env.qc_over(b) for b in blocks]
    errors = []

    def run(qc):
        try:
            backend.verify_batch([qc.digest().data] * 3, [pk.data for pk, _ in qc.votes],
                                 [sig.data for _, sig in qc.votes])
        except Exception as e:  # the verdict is read below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(qc,)) for qc in qcs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert errors == [] and backend.dispatches == 2 and backend.sigs == 6


# -- 3. a device failure on the certificate path -------------------------------


def _failing_batched(env):
    """``BatchingBackend`` (each package's) around an inner backend with no
    ``verify_cert`` that fails every call, as a dead card does."""
    crypto = env.pkg.crypto

    class DeadCard:
        name = "dead"

        def verify_batch(self, msgs, pubs, sigs):
            raise crypto.BackendUnavailable("device lost")

    return env.pkg.batching.BatchingBackend(DeadCard())


@async_test(timeout=30)
async def test_failing_card_leaves_an_assembled_qc_unjudged_in_both():
    """The QC ``_handle_vote_batched`` assembles is materialized, so it
    takes ``BatchingBackend``'s triple path, where both packages keep
    ``BackendUnavailable``: both cores schedule a retry and eject no vote."""

    async def scenario(env):
        env.pkg.crypto.set_backend(_failing_batched(env))
        block = env.chain(1)[0]
        node = Node(env, env.index(env.leader(2)), batch_vote_verification=True)
        for i in range(3):
            await node.put("vote", env.vote(block, i))
        assert len(node.core._retry_tasks) == 1 and not node.core._bad_sigs.get(1)
        node.stop()
        return await node.snapshot()

    snap = await both(scenario)
    assert snap["proposer"] == [] and snap["round"] == 1


@pytest.mark.parametrize("kind", ["propose", "timeout"])
@async_test
async def test_failing_card_on_a_v2_certificate_differs_by_design(kind):
    """A v2 certificate off the wire is a cert job; in front of a backend
    without ``verify_cert`` the reference's ``_flush_certs`` turns the
    device failure into ``CryptoError``, so its core judges the message
    byzantine (``InvalidSignature``); the port keeps ``BackendUnavailable``
    and its core leaves the message unjudged. Neither votes nor forms
    anything; only the verdict differs."""
    raised = {}
    for name in ("reference", "port"):
        env = Env(name)
        env.pkg.crypto.set_backend(_failing_batched(env))
        node = Node(env, 0, batch_vote_verification=True)
        await node.settle()
        blocks = env.chain(2)
        if kind == "propose":
            coro = node.core.handle_proposal(env.wire("propose", blocks[1], v2=True))
        else:
            coro = node.core.handle_timeout(
                env.wire("timeout", env.timeout(3, 1, high_qc=env.qc_over(blocks[0])), v2=True))
        try:
            await coro
            raised[name] = None
        except Exception as e:  # the verdict is the exception class
            raised[name] = type(e)
        node.stop()
        snap = await node.snapshot()
        assert snap["frames"] == [] and snap["proposer"] == [] and snap["round"] == 1
    assert raised["reference"] is PKGS["reference"].errors.InvalidSignature
    assert raised["port"] is PKGS["port"].crypto.BackendUnavailable
