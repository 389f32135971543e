"""The port's native (C++) vote pre-stage, on the CPU.

Twins of ``tests/test_native_vote_prestage.py`` (its 2 tests, same inputs
and assertions) on ``hotstuff_tpu_torch``: a fuzzed vote stream through a
real native listener admits exactly the model's set of the core's cheap
drops, in order, and the duplicate-vote ejection path stays live. Then
across the packages (tolerance: the same frames, in the same order): the
same seeded fuzzed stream through the reference's native listener and
the port's admits the same vote frames and passes the same other frames
through. Keys are the port's, from ``random.Random(0)`` as
``tests/common.py``'s ``keys`` makes the reference's.

The library builds with g++ into ``hotstuff_tpu_torch/_build/``; a build
failure fails these tests. Ports 23900-23999.
"""

import asyncio
import random

from hotstuff_tpu.network import native as j_native
from hotstuff_tpu_torch.consensus.messages import (
    Vote,
    decode_vote_frame,
    encode_vote,
)
from hotstuff_tpu_torch.crypto import Signature, generate_keypair, sha512_digest
from hotstuff_tpu_torch.network import native as hsnative
from hotstuff_tpu_torch.network.receiver import write_frame

from .common import async_test


def keys(n: int = 4):
    """n deterministic port keypairs (the reference's ``tests/common.keys``)."""
    rng = random.Random(0)
    return [generate_keypair(seed=rng.randbytes(32))[0:2] for _ in range(n)]


BASE_PORT = 23900
LOOKAHEAD = 1000  # == Core.MAX_ROUND_LOOKAHEAD == netcore VOTE_ROUND_LOOKAHEAD


class _CollectingHandler:
    """Records exactly what the pre-stage delivers, in order."""

    def __init__(self):
        self.votes: list[bytes] = []  # raw frames via dispatch_votes
        self.frames: list[bytes] = []  # anything else via dispatch

    async def dispatch_votes(self, frames):
        self.votes.extend(frames)

    async def dispatch(self, writer, message):
        self.frames.append(message)


def _model_filter(stream, committee_keys, current_round):
    """The documented pre-stage contract, in pure Python: admit exactly
    the frames the core's cheap pre-verification gate would not drop.
    ``stream`` is a list of wire frames; returns the admitted subset."""
    seats = {pk.data for pk in committee_keys}
    latest: dict[tuple[int, bytes], bytes] = {}  # (round, author) -> frame
    admitted = []
    for frame in stream:
        if len(frame) != 137 or frame[0] != 1:
            continue  # not a fixed-layout vote: flows through EV_RECV
        round_ = int.from_bytes(frame[33:41], "little")
        author = frame[41:73]
        if author not in seats:
            continue
        if round_ < current_round or round_ > current_round + LOOKAHEAD:
            continue
        key = (round_, author)
        if latest.get(key) == frame:
            continue  # byte-identical resend of the seat's latest vote
        latest[key] = frame
        admitted.append(frame)
    return admitted


def _fuzzed_stream(committee, current_round):
    """The reference test's fuzzed stream (seed 1234), made with the
    port's keys, votes and encoder."""
    outsider = generate_keypair(seed=b"\xee" * 32)
    rng = random.Random(1234)

    digests = [sha512_digest(b"block-%d" % i) for i in range(3)]
    stream: list[bytes] = []
    for i in range(300):
        roll = rng.random()
        if roll < 0.35:
            # Honest vote at a live round.
            pk, sk = committee[rng.randrange(4)]
            round_ = current_round + rng.randrange(3)
            stream.append(
                encode_vote(
                    Vote.new_from_key(digests[rng.randrange(3)], round_, pk, sk)
                )
            )
        elif roll < 0.45 and stream:
            # Identical resend of a random earlier frame.
            stream.append(stream[rng.randrange(len(stream))])
        elif roll < 0.55:
            # Same seat+round+digest, different signature (spoof shape):
            # MUST pass the filter (core arbitrates via re-seat logic).
            pk, _ = committee[rng.randrange(4)]
            fake = Vote(
                digests[rng.randrange(3)],
                current_round + rng.randrange(3),
                pk,
                Signature(rng.randbytes(64)),
            )
            stream.append(encode_vote(fake))
        elif roll < 0.65:
            # Unknown seat (not in the committee table): dropped.
            round_ = current_round + rng.randrange(3)
            stream.append(
                encode_vote(
                    Vote.new_from_key(
                        digests[0], round_, outsider[0], outsider[1]
                    )
                )
            )
        elif roll < 0.75:
            # Stale or far-future round: dropped.
            pk, sk = committee[rng.randrange(4)]
            round_ = rng.choice(
                [
                    rng.randrange(current_round),
                    current_round + LOOKAHEAD + 1 + rng.randrange(1000),
                ]
            )
            stream.append(
                encode_vote(Vote.new_from_key(digests[0], round_, pk, sk))
            )
        elif roll < 0.9:
            # Garbage that is NOT vote-shaped: must flow through EV_RECV.
            stream.append(rng.randbytes(rng.choice([5, 64, 136, 138, 200])))
        else:
            # Vote-tagged frame of exactly 137 bytes with random bytes:
            # the filter decodes offsets; unknown author bytes drop it.
            stream.append(b"\x01" + rng.randbytes(136))

    return stream


async def _run_stream(port, committee_keys, current_round, stream, native=hsnative):
    """Push ``stream`` through a native listener (the port's, or
    ``native``'s) with the pre-stage on; return (admitted vote frames,
    passthrough frames) as Python saw them."""
    handler = _CollectingHandler()
    receiver = await native.NativeReceiver.spawn(
        ("127.0.0.1", port), handler, auto_ack=True
    )
    try:
        receiver.configure_vote_prestage([pk.data for pk in committee_keys])
        receiver.set_round(current_round)
        await asyncio.sleep(0.05)
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        for frame in stream:
            write_frame(writer, frame)
        await writer.drain()
        # Wait for the stream to fully drain through the loop thread.
        expected_total = None
        for _ in range(200):
            await asyncio.sleep(0.02)
            total = len(handler.votes) + len(handler.frames)
            if total == expected_total:
                break
            expected_total = total
        writer.close()
        return list(handler.votes), list(handler.frames)
    finally:
        await receiver.shutdown()


@async_test(timeout=120)
async def test_prestage_equivalence_fuzzed_stream():
    """A fuzzed mix of valid votes, unknown-seat votes, stale/future
    rounds, identical resends, conflicting re-signs, and non-vote frames:
    the native filter must admit exactly the model's set, in order, and
    route every non-vote frame through the normal path untouched."""
    committee = keys(4)
    current_round = 50
    stream = _fuzzed_stream(committee, current_round)
    expected = _model_filter(stream, [pk for pk, _ in committee], current_round)
    expected_passthrough = [
        f for f in stream if not (len(f) == 137 and f[0] == 1)
    ]

    admitted, passthrough = await _run_stream(
        BASE_PORT, [pk for pk, _ in committee], current_round, stream
    )
    assert admitted == expected
    assert passthrough == expected_passthrough
    # Every admitted frame decodes as the vote that was sent.
    for frame in admitted:
        decode_vote_frame(frame)


@async_test(timeout=120)
async def test_prestage_duplicate_vote_ejection_equivalence():
    """The ejection liveness contract end-to-end through the filter: a
    spoofed signature occupies a seat, the identical spoof resend is
    dropped natively (the core would drop it via its bad-signature cache
    anyway), and the author's GENUINE vote — different bytes, same seat —
    passes the filter so the core can verify it individually and re-seat
    it. The batch path must accept the same final vote set as the
    per-vote path."""
    committee = keys(4)
    digest = sha512_digest(b"the-block")
    round_ = 7
    pk0, sk0 = committee[0]

    spoof = Vote(digest, round_, pk0, Signature(b"\x5a" * 64))
    genuine = Vote.new_from_key(digest, round_, pk0, sk0)
    stream = [
        encode_vote(spoof),
        encode_vote(spoof),  # identical resend: native drop
        encode_vote(genuine),  # different bytes: MUST pass for re-seat
        encode_vote(genuine),  # identical resend of the genuine: drop
    ]
    admitted, _ = await _run_stream(
        BASE_PORT + 1, [pk for pk, _ in committee], round_, stream
    )
    assert admitted == [encode_vote(spoof), encode_vote(genuine)]

    # Feed the admitted set to a real batched-verification core path:
    # aggregator seats the spoof, the genuine vote is individually
    # verified and re-seated — identical to what the per-vote path does
    # with the same admitted frames.
    from hotstuff_tpu_torch.consensus import Authority
    from hotstuff_tpu_torch.consensus.aggregator import Aggregator
    from hotstuff_tpu_torch.consensus.config import Committee as CCommittee

    ccommittee = CCommittee(
        authorities={
            pk: Authority(stake=1, address=("127.0.0.1", 0))
            for pk, _ in committee
        }
    )
    agg = Aggregator(ccommittee)
    votes = [decode_vote_frame(f) for f in admitted]
    agg.add_vote(votes[0])  # spoof takes the seat (batched mode: unverified)
    assert agg.stored_signature(round_, votes[0].digest(), pk0) == spoof.signature
    # The genuine vote conflicts; individual verification succeeds and
    # re-seats it (core._handle_vote_batched's arbitration).
    votes[1].verify(ccommittee)
    agg.reseat_vote(votes[1])
    assert (
        agg.stored_signature(round_, votes[1].digest(), pk0)
        == genuine.signature
    )


@async_test(timeout=120)
async def test_both_packages_prestages_admit_the_same_frames():
    committee = keys(4)
    current_round = 50
    stream = _fuzzed_stream(committee, current_round)
    seats = [pk for pk, _ in committee]
    port = await _run_stream(BASE_PORT + 2, seats, current_round, stream)
    reference = await _run_stream(
        BASE_PORT + 3, seats, current_round, stream, native=j_native
    )
    assert port == reference
    assert port[0] == _model_filter(stream, seats, current_round)
