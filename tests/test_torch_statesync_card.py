"""A snapshot record's 2-chain proof verified on the card: a committee of
N = 100 (quorum 67), a record ``(F, c1, cert)`` of signed blocks whose two
QCs carry 67 votes each, decoded with ``decode_snapshot`` and verified with
``verify_snapshot`` under ``cuda-batched``. Its two QCs are awaited one after
the other, so they make two inner calls, each launching the decompression
once (the committee's keys are in the card's cache beforehand), K2 and K3
twice and the verdict once; K4 never. A flipped vote byte raises
``InvalidSignature``; a record whose cert certifies another block raises
``SnapshotError`` with no launch.

Needs a CUDA card with nvcc (``cuda`` marker; it skips without one).
Imports neither JAX nor the JAX package. Binds no port.
"""

import asyncio
import random

import pytest
import torch

import hotstuff_tpu_torch.crypto as t_crypto
from hotstuff_tpu_torch.consensus import Authority, Committee, cert_arena, errors
from hotstuff_tpu_torch.consensus.messages import QC, Block, Vote
from hotstuff_tpu_torch.consensus.statesync import (
    SnapshotError,
    decode_snapshot,
    encode_snapshot,
    verify_snapshot,
)
from hotstuff_tpu_torch.crypto import Signature
from hotstuff_tpu_torch.ops import msm_kernels as mk

pytestmark = pytest.mark.cuda
N = 100


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(t_crypto, "_BACKEND", None)
    t_crypto.set_backend("cuda-batched")
    cert_arena.reset()
    yield t_crypto.get_backend()
    cert_arena.reset()


def snapshot_chain():
    """(committee, keys, F, c1, the block above c1): blocks of rounds 1-4
    by their leaders, each QC signed by the first 67 keys in key order."""
    rng = random.Random(5)
    keys = [t_crypto.generate_keypair(seed=rng.randbytes(32))[:2] for _ in range(N)]
    committee = Committee({pk: Authority(1, ("127.0.0.1", 9000 + i))
                           for i, (pk, _) in enumerate(keys)})
    secret = dict(keys)
    leaders = committee.sorted_keys()
    signers = keys[: committee.quorum_threshold()]
    blocks, qc = [], QC.genesis()
    for r in range(1, 5):
        author = leaders[r % N]
        blocks.append(Block.new_from_key(qc, None, author, r, [], secret[author]))
        qc = QC(blocks[-1].digest(), r,
                [(pk, Vote.new_from_key(blocks[-1].digest(), r, pk, sk).signature)
                 for pk, sk in signers])
    return committee, keys, blocks[1], blocks[2], blocks[3]


def test_snapshot_verifies_on_the_card_in_two_inner_calls(cuda):
    committee, _, frontier, child, above = snapshot_chain()
    raw = encode_snapshot(frontier, child, above.qc)
    snap = decode_snapshot(raw)
    assert cuda.inner._cache.ensure([pk.data for pk in committee.sorted_keys()])
    calls = cuda.inner_calls
    cert_arena.reset()
    mk.reset_launches()
    asyncio.run(verify_snapshot(snap, committee))
    torch.cuda.synchronize()
    assert cuda.inner_calls - calls == 2
    assert dict(mk.LAUNCHES) == {"decompress": 2, "sqrt_pow": 0, "msm_partials_signed": 4,
                                 "msm_partials": 0, "msm_combine": 4, "verdict": 2}


def test_snapshot_with_a_flipped_vote_byte_is_rejected_on_the_card(cuda):
    committee, _, frontier, child, above = snapshot_chain()
    votes = list(above.qc.votes)
    pk, sig = votes[10]
    data = bytearray(sig.data)
    data[5] ^= 0x01
    votes[10] = (pk, Signature(bytes(data)))
    snap = decode_snapshot(encode_snapshot(frontier, child, QC(above.qc.hash, above.qc.round,
                                                               votes)))
    cert_arena.reset()
    with pytest.raises(errors.InvalidSignature):
        asyncio.run(verify_snapshot(snap, committee))


def test_snapshot_whose_cert_certifies_another_block_launches_nothing(cuda):
    committee, _, frontier, child, above = snapshot_chain()
    wrong = QC(frontier.digest(), child.round, above.qc.votes)
    mk.reset_launches()
    with pytest.raises(SnapshotError):
        decode_snapshot(encode_snapshot(frontier, child, wrong))
    assert sum(mk.LAUNCHES.values()) == 0
