"""The port's slice end to end on the CPU: an N = 10 committee's signed
votes go through ``Aggregator.add_vote`` to a QC, and ``QC.verify`` runs
under ``CudaBackend(device="cpu")``. Its verdicts must equal the JAX
package's ``QC.verify`` under that package's jax-free ``cpu`` backend, for
the same keys and signatures (tolerance: the same accept/reject outcome
and the same error class).
"""

import random

import pytest

import hotstuff_tpu.crypto as jcrypto
from hotstuff_tpu.consensus import errors as jerrors
from hotstuff_tpu.consensus.aggregator import Aggregator as JAggregator
from hotstuff_tpu.consensus.config import Authority as JAuthority
from hotstuff_tpu.consensus.config import Committee as JCommittee
from hotstuff_tpu.consensus.messages import QC as JQC
from hotstuff_tpu.consensus.messages import Vote as JVote
from hotstuff_tpu_torch import crypto
from hotstuff_tpu_torch.consensus import errors
from hotstuff_tpu_torch.consensus.aggregator import Aggregator
from hotstuff_tpu_torch.consensus.config import Authority, Committee
from hotstuff_tpu_torch.consensus.messages import QC, Vote
from hotstuff_tpu_torch.crypto.cuda_backend import CudaBackend

N = 10


@pytest.fixture
def backends(monkeypatch):
    """The port on its CPU device, the reference on its cpu backend; both
    packages' process-wide certificate arenas off (one switch), so that
    every QC is judged afresh."""
    monkeypatch.setenv("HOTSTUFF_CERT_ARENA", "0")
    monkeypatch.setattr(crypto, "_BACKEND", None)
    monkeypatch.setattr(jcrypto, "_BACKEND", None)
    crypto.set_backend(CudaBackend(device="cpu"))
    jcrypto.set_backend("cpu")


def committee_and_keys(seed=0):
    rng = random.Random(seed)
    keys = [crypto.generate_keypair(seed=rng.randbytes(32)) for _ in range(N)]
    committee = Committee({pk: Authority(1, ("127.0.0.1", 9000 + i)) for i, (pk, _) in enumerate(keys)})
    jcommittee = JCommittee(
        {jcrypto.PublicKey(pk.data): JAuthority(1, ("127.0.0.1", 9000 + i))
         for i, (pk, _) in enumerate(keys)}
    )
    return keys, committee, jcommittee


def make_qc(keys, committee, round_=3):
    block = crypto.sha512_digest(b"block", round_.to_bytes(8, "little"))
    agg = Aggregator(committee)
    qcs = [agg.add_vote(Vote.new_from_key(block, round_, pk, sk)) for pk, sk in keys]
    formed = [q for q in qcs if q is not None]
    assert len(formed) == 1  # exactly once, at the quorum
    assert qcs.index(formed[0]) == committee.quorum_threshold() - 1
    return formed[0]


def to_reference(qc: QC) -> JQC:
    return JQC(
        hash=jcrypto.Digest(qc.hash.data),
        round=qc.round,
        votes=[(jcrypto.PublicKey(pk.data), jcrypto.Signature(sig.data)) for pk, sig in qc.votes],
    )


def outcome(verify):
    try:
        verify()
    except Exception as e:  # the class name is the verdict compared
        return type(e).__name__
    return "accepted"


def variant(qc: QC, keys, name: str) -> QC:
    votes = list(qc.votes)
    if name == "tampered_signature":
        pk, sig = votes[2]
        data = bytearray(sig.data)
        data[40] ^= 0x10
        votes[2] = (pk, crypto.Signature(bytes(data)))
    elif name == "below_quorum":
        votes = votes[:-1]
    elif name == "duplicate_author":
        votes[-1] = votes[0]
    elif name == "unknown_authority":
        stranger, sk = crypto.generate_keypair(seed=b"\x99" * 32)
        votes[-1] = (stranger, crypto.Signature.new(qc.digest(), sk))
    return QC(qc.hash, qc.round, votes)


EXPECTED = {
    "valid": "accepted",
    "tampered_signature": "InvalidSignature",
    "below_quorum": "QCRequiresQuorum",
    "duplicate_author": "AuthorityReuse",
    "unknown_authority": "UnknownAuthority",
}


@pytest.mark.parametrize("name", list(EXPECTED))
def test_qc_verdict_equals_reference(backends, name):
    keys, committee, jcommittee = committee_and_keys()
    qc = variant(make_qc(keys, committee), keys, name)
    got = outcome(lambda: qc.verify(committee))
    want = outcome(lambda: to_reference(qc).verify(jcommittee))
    assert got == want == EXPECTED[name]
    assert hasattr(errors, got) or got == "accepted"


def test_votes_and_aggregation_equal_reference():
    """Same digests and signatures, and the same QC out of both aggregators."""
    keys, committee, jcommittee = committee_and_keys(seed=1)
    block = crypto.sha512_digest(b"b")
    jagg, agg = JAggregator(jcommittee), Aggregator(committee)
    for pk, sk in keys:
        vote = Vote.new_from_key(block, 7, pk, sk)
        jvote = JVote(jcrypto.Digest(block.data), 7, jcrypto.PublicKey(pk.data),
                      jcrypto.Signature(vote.signature.data))
        assert vote.digest().data == jvote.digest().data
        assert vote.signature.data == jcrypto.Signature.new(jvote.digest(), jcrypto.SecretKey(sk.seed)).data
        qc, jqc = agg.add_vote(vote), jagg.add_vote(jvote)
        assert (qc is None) == (jqc is None)
        if qc is not None:
            assert qc.digest().data == jqc.digest().data
            assert [(pk.data, s.data) for pk, s in qc.votes] == [
                (pk.data, s.data) for pk, s in jqc.votes
            ]
    with pytest.raises(errors.AuthorityReuse):
        agg.add_vote(Vote.new_from_key(crypto.sha512_digest(b"other"), 7, *keys[0]))
    with pytest.raises(jerrors.AuthorityReuse):
        jagg.add_vote(JVote.new_from_key(jcrypto.sha512_digest(b"other"), 7,
                                         jcrypto.PublicKey(keys[0][0].data),
                                         jcrypto.SecretKey(keys[0][1].seed)))


def test_single_vote_verify(backends):
    keys, committee, _ = committee_and_keys(seed=2)
    vote = Vote.new_from_key(crypto.sha512_digest(b"c"), 1, *keys[0])
    vote.verify(committee)
    vote.round = 2
    with pytest.raises(errors.InvalidSignature):
        vote.verify(committee)
