"""The verdict matrix of the port's sharded verifier, shared by
``test_torch_mesh_verdicts.py`` (1 to 4 shards) and
``test_torch_mesh_wide.py`` (6 and 8). A batch of N = 8 signatures, from a
seed, in each of these forms:

- ``valid``;
- ``torsioned_r``: signature 0 with a torsioned R, which the cofactored
  check accepts;
- ``tampered_r<j>``: signature j's R moved to R + B, a valid point, so
  every lane decompresses and only the combined sum can reject;
- ``noncanonical_s`` (s + L) and ``noncanonical_y`` (R's y = p + 2),
  rejected on the host before any shard runs.

Each is held against the port's unsharded path and the RFC 8032 oracle's
cofactored verdict. Pure Python and numpy; imports neither JAX nor the
card."""

import functools
import random

import torch

from hotstuff_tpu_torch.crypto import ed25519_ref as ref
from hotstuff_tpu_torch.ops import verify as ov
from hotstuff_tpu_torch.parallel import mesh as pm

N = 8
CPU = torch.device("cpu")


def make_batch(n: int, seed: int):
    rng = random.Random(seed)
    msgs, pubs, sigs = [], [], []
    for _ in range(n):
        seed_bytes = rng.randbytes(32)
        pubs.append(ref.secret_to_public(seed_bytes))
        msgs.append(rng.randbytes(32))
        sigs.append(ref.sign(seed_bytes, msgs[-1]))
    return msgs, pubs, sigs


@functools.lru_cache(maxsize=None)
def batch(name: str):
    msgs, pubs, sigs = make_batch(N, seed=41)
    if name == "torsioned_r":
        rng = random.Random(16)
        a, _ = ref.secret_expand(rng.randbytes(32))
        pubs[0] = ref.point_compress(ref.point_mul(a, ref.G))
        r = rng.getrandbits(250) % ref.L
        r_enc = ref.point_compress(ref.point_add(ref.point_mul(r, ref.G), ref.torsion_generator()))
        s = (r + ref.compute_challenge(r_enc, pubs[0], msgs[0]) * a) % ref.L
        sigs[0] = r_enc + s.to_bytes(32, "little")
    elif name.startswith("tampered_r"):
        j = int(name[len("tampered_r"):])
        moved = ref.point_add(ref.point_decompress(sigs[j][:32]), ref.G)
        sigs[j] = ref.point_compress(moved) + sigs[j][32:]
    elif name == "noncanonical_s":
        s = int.from_bytes(sigs[1][32:], "little") + ref.L
        sigs[1] = sigs[1][:32] + s.to_bytes(32, "little")
    elif name == "noncanonical_y":
        sigs[2] = (ref.P + 2).to_bytes(32, "little") + sigs[2][32:]
    else:
        assert name == "valid", name
    return msgs, pubs, sigs


def oracle(name: str) -> bool:
    return all(ref.verify(p, m, s, strict=False) for m, p, s in zip(*batch(name)))


@functools.lru_cache(maxsize=None)
def unsharded(name: str, cached: bool) -> bool:
    """The port's unsharded verdict (cached or uncached path)."""
    if cached:
        return ov.verify_batch_device_cached(*batch(name), ov.DevicePointCache(device="cpu"))
    return ov.verify_batch_device(*batch(name), device="cpu")


def shard_positions(d: int) -> list[int]:
    """The first signature whose fresh R row lies in each shard that holds
    one, on the cached path's split of ``d`` shards."""
    per = pm._shard_target(N, d) // d  # N = 8 is its own power of two
    firsts = {}
    for j in range(N):
        firsts.setdefault(j // per, j)
    return sorted(firsts.values())


def cases(d: int) -> list[str]:
    return (["valid", "torsioned_r", "noncanonical_s", "noncanonical_y"]
            + [f"tampered_r{j}" for j in shard_positions(d)])


HOST_REJECTED = ("noncanonical_s", "noncanonical_y")


def sharded_verdict(d: int, name: str, cached: bool, monkeypatch) -> bool:
    """The sharded verdict over ``d`` CPU shards; a case rejected on the
    host must reach no shard."""
    if name in HOST_REJECTED:
        def no_shard(*args):
            raise AssertionError("a host-rejected batch reached a shard")

        monkeypatch.setattr(ov, "fresh_inputs", no_shard)
        monkeypatch.setattr(ov, "uncached_inputs", no_shard)
    mesh = pm.make_mesh(devices=[CPU] * d)
    if cached:
        return pm.verify_batch_device_cached_sharded(mesh, *batch(name),
                                                     ov.DevicePointCache(device="cpu"))
    return pm.verify_batch_device_sharded(mesh, *batch(name))
