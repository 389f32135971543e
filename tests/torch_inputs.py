"""Inputs for the decompression and verdict tests of the PyTorch port, shared
by the CPU tests (``test_torch_decompress.py``, against the JAX package)
and the card tests (``test_torch_kernels.py``, against the plain versions).
Pure Python and numpy, from a seed; imports neither JAX nor the card."""

import functools
import random

import numpy as np

from hotstuff_tpu_torch.crypto import ed25519_ref as ref
from hotstuff_tpu_torch.ops import field as fe

# What lane i of a decompression batch holds, by i % 8.
KINDS = ["valid", "valid", "valid", "non-square", "x=0 sign 1", "identity",
         "y=p-1", "top limb full"]


@functools.lru_cache(maxsize=8)
def encodings(m: int, seed: int) -> tuple[bytes, ...]:
    """m 32-byte encodings (y < p), mixing valid points, non-squares, x = 0
    with sign 1, the identity's y = 1, y = p - 1 with either sign, and y
    whose top 13-bit limb is full (255, the most below p)."""
    rng = random.Random(seed)
    encs = []
    for i in range(m):
        kind = KINDS[i % len(KINDS)]
        if kind == "valid":
            encs.append(ref.point_compress(ref.point_mul(rng.getrandbits(250), ref.G)))
            continue
        if kind == "non-square":
            y = rng.randrange(ref.P)
            while ref.recover_x(y, 0) is not None:
                y = rng.randrange(ref.P)
            sign = rng.getrandbits(1)
        elif kind == "x=0 sign 1":
            y, sign = 1, 1
        elif kind == "identity":
            y, sign = 1, 0
        elif kind == "y=p-1":
            y, sign = ref.P - 1, (i // len(KINDS)) % 2
        else:
            y, sign = ref.P - 1 - rng.getrandbits(246), rng.getrandbits(1)
        encs.append((y | sign << 255).to_bytes(32, "little"))
    return tuple(encs)


def decompress_inputs(m: int, seed: int):
    """(y limbs int32 [m, 20], signs int32 [m], the RFC 8032 oracle's
    verdict per lane) for ``encodings(m, seed)``."""
    encs = encodings(m, seed)
    data = np.frombuffer(b"".join(encs), dtype=np.uint8).reshape(-1, 32).copy()
    sign = (data[:, 31] >> 7).astype(np.int32)
    data[:, 31] &= 0x7F
    valid = np.array([ref.point_decompress(e) is not None for e in encs])
    return fe.fe_from_bytes(data), sign, valid


def point_limbs(p) -> np.ndarray:
    """An oracle point in affine extended coordinates, int32 [4, 20]."""
    x, y, z, _ = p
    zi = ref.inv(z)
    xa, ya = x * zi % ref.P, y * zi % ref.P
    return np.stack([fe._int_to_limbs(xa), fe._int_to_limbs(ya), fe.ONE_LIMBS,
                     fe._int_to_limbs(xa * ya % ref.P)]).astype(np.int32)


def _neg(p):
    x, y, z, t = p
    return (-x % ref.P, y, z, -t % ref.P)


VERDICT_CASES = ["a+b=O", "a+b torsion", "base point", "ok false in last lane"]


def verdict_case(name: str, m: int, seed: int = 9):
    """(ok bool [m], a, b, sum) for a verdict case: a and b int32 [4, 20]
    and their sum a + b (the one point of the case without ``b``), with
    the expected verdict."""
    rng = random.Random(seed)
    q = ref.point_mul(rng.getrandbits(250), ref.G)
    a, b = q, _neg(q)
    if name == "a+b torsion":  # 8 (a + b) = O: accepted, as the cofactored check says
        a = ref.point_add(q, ref.torsion_generator())
    elif name == "base point":
        a, b = ref.G, ref.IDENTITY
    ok = np.ones(m, dtype=bool)
    if name == "ok false in last lane":
        ok[-1] = False
    want = name in ("a+b=O", "a+b torsion")
    return ok, point_limbs(a), point_limbs(b), point_limbs(ref.point_add(a, b)), want
