"""The port's bench on the card: both device paths of ``bench_torch.py`` at
8 signatures launch exactly their kernels, batch by batch (the cached path
one decompression more, for the keys entering its cache).

Needs a CUDA card with nvcc (``cuda`` marker; it skips without one).
Imports neither JAX nor the JAX package, so it runs on a host without them.
"""

import pytest
import torch

import bench_torch
from hotstuff_tpu_torch.ops import msm_kernels as mk

pytestmark = pytest.mark.cuda


def test_bench_paths_on_the_card_launch_exactly_their_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    msgs, pubs, sigs = bench_torch.make_batch(8)
    feed = dict(iters=2, threads=2, rounds=2, device="cuda")
    batches = 1 + 2 + 2 * 2
    zeros = dict.fromkeys(mk.LAUNCHES, 0)
    mk.reset_launches()
    assert bench_torch.bench_device_cached(msgs, pubs, sigs, **feed) > 0
    assert mk.LAUNCHES == {**zeros, "decompress": batches + 1, "msm_partials_signed": 2 * batches,
                           "msm_combine": 2 * batches, "verdict": batches}
    mk.reset_launches()
    assert bench_torch.bench_device(msgs, pubs, sigs, **feed) > 0
    assert mk.LAUNCHES == {**zeros, "decompress": batches, "msm_partials": batches,
                           "msm_combine": batches, "verdict": batches}
