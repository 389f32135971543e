"""hotstuff_tpu_torch — the PyTorch/CUDA port of ``hotstuff_tpu``.

The JAX package stays the reference; this package mirrors its module paths
(``hotstuff_tpu_torch/ops/field.py`` <-> ``hotstuff_tpu/ops/field.py``, and
so on) and imports nothing of it. The crypto plane's device work —
quorum-certificate batch verification — runs on an NVIDIA Hopper card
through hand-written CUDA kernels (``csrc/``), each with a plain PyTorch
version beside it. Entry points take ``device``, default ``"cuda"``; only
an explicit ``"cpu"`` runs the plain versions on the host.
"""

__version__ = "0.1.0"
