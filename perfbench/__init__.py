"""The benchmark of the PyTorch and CUDA port (``hotstuff_tpu_torch``).

``python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``. The harness is driven
by data: a cell names a configuration (``configs/<name>.json``) and a
traffic mix (``traffic/<name>.json``), the traffic file names the part of
the program the cell drives (``entries/<name>.py``; ``proposal``, a
validator receiving proposals, where it names none), and each metric is
read by ``metrics/<name>.py``. ``reference/`` is the plain Ed25519 and quorum
reference that decides ``correct``; ``roofline/`` counts the work of the
batch equation.
"""
