"""The measurement harness, on the port.

Port copies of the reference's ``benchmark/`` scripts, each run as
``python -m hotstuff_tpu_torch.benchmark.<name>``: ``committee_scale``
(BASELINE configs 2-4), ``digest_bench`` (config 3's digest decision),
``superbatch_bench``, ``local`` and ``run_local`` (config 1 as separate
node processes), and what they use: ``hostinfo``, ``logs`` (``LogParser``,
``TelemetryParser`` and the stream readers), ``trace_assemble``,
``profile_assemble`` and ``watchtower``. Each keeps the reference's flags,
printed lines and result-file names, runs on the card unless ``cpu`` is
named, and imports neither JAX nor the reference's packages. Importing a
module does nothing else.
"""
