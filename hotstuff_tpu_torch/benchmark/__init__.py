"""The measurement harness, on the port.

Port copies of the reference's ``benchmark/`` scripts, each run as
``python -m hotstuff_tpu_torch.benchmark.<name>``: ``committee_scale``
(BASELINE configs 2-4), ``digest_bench`` (config 3's digest decision),
``superbatch_bench``, ``local`` and ``run_local`` (config 1 as separate
node processes); the data plane's ``dataplane_sweep`` (the Conveyor rate
sweep and its gate), ``fleet_bench`` (the open-loop fleet) and
``dtrace_assemble`` (per-batch lifelines); the robustness harness's
``fault_matrix``, ``soak``, ``detector_bench``, ``sim_sweep`` and
``detector_sweep``; and what they use: ``hostinfo``, ``logs``
(``LogParser``, ``TelemetryParser`` and the stream readers),
``trace_assemble``, ``profile_assemble`` and ``watchtower``. Each keeps the
reference's flags,
printed lines and result-file names, runs on the card unless ``cpu`` is
named (the sim-plane sweeps run under ``cpu``, which they set), and imports
neither JAX nor the reference's packages. Importing a
module does nothing else.
"""
