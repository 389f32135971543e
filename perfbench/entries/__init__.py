"""The entries a cell can drive, one module each: ``entries/<name>.py``,
named by the traffic file's ``"entry"`` (``proposal`` where it names none).
An entry module is the one module of the benchmark that imports the
program for its cells; ``run.py`` keeps the rest of a run (set-up timing,
the trace, the metric readers, the limits, the result line).

An entry module defines:

- ``configure_environment(traffic, chips)``: the program's switches, set
  before torch and the program are imported;
- ``Entry(config, traffic, seed, seconds, device, log)`` with
  - ``setup()``: the inputs from the seed, the program's objects and the
    warm-up, all counted in ``setup_s``;
  - ``install(control, fault)``: put the control or a fault of
    ``faults.py`` in place;
  - ``backend``: the card backend instance whose ``verify_batch`` the
    trace times (``drive.wrap_backend``);
  - ``counters()``, ``launches()``: the program's counters and kernel
    launches, read at the window's edges;
  - ``window(seconds, spans)``: run the window and return a
    ``drive.Outcome`` whose records carry ``t0`` and ``t1`` (ns,
    ``time.perf_counter_ns``);
  - ``host_spans(run)``: label -> host intervals (ns), in order of
    precedence, that name the trace's idle gaps;
  - ``check(run)``: once the window has closed, the comparison with the
    plain reference: ``(checks, failed)`` with ``checks`` name ->
    ``{"value", "limit"}``, or None when the benchmark's own inputs are at
    fault (no result).

A cell whose entry exists is added with data files; a new entry is a new
module here and its data files, with no edit to another file.
"""

from __future__ import annotations

import importlib

DEFAULT = "proposal"


def load(traffic: dict):
    """The entry module a traffic file names."""
    return importlib.import_module(f"perfbench.entries.{traffic.get('entry', DEFAULT)}")
