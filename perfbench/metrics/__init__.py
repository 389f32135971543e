"""One reader a metric: ``<name>.py`` defines ``read(run)``, which returns
the metric's value from the run's records, spans, counters or trace, or
None when it finds nothing to read (the harness then leaves the metric out
of the result line). ``run`` is ``perfbench.run.RunData``."""
