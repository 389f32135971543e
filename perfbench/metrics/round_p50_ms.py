"""Median time from a proposal's hand-off to its verdict, over every
proposal handed off in the window."""

import numpy as np


def read(run):
    if not run.records:
        return None
    return float(np.percentile([(r.t1 - r.t0) / 1e6 for r in run.records], 50))
