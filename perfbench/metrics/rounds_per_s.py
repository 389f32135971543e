"""Proposals judged inside the window, over the window's seconds."""


def read(run):
    done = sum(1 for r in run.records if r.t1 <= run.t_end)
    return done / run.seconds
