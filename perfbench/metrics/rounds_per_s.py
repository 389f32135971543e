"""Proposals judged inside the window, over the window's seconds: where a
run spreads its window over processes, a proposal counts when it was handed
off and judged inside one process's window, over their seconds together."""


def read(run):
    done = sum(1 for r in run.records if any(a <= r.t0 and r.t1 <= b for a, b in run.windows))
    return done / run.seconds
