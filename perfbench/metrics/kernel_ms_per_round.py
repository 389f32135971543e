"""Device time of the port's kernels over the traced window, per proposal
handed off in it. None when the trace lost launches (its count of the
port's kernels differs from ``msm_kernels.LAUNCHES`` over the window)."""


def read(run):
    t = run.trace
    if t is None or run.launches_lost or not run.records or t.port_kernel_s <= 0:
        return None
    return t.port_kernel_s / len(run.records) * 1e3
