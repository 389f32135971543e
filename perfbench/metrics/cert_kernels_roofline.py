"""The least time the card could take for the window's certificate
checks (``perfbench.roofline.model``, from the batch sizes the backend was
handed), as a share of the port's kernel time in the trace."""

from perfbench.roofline import model


def read(run):
    t = run.trace
    if (t is None or run.launches_lost or t.port_kernel_s <= 0
            or not run.batches or not run.card.get("clock_max_mhz")):
        return None
    least, _ = model.least_seconds(run.batches, run.card["sms"], run.card["clock_max_mhz"])
    return 100.0 * least / t.port_kernel_s
