"""Process start to the first timed proposal: imports, CUDA start, the
kernels loaded (built on a checkout's first run), keys and the signed
inputs, the committee's key cache filled and the warm-up."""


def read(run):
    return run.setup_s
