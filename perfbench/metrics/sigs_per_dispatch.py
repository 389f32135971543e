"""Signatures per call of the card backend over the window:
the change of ``crypto.dispatch.cuda_sigs`` over that of
``crypto.dispatch.cuda``."""


def read(run):
    calls = run.counters.get("crypto.dispatch.cuda", 0)
    if not calls:
        return None
    return run.counters.get("crypto.dispatch.cuda_sigs", 0) / calls
