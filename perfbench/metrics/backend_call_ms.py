"""Mean time of the card backend's ``verify_batch`` (host prep, the
kernels and the wait for the verdict), from the benchmark's wrapper on
the backend instance."""


def read(run):
    spans = run.spans.backend if run.spans is not None else []
    if not spans:
        return None
    return sum(s[1] - s[0] for s in spans) / len(spans) / 1e6
