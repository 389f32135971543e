"""Mean time of ``decode_message`` on a frame, from the benchmark's own
span around each call."""


def read(run):
    spans = run.spans.decode if run.spans is not None else []
    if not spans:
        return None
    return sum(b - a for a, b in spans) / len(spans) / 1e6
