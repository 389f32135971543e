"""Port copy of the reference's ``benchmark/hostinfo.py``, whole.

Host metadata for benchmark artifacts.

Every committed perf row is meaningless without the box it ran on.
``host_meta()`` is the one shared helper the harnesses stamp into
their artifact metadata so a future reader (or the perf-regress gate)
can tell a real regression from a host-class change.
"""

from __future__ import annotations

import os
import platform


def host_meta() -> dict:
    """Return ``{"cpu_count": N, "cpu_model": str}`` for this host."""
    model = None
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                # x86 says "model name"; some ARM kernels say "model" or
                # "Hardware" — take the first model-ish line we find.
                if line.lower().startswith(("model name", "hardware", "cpu model")):
                    model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    if not model:
        model = platform.processor() or platform.machine() or "unknown"
    return {"cpu_count": os.cpu_count() or 1, "cpu_model": model}
