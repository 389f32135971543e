"""Device selection for the port's entry points.

Entry points take ``device``, which defaults to ``"cuda"``. Without a card
they raise rather than carry on on the CPU; only an explicit ``"cpu"``
runs the plain versions there (as the tests do).
"""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain versions"
        )
    return dev
