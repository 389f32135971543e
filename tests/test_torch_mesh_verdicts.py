"""The port's sharded verdicts over 1 to 4 CPU shards (``cpu`` repeated),
held against its unsharded path and the RFC 8032 oracle's cofactored
verdict, on the cached path (the backend's default) for every case of
``tests/torch_mesh_cases.py`` and on the uncached path for the valid and
host-rejected batches. 6 and 8 shards are ``test_torch_mesh_wide.py``.
Tolerance: equal verdicts.
"""

import pytest

from .torch_mesh_cases import HOST_REJECTED, cases, oracle, sharded_verdict, unsharded

WIDTHS = [1, 2, 3, 4]


@pytest.mark.parametrize("d, name", [(d, name) for d in WIDTHS for name in cases(d)])
def test_cached_sharded_verdict(monkeypatch, d, name):
    want = oracle(name)
    assert want == (name in ("valid", "torsioned_r"))
    assert unsharded(name, cached=True) == want
    assert sharded_verdict(d, name, True, monkeypatch) == want


@pytest.mark.parametrize("d, name", [(d, name) for d in WIDTHS
                                     for name in ("valid", *HOST_REJECTED)])
def test_uncached_sharded_verdict(monkeypatch, d, name):
    want = oracle(name)
    assert unsharded(name, cached=False) == want
    assert sharded_verdict(d, name, False, monkeypatch) == want
