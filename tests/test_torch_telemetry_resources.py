"""Twin of ``tests/test_resources.py``, run against the port's copy
(``hotstuff_tpu_torch.telemetry``).

Resource-observability tests: RSS / on-disk size probes and the
snapshot-gauge collector the memory-growth SLOs read."""

from __future__ import annotations

import pytest

from hotstuff_tpu_torch import telemetry
from hotstuff_tpu_torch.telemetry import resources


@pytest.fixture(autouse=True)
def _isolated_telemetry():
    telemetry.reset_for_tests()
    yield
    telemetry.reset_for_tests()


def test_rss_bytes_is_positive():
    rss = resources.rss_bytes()
    assert rss is not None and rss > 1024 * 1024  # a CPython process


def test_dir_bytes_counts_recursively(tmp_path):
    (tmp_path / "a").write_bytes(b"x" * 100)
    sub = tmp_path / "sub"
    sub.mkdir()
    (sub / "b").write_bytes(b"y" * 50)
    assert resources.dir_bytes(str(tmp_path)) == 150
    assert resources.dir_bytes(str(tmp_path / "missing")) == 0


def test_collector_surfaces_gauges_in_snapshots(tmp_path):
    (tmp_path / "wal").write_bytes(b"z" * 4096)
    telemetry.enable()
    resources.install(store_path=str(tmp_path), tracemalloc_on=False)
    snap = telemetry.get_registry().snapshot()
    assert snap["gauges"]["resource.rss_bytes"] > 0
    assert snap["gauges"]["resource.store_bytes"] == 4096
    assert snap["gauges"]["resource.open_fds"] > 0


def test_install_without_store_path_omits_store_gauge():
    telemetry.enable()
    resources.install(tracemalloc_on=False)
    snap = telemetry.get_registry().snapshot()
    assert "resource.rss_bytes" in snap["gauges"]
    assert "resource.store_bytes" not in snap["gauges"]


def test_tracemalloc_gauges_when_enabled():
    telemetry.enable()
    resources.install(tracemalloc_on=True)
    try:
        blob = [bytearray(64 * 1024) for _ in range(8)]  # noqa: F841
        snap = telemetry.get_registry().snapshot()
        assert snap["gauges"]["resource.tracemalloc_total_bytes"] > 0
        assert "resource.tracemalloc_top_growth_bytes" in snap["gauges"]
        # Second poll sees growth bounded by what we allocated since.
        blob.extend(bytearray(128 * 1024) for _ in range(4))
        snap2 = telemetry.get_registry().snapshot()
        assert (
            snap2["gauges"]["resource.tracemalloc_total_bytes"]
            > snap["gauges"]["resource.tracemalloc_total_bytes"]
        )
    finally:
        import tracemalloc

        tracemalloc.stop()
