"""Twin of ``tests/test_slo.py``, run against the port's copy
(``hotstuff_tpu_torch.telemetry``).

SLO engine tests: window arithmetic over cumulative snapshot streams
(empty window, single snapshot, counter reset after restart), histogram
quantiles, and verdict semantics."""

from __future__ import annotations

import pytest

from hotstuff_tpu_torch.telemetry import slo


def _snap(ts, counters=None, histograms=None, gauges=None):
    return {
        "ts": ts,
        "seq": int(ts),
        "counters": counters or {},
        "histograms": histograms or {},
        "gauges": gauges or {},
    }


def _hist(le, counts):
    return {
        "le": list(le),
        "counts": list(counts),
        "sum": 0.0,
        "count": sum(counts),
    }


# -- primitives --------------------------------------------------------------


def test_counter_delta_and_reset():
    b = _snap(0, {"c": 100})
    a = _snap(10, {"c": 150})
    assert slo.counter_delta(b, a, "c") == 50
    # Restart mid-window: cumulative value went DOWN => counted from
    # zero again, the delta is the after-value, never negative.
    a_reset = _snap(10, {"c": 30})
    assert slo.counter_delta(b, a_reset, "c") == 30
    assert slo.counter_delta(None, a, "c") == 150
    assert slo.counter_delta(b, _snap(10, {}), "c") == 0


def test_histogram_delta_and_reset():
    le = (1, 10, 100)
    b = _snap(0, histograms={"h": _hist(le, [5, 3, 0, 0])})
    a = _snap(10, histograms={"h": _hist(le, [8, 4, 1, 0])})
    d = slo.histogram_delta(b, a, "h")
    assert d["counts"] == [3, 1, 1, 0]
    # Reset: any negative bucket falls back to the after-histogram.
    a_reset = _snap(10, histograms={"h": _hist(le, [2, 0, 0, 0])})
    d = slo.histogram_delta(b, a_reset, "h")
    assert d["counts"] == [2, 0, 0, 0]
    assert slo.histogram_delta(b, _snap(10), "h") is None


def test_histogram_quantile_interpolation():
    h = _hist((10, 20, 40), [0, 100, 0, 0])  # all mass in (10, 20]
    assert slo.histogram_quantile(h, 0.5) == pytest.approx(15.0)
    assert slo.histogram_quantile(h, 0.99) == pytest.approx(19.9)
    # Overflow bucket resolves to the last edge (conservative).
    h = _hist((10, 20), [0, 0, 5])
    assert slo.histogram_quantile(h, 0.99) == 20
    assert slo.histogram_quantile(_hist((10,), [0, 0]), 0.5) is None


def test_windows_empty_single_and_sliding():
    assert slo.windows([], 30.0) == []
    s0 = _snap(0)
    assert slo.windows([s0], 30.0) == [(None, s0)]  # cumulative-from-zero
    snaps = [_snap(t) for t in (0, 10, 20, 30, 40)]
    wins = slo.windows(snaps, 30.0)
    assert len(wins) == 4  # one per snapshot past the first
    # The last window spans [10, 40] (>= 30 s back), the second [0, 10]
    # (clamped to the stream head during warm-up).
    assert wins[-1][0]["ts"] == 10 and wins[-1][1]["ts"] == 40
    assert wins[0][0]["ts"] == 0 and wins[0][1]["ts"] == 10


# -- evaluation --------------------------------------------------------------


def test_evaluate_empty_stream_fails_closed():
    verdict = slo.evaluate([], slo.default_slos())
    assert verdict["ok"] is False
    assert verdict["reason"] == "no snapshots"


def test_evaluate_single_snapshot_uses_cumulative_window():
    snap = _snap(
        100,
        counters={"consensus.timeouts_fired": 1,
                  "consensus.rounds_advanced": 100},
    )
    specs = [
        slo.SloSpec(
            "timeouts_per_round", "ratio", "consensus.timeouts_fired",
            per="consensus.rounds_advanced", max=0.5,
        )
    ]
    verdict = slo.evaluate([snap], specs)
    assert verdict["ok"] is True
    assert verdict["slos"][0]["windows"] == 1
    assert verdict["slos"][0]["worst"] == pytest.approx(0.01)


def test_evaluate_ms_per_round_flags_stall():
    snaps = [
        _snap(0, {"consensus.rounds_advanced": 10}),
        _snap(10, {"consensus.rounds_advanced": 110}),  # 100 ms/round: ok
        _snap(20, {"consensus.rounds_advanced": 110}),  # stall: inf
    ]
    specs = [
        slo.SloSpec(
            "ms_per_round", "ms_per_count",
            "consensus.rounds_advanced", max=500.0,
        )
    ]
    verdict = slo.evaluate(snaps, specs, window_s=5.0)
    res = verdict["slos"][0]
    assert res["windows"] == 2
    assert res["violated_windows"] == 1
    assert res["worst"] == "inf"
    assert verdict["ok"] is False
    # A bounded tolerated degradation fraction flips it green.
    specs[0].allow_violation_fraction = 0.5
    assert slo.evaluate(snaps, specs, window_s=5.0)["ok"] is True


def test_evaluate_counter_reset_is_not_a_violation():
    # A node restart resets the counter; the reset-aware delta keeps the
    # window positive and the rate sane.
    snaps = [
        _snap(0, {"consensus.rounds_advanced": 500}),
        _snap(10, {"consensus.rounds_advanced": 40}),  # restarted
    ]
    specs = [
        slo.SloSpec(
            "ms_per_round", "ms_per_count",
            "consensus.rounds_advanced", max=500.0,
        )
    ]
    verdict = slo.evaluate(snaps, specs, window_s=5.0)
    assert verdict["ok"] is True
    assert verdict["slos"][0]["worst"] == pytest.approx(250.0)


def test_evaluate_quantile_and_gauge():
    hist = _hist((100, 500, 1000), [90, 10, 0, 0])
    snaps = [
        _snap(0, histograms={"consensus.commit_latency_ms": _hist(
            (100, 500, 1000), [0, 0, 0, 0])}),
        _snap(
            30,
            histograms={"consensus.commit_latency_ms": hist},
            gauges={"mempool.tx_queue_depth": 120.0},
        ),
    ]
    specs = [
        slo.SloSpec(
            "p99", "quantile", "consensus.commit_latency_ms",
            q=0.99, max=450.0,
        ),
        slo.SloSpec(
            "queue", "gauge_max", "mempool.tx_queue_depth", max=100.0,
        ),
    ]
    verdict = slo.evaluate(snaps, specs, window_s=10.0)
    by_name = {r["spec"]["name"]: r for r in verdict["slos"]}
    # 90 of 100 observations ≤ 100 ms, the rest in (100, 500]: the
    # interpolated p99 is 100 + 400*(9/10) = 460 ms > the 450 budget.
    assert by_name["p99"]["ok"] is False
    assert by_name["p99"]["worst"] == pytest.approx(460.0)
    assert by_name["queue"]["ok"] is False
    assert by_name["queue"]["worst"] == 120.0


def test_metric_absent_is_not_a_violation():
    snaps = [_snap(0), _snap(30)]
    verdict = slo.evaluate(snaps, slo.default_slos(), window_s=10.0)
    # No metric ever appeared: every spec reports zero windows and the
    # verdict stays green (absence of a plane ≠ violation) — but the
    # stream itself carried windows, so ok is True.
    assert verdict["ok"] is True
    assert all(r["windows"] == 0 for r in verdict["slos"])


def test_evaluate_streams_aggregates_per_node():
    good = [
        _snap(0, {"consensus.rounds_advanced": 0}),
        _snap(10, {"consensus.rounds_advanced": 100}),
    ]
    stalled = [
        _snap(0, {"consensus.rounds_advanced": 0}),
        _snap(10, {"consensus.rounds_advanced": 0}),
    ]
    specs = [
        slo.SloSpec(
            "ms_per_round", "ms_per_count",
            "consensus.rounds_advanced", max=500.0,
        )
    ]
    verdict = slo.evaluate_streams(
        {"n0": good, "n1": stalled}, specs, window_s=5.0
    )
    assert verdict["ok"] is False  # a wedged straggler fails the cluster
    assert verdict["nodes"]["n0"]["ok"] is True
    assert verdict["nodes"]["n1"]["ok"] is False


def test_spec_validation_and_io(tmp_path):
    with pytest.raises(ValueError):
        slo.SloSpec("x", "nope", "m", max=1)
    with pytest.raises(ValueError):
        slo.SloSpec("x", "quantile", "m", q=1.5, max=1)
    with pytest.raises(ValueError):
        slo.SloSpec("x", "ratio", "m", max=1)  # missing per
    with pytest.raises(ValueError):
        slo.SloSpec("x", "rate", "m")  # no threshold
    import json

    specs = slo.default_slos()
    path = tmp_path / "slos.json"
    path.write_text(json.dumps([s.to_dict() for s in specs]))
    loaded = slo.load_specs(str(path))
    assert [s.to_dict() for s in loaded] == [s.to_dict() for s in specs]


# -- gauge_growth (memory-growth SLOs) ---------------------------------------


def test_gauge_growth_judges_per_second_slope():
    spec = slo.SloSpec(
        "rss_growth", "gauge_growth", "resource.rss_bytes", max=1_000.0
    )
    snaps = [
        _snap(0, gauges={"resource.rss_bytes": 100_000}),
        _snap(10, gauges={"resource.rss_bytes": 105_000}),  # 500 B/s: ok
        _snap(20, gauges={"resource.rss_bytes": 205_000}),  # 10 kB/s: bad
    ]
    verdict = slo.evaluate(snaps, [spec], window_s=5.0)
    assert verdict["ok"] is False
    result = verdict["slos"][0]
    assert result["windows"] == 2
    assert result["violated_windows"] == 1
    assert result["worst"] == pytest.approx(10_000.0)


def test_gauge_growth_negative_growth_passes():
    # Compaction/GC shrinks the gauge: a max bound never fires.
    spec = slo.SloSpec(
        "store_growth", "gauge_growth", "resource.store_bytes", max=100.0
    )
    snaps = [
        _snap(0, gauges={"resource.store_bytes": 1_000_000}),
        _snap(10, gauges={"resource.store_bytes": 200_000}),
    ]
    verdict = slo.evaluate(snaps, [spec], window_s=5.0)
    assert verdict["ok"] is True


def test_gauge_growth_absent_gauge_skips_windows():
    # A node without the resource collector: no data, not a violation.
    spec = slo.SloSpec(
        "rss_growth", "gauge_growth", "resource.rss_bytes", max=1.0
    )
    snaps = [_snap(0), _snap(10), _snap(20)]
    verdict = slo.evaluate(snaps, [spec], window_s=5.0)
    assert verdict["ok"] is True
    assert verdict["slos"][0]["windows"] == 0


def test_memory_slos_default_set():
    specs = slo.memory_slos()
    names = [s.name for s in specs]
    assert names == ["rss_growth_bytes_per_s", "store_growth_bytes_per_s"]
    assert all(s.kind == "gauge_growth" for s in specs)


def test_dataplane_slos_gate_depth_and_unresolved():
    specs = slo.dataplane_slos(worker_store_depth=100.0)
    assert [s.name for s in specs] == [
        "worker_store_depth", "resolver_unresolved",
        "digest_queue_growth_per_s",
    ]
    # Bounded depth + zero resolution timeouts: green.
    ok_snaps = [
        _snap(0, counters={"mempool.resolver.unresolved": 0},
              gauges={"mempool.worker.store_depth": 10}),
        _snap(10, counters={"mempool.resolver.unresolved": 0},
              gauges={"mempool.worker.store_depth": 40}),
    ]
    assert slo.evaluate(ok_snaps, specs, window_s=5.0)["ok"] is True
    # Depth breach: the back-pressure failure mode is flagged.
    deep = [
        _snap(0, gauges={"mempool.worker.store_depth": 10}),
        _snap(10, gauges={"mempool.worker.store_depth": 500}),
    ]
    verdict = slo.evaluate(deep, specs, window_s=5.0)
    assert verdict["ok"] is False
    assert verdict["slos"][0]["ok"] is False
    # A single resolution timeout is an availability violation.
    timeouts = [
        _snap(0, counters={"mempool.resolver.unresolved": 0}),
        _snap(10, counters={"mempool.resolver.unresolved": 1}),
    ]
    verdict = slo.evaluate(timeouts, specs, window_s=5.0)
    assert verdict["ok"] is False


def test_dataplane_slos_skip_when_plane_absent():
    specs = slo.dataplane_slos()
    snaps = [_snap(0), _snap(10)]
    verdict = slo.evaluate(snaps, specs, window_s=5.0)
    assert verdict["ok"] is True
    assert all(s["windows"] == 0 for s in verdict["slos"])
