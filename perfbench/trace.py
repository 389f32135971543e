"""Device trace of a window: ``torch.profiler`` with CUDA activity only
(CUPTI's record of every kernel, copy and set on the card, whoever launched
it), reduced to the busy time, the port's kernel time and launch count,
the device operations that took most time, and the idle gaps labelled with
what the host was doing.

Host and device clocks are tied by two marker kernels (``torch.cuda._sleep``),
one before the window and one after it, each launched right after a
synchronise and waited for: a marker starts after the host time read
before its launch and ends before the host time read after its wait, which
brackets the offset between the clocks at that marker. The wait returns
promptly while a launch can be held up (the first under a fresh profiler
is), so the offset is taken at the bracket's low end, and drawn as a line
between the markers, which follows a drift of one clock against the
other. The traced window is the time between the markers on the device.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

# The kernels of the port's csrc/ that ``msm_kernels.LAUNCHES`` counts.
PORT_KERNELS = (
    "decompress_kernel", "sqrt_pow_kernel", "msm_partials_kernel",
    "msm_combine_kernel", "verdict_kernel", "verdict_tree_kernel",
)
_MARKER = "spin_kernel"


@dataclass
class Trace:
    window_s: float
    busy_s: float
    port_kernel_s: float
    port_launches: int
    device_ops: list  # [name, seconds], most time first
    idle_gaps: list  # [label, seconds], longest first
    idle_by_label: dict = field(default_factory=dict)
    aligned: bool = True
    clock: str = ""


class Recorder:
    def __init__(self, torch) -> None:
        self.torch = torch
        self.prof = None
        self.marks: list[tuple[int, int]] = []  # host ns before launch, after wait

    def _mark(self) -> None:
        self.torch.cuda.synchronize()
        before = time.perf_counter_ns()
        self.torch.cuda._sleep(1000)
        self.torch.cuda.synchronize()
        self.marks.append((before, time.perf_counter_ns()))

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self._mark()

    def stop(self) -> None:
        self.torch.cuda.synchronize()
        self._mark()
        self.prof.stop()

    def reduce(self, host: dict) -> Trace | None:
        """``host``: label -> sorted, merged host intervals (ns) of what the
        harness saw, in order of precedence."""
        from torch.autograd import DeviceType

        events = []
        markers = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            name = e.name()
            start, end = e.start_ns(), e.start_ns() + e.duration_ns()
            if _MARKER in name:
                markers.append((start, end))
            else:
                events.append((start, end, name))
        if len(markers) != 2 or not events:
            return None
        markers.sort()
        lo, hi = markers[0][1], markers[1][0]
        # Device time minus host time at a marker: at least its end less the
        # host time after its wait, at most its start less the host time
        # before its launch. An empty bracket means clocks that disagree; one
        # wider than the idle gaps the breakdown labels is of no use.
        brackets = [(e - a, s - b) for (s, e), (b, a) in zip(markers, self.marks)]
        lows = [least for least, _ in brackets]
        aligned = all(0 <= most - least < 5_000_000 for least, most in brackets)
        t0, t1 = markers[0][0], markers[1][0]

        def to_host(t: int) -> int:
            return t - lows[0] - (lows[1] - lows[0]) * (t - t0) // (t1 - t0)

        events = [(max(s, lo), min(e, hi), n) for s, e, n in events if e > lo and s < hi]
        events.sort()
        by_name: dict[str, float] = {}
        port_s = 0.0
        port_n = 0
        busy = 0
        gaps = []
        cur_s, cur_e = None, None
        for s, e, name in events:
            d = e - s
            short = _short(name)
            by_name[short] = by_name.get(short, 0.0) + d / 1e9
            if any(k in name for k in PORT_KERNELS):
                port_s += d / 1e9
                port_n += 1
            if cur_e is None:
                if s > lo:
                    gaps.append((lo, s))
                cur_s, cur_e = s, e
            elif s > cur_e:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        if hi > cur_e:
            gaps.append((cur_e, hi))
        labelled = []
        idle_by = {}
        for a, b in gaps:
            label = _label(host, to_host((a + b) // 2)) if aligned else "unaligned"
            labelled.append((b - a, label))
            idle_by[label] = idle_by.get(label, 0.0) + (b - a) / 1e9
        labelled.sort(reverse=True)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return Trace(
            window_s=(hi - lo) / 1e9,
            busy_s=busy / 1e9,
            port_kernel_s=port_s,
            port_launches=port_n,
            device_ops=[[n, s] for n, s in ops],
            idle_gaps=[[label, d / 1e9] for d, label in labelled[:10]],
            idle_by_label=idle_by,
            aligned=aligned,
            clock=(f"brackets {[(most - least) // 1000 for least, most in brackets]} us, "
                   f"drift {(lows[1] - lows[0]) / 1000} us"),
        )


def _short(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    if name.startswith("void "):
        name = name[5:]
    return name[:96]


def merge(intervals) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _label(host: dict, t: int) -> str:
    for label, spans in host.items():
        i = bisect.bisect_right(spans, (t, float("inf"))) - 1
        if i >= 0 and spans[i][0] <= t < spans[i][1]:
            return label
    return "feeder"
