"""The device trace of a window: ``torch.profiler`` over the call, reduced to
kernel intervals, the busy union, device time by kernel pattern, the
operations that took most time and the idle gaps by what the host was doing.

The benchmark's own spans (``torch.profiler.record_function`` in the
drivers) name what the host did; an idle gap is named by the innermost
host span or operator that covers its midpoint.
"""

from __future__ import annotations

import dataclasses
import re
import time

import torch

__all__ = ["TraceReading", "traced", "span", "SPANS"]

# The benchmark's own host spans (drivers/): the profiler mirrors a range on
# the device timeline too, which is no kernel.
SPANS = ("scheduler.step", "harness.deliveries")

span = torch.profiler.record_function


def _annotation(event) -> bool:
    """A ``record_function`` range mirrored on the device timeline: no kernel."""
    return bool(getattr(event, "is_user_annotation", False))


@dataclasses.dataclass
class TraceReading:
    window_s: float
    kernels: list[tuple[str, float, float]]  # (name, start_us, end_us)
    host: list[tuple[str, float, float]]

    def busy_s(self) -> float:
        """Seconds in which some kernel ran: the union of the intervals."""
        total, end = 0.0, float("-inf")
        for _, a, b in sorted(self.kernels, key=lambda k: k[1]):
            if b <= end:
                continue
            total += b - max(a, end)
            end = b
        return total / 1e6

    def device_s(self, pattern: str) -> float | None:
        """Summed durations of the kernels whose name matches; None if none ran."""
        rx = re.compile(pattern)
        hits = [b - a for name, a, b in self.kernels if rx.search(name)]
        return sum(hits) / 1e6 if hits else None

    def top_ops(self, n: int = 10) -> list[list]:
        by: dict[str, float] = {}
        for name, a, b in self.kernels:
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """Idle device time between kernels, summed by the host span or
        operator running at each gap's midpoint; the n largest."""
        ks = sorted(self.kernels, key=lambda k: k[1])
        gaps, end = [], None
        for _, a, b in ks:
            if end is not None and a > end:
                gaps.append((end, a))
            end = b if end is None else max(end, b)
        host = sorted(self.host, key=lambda h: (h[1], -h[2]))
        by: dict[str, float] = {}
        stack: list[tuple[str, float, float]] = []
        at = 0
        # One sweep: host intervals open at the gap's midpoint stack up
        # outermost first, so the top one still open is the innermost.
        for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = (a + b) / 2
            while at < len(host) and host[at][1] <= mid:
                stack.append(host[at])
                at += 1
            while stack and stack[-1][2] < mid:
                stack.pop()
            key = stack[-1][0] if stack else "(no host span)"
            by[key] = by.get(key, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def traced(fn) -> tuple[object, TraceReading]:
    """(fn(), the trace of its call), the device synchronized on both sides."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    kernels, host = [], []
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not _annotation(e) and e.name not in SPANS:
                kernels.append((e.name, a, b))
        elif not e.name.startswith("cuda"):
            host.append((e.name, a, b))
    return out, TraceReading(window_s=window, kernels=kernels, host=host)
