"""The traced part of a `--trace 1` run: torch.profiler over a short
stretch of the window, reduced at once to a few numbers.

`Trace.start()` and `Trace.stop()` each synchronise the card, so the
stretch holds whole steps or micro-batches. From the profiler's device
activity (kernels, copies, fills) the reduction keeps:

- `busy_s`: the union of the device's activity intervals;
- `window_s`: the host clock from start to stop;
- `device_ops`: device time by operation name, the largest first;
- `idle_gaps`: the device's longest idle gaps between activities, by
  the innermost host operation running at the middle of each gap;
- `kernel_s`: device time and launches of the operations whose names
  hold given parts (the hand-written kernels).

The chrome trace is not written.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

MAX_GAPS = 2000               # the longest idle gaps, named by host work
LOOKBACK_NS = 50_000_000      # host operations started this close before


class Trace:
    def __init__(self, kernel_parts=("chain_kernel", "step_bwd")):
        self.kernel_parts = tuple(kernel_parts)
        self._prof = None
        self.summary = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.cuda = torch.cuda.is_available()
        activities = [ProfilerActivity.CPU]
        if self.cuda:
            torch.cuda.synchronize()
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self):
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        self._prof.__exit__(None, None, None)
        self.summary = summarise(self._prof, t1 - self._t0,
                                 self.kernel_parts)
        self._prof = None
        return self.summary


def _events(prof):
    """(device intervals [(start_ns, end_ns, name)], host intervals)."""
    from torch.autograd import DeviceType

    dev, host = [], []
    results = prof.profiler.kineto_results
    for e in results.events():
        item = (e.start_ns(), e.end_ns(), e.name())
        if item[1] <= item[0]:
            continue
        if e.device_type() == DeviceType.CUDA:
            dev.append(item)
        elif not e.name().startswith(("cuda", "ProfilerStep", "Activity")):
            host.append(item)
    return dev, host


def summarise(prof, window_s: float, kernel_parts=()):
    dev, host = _events(prof)
    by_name = defaultdict(float)
    kernels = {part: [0.0, 0] for part in kernel_parts}
    for s, e, name in dev:
        by_name[name] += (e - s) / 1e9
        for part in kernel_parts:
            if part in name:
                kernels[part][0] += (e - s) / 1e9
                kernels[part][1] += 1
    merged = []
    for s, e, _ in sorted(dev):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged) / 1e9
    gaps = defaultdict(float)
    host.sort()
    starts = [h[0] for h in host]
    idle = sorted(((b - a, a, b) for (_, a), (b, _) in zip(merged,
                                                           merged[1:])),
                  reverse=True)[:MAX_GAPS]
    for length, a, b in idle:
        mid = (a + b) // 2
        lo = bisect.bisect_left(starts, mid - LOOKBACK_NS)
        hi = bisect.bisect_right(starts, mid)
        covering = [h for h in host[lo:hi] if h[1] >= mid]
        name = (min(covering, key=lambda h: h[1] - h[0])[2] if covering
                else "no host operation")
        gaps[name] += length / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "window_s": window_s,
            "device_ops": [[n[:80], v] for n, v in top],
            "idle_gaps": [[n[:80], v] for n, v in top_gaps],
            "kernel_s": {k: v[0] for k, v in kernels.items()},
            "kernel_launches": {k: v[1] for k, v in kernels.items()},
            "device_ops_count": len(dev)}
