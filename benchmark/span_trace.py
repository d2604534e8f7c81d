"""A traced stretch that also divides the card's time by the program's
spans: `Trace` (the same profiler, summary and synchronisations) with the
program's span recording (`utils.profiling`) on over the same stretch.

`stop()` adds to `Trace`'s summary `span_device`: for each span name
asked for, [the device seconds of the activity launched inside such
spans, the number of those spans that started inside the stretch]. A
device activity (kernel, fill or copy) is matched to the host operator
that launched it by kineto's correlation ids, as torch.profiler links
them (`linked_correlation_id`), and the operator to the span open when
it started, by time: spans and the profiler's events share
`time.time_ns()`'s clock. Operators of any thread count, since the
autograd engine runs a backward's operators on a thread of its own while
the step's thread waits in its span; host-to-device copies do not, since
they are the prefetcher's staging of later batches.

Where the program records no such span, the counts are 0 and the
metrics that read them report nothing.
"""

from __future__ import annotations

import bisect
import time

from benchmark.trace import Trace

HOST_TO_DEVICE = "Memcpy HtoD"


class SpanTrace(Trace):
    def __init__(self, span_names, kernel_parts):
        super().__init__(kernel_parts)
        self.span_names = tuple(span_names)

    def start(self):
        from t2onet_tpu_torch.utils import profiling

        profiling.start_spans()
        super().start()
        self._t0_ns = time.time_ns()

    def stop(self):
        from t2onet_tpu_torch.utils import profiling

        prof = self._prof
        summary = super().stop()
        spans = [(s.name, s.start_ns, s.end_ns)
                 for s in profiling.take_spans()[0]
                 if s.name in self.span_names]
        dev, launches = _launches(prof)
        summary["span_device"] = span_device_seconds(
            dev, launches, spans, self.span_names, self._t0_ns)
        return summary


def _launches(prof):
    """(device activities [(start_ns, end_ns, name, linked correlation
    id)], {correlation id: start_ns of the host operator that launched
    it}). As torch.profiler links them: a device activity's (and a runtime
    call's) linked correlation id is the correlation id of the host
    operator it came from, an event whose own link is 0."""
    from torch.autograd import DeviceType

    dev, launches = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if e.end_ns() > e.start_ns():
                dev.append((e.start_ns(), e.end_ns(), e.name(),
                            e.linked_correlation_id()))
        elif e.linked_correlation_id() == 0 and e.correlation_id():
            launches[e.correlation_id()] = e.start_ns()
    return dev, launches


def span_device_seconds(dev, launches, spans, names, t0_ns: int = 0):
    """{name: [device seconds launched inside the spans of that name,
    spans of that name started at or after t0_ns]}.

    dev: [(start_ns, end_ns, name, linked correlation id)]; launches:
    {correlation id: launch start_ns}; spans: [(name, start_ns, end_ns)],
    spans of one name not overlapping (one thread's)."""
    out = {}
    for name in names:
        mine = sorted((s, e) for n, s, e in spans if n == name and s >= t0_ns)
        starts = [s for s, _ in mine]
        total = 0.0
        for a, b, kind, corr in dev:
            if kind.startswith(HOST_TO_DEVICE) or corr not in launches:
                continue
            t = launches[corr]
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= mine[i][1]:
                total += (b - a) / 1e9
        out[name] = [total, len(mine)]
    return out


def per_span_ms(readings: dict, name: str):
    """The device ms a span of `name` launched, from a run's readings;
    None where the stretch holds no such span or no device work was
    matched to one (a run without a card)."""
    found = (readings.get("trace") or {}).get("span_device", {}).get(name)
    if not found or not found[0] or not found[1]:
        return None
    return 1e3 * found[0] / found[1]
