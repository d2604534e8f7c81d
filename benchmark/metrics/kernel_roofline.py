"""The hand-written kernels' least time over their device time in the
traced stretch, in %. Each launch's least time comes from its shape and
slots (`kernels.KernelLog`, `flops`); a kernel's total is its mean least
time a launch times the launches the profiler saw, so a launch at the
stretch's edge counts on both sides alike."""

from benchmark.kernels import PARTS


def read(r):
    trace, least = r.get("trace"), r.get("kernel_least")
    if not trace or not least:
        return None
    num = den = 0.0
    for kind, part in PARTS.items():
        total, logged = least.get(kind, (0.0, 0))
        seen = trace["kernel_launches"].get(part, 0)
        if logged and seen:
            num += total / logged * seen
            den += trace["kernel_s"][part]
    return 100.0 * num / den if den > 0 else None
