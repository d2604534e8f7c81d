"""The hysteresis kernel's least time over its device time in the traced
stretch, in %: its calls (one `hysteresis_init` launch each) times a
call's least time (`flops_edgeconnect.hysteresis_call`: a byte read and
a byte written a pixel, over the card's bytes per second), over the
device time of every hysteresis kernel (init, merge, mark, spread; the
output's zeroing memset is not a kernel and is left out)."""

from benchmark.flops import least_seconds


def read(r):
    trace, call = r.get("trace"), r.get("hysteresis_call")
    if not trace or not call:
        return None
    calls = trace["kernel_launches"].get("hysteresis_init", 0)
    seconds = trace["kernel_s"].get("hysteresis", 0.0)
    if not calls or seconds <= 0:
        return None
    return 100.0 * calls * least_seconds(*call) / seconds
