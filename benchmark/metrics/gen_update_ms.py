"""Device ms of the work launched inside each `train.gan.gen` span (the
rollout, G's passes through D, G's backward and Adam) in the traced
stretch, per span (`span_trace.SpanTrace`)."""

from benchmark.span_trace import per_span_ms


def read(r):
    return per_span_ms(r, "train.gan.gen")
