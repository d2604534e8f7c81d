"""Device ms of the work launched inside each `train.gan.disc` span (D's
passes, backward and Adam, and the statistics update) in the traced
stretch, per span (`span_trace.SpanTrace`)."""

from benchmark.span_trace import per_span_ms


def read(r):
    return per_span_ms(r, "train.gan.disc")
