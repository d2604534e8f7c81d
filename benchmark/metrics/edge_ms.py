"""Device ms of the work launched inside each `train.inpaint.edges` span
(gray, canny with the hysteresis kernel, the edge G's forward) in the
traced stretch, per span (`span_trace.SpanTrace`)."""

from benchmark.span_trace import per_span_ms


def read(r):
    return per_span_ms(r, "train.inpaint.edges")
