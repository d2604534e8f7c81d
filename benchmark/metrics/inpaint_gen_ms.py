"""Device ms of the work launched inside each `train.inpaint.gen` span
(the inpaint G's forward, all three of D's power iterations, those of
D's real and fake passes too, and G's pass through D,
the VGG19 losses, G's backward and Adam) in the traced stretch, per span
(`span_trace.SpanTrace`)."""

from benchmark.span_trace import per_span_ms


def read(r):
    return per_span_ms(r, "train.inpaint.gen")
