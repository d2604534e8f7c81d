"""Device ms of the work launched inside each `train.p2p.gen` span (G's
forward, D's three passes, the losses with the VGG19 passes, G's backward
and Adam) in the traced stretch, per span (`span_trace.SpanTrace`)."""

from benchmark.span_trace import per_span_ms


def read(r):
    return per_span_ms(r, "train.p2p.gen")
