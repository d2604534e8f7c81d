"""Device ms of the work launched inside each `train.p2p.disc` span (D's
loss over the passes made in `train.p2p.gen`, its backward and Adam) in
the traced stretch, per span (`span_trace.SpanTrace`)."""

from benchmark.span_trace import per_span_ms


def read(r):
    return per_span_ms(r, "train.p2p.disc")
