"""Device ms of the work launched inside each `train.inpaint.disc` span
(D's passes on the real images and the fakes, its loss, backward and
Adam; not their power iterations, which run in `train.inpaint.gen`
before G's pass through D) in the traced stretch, per span
(`span_trace.SpanTrace`)."""

from benchmark.span_trace import per_span_ms


def read(r):
    return per_span_ms(r, "train.inpaint.disc")
