"""The model FLOPs of the requests completed in the window
(`flops.serve_request`) over the window's seconds and the card's f32
peak (`flops.PEAK_F32_FLOPS`), in %."""

from benchmark.flops import PEAK_F32_FLOPS


def read(r):
    if not r.get("completed"):
        return None
    return 100.0 * r["model_flops"] / (r["window_s"] * PEAK_F32_FLOPS)
