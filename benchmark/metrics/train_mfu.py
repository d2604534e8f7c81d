"""The model FLOPs of the training steps taken in the window
(`flops.train_step`) over the window's seconds and the card's f32 peak
(`flops.PEAK_F32_FLOPS`), in %."""

from benchmark.flops import PEAK_F32_FLOPS


def read(r):
    if not r.get("steps"):
        return None
    return 100.0 * r["model_flops"] / (r["window_s"] * PEAK_F32_FLOPS)
