"""The discriminator's FLOPs in the window (`flops_gan.updates` for each
G, D and statistics update that `GANState.stats` counted over the
window) over the window's seconds and the card's f32 peak
(`flops.PEAK_F32_FLOPS`), in %."""

from benchmark.flops import PEAK_F32_FLOPS


def read(r):
    if not r.get("disc_flops"):
        return None
    return 100.0 * r["disc_flops"] / (r["window_s"] * PEAK_F32_FLOPS)
