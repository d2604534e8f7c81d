"""pix2pixHD's model FLOPs in the window (`flops_pix2pixhd.step_flops` for
each iteration that `Pix2PixHDState.stats` counted over the window) over
the window's seconds and the card's f32 peak (`flops.PEAK_F32_FLOPS`), in
%: the whole step's share of the peak."""

from benchmark.flops import PEAK_F32_FLOPS


def read(r):
    if not r.get("p2p_flops"):
        return None
    return 100.0 * r["p2p_flops"] / (r["window_s"] * PEAK_F32_FLOPS)
