"""EdgeConnect's model FLOPs in the window (`flops_edgeconnect.step_flops`
for each iteration that `EdgeConnectState.stats` counted over the window)
over the window's seconds and the card's f32 peak
(`flops.PEAK_F32_FLOPS`), in %: the whole step's share of the peak."""

from benchmark.flops import PEAK_F32_FLOPS


def read(r):
    if not r.get("edgeconnect_flops"):
        return None
    return 100.0 * r["edgeconnect_flops"] / (r["window_s"] * PEAK_F32_FLOPS)
