"""The card's idle share of the traced stretch: 1 - (the union of its
activity) / (the stretch's host clock), in %."""


def read(r):
    t = r.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
