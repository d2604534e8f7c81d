"""The time the window's steps waited to take their batch from the
`Prefetcher`, over the window's seconds, in %."""


def read(r):
    if "data_wait_s" not in r:
        return None
    return 100.0 * r["data_wait_s"] / r["window_s"]
