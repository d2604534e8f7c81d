"""Host ms the engine spent launching a micro-batch (stacking, upload,
decode and execute enqueued), from `ServingEngine.stats` over the
window."""


def read(r):
    if not r.get("batches"):
        return None
    return 1e3 * r["launch_s"] / r["batches"]
